"""``chip_smoke.py``'s check of the LM kernels against their plain versions,
its timing records, and its bookkeeping of the CSR-route intersect kernel
(launches a call, the bytes a batch of pairs must read, the Panel recipe).

The check holds each kernel's bf16 output, element by element, within
2^-7 of the plain version evaluated in f32 on the same inputs (plus 2^-12
of the reference's largest value), and at every shape it asserts that the
same limit rejects two planted faults. Here the CUDA wrappers are stood in
with the plain versions, evaluated in f32 and rounded once to bf16 as the
kernels round, and with faulty variants of them: the check must pass the
first and reject the others, whatever the scale of the outputs (the SSD
outputs of a Mamba2 layer are of order 1e-5). Inputs come from
``np.random.default_rng`` with the seed named in each test.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng, shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)
                            ).bfloat16()


def _inputs(name: str, scale: float):
    """(args, kwargs) of one launch, seed 2000."""
    rng = np.random.default_rng(2000)  # seed 2000
    if name == "flash_attention":
        q, k, v = (_bf16(rng, s, scale)
                   for s in ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
        return [q, k, v], dict(scale=32**-0.5, causal=True)
    if name == "rmsnorm":
        w = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
        return [_bf16(rng, (16, 64), scale), w], dict(eps=1e-6, plus_one=True)
    B, H, S, P, N = 2, 3, 64, 16, 16
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (B, H, S)).astype(np.float32))
    a_log = -dt * torch.from_numpy(rng.uniform(1.0, 16.0, (B, H, S)).astype(np.float32))
    return ([_bf16(rng, (B, H, S, P), scale), dt, a_log, _bf16(rng, (B, S, N), 0.2),
             _bf16(rng, (B, S, N), 0.2)], dict(chunk=16))


def _plain32(name, args, kwargs):
    plain = {"flash_attention": ref.attention_heads_ref, "rmsnorm": ref.rmsnorm_ref,
             "ssd_scan": ref.ssd_scan_heads_ref}[name]
    return plain(*[a.float() for a in args], **kwargs)


def _standin(name: str, fault: str):
    """A stand-in for ``ops.<name>_cuda``: the plain version in f32 rounded
    once to x's dtype, then the planted ``fault``."""
    def run(*args, **kwargs):
        y = _plain32(name, args, kwargs)
        if fault == "zeros":
            y = torch.zeros_like(y)
        elif fault == "coarse":  # 5 significant bits where bf16 has 8
            m, e = torch.frexp(y)
            y = torch.ldexp(torch.round(m * 32) / 32, e)
        elif fault == "nan":
            y = y.clone()
            y.view(-1)[7] = float("nan")
        elif fault == "carry":  # the state carried between chunks dropped
            q = kwargs["chunk"]
            x, dt, a_log, bm, cm = args
            y = torch.cat([
                _plain32(name, [x[:, :, t:t + q], dt[:, :, t:t + q],
                                a_log[:, :, t:t + q], bm[:, t:t + q], cm[:, t:t + q]],
                         kwargs)
                for t in range(0, x.shape[2], q)], dim=2)
        return y.to(args[0].dtype)
    return run


def _seen(name: str, scale: float) -> dict:
    args, kwargs = _inputs(name, scale)
    shapes = tuple((tuple(a.shape), str(a.dtype)) for a in args)
    return {(name, "test", shapes): (args, kwargs)}


@pytest.mark.parametrize("scale", [1.0, 1e-4])
@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "ssd_scan"])
def test_lm_kernel_check_passes_a_kernel_that_rounds_once(smoke, monkeypatch, name, scale):
    monkeypatch.setattr(ops, f"{name}_cuda", _standin(name, "none"))
    worst = smoke.lm_kernel_checks(_seen(name, scale))
    assert set(worst) == {name}
    # the stand-in rounds to bf16 once: within half a unit of 8 bits
    args, kwargs = _inputs(name, scale)
    want = _plain32(name, args, kwargs)
    assert 0.0 < worst[name] <= 2.0**-8 * float(want.abs().max())


@pytest.mark.parametrize("scale", [1.0, 1e-4])
@pytest.mark.parametrize("fault", ["zeros", "coarse", "nan"])
@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "ssd_scan"])
def test_lm_kernel_check_rejects_planted_faults(smoke, monkeypatch, name, fault, scale):
    monkeypatch.setattr(ops, f"{name}_cuda", _standin(name, fault))
    with pytest.raises(AssertionError, match="LM kernel checks failed"):
        smoke.lm_kernel_checks(_seen(name, scale))


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_lm_kernel_check_rejects_an_ssd_scan_without_its_carried_state(
        smoke, monkeypatch, scale):
    monkeypatch.setattr(ops, "ssd_scan_cuda", _standin("ssd_scan", "carry"))
    with pytest.raises(AssertionError, match="LM kernel checks failed"):
        smoke.lm_kernel_checks(_seen("ssd_scan", scale))


def test_lm_excess_scales_with_the_reference(smoke):
    want = torch.tensor([1e-5, -2e-5, 4e-5])
    _, ratio = smoke.lm_excess(want * (1 + 2.0**-8), want)
    assert ratio <= 1.0
    _, ratio = smoke.lm_excess(want + 1e-6, want)  # 1e-6 is 2.5 % of the largest
    assert ratio > 1.0


def _record(ms, library_ms, bound_ms=0.139):
    return {"name": "flash_attention", "ms": ms, "library_ms": library_ms,
            "bound_ms": bound_ms}


@pytest.mark.parametrize("ms,library_ms", [(0.1, 0.3), (0.3, 0.1), (0.1, None)])
def test_check_readings_refuses_a_time_under_the_bound(smoke, ms, library_ms):
    # 0.139 ms: qwen3's causal prefill attention at the H100's bf16 peak
    with pytest.raises(AssertionError, match="under its bound"):
        smoke.check_readings(_record(ms, library_ms))


@pytest.mark.parametrize("ms,library_ms", [(0.139, 0.139), (0.3, 0.5), (4.5, None)])
def test_check_readings_accepts_a_time_at_or_above_the_bound(smoke, ms, library_ms):
    rec = _record(ms, library_ms)
    assert smoke.check_readings(rec) is rec


def _stub_timing(smoke, monkeypatch, acts: dict, event_ms: float = 9.0):
    """Stands the profiler window in with ``acts`` ({name: [events, us]}),
    CUDA-event timing with ``event_ms`` a call and nvidia-smi with a line."""
    windows = []

    def device_activity(fn, iters):
        windows.append(iters)
        return {k: list(v) for k, v in acts.items()}

    monkeypatch.setattr(smoke, "device_activity", device_activity)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: event_ms)
    monkeypatch.setattr(smoke, "device_line", lambda fields="": "stub card, 700.00 W")
    return windows


def _ssd_record(smoke, symbols, iters=10):
    # bound: 1 MB at the card's rate, far under every time here
    return smoke.kernel_record(
        "ssd_scan", symbols, "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:93", 16, 0.0, lambda: None, lambda: None,
        iters, 1e6, 0.0, "stub shape", library_none="none")


def test_kernel_record_sums_the_kernels_of_one_call(smoke, monkeypatch):
    # 10 calls, each launching two kernels; a third activity is not listed
    acts = {"void (anonymous namespace)::tc::ssd_tc_kernel<8>(CUtensorMap)": [10, 2000.0],
            "void at::native::elementwise_kernel<copy>(...)": [10, 500.0],
            "Memset (Device)": [3, 30.0]}
    windows = _stub_timing(smoke, monkeypatch, acts)
    rec = _ssd_record(smoke, ("ssd_tc_kernel", "elementwise_kernel"))
    assert rec["ms"] == pytest.approx((2000.0 + 500.0) / 10 / 1e3)
    assert rec["ms_from"] == "profiler" and windows == [10]


def test_kernel_record_counts_each_kernel_once_a_call_when_events_drop(
        smoke, monkeypatch):
    # the profiler delivered 7 and 4 of 10 events: each kernel's mean
    # duration, once a call, not the window's sum over 10 calls
    acts = {"ssd_tc_kernel": [7, 1400.0], "copy_kernel": [4, 200.0]}
    _stub_timing(smoke, monkeypatch, acts)
    rec = _ssd_record(smoke, ("ssd_tc_kernel", "copy_kernel"))
    assert rec["ms"] == pytest.approx(0.200 + 0.050)


def test_kernel_record_falls_back_to_event_time_when_a_kernel_is_lost(
        smoke, monkeypatch):
    acts = {"ssd_tc_kernel": [10, 2000.0]}  # copy_kernel lost in every window
    windows = _stub_timing(smoke, monkeypatch, acts, event_ms=0.75)
    rec = _ssd_record(smoke, ("ssd_tc_kernel", "copy_kernel"))
    assert rec["ms"] == 0.75
    assert rec["ms_from"] == "cuda events, host launch included"
    assert len(windows) == smoke.PROFILER_WINDOWS


def test_kernel_record_falls_back_to_event_time_when_every_event_is_lost(
        smoke, monkeypatch):
    _stub_timing(smoke, monkeypatch, {}, event_ms=0.5)
    calls = []

    def lost(fn, iters):
        calls.append(iters)
        raise smoke.ProfilerLostEvents("no device activity in 3 windows")

    monkeypatch.setattr(smoke, "device_activity", lost)
    rec = _ssd_record(smoke, ("ssd_tc_kernel",))
    assert rec["ms"] == 0.5
    assert rec["ms_from"] == "cuda events, host launch included"
    assert len(calls) == smoke.PROFILER_WINDOWS


def test_call_device_ms_refuses_a_kernel_launched_more_than_once_a_call(smoke):
    with pytest.raises(AssertionError, match="once a call"):
        smoke.call_device_ms({"ssd_tc_kernel": [20, 10.0]}, ("ssd_tc_kernel",), 10)
    ms, seen = smoke.call_device_ms({"ssd_tc_kernel": [10, 10.0]}, ("ssd_tc_kernel",), 10)
    assert ms == pytest.approx(1e-3) and seen == {"ssd_tc_kernel": 10}


def test_call_device_ms_counts_a_kernel_launched_n_times_a_call(smoke):
    # the union's wide route: one tile sort, two merge levels, one compaction
    acts = {"segmented_union_kernel<1024, 32>": [10, 500.0],
            "union_merge_kernel": [20, 400.0], "union_compact_kernel": [10, 100.0]}
    symbols = (("segmented_union_kernel", 1), ("union_merge_kernel", 2),
               "union_compact_kernel")
    ms, seen = smoke.call_device_ms(acts, symbols, 10)
    assert ms == pytest.approx((50.0 + 2 * 20.0 + 10.0) / 1e3)
    assert seen == {"segmented_union_kernel": 10, "union_merge_kernel": 20,
                    "union_compact_kernel": 10}
    with pytest.raises(AssertionError, match="2 times a call"):
        smoke.call_device_ms({"union_merge_kernel": [21, 10.0]},
                             (("union_merge_kernel", 2),), 10)


def test_edge_launches_wants_one_csr_launch_a_call_and_no_padded_one(smoke,
                                                                    monkeypatch):
    import collections

    from repro_torch.kernels import build

    counts = collections.Counter({"intersect_rows": 5, "intersect_count": 2})
    monkeypatch.setattr(build, "launch_counts", counts)
    before = {"intersect_rows": 2, "intersect_count": 2}
    assert smoke.edge_launches("x", before, 3) == "intersect_rows x1 a call"
    with pytest.raises(AssertionError):
        smoke.edge_launches("x", before, 4)
    counts["intersect_count"] += 1
    with pytest.raises(AssertionError):
        smoke.edge_launches("x", before, 3)


def _small_layer(indptr_dtype):
    """Rows of 0, 3, 20 and 9 int32 ids (row starts at byte 0, 0, 12, 92)."""
    from types import SimpleNamespace

    from repro_torch.core.csr import csr_from_arrays

    lengths = [0, 3, 20, 9]
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(indptr_dtype)
    ids = np.concatenate([np.arange(k) * 7 for k in lengths]).astype(np.int32)
    memb = csr_from_arrays(indptr, ids, None, 4, 200, "cpu")
    return SimpleNamespace(memb=memb, memb_ov=None), indptr


@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
def test_rows_bytes_count_what_the_pairs_must_read(smoke, indptr_dtype):
    layer, indptr = _small_layer(indptr_dtype)
    u = torch.tensor([1, 0, 3, 2, 9], dtype=torch.int32)
    v = torch.tensor([2, 2, -1, 2, 3], dtype=torch.int32)
    psz = np.dtype(indptr_dtype).itemsize
    # pairs (1, 2) and (2, 2) have both rows; (2, 9 -> empty row 9) not
    entries = (3 + 20) + (20 + 20)
    assert smoke.rows_bytes(layer, u, v) == 12 * 5 + 4 * psz * 5 + 4 * entries

    def sectors(r):
        r = min(max(r, 0), 4)
        r1 = min(r + 1, 4)
        lo, hi = int(indptr[r]) * 4, int(indptr[r1]) * 4
        rows = (hi - 1) // 32 - lo // 32 + 1 if hi > lo else 0
        return rows, len({r * psz // 32, r1 * psz // 32})

    want = 12 * 5
    for a, b in zip(u.tolist(), v.tolist()):
        (ra, pa), (rb, pb) = sectors(a), sectors(b)
        want += 32 * ((ra + rb if ra and rb else 0) + pa + pb)
    assert smoke.rows_sector_bytes(layer, u, v) == want


def test_panel_membership_chunks_follow_the_recipe(smoke):
    parts = list(smoke.panel_membership_chunks(20_000, 1_000, seed=5))
    nodes = np.concatenate([n for n, _ in parts])
    groups = np.concatenate([g for _, g in parts])
    per = np.bincount(nodes, minlength=20_000)
    assert per.min() >= 1 and per.max() <= smoke.PANEL_CAP
    assert abs(per.mean() - smoke.PANEL_MEAN) < 0.5
    assert groups.min() >= 0 and groups.max() < 1_000
    assert np.all(np.diff(nodes) >= 0)


# ---------------------------------------------------------------------------
# The sampling phase's checks (fleet prefixes against the CPU path, the
# threefry kernels against their plain versions) and its byte counts
# ---------------------------------------------------------------------------


def _fleet(seed=2100, rows=64, steps=9):
    """A walk-fleet-like int32 path table, seed 2100."""
    return np.random.default_rng(seed).integers(0, 1000, (rows, steps + 1)).astype(np.int32)


def test_prefix_check_passes_equal_fleets(smoke):
    want = _fleet()
    line = smoke.prefix_check("fleet", want.tolist(), want, np.zeros(64, bool), 64)
    assert "64 rows equal the CPU path" in line


def test_prefix_check_rejects_one_walker_step_changed(smoke):
    want = _fleet()
    got = want.copy()
    got[17, 5] += 1  # one walker's step
    with pytest.raises(AssertionError, match="1 rows differ"):
        smoke.prefix_check("fleet", got, want, np.zeros(64, bool), 64)


def test_prefix_check_excuses_only_walkers_whose_layer_choice_differed(
        smoke, monkeypatch):
    want = _fleet()
    got = want.copy()
    got[17, 5:] += 1
    excused = np.zeros(64, bool)
    excused[17] = True
    # one excused walker of 10,000 compared: within CHOICE_TOL = 1e-4
    smoke.prefix_check("fleet", got, want, excused, 10_000)
    with pytest.raises(AssertionError, match="chose another layer"):
        smoke.prefix_check("fleet", got, want, excused, 5_000)
    got[3, 1] += 1  # a second walker, its choices equal: refused
    with pytest.raises(AssertionError, match="same layer choices"):
        smoke.prefix_check("fleet", got, want, excused, 10_000)


@pytest.mark.parametrize("name", ["threefry_bits", "randint", "csr_row_sample"])
def test_exact_check_rejects_a_kernel_output_off_by_one(smoke, name):
    """The plain version on the CPU stands in for the kernel; the check
    passes it and rejects the same output with one element off by one."""
    args, kwargs = _draw_args(name)
    want = smoke.draw_plain(name, args, kwargs)
    smoke.exact_check(name, want, smoke.draw_plain(name, args, kwargs))
    assert smoke.draw_err(want, want) == 0
    bad = [t.clone() for t in want]
    bad[0][len(bad[0]) // 2] += 1
    with pytest.raises(AssertionError, match="1 of"):
        smoke.exact_check(name, bad, want)
    assert smoke.draw_err(bad, want) == 1


def _draw_args(name):
    """A launch's arguments for each threefry kernel's wrapper, seed 2101:
    1,001 bits; 333 draws under per-element bounds; 40 row samples of the
    small layer of ``test_rows_bytes_count_what_the_pairs_must_read``."""
    from repro_torch.core import prng

    cpu = torch.device("cpu")
    k1, k2 = prng.split(prng.key(2101))
    if name == "threefry_bits":
        return (k1, 1001, cpu), {}
    if name == "randint":
        hi = torch.from_numpy(np.random.default_rng(2101).integers(-2, 50, 333)
                              .astype(np.int32))
        return (k1, k2, 0, hi, 333, cpu), {}
    layer, _ = _small_layer(np.int64)
    rows = torch.from_numpy(np.random.default_rng(2101).integers(-1, 6, 40)
                            .astype(np.int32))
    return (layer.memb.indptr, layer.memb.indices, rows, k1, k2), {}


def test_draw_bytes_count_what_a_row_sample_must_read(smoke):
    (indptr, ids, rows, k1, k2), kw = _draw_args("csr_row_sample")
    lengths = np.array([0, 3, 20, 9])
    r = rows.numpy()
    filled = int(sum(lengths[x] > 0 for x in r if 0 <= x < 4))
    per_row = 4 + 2 * 8 + 4 + 1
    assert smoke.draw_bytes("csr_row_sample", (indptr, ids, rows, k1, k2), kw) == \
        40 * per_row + 4 * filled
    assert smoke.draw_bytes("csr_row_sample", (indptr, ids, rows, k1, k2), kw,
                            exact=False) == 40 * per_row + 4 * 40
    assert smoke.draw_bytes("threefry_bits", *_draw_args("threefry_bits")) == 4 * 1001
    assert smoke.draw_bytes("randint", *_draw_args("randint")) == 8 * 333
    # each row's indptr pair (int64: entries r and r+1 share a sector unless
    # r+1 starts a new one) and one sector for each non-empty row's sample
    pos = np.clip(r, 0, 4)
    pairs = sum(1 + (p * 8 // 32 != (p + 1) * 8 // 32) for p in pos)
    assert smoke.draw_sector_bytes((indptr, ids, rows, k1, k2), kw) == \
        9 * 40 + 32 * (pairs + filled)


def test_moved_copies_every_tensor_of_a_network(smoke):
    from repro_torch.core import api

    net = api.createnetwork(api.createnodeset(50, device="cpu"))
    net = api.generate(api.addlayer(net, "wk", 2), "wk", type="2mode", h=5, a=2, seed=1)
    net = api.setnodeattr(net, "x", np.arange(50), np.arange(50), kind="int")
    copy = smoke.moved(net, torch.device("cpu"))
    assert copy is not net and copy.layer_names == net.layer_names
    assert torch.equal(copy.layer("wk").memb.indices, net.layer("wk").memb.indices)
    assert copy.nodeset.device == torch.device("cpu")


def test_busy_share_reads_not_measured_when_the_profiler_loses_every_event(
        smoke, monkeypatch):
    def lost(fn, iters):
        raise smoke.ProfilerLostEvents("no device activity in 3 windows")

    monkeypatch.setattr(smoke, "device_activity", lost)
    assert smoke.busy_share(lambda: None, 1.0, top=4).startswith(
        "device busy not measured")

    def fault(fn, iters):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(smoke, "device_activity", fault)
    with pytest.raises(RuntimeError, match="illegal"):
        smoke.busy_share(lambda: None, 1.0)


# ---------------------------------------------------------------------------
# The storage phase, rehearsed on the CPU: counting stand-ins for the three
# kernels' CUDA entries (each the plain version), cut constants
# ---------------------------------------------------------------------------

STORAGE_CUT = {
    "REG_MOVES": 40, "REG_NEW_GROUPS": 10, "REG_NEW_MEMBERS": 50,
    "REG_RANDOM_ADDS": 200, "REG_RANDOM_DELETES": 40, "REG_SCHOOL_JOINS": 40,
    "REG_INCOME_UPDATES": 40, "POINT_PAIRS": 64, "ALTERS_NODES": 32,
    "DEGREE_NODES": 64, "ORACLE_QUERIES": 16, "MAX_ALTERS": 512,
    "STORAGE_WALK_STARTS": 64, "STORAGE_WALK_STEPS": 5, "STORAGE_REPEATS": 1,
    "CLI_QUERIES": 4,
}
STORAGE_NODES = 20_000


def _counting(key, fn):
    from repro_torch.kernels import build

    def run(*args, **kwargs):
        build.launch_counts[key] += 1
        return fn(*args, **kwargs)

    return run


@pytest.fixture
def storage_smoke(smoke, monkeypatch):
    """``chip_smoke`` with the storage phase's kernels stood in on the CPU
    and its constants cut; the network is built once per test."""
    import time

    from repro_torch.core.csr import SENTINEL

    for name, value in STORAGE_CUT.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "STORE_NODES", STORAGE_NODES)
    monkeypatch.setattr(smoke, "sync", lambda: None)
    monkeypatch.setattr(smoke, "device_line", lambda fields="": "cpu (stand-in)")

    def profiled(fn):
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, {}, out

    monkeypatch.setattr(smoke, "profiled", profiled)
    monkeypatch.setattr(ops, "intersect_rows",
                        _counting("intersect_rows", ops.intersect_rows))
    monkeypatch.setattr(ops, "segmented_union_cuda", _counting(
        "segmented_union", lambda flat, max_out: ref.segmented_union_ref(flat, max_out)[0]))

    def union(flat, max_out, *, tile=ops.MAX_FLAT):
        batch, k = flat.shape[:-1], flat.shape[-1]
        out = ops.segmented_union_cuda(flat.reshape(-1, k).contiguous(), max_out)
        out = out.reshape(batch + (max_out,))
        return out, out != int(SENTINEL)

    monkeypatch.setattr(ops, "segmented_union", union)

    def sample_cuda(indptr, ids, rows, k1, k2, *, overlay=None):
        base, ov = smoke.draw_csrs((indptr, ids, rows), {"overlay": overlay})
        return ref.csr_row_sample_ref(base, ov, rows, k1, k2)

    monkeypatch.setattr(ops, "csr_row_sample_cuda",
                        _counting("csr_row_sample", sample_cuda))

    def sample(base, ov, rows, k1, k2):
        overlay = None if ov is None else (ov.dirty, ov.delta.indptr, ov.delta.indices)
        flat = rows.reshape(-1).to(torch.int32).contiguous()
        s, v = ops.csr_row_sample_cuda(base.indptr, base.indices, flat, k1, k2,
                                       overlay=overlay)
        return s.reshape(rows.shape), v.reshape(rows.shape)

    monkeypatch.setattr(ops, "csr_row_sample", sample)
    monkeypatch.setattr(ops, "frontier_compact",
                        _counting("frontier_compact", ops.frontier_compact))
    # a load on the CPU holds the whole network on the host: the reading's
    # own checks are rehearsed below
    monkeypatch.setattr(smoke, "load_rss", lambda path, mmap, device: {
        "growth": 1, "mirrors": 1, "staging": 0})
    net, median = smoke.build_network(STORAGE_NODES, 0, torch.device("cpu"))
    return smoke, net, median


def test_storage_phase_rehearsed_on_the_cpu(storage_smoke, capsys):
    smoke, net, median = storage_smoke
    out = smoke.phase_storage(net, median, 0, torch.device("cpu"))
    for key in ("intersect_rows", "segmented_union", "csr_row_sample"):
        assert out["launches"][key] > 0
    text = capsys.readouterr().out
    assert "each query on the overlays equals compacted()'s" in text
    # the Schools batch past 65,535 leaves an int32 delta over a uint16 base
    assert "Schools: memb torch.uint16 base under a torch.int32 delta" in text
    assert out["cli_launches"]["frontier_compact"] > 0
    assert "WAL cut at byte" in text and "CLI script" in text
    assert "its network equals the directly mutated one" in text
    assert "CLI store script" in text


@pytest.mark.parametrize("reading", ["below the floor", "the file's size"])
def test_storage_files_rejects_a_load_rss_reading(storage_smoke, monkeypatch,
                                                  tmp_path, reading):
    """A reading under what the load allocates (indptr mirrors + staging)
    misses growth; an mmap load's at the file's size made a host copy."""
    smoke, net, _ = storage_smoke
    growth = 99 if reading == "below the floor" else 1 << 40
    monkeypatch.setattr(smoke, "load_rss", lambda path, mmap, device: {
        "growth": growth, "mirrors": 64, "staging": 36})
    with pytest.raises(AssertionError, match="below|not less than the file"):
        smoke.storage_files(net, tmp_path, "cpu (stand-in)", torch.device("cpu"))


def test_load_rss_reads_the_load_alone(smoke, tmp_path):
    """The reading in a fresh interpreter: on the CPU the load holds every
    array on the host, so it passes the mirrors and needs no staging."""
    from repro_torch.core import api

    net, _ = smoke.build_network(2_000, 0, torch.device("cpu"))
    path = tmp_path / "n.npz"
    api.savefile(net, str(path), compress=False)
    got = smoke.load_rss(path, True, torch.device("cpu"))
    assert got["staging"] == 0
    assert got["mirrors"] == sum(
        c.indptr_host.nbytes for layer in net.layers
        for c in ((layer.memb, layer.members) if layer.mode == 2 else (layer.out, layer.in_))
        if c is not None)
    assert got["growth"] >= got["mirrors"] > 0


def _changed(net, what: str):
    """A copy of ``net`` with one buffer changed."""
    from dataclasses import replace

    layer = net.layer("Households")
    memb = layer.memb
    if what == "element":
        ids = memb.indices.clone()
        ids.view(torch.int16)[3] += 1  # uint16 ids: torch adds on int16
        return net.with_layer("Households", replace(layer, memb=replace(memb, indices=ids)))
    if what == "dtype":
        return net.with_layer("Households", replace(layer, memb=replace(
            memb, indptr=memb.indptr.to(torch.int64))))
    col = net.nodeset.attrs.column("income")
    vals = col.values.clone()
    vals[-1] += 1
    attrs = net.nodeset.attrs.with_column("income", replace(col, values=vals))
    return net.with_nodeset(replace(net.nodeset, attrs=attrs))


@pytest.mark.parametrize("what", ["element", "dtype", "attribute"])
def test_assert_same_network_rejects_a_changed_buffer(storage_smoke, what):
    smoke, net, _ = storage_smoke
    assert smoke.assert_same_network("same", net, net) > 0
    with pytest.raises(AssertionError, match="differs"):
        smoke.assert_same_network("changed", _changed(net, what), net)


def test_storage_phase_rejects_a_query_differing_from_compacted(storage_smoke,
                                                               monkeypatch):
    from repro_torch.core.network import Network

    smoke, net, median = storage_smoke
    real = Network.compacted

    def compacted(self):
        out = real(self)
        if out is self:  # nothing to fold: the file save's call
            return out
        return out.with_layer("Households", out.layer("Workplaces"))

    monkeypatch.setattr(Network, "compacted", compacted)
    with pytest.raises(AssertionError, match="differs from the same query on compacted"):
        smoke.phase_storage(net, median, 0, torch.device("cpu"))


def test_storage_phase_rejects_a_recovery_missing_the_last_op(storage_smoke,
                                                             monkeypatch):
    from repro_torch.core import wal

    smoke, net, median = storage_smoke
    real = wal.WriteAheadLog.append

    def append(self, op):
        if op["op"] == "set_attr":  # acknowledged, never written
            self.last_lsn += 1
            return self.last_lsn
        return real(self, op)

    monkeypatch.setattr(wal.WriteAheadLog, "append", append)
    with pytest.raises(AssertionError, match="recovery replayed"):
        smoke.phase_storage(net, median, 0, torch.device("cpu"))


def test_storage_phase_runs_the_store_on_a_cut_network(storage_smoke, monkeypatch,
                                                      capsys):
    smoke, net, median = storage_smoke
    monkeypatch.setattr(smoke, "STORE_NODES", STORAGE_NODES // 2)
    smoke.phase_storage(net, median, 0, torch.device("cpu"))
    text = capsys.readouterr().out
    assert f"store network of {STORAGE_NODES // 2} nodes (cut)" in text
    assert f"store of {STORAGE_NODES // 2} nodes" in text
