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
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.flash_attention import uses_wgmma

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
    if name == "rglru_scan":  # f32 in and out, the carried state given
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 48, 32)).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal((2, 48, 32)) * scale).astype(np.float32))
        h0 = torch.from_numpy((rng.standard_normal((2, 32)) * scale).astype(np.float32))
        return [a, b, h0], {}
    B, H, S, P, N = 2, 3, 64, 16, 16
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (B, H, S)).astype(np.float32))
    a_log = -dt * torch.from_numpy(rng.uniform(1.0, 16.0, (B, H, S)).astype(np.float32))
    return ([_bf16(rng, (B, H, S, P), scale), dt, a_log, _bf16(rng, (B, S, N), 0.2),
             _bf16(rng, (B, S, N), 0.2)], dict(chunk=16))


def _plain32(name, args, kwargs):
    plain = {"flash_attention": ref.attention_heads_ref, "rmsnorm": ref.rmsnorm_ref,
             "ssd_scan": ref.ssd_scan_heads_ref, "rglru_scan": ref.rglru_scan_ref}[name]
    return plain(*[a if a is None else a.float() for a in args], **kwargs)


def _standin(name: str, fault: str):
    """A stand-in for ``ops.<name>_cuda``: the plain version in f32 rounded
    once to x's dtype, then the planted ``fault``."""
    def run(*args, **kwargs):
        if kwargs.pop("residuals", False):  # the flash forward under grad
            return _flash_residuals(args, kwargs)
        y = _plain32(name, args, kwargs)
        if fault == "zeros":
            y = torch.zeros_like(y)
        elif fault == "coarse":  # 5 significant bits where bf16 has 8
            m, e = torch.frexp(y)
            y = torch.ldexp(torch.round(m * 32) / 32, e)
        elif fault == "nan":
            y = y.clone()
            y.view(-1)[7] = float("nan")
        elif fault == "no_h0":  # the RG-LRU scan started from 0, not h0
            y = _plain32(name, args[:2], kwargs)
        elif fault == "no_recurrence":  # h_t = b_t: a_t h_(t-1) dropped
            y = args[1].clone()
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
@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "ssd_scan", "rglru_scan"])
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


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_lm_kernel_check_passes_an_rglru_scan_equal_to_its_loop(smoke, monkeypatch,
                                                                  scale):
    monkeypatch.setattr(ops, "rglru_scan_cuda", _standin("rglru_scan", "none"))
    assert smoke.lm_kernel_checks(_seen("rglru_scan", scale)) == {"rglru_scan": 0.0}


@pytest.mark.parametrize("scale", [1.0, 1e-4])
@pytest.mark.parametrize("fault", ["no_h0", "no_recurrence"])
def test_lm_kernel_check_rejects_an_rglru_scan_without_its_state(smoke, monkeypatch,
                                                                 fault, scale):
    monkeypatch.setattr(ops, "rglru_scan_cuda", _standin("rglru_scan", fault))
    with pytest.raises(AssertionError, match="LM kernel checks failed"):
        smoke.lm_kernel_checks(_seen("rglru_scan", scale))


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


def test_kernel_record_prefers_a_window_whose_events_all_arrived(smoke, monkeypatch):
    # the first window lost 4 of 10 events and read half the time; the
    # second delivered all 10: its reading is the record's
    _stub_timing(smoke, monkeypatch, {})
    windows = [{"ssd_tc_kernel": [6, 600.0]}, {"ssd_tc_kernel": [10, 2000.0]}]
    calls = []

    def device_activity(fn, iters):
        calls.append(iters)
        return windows[len(calls) - 1]

    monkeypatch.setattr(smoke, "device_activity", device_activity)
    rec = _ssd_record(smoke, ("ssd_tc_kernel",))
    assert rec["ms"] == pytest.approx(0.200)
    assert rec["ms_from"] == "profiler" and calls == [10, 10]


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


SERVING_CUT = {"SERVE_REQUESTS": 800, "SERVE_CAPACITY_REQUESTS": 160,
               "SERVE_MUTATIONS": 4, "SERVE_PHASE_LIMIT_S": 900.0}


@pytest.fixture
def serving_smoke(storage_smoke, monkeypatch):
    """The storage rehearsal's stand-ins and network, the serving phase's
    constants cut (a trace of 800 requests, 4 mutations)."""
    smoke, net, median = storage_smoke
    for name, value in SERVING_CUT.items():
        monkeypatch.setattr(smoke, name, value)
    return smoke, net, median


def test_serving_phase_rehearsed_on_the_cpu(serving_smoke, capsys):
    smoke, net, median = serving_smoke
    out = smoke.phase_serving(net, median, torch.device("cpu"))
    for key in smoke.SERVE_KERNELS:
        assert out["launches"][key] > 0, key
    text = capsys.readouterr().out
    n_loop = len(range(0, 800, smoke.SERVE_LOOP_STRIDE))
    assert (f"800 served results, 0 errors; the {n_loop} of the loop bit-identical"
            in text)
    assert "loop ms a request by kind: alters" in text
    assert "bit-identical to the plain paths" in text
    assert "800 wire results (JSON round trip) equal (a)'s" in text
    assert "ran on the pump thread" in text
    assert "bit-identical between scoped and global invalidation" in text
    wire = out["wire"]
    assert wire["faults_fired"] >= 1 and wire["idempotent_replays"] >= 1
    assert out["mutations"]["scoped"]["misses"] <= out["mutations"]["global"]["misses"]


@pytest.mark.parametrize("kind", ["getedge", "fgetedge", "alters", "degree",
                                  "khop", "walkbatch"])
def test_serving_oracle_rejects_a_changed_result(serving_smoke, kind):
    from repro_torch.serve import run_request

    smoke, net, median = serving_smoke
    slo = smoke.serve_slo()
    flt = {"attr": "income", "op": "gt", "value": median}
    trace = slo.build_serve_trace(net, 400, flt)
    values = [run_request(net, r) for r in trace]
    smoke.serving_oracle(net, trace, values, median, torch.device("cpu"))
    i = next(j for j, r in enumerate(trace) if slo.trace_kind(r) == kind)
    v = values[i]
    if isinstance(v, list):  # a k-hop record
        v = [dict(v[0], count=v[0]["count"] + 1)]
    elif isinstance(v, np.ndarray):
        v = v.copy()
        v.flat[-1] += 1
    else:
        v = v + 1
    values[i] = v
    with pytest.raises(AssertionError, match=kind):
        smoke.serving_oracle(net, trace, values, median, torch.device("cpu"))


def test_serving_wire_rejects_a_result_differing_from_the_engine(serving_smoke):
    from repro_torch.serve import run_request

    smoke, net, median = serving_smoke
    slo = smoke.serve_slo()
    trace = slo.build_serve_trace(net, 300, {
        "attr": "income", "op": "gt", "value": median})
    values = [run_request(net, r) for r in trace]
    values[7] = values[8] if trace[7] != trace[8] else -1.0
    with pytest.raises(AssertionError, match="differ from \\(a\\)'s, first at request 7"):
        smoke.serving_wire(net, trace, values, "cpu (stand-in)", torch.device("cpu"))


def test_serving_wire_rejects_a_mutation_off_the_pump_thread(serving_smoke,
                                                            monkeypatch):
    from repro_torch.serve import GraphServeEngine, run_request

    smoke, net, median = serving_smoke
    slo = smoke.serve_slo()
    trace = slo.build_serve_trace(net, 300, {
        "attr": "income", "op": "gt", "value": median})
    values = [run_request(net, r) for r in trace]

    def on_the_caller(self, apply, **commit):  # the wire's session thread
        self._commit_mutation(apply(), **commit)
        return self.net

    monkeypatch.setattr(GraphServeEngine, "_mutate", on_the_caller)
    with pytest.raises(AssertionError, match="mutation ran on threads"):
        smoke.serving_wire(net, trace, values, "cpu (stand-in)", torch.device("cpu"))


def test_wire_load_outlasts_a_run_of_torn_writes(smoke):
    """One session whose response is torn 12 times running (more than the
    8 attempts the load generator once allowed) still gets every result,
    each torn ack replayed."""
    from repro_torch.core import api
    from repro_torch.serve import FaultPlan, run_request

    slo = smoke.serve_slo()
    net, median = slo._standalone_net(2_000, torch.device("cpu"))
    trace = slo.build_serve_trace(net, 20, {"attr": "income", "op": "gt",
                                            "value": median})
    plan = FaultPlan({"write": {"kind": "torn", "frac": 0.5,
                                "at": tuple(range(4, 16))}}, seed=17)
    fe = api.servenet(net, port=0, fault_plan=plan)
    try:
        res = slo.run_open_loop(fe, trace, rate=200.0, n_threads=1,
                                deadline_ms=2000.0)
    finally:
        fe.close()
    assert res["errors"] == 0, res["error_kinds"]
    assert res["torn_writes"] == 12 and res["idempotent_replays"] == 12
    assert [got for _, got in res["outcomes"]] == [
        smoke.wire_value(run_request(net, r)) for r in trace]


@pytest.mark.parametrize("lost", [0, 1])
def test_serving_engine_reads_busy_only_from_a_whole_window(serving_smoke,
                                                          monkeypatch, capsys,
                                                          lost):
    """The profiled engine run reports device busy only where the window
    holds a graph-kernel event for every launch counted in it."""
    import collections
    import time

    from repro_torch.kernels import build

    smoke, net, median = serving_smoke
    slo = smoke.serve_slo()
    trace = slo.build_serve_trace(net, 300, {
        "attr": "income", "op": "gt", "value": median})

    def profiled(fn):  # one device event for each launch, less ``lost``
        before = collections.Counter(build.launch_counts)
        t0 = time.perf_counter()
        out = fn()
        wall = (time.perf_counter() - t0) * 1e3
        n = smoke.graph_launches(build.launch_counts - before) - lost
        return wall, {"void segmented_union_kernel<8, 4>(int const*)": [n, 1000.0],
                      "Memcpy HtoD (Pageable -> Device)": [3, 500.0]}, out

    monkeypatch.setattr(smoke, "profiled", profiled)
    out = smoke.serving_engine(net, trace, median, "cpu (stand-in)",
                               torch.device("cpu"))
    text = capsys.readouterr().out
    if lost:
        assert "(window 3 of at most 3)" in text
        assert "device busy not measured (every window lost events)" in text
        assert out["busy_ms"] is None
    else:
        assert "(window 1 of at most 3)" in text
        assert "device busy 1.500 ms" in text and "0.3333 of busy" in text
        assert out["busy_ms"] == 1.5 and out["h2d_ms"] == 0.5


def test_thread_ids_take_the_signed_low_bits_of_the_ident(smoke):
    """Kineto filed the pump's runtime events under -1760565568, the low
    32 bits of its ``threading.get_ident()`` (2534401728) read signed."""
    import types

    pump = types.SimpleNamespace(native_id=271, ident=(0x7F3A << 32) | 2534401728)
    assert smoke.thread_ids(pump) == {271, 2534401728, -1760565568}
    main = types.SimpleNamespace(native_id=129, ident=(0x7F3A << 32) | 764409536)
    assert smoke.thread_ids(main) == {129, 764409536}


# ---------------------------------------------------------------------------
# The sharded phase, rehearsed on the CPU: the serving rehearsal's stand-ins
# and network, counting stand-ins for intersect_count and randint, the CUDA
# memory readings and the profiler's thread ids stubbed, cut constants
# ---------------------------------------------------------------------------

SHARDED_CUT = {"SHARDED_WALKERS": 512, "SHARDED_BENCH_NODES": 24_000,
               "SHARDED_BENCH_HUB": 400, "SHARDED_PHASE_LIMIT_S": 900.0,
               "KHOP_SOURCES": 32}


@pytest.fixture
def sharded_smoke(serving_smoke, monkeypatch):
    import collections

    smoke, net, median = serving_smoke
    for name, value in SHARDED_CUT.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(ops, "intersect_count",
                        _counting("intersect_count", ops.intersect_count))
    monkeypatch.setattr(ops, "randint", _counting("randint", ops.randint))
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda: 0)
    def no_events(fn, iters):
        raise smoke.ProfilerLostEvents("no device on the CPU")

    monkeypatch.setattr(smoke, "device_activity", no_events)
    monkeypatch.setattr(smoke, "launch_threads", lambda prof: collections.Counter({7: 1}))
    monkeypatch.setattr(smoke, "thread_ids", lambda thread: {7})
    return smoke, net, median


def test_sharded_phase_rehearsed_on_the_cpu(sharded_smoke, capsys):
    smoke, net, median = sharded_smoke
    out = smoke.phase_sharded(net, median, 0, torch.device("cpu"))
    for key in smoke.SHARDED_KERNELS + ("randint",):
        assert out["launches"][key] > 0, key
    text = capsys.readouterr().out
    for count in smoke.SHARD_COUNTS:
        assert f"shard_network at {count} shards" in text
    assert "calls equals the unsharded port's bit for bit" in text
    assert "equal to the plain draws'" in text
    assert "every record equal" in text
    assert "(reshard_deltas), getedge after it reads 1.0 for each" in text
    assert "1-over-4" in text


def test_sharded_phase_rejects_a_result_differing_from_unsharded(sharded_smoke,
                                                                monkeypatch):
    from repro_torch.core import sharded

    smoke, net, median = sharded_smoke
    real = sharded.ShardedNetwork.degree

    def degree(self, *args, **kw):
        out = real(self, *args, **kw)
        out[-1] += 1
        return out

    monkeypatch.setattr(sharded.ShardedNetwork, "degree", degree)
    with pytest.raises(AssertionError, match="getdegree .* differs from the unsharded"):
        smoke.phase_sharded(net, median, 0, torch.device("cpu"))


def test_sharded_phase_rejects_a_full_reshard_after_add_edges(sharded_smoke,
                                                             monkeypatch):
    from repro_torch.core import sharded

    smoke, net, median = sharded_smoke
    monkeypatch.setattr(sharded, "reshard_deltas", lambda snet, new_net: None)
    with pytest.raises(AssertionError, match="not reshard_deltas"):
        smoke.phase_sharded(net, median, 0, torch.device("cpu"))


# ---------------------------------------------------------------------------
# The lm_families phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

FAMILY_CUT = {"LM_REQUESTS": 2, "LM_PROMPT": 64, "LM_NEW": 4, "LM_MAX_SEQ": 68,
              "LM_CHECK_REQUESTS": 2, "LM_CHECK_PROMPT": 16, "LM_CHECK_STEPS": 2,
              "LM_FAMILY_PREFIX_STEPS": 2}


def _kernel_standin(name: str, fault: str = "none"):
    """``ops.<name>_cuda`` stood in by its plain version in f32, rounded
    once (``_standin``), counted under the kernel's own key."""
    return _counting(name, _standin(name, fault))


@pytest.fixture
def families_smoke(smoke, monkeypatch):
    """``chip_smoke`` with its LM constants cut, its device probes stubbed
    and the LM ops routed on the CPU to counting stand-ins of their CUDA
    wrappers, which ``KernelInputs`` records as it records the kernels."""
    for name, value in FAMILY_CUT.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "sync", lambda: None)
    monkeypatch.setattr(smoke, "device_line", lambda fields="": "cpu (stand-in)")
    monkeypatch.setattr(smoke, "device_activity", lambda fn, iters: (
        fn(), {"void rmsnorm_any_kernel<__nv_bfloat16>": [1, 2.0]})[1])
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "cold_ms", lambda fn, iters, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    for name in ("flash_attention", "rmsnorm", "rglru_scan"):
        monkeypatch.setattr(ops, f"{name}_cuda", _kernel_standin(name))
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, *, causal=True: (
        ops.flash_attention_cuda(q, k, v, scale=q.shape[-1] ** -0.5, causal=causal)))
    monkeypatch.setattr(ops, "rmsnorm", lambda x, w, *, eps, plus_one: (
        ops.rmsnorm_cuda(x, w, eps=eps, plus_one=plus_one)))
    monkeypatch.setattr(ops, "rglru_scan", lambda a, b, h0=None: (
        ops.rglru_scan_cuda(a, b, h0)))
    from repro_torch.configs import get_config

    configs = {arch: get_config(arch).reduced(dtype="bfloat16")
               for arch in smoke.LM_FAMILY_ARCHS}
    return smoke, configs


def test_lm_families_phase_rehearsed_on_the_cpu(families_smoke, capsys):
    smoke, configs = families_smoke
    out = smoke.phase_lm_families(torch.device("cpu"), 0, configs)
    text = capsys.readouterr().out
    runs = 2 * (smoke.LM_FAMILY_REPEATS + 1)  # generate calls, both kinds
    hybrid = configs["recurrentgemma-9b"]
    n_rglru = (list(hybrid.block_pattern) * hybrid.n_groups
               + list(hybrid.tail_pattern)).count("rglru")
    assert out["launches"]["rglru_scan"] == n_rglru * runs
    assert out["launches"]["flash_attention"] > 0 and out["launches"]["rmsnorm"] > 0
    assert set(out["worst"]) == {"flash_attention", "rmsnorm", "rglru_scan"}
    assert out["worst"]["rglru_scan"] == 0.0
    for arch in configs:
        assert f"lm_families: {arch} f32 (TF32 off" in text
        assert f"lm_families: {arch}: greedy tokens deterministic" in text
    assert "MoE routing at prefill" in text and "MoE routing at decode step" in text
    assert "patch embeddings ahead of 64 tokens" in text
    assert "codebook choices" in text
    assert "route void rmsnorm_any_kernel" in text
    rec = smoke.rglru_timing(out)
    assert rec["name"] == "rglru_scan" and rec["library_ms"] is None
    assert rec["launches"] == n_rglru * runs and rec["bound_by"] == "bytes"
    assert rec["source"] == "src/repro_torch/csrc/rglru_scan.cu"
    assert {"route", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms"} <= set(rec)


def test_lm_families_phase_refuses_flash_on_a_windowed_model(families_smoke,
                                                              monkeypatch):
    """recurrentgemma's windowed attention must never take the flash
    kernel; a path that sent it there fails the phase."""
    smoke, configs = families_smoke
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "attention_blocked", lambda q, k, v, cfg: (
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)))
    with pytest.raises(AssertionError, match="flash_attention launched"):
        smoke.phase_lm_families(torch.device("cpu"), 0,
                                {"recurrentgemma-9b": configs["recurrentgemma-9b"]})


@pytest.mark.parametrize("fault", ["zeros", "no_h0", "no_recurrence"])
def test_lm_families_phase_rejects_a_faulty_rglru_scan(families_smoke, monkeypatch,
                                                       fault):
    smoke, configs = families_smoke
    monkeypatch.setattr(ops, "rglru_scan_cuda", _kernel_standin("rglru_scan", fault))
    with pytest.raises(AssertionError, match="LM kernel checks failed|f32 decode"):
        smoke.phase_lm_families(torch.device("cpu"), 0,
                                {"recurrentgemma-9b": configs["recurrentgemma-9b"]})


def test_lm_phase_rehearsed_on_the_cpu(families_smoke, capsys):
    """The lm phase's shared serving code on a reduced bf16 qwen3: flash
    attention and rmsnorm launch, greedy tokens are equal over every
    greedy call and the f32 copy decodes as the full forward."""
    smoke, _ = families_smoke
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-1.7b").reduced(dtype="bfloat16")
    out = smoke.phase_lm(torch.device("cpu"), 0, {"qwen3-1.7b": cfg})
    text = capsys.readouterr().out
    assert out["launches"]["flash_attention"] > 0 and out["launches"]["rmsnorm"] > 0
    calls = smoke.LM_REPEATS + 1
    assert f"greedy tokens deterministic over {calls} calls" in text
    assert "lm: qwen3-1.7b f32 (TF32 off): prefill 16 + 2 decode steps" in text


def test_family_configs_cut_depth_only(smoke, capsys):
    from repro_torch.configs import get_config

    configs = smoke.family_configs()
    text = capsys.readouterr().out
    assert list(configs) == list(smoke.LM_FAMILY_ARCHS)
    for arch, cfg in configs.items():
        full = get_config(arch)
        assert cfg.n_layers == smoke.LM_FAMILY_LAYERS.get(arch, full.n_layers)
        assert (cfg.d_model, cfg.n_heads, cfg.vocab_size, cfg.n_experts) == (
            full.d_model, full.n_heads, full.vocab_size, full.n_experts)
    assert "llama4-scout-17b-a16e: depth cut to 8 of 48 layers (all 48 take " \
           "215540224000 bytes in bf16, past the card's memory" in text
    assert "internvl2-26b: depth cut to 16 of 48 layers (the smoke's time" in text
    assert "recurrentgemma-9b: depth cut" not in text


# ---------------------------------------------------------------------------
# The train: phase
# ---------------------------------------------------------------------------

TRAIN_CUT = {"TRAIN_BATCH": 2, "TRAIN_SEQ": 32, "TRAIN_STEPS": 3,
             "TRAIN_RESUME_STEPS": 4, "TRAIN_SERVE_PROMPT": 8, "TRAIN_SERVE_NEW": 3,
             "TRAIN_SCAN_STEPS": 3,
             "TRAIN_F32_SHAPES": {"flash": (1, 2, 1, 40, 32), "rmsnorm": (16, 64),
                                  "ssd": (1, 2, 45, 16, 16, 32), "rglru": (1, 33, 8)}}
# the scans' plain versions as imported, before the smoke's PlainScanCalls
# wraps them: the stand-ins below are the card's kernels, not its fallback
_SSD_PLAIN, _RGLRU_PLAIN = ref.ssd_scan_heads_ref, ref.rglru_scan_ref


def _bwd_chunk_standin(chunk: int, seq: int, n: int, p: int) -> int:
    """The SSD backward's chunk where its blocks fit in shared memory, as
    they do at these tests' shapes: ``ssd_scan.bwd_chunk`` asks the CUDA
    library, which is not built here."""
    return min(ssd_scan.kernel_chunk(chunk, seq), ssd_scan.BWD_MAX_CHUNK)


def _bwd_standin(name: str, fault: str = "none"):
    """A stand-in for ``ops.<name>_cuda`` of a backward kernel: its plain
    version (f32 autograd), each output rounded once to its kernel's dtype,
    then the planted ``fault`` on the first output."""
    def run(*args, **kwargs):
        if name == "rmsnorm_bwd":
            x, w, dy = args
            outs = list(ref.rmsnorm_bwd_ref(x, w, dy, **kwargs))
            outs[0] = outs[0].to(x.dtype)
        elif name == "ssd_scan_bwd":  # the kernel's algorithm at its own chunk
            x, dt, a_log, bmat, cmat, dy = args
            q = _bwd_chunk_standin(kwargs["chunk"], x.shape[2], bmat.shape[-1],
                                   x.shape[-1])
            outs = list(ref.ssd_scan_chunked_bwd(*args, chunk=q))
            for i, dtype in ((0, x.dtype), (3, bmat.dtype), (4, bmat.dtype)):
                outs[i] = outs[i].to(dtype)
        elif name == "rglru_scan_bwd":
            outs = list(ref.rglru_scan_bwd_loop(*args))
        else:
            outs = [t.to(args[0].dtype)
                    for t in ref.attention_bwd_ref(*args[:4], **kwargs)]
        if fault == "zeros":
            outs[0] = torch.zeros_like(outs[0])
        elif fault == "scaled":  # a dropped factor: the gradient doubled
            outs[0] = outs[0] * 2
        return tuple(outs)
    return run


def _flash_residuals(args, kwargs):
    """What ``flash_attention_cuda(..., residuals=True)`` returns, in plain
    torch: (o, o_lo, lse) on the tensor-core route, (o, None, None) on the
    CUDA-core route, whose backward recomputes them."""
    q = args[0]
    if uses_wgmma(q.dtype, q.shape[-1]):
        return ref.attention_residuals_ref(*args, **kwargs)
    return _plain32("flash_attention", args, kwargs).to(q.dtype), None, None


def _fwd_standin(name: str):
    def run(*args, **kwargs):
        if kwargs.pop("residuals", False):
            return _flash_residuals(args, kwargs)
        if name == "ssd_scan":
            return _SSD_PLAIN(*(a.float() for a in args), **kwargs).to(args[0].dtype)
        if name == "rglru_scan":
            return _RGLRU_PLAIN(*args, **kwargs)
        return _plain32(name, args, kwargs).to(args[0].dtype)
    return run


@pytest.fixture
def train_smoke(smoke, monkeypatch):
    """``chip_smoke`` with its train constants cut and its device probes
    stubbed; ``ops.rmsnorm``, ``ops.flash_attention``, ``ops.ssd_scan`` and
    ``ops.rglru_scan`` run through their autograd Functions on the CPU, the
    CUDA wrappers stood in with counting plain versions (``KernelInputs``
    records the backward ones; the SSD backward's stand-in also counts its
    states kernel). Returns the reduced bf16 qwen3 (remat full), the two
    scan families reduced in bf16 (remat full) and a 400-node network."""
    for name, value in TRAIN_CUT.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "sync", lambda: None)
    monkeypatch.setattr(smoke, "device_line", lambda fields="": "cpu (stand-in)")
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "cold_ms", lambda fn, iters, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "device_activity", lambda fn, iters: (fn(), {
        "void (anonymous namespace)::tc::ssd_bwd_tc_states_kernel<8>": [iters, 100.0 * iters],
        "void (anonymous namespace)::tc::ssd_bwd_tc_grads_kernel<8, 2>": [iters, 300.0 * iters],
    })[1])
    monkeypatch.setattr(ssd_scan, "bwd_chunk", _bwd_chunk_standin)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    for name in ("flash_attention", "rmsnorm", "ssd_scan", "rglru_scan"):
        monkeypatch.setattr(ops, f"{name}_cuda", _counting(name, _fwd_standin(name)))
        bwd = _counting(f"{name}_bwd", _bwd_standin(f"{name}_bwd"))
        if name == "ssd_scan":
            bwd = _counting("ssd_scan_bwd_states", bwd)
        monkeypatch.setattr(ops, f"{name}_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, *, causal=True: (
        ops._FlashAttention.apply(q, k, v, q.shape[-1] ** -0.5, causal)))
    monkeypatch.setattr(ops, "rmsnorm", lambda x, w, *, eps, plus_one: (
        ops._RMSNorm.apply(x, w, eps, plus_one)))
    monkeypatch.setattr(ops, "ssd_scan", lambda x, dt, a_log, bmat, cmat, *, chunk=128: (
        ops._SSDScan.apply(x, dt, a_log, bmat, cmat, chunk)))
    monkeypatch.setattr(ops, "rglru_scan", lambda a, b, h0=None: (
        ops._RGLRUScan.apply(a, b, h0)))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import demo_population_network

    cfg = get_config("qwen3-1.7b").reduced(dtype="bfloat16", remat="full")
    scans = {arch: get_config(arch).reduced(dtype="bfloat16", remat="full")
             for arch in smoke.TRAIN_SCAN_ARCHS}
    return smoke, cfg, scans, demo_population_network(400, seed=0, device="cpu")


def test_train_phase_rehearsed_on_the_cpu(train_smoke, capsys):
    smoke, cfg, scans, net = train_smoke
    out = smoke.phase_train(net, torch.device("cpu"), 0, cfg, scans)
    text = capsys.readouterr().out
    steps, L = smoke.TRAIN_STEPS, cfg.n_layers
    # remat recomputes every group's forward in the backward pass: each
    # layer's two norms (qk-norm: four) and its attention run twice a step
    assert out["launches"]["flash_attention"] == 2 * L * steps
    assert out["launches"]["flash_attention_bwd"] == L * steps
    assert out["launches"]["rmsnorm_bwd"] == (4 * L + 1) * steps
    assert len(out["losses"]) == steps and out["losses"][-1] < out["losses"][0]
    assert set(out["worst"]) == {"rmsnorm_bwd", "flash_attention_bwd", "ssd_scan_bwd",
                                 "rglru_scan_bwd"}
    assert "tensors differ" in text and "0 of" in text
    assert "restored params from step 4" in text
    assert "Model.apply's argmax" in text
    for arch, scan_cfg in scans.items():
        run = out["scans"]["runs"][arch]
        n_scans = sum(kind != "attn" for kind in smoke_layer_kinds(scan_cfg))
        key = "ssd_scan" if arch.startswith("mamba") else "rglru_scan"
        assert run["launches"][f"{key}_bwd"] == n_scans * smoke.TRAIN_SCAN_STEPS
        # remat recomputes a group's layers in the backward pass (not the tail's)
        assert (n_scans * smoke.TRAIN_SCAN_STEPS < run["launches"][key]
                <= 2 * n_scans * smoke.TRAIN_SCAN_STEPS)
        assert run["losses"][-1] < run["losses"][0]
        assert f"train: {arch} one step in parts (ms)" in text
    assert "bit-identical to its loop: True" in text
    assert "one step in parts (ms)" in text
    records = smoke.train_timing(out)
    assert ("ssd_bwd_tc_states_kernel 0.1000 ms a call (3 events), ssd_bwd_tc_grads_kernel "
            "0.3000 ms a call (3 events)") in capsys.readouterr().out
    assert [r["name"] for r in records] == ["rmsnorm_bwd", "flash_attention_bwd",
                                            "ssd_scan_bwd", "rglru_scan_bwd"]
    for rec in records[2:]:
        assert rec["library_ms"] is None and rec["launches"] > 0
        assert rec["bound_by"] in ("bytes", "operations") and rec["bound_ms"] > 0
    flash = records[1]
    B, Hq, S, D = smoke.TRAIN_BATCH, cfg.n_heads, smoke.TRAIN_SEQ, cfg.head_dim
    ops_ms = 2.5 * 4 * B * Hq * D * S * (S + 1) / 2 / smoke.BF16_TENSOR_OPS_PER_S * 1e3
    assert flash["bound_ms"] == pytest.approx(max(ops_ms, flash["bound_ms"]))
    assert flash["bound_ms"] >= ops_ms and flash["library_ms"] is not None
    assert records[0]["launches"] == (out["launches"]["rmsnorm_bwd"]
                                      + out["scans"]["launches"]["rmsnorm_bwd"])
    assert {"route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"} <= set(flash)


@pytest.mark.parametrize("key", ["ssd_scan_bwd_fma", "ssd_scan_bwd_copies"])
def test_train_scans_refuse_the_ssd_fma_backward_and_copies(train_smoke, monkeypatch, key):
    """mamba2's bf16 SSD backward must take the tensor-core route and read
    the layer's views as they lie: a stand-in that also counts an FMA-route
    launch or an operand copy fails the family's steps."""
    smoke, _, scans, _ = train_smoke
    monkeypatch.setattr(ops, "ssd_scan_bwd_cuda", _counting(key, ops.ssd_scan_bwd_cuda))
    with pytest.raises(AssertionError, match=key):
        smoke.train_scans(torch.device("cpu"), 0, {"mamba2-130m": scans["mamba2-130m"]})


def smoke_layer_kinds(cfg) -> list:
    return list(cfg.block_pattern) * cfg.n_groups + list(cfg.tail_pattern)


def _bwd_seen(name: str) -> dict:
    """``KernelInputs``' record of one backward launch, seed 2600."""
    rng = np.random.default_rng(2600)  # seed 2600
    if name == "rmsnorm_bwd":
        w = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
        args = [_bf16(rng, (16, 64), 3.0), w, _bf16(rng, (16, 64))]
        kwargs = dict(eps=1e-6, plus_one=True)
    elif name == "ssd_scan_bwd":
        dt = torch.from_numpy(rng.uniform(0.01, 0.5, (1, 2, 45)).astype(np.float32))
        args = [_bf16(rng, (1, 2, 45, 16)), dt, -2.0 * dt, _bf16(rng, (1, 45, 16)),
                _bf16(rng, (1, 45, 16)), _bf16(rng, (1, 2, 45, 16))]
        kwargs = dict(chunk=32)
    elif name == "rglru_scan_bwd":
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 40, 8)).astype(np.float32))
        b, dh = (torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32))
                 for _ in range(2))
        args, kwargs = [a, ref.rglru_scan_ref(a, b), None, dh], {}
    else:
        args = [_bf16(rng, s) for s in ((1, 4, 40, 32), (1, 2, 40, 32), (1, 2, 40, 32),
                                        (1, 4, 40, 32))]
        kwargs = dict(scale=32**-0.5, causal=True)
    shapes = tuple((tuple(a.shape), str(a.dtype)) for a in args if a is not None)
    return {(name, "train", shapes): (args, kwargs)}


@pytest.mark.parametrize("name", ["rmsnorm_bwd", "flash_attention_bwd", "ssd_scan_bwd",
                                  "rglru_scan_bwd"])
@pytest.mark.parametrize("fault", ["none", "zeros", "scaled"])
def test_train_phase_backward_check_rejects_a_faulty_kernel(smoke, monkeypatch, name,
                                                            fault):
    """The train phase's backward check passes a kernel that rounds its
    outputs once and rejects a zeroed or doubled gradient."""
    monkeypatch.setattr(ops, f"{name}_cuda", _bwd_standin(name, fault))
    if fault == "none":
        assert set(smoke.bwd_kernel_checks(_bwd_seen(name))) == {name}
        return
    with pytest.raises(AssertionError, match="backward kernel checks failed"):
        smoke.bwd_kernel_checks(_bwd_seen(name))


def test_train_timing_records_rmsnorm_bwd_at_the_qnorm_width(smoke, monkeypatch):
    """Where the train phase launched ``rmsnorm_bwd`` at the q/k-norm width
    (128) besides a heavier width, the timing keeps a record of each, the
    narrow one right after the other; their launches split the phase's
    count by width (the recorded calls), summing to it."""
    import collections

    for stub in ("cold_ms", "cuda_ms"):
        monkeypatch.setattr(smoke, stub, lambda fn, iters, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "device_line", lambda fields="": "cpu (stand-in)")
    monkeypatch.setattr(smoke, "device_activity", lambda fn, iters: (fn(), {})[1])
    monkeypatch.setattr(ssd_scan, "bwd_chunk", _bwd_chunk_standin)
    seen = {}
    for name in ("rmsnorm_bwd", "flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd"):
        monkeypatch.setattr(ops, f"{name}_cuda", _bwd_standin(name))
        seen.update(_bwd_seen(name))
    rng = np.random.default_rng(2620)  # seed 2620
    narrow = [_bf16(rng, (6, smoke.QNORM_WIDTH), 3.0),
              torch.from_numpy((rng.standard_normal(smoke.QNORM_WIDTH) * 0.1
                                ).astype(np.float32)),
              _bf16(rng, (6, smoke.QNORM_WIDTH))]
    key = ("rmsnorm_bwd", "train", tuple((tuple(a.shape), str(a.dtype)) for a in narrow))
    seen[key] = (narrow, dict(eps=1e-6, plus_one=True))
    calls = collections.Counter({key: 3})
    train = {"seen": seen, "calls": calls, "launches": {"rmsnorm_bwd": 7,
             "flash_attention_bwd": 2}, "worst": {n: 0.0 for n, _, _ in seen},
             "scans": {"seen": {}, "launches": {"rmsnorm_bwd": 4, "ssd_scan_bwd": 1,
                                                "rglru_scan_bwd": 1}}}
    records = smoke.train_timing(train)
    assert [r["name"] for r in records] == ["rmsnorm_bwd", "rmsnorm_bwd",
                                            "flash_attention_bwd", "ssd_scan_bwd",
                                            "rglru_scan_bwd"]
    assert "[16,64]" in records[0]["shape"] and "[6,128]" in records[1]["shape"]
    assert (records[0]["launches"], records[1]["launches"]) == (11 - 3, 3)


@pytest.mark.parametrize("fault", ["none", "zeros"])
def test_train_phase_backward_check_takes_the_forward_residuals(smoke, monkeypatch,
                                                                fault):
    """On the tensor-core route the flash backward's recorded call carries
    the forward's o, o_lo and lse after q, k, v and dO: the check holds dq,
    dk and dv against f32 autograd of the first four, passes the route's
    algorithm (``ref.attention_bwd_blocked``) and rejects a zeroed dq."""
    rng = np.random.default_rng(2610)  # seed 2610
    q, do = (_bf16(rng, (1, 4, 40, 64)) for _ in range(2))
    k, v = (_bf16(rng, (1, 2, 40, 64)) for _ in range(2))
    kwargs = dict(scale=64**-0.5, causal=True)
    args = [q, k, v, do, *ref.attention_residuals_ref(q, k, v, **kwargs)]
    shapes = tuple((tuple(a.shape), str(a.dtype)) for a in args)

    def kernel(*a, **kw):
        outs = list(ref.attention_bwd_blocked(*a, **kw))
        if fault == "zeros":
            outs[0] = torch.zeros_like(outs[0])
        return tuple(outs)

    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", kernel)
    seen = {("flash_attention_bwd", "train", shapes): (args, kwargs)}
    if fault == "none":
        assert set(smoke.bwd_kernel_checks(seen)) == {"flash_attention_bwd"}
        return
    with pytest.raises(AssertionError, match="backward kernel checks failed"):
        smoke.bwd_kernel_checks(seen)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_train_scans_rehearsed_on_the_cpu(train_smoke, capsys, arch):
    """``train_scans`` at ``reduced()`` size: the loss falls, the scans'
    forward and backward stand-ins launch and their plain versions, the
    CPU path of ``ops``, are never called."""
    smoke, _, scans, _ = train_smoke
    out = smoke.train_scans(torch.device("cpu"), 0, {arch: scans[arch]})
    text = capsys.readouterr().out
    run = out["runs"][arch]
    assert run["losses"][-1] < run["losses"][0]
    assert '"ssd_scan_heads_ref": 0' in text and '"rglru_scan_ref": 0' in text
    assert [k[0] for k in out["seen"]] == (
        ["ssd_scan_bwd"] if arch.startswith("mamba") else ["rglru_scan_bwd"])
    assert "budget 35 s" in text


def test_train_scans_refuse_the_plain_scan_on_the_card(train_smoke, monkeypatch):
    """A scan that takes its plain version where the card's kernel should
    run (the CPU path's call) fails the part."""
    smoke, _, scans, _ = train_smoke
    monkeypatch.setattr(ops, "rglru_scan", lambda a, b, h0=None: ref.rglru_scan_ref(a, b, h0))
    with pytest.raises(AssertionError, match="plain version ran on the card"):
        smoke.train_scans(torch.device("cpu"), 0,
                          {"recurrentgemma-9b": scans["recurrentgemma-9b"]})


@pytest.mark.parametrize("losses", [[3.0, 2.5, float("nan")], [3.0, 3.1, 3.2],
                                    [3.0, 2.0, 3.0]])
def test_check_losses_refuses_a_non_finite_or_rising_loss(smoke, losses):
    with pytest.raises(AssertionError, match="non-finite|did not fall"):
        smoke.check_losses("x", losses)
    smoke.check_losses("x", [3.0, 3.5, 2.9])


def test_check_phase_time_refuses_a_phase_past_its_limit(smoke):
    smoke.check_phase_time("train", smoke.TRAIN_PHASE_LIMIT_S, smoke.TRAIN_PHASE_LIMIT_S)
    with pytest.raises(AssertionError, match="over its 150 s"):
        smoke.check_phase_time("train", 150.1, smoke.TRAIN_PHASE_LIMIT_S)


@pytest.mark.parametrize("name", ["rmsnorm_bwd", "flash_attention_bwd", "ssd_scan_bwd",
                                  "rglru_scan_bwd"])
def test_check_readings_refuses_a_backward_time_under_its_bound(smoke, name):
    rec = {"name": name, "ms": 0.5, "library_ms": 0.9, "bound_ms": 0.6}
    with pytest.raises(AssertionError, match="under its bound"):
        smoke.check_readings(rec)
    smoke.check_readings({**rec, "ms": 0.6})


def test_integer_rate_counts_four_warp_instructions_a_clock_an_sm(smoke):
    """The draw kernels' operations bound: 132 SMs x 4 warp instructions of
    32 lanes a clock at the H100's maximum SM clock, 1,980 MHz, which is
    half the float32 table entry (that counts a fused multiply-add as two
    flops); a hash counted as the 68 instructions it compiles to at
    least where the counter's high word is 0 (below 2^32 elements), 69
    above."""
    rate = smoke.int_ops_per_s(132, 1980.0)
    assert rate == pytest.approx(132 * 4 * 32 * 1980e6, rel=1e-12)
    assert rate == pytest.approx(smoke.SCALAR_OPS_PER_S / 2, rel=2e-3)
    assert smoke.HASH_OPS == 68 and smoke.RANDINT_OPS == 2 * 68 + 9
    assert smoke.bits_ops(2**32 + 5) == (2**32 + 5) * 68 + 5
    # threefry_bits at the sampling phase's 1,638,400 elements: bound by
    # its instructions (0.0033 ms), not its 4 bytes an element (0.0020)
    ops_ms = smoke.bits_ops(1_638_400) / rate * 1e3
    assert ops_ms == pytest.approx(0.0033302, rel=1e-3)
    assert ops_ms > 4 * 1_638_400 / smoke.HBM_BYTES_PER_S * 1e3


def _row_sample_sampling(smoke, counts):
    """A sampling record as the phase returns it: launch counts by shape
    and the first launch's inputs of each, on a 64-row CSR (seed 2711)."""
    import collections

    rng = np.random.default_rng(2711)  # seed 2711
    lengths = rng.integers(0, 9, 64)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 1000, int(indptr[-1])).astype(np.int32))
    shapes, first = collections.Counter(), {}
    for n, count in counts.items():
        rows = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32))
        shape = (n, "torch.int32", "torch.int32", False)
        shapes[("csr_row_sample",) + shape] = count
        first[("csr_row_sample", shape)] = ((indptr, ids, rows, (1, 2), (3, 4)), {})
    shapes[("threefry_bits", 4096)] = 10**6  # another kernel's shape: not timed
    return {"shapes": shapes, "first": first}


def test_row_sample_shapes_times_the_most_frequent(smoke, monkeypatch):
    """The three most frequent shapes are timed, each cold and on the card
    alone, and the sum of launches x (time - bound) is returned."""
    timed = []

    def cold_ms(fn, iters, host_ahead=False):
        out = fn()
        timed.append((out[0].numel(), host_ahead))
        return 0.05 if host_ahead else 0.08

    monkeypatch.setattr(smoke, "cold_ms", cold_ms)
    monkeypatch.setattr(smoke, "draw_kernel",
                        lambda name, args, kwargs: smoke.draw_plain(name, args, kwargs))
    counts = {5: 40, 17: 7, 300: 300, 1000: 2}
    rate = smoke.int_ops_per_s(132, 1980.0)
    loss = smoke.row_sample_shapes(_row_sample_sampling(smoke, counts), rate)
    assert sorted(timed) == sorted((n, ahead) for n in (300, 5, 17)
                                   for ahead in (False, True))
    # each bound is the larger of the bytes (at most 21 a row) and the
    # draws' instructions, both under 1e-6 ms at these sizes
    assert loss == pytest.approx(sum(counts[n] * 0.05 for n in (300, 5, 17)), rel=1e-4)
    assert loss < sum(counts[n] * 0.05 for n in (300, 5, 17))


def test_row_sample_shapes_refuses_a_time_under_its_bound(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "cold_ms", lambda fn, iters, host_ahead=False: 1e-9)
    monkeypatch.setattr(smoke, "draw_kernel",
                        lambda name, args, kwargs: smoke.draw_plain(name, args, kwargs))
    with pytest.raises(AssertionError, match="under its bound"):
        smoke.row_sample_shapes(_row_sample_sampling(smoke, {300: 3}),
                                smoke.int_ops_per_s(132, 1980.0))
