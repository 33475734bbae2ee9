"""CPU models of the plans of two CUDA kernels, held against their plain
versions: the row-sample kernel of ``csrc/threefry.cu`` (its grid-stride
index plan and its draw's uint32 arithmetic) and the RG-LRU backward of
``csrc/rglru_scan.cu`` (its ring of shared-memory stages walked
downward). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); these tests model in numpy and torch what
each thread of them computes, with the constants read from the sources,
so a change of plan that drops, repeats or misorders an element shows
here. Also: the threefry wrappers bind each launcher's argument types
once. Inputs come from ``np.random.default_rng`` with the seed named in
each test.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.csr import CSR, csr_from_arrays, widen_ids
from repro_torch.core.overlay import DeltaOverlay
from repro_torch.kernels import ref, threefry

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
M32 = (1 << 32) - 1


def _constants(source: str, *names: str) -> tuple:
    text = (CSRC / source).read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
                 for n in names)


# ---------------------------------------------------------------------------
# csr_row_sample_kernel's index plan and draw (threefry.cu)
# ---------------------------------------------------------------------------


SMS = 132  # an H100 SXM's SMs


def _grid_plan(source: str = "threefry.cu") -> tuple:
    """(the widest block, the narrowest, most blocks a launch on SMS SMs)
    of the draw kernels' grid, ``draw_grid``."""
    text = (CSRC / source).read_text()
    narrowest = int(re.search(r"while \(threads > (\d+) &&", text)[1])
    widest, per_sm = _constants(source, "kDrawThreads", "kMaxBlocksPerSm")
    return widest, narrowest, SMS * per_sm


THREADS, MIN_THREADS, MAX_BLOCKS = _grid_plan()


def _plan(n: int, max_blocks: int = MAX_BLOCKS) -> np.ndarray:
    """The element indices the kernel's threads take, in launch order:
    ``draw_grid(n, false)``, one row a thread in blocks of THREADS halved
    (to MIN_THREADS at least) while the grid would leave one of SMS SMs
    without a block, at most ``max_blocks`` of them, each thread striding
    by the grid from its global index."""
    threads = THREADS
    while threads > MIN_THREADS and -(-n // threads) < SMS:
        threads //= 2
    blocks = min(-(-n // threads), max_blocks)
    first = np.arange(blocks * threads)
    steps = [first + k * blocks * threads for k in range(-(-n // (blocks * threads)))]
    taken = np.concatenate(steps) if steps else np.zeros(0, np.int64)
    return taken[taken < n]


def _draw(hb, lb, span):
    """threefry.cu's ``offset`` from the two words of bits, in uint64 numpy
    with the kernel's uint32 wrap: mult = (2^16 mod span)^2 mod span (the
    square wraps to 0 past 2^16), ((hb mod span) mult + lb mod span) mod
    span."""
    w = np.uint64(M32)
    mult = np.uint64(65536) % span
    mult = ((mult * mult) & w) % span
    low = (hb % span) * mult & w
    return ((low + lb % span) & w) % span


def test_draw_equals_randint_ref():
    """The kernels' offset from the two words of bits equals
    ``ref.randint_ref``'s reduction at spans 1 .. 2^32 - 1."""
    rng = np.random.default_rng(2703)  # seed 2703
    n = 4096
    k1, k2 = prng.split(prng.key(2703))
    spans = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    spans[:8] = [1, 2, 3, 65535, 65536, 65537, 1 << 31, M32]
    cpu = torch.device("cpu")
    hb = ref.threefry_bits_ref(k1, n, cpu).numpy().view(np.uint32).astype(np.uint64)
    lb = ref.threefry_bits_ref(k2, n, cpu).numpy().view(np.uint32).astype(np.uint64)
    # randint over [lo, lo + span): lo = 0 for spans below 2^31, else
    # -2^31 so that hi = lo + span is still an int32
    lo = np.where(spans >= 1 << 31, -(1 << 31), 0).astype(np.int64)
    hi = ((lo + spans.astype(np.int64)) & M32).astype(np.uint32).view(np.int32)
    got = ref.randint_ref(k1, k2, torch.from_numpy(lo.astype(np.int32)),
                          torch.from_numpy(hi.copy()), n, cpu).numpy()
    want = ((lo + _draw(hb, lb, spans).astype(np.int64)) & M32).astype(np.uint32)
    np.testing.assert_array_equal(got.view(np.uint32), want)


def _csr(lengths, top: int, ids_dtype, indptr_dtype, rng) -> CSR:
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(indptr_dtype)
    ids = rng.integers(0, top, int(indptr[-1])).astype(ids_dtype)
    return csr_from_arrays(indptr, ids, None, len(lengths), top, torch.device("cpu"))


def _model_sample(base: CSR, ov, rows: np.ndarray, k1, k2, plan: np.ndarray):
    """Each planned element as the kernel computes it: the dirty byte at
    the clipped row, the indptr pair at the clipped positions, the hashes
    of the element's index, the offset by ``_draw``, the stored id."""
    n = rows.size
    cpu = torch.device("cpu")
    hb = ref.threefry_bits_ref(k1, n, cpu).numpy().view(np.uint32).astype(np.uint64)
    lb = ref.threefry_bits_ref(k2, n, cpu).numpy().view(np.uint32).astype(np.uint64)
    csrs = [(c.indptr.numpy().astype(np.int64), widen_ids(c.indices).numpy(), c.n_rows)
            for c in ([base] if ov is None else [base, ov.delta])]
    dirty = None if ov is None else ov.dirty.numpy()
    out = np.full(n, -7, np.int64)
    ok = np.zeros(n, bool)
    for i in plan:
        r = int(rows[i])
        d = dirty is not None and dirty[min(max(r, 0), dirty.size - 1)]
        indptr, ids, n_rows = csrs[int(d)]
        a, b = min(max(r, 0), n_rows), min(max(r + 1, 0), n_rows)
        length = indptr[b] - indptr[a]
        ok[i] = length > 0
        out[i] = r
        if length > 0:
            off = int(_draw(hb[i], lb[i], np.uint64(length & M32)))
            out[i] = ids[indptr[a] + off]
    return out.astype(np.int32), ok


def _row_layer(seed: int, ids_dtype, indptr_dtype, overlay: bool):
    """40 rows of 0-12 ids, one of 65,536 and one of 70,000 (the multiplier
    is 0 past 2^16); with an overlay 12 rows dirty and 3 past the base,
    int32 ids over the other indptr dtype."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 13, 40)
    lengths[[7, 31]] = [65536, 70000]
    top = 60_000 if ids_dtype == np.uint16 else 1 << 20
    base = _csr(lengths, top, ids_dtype, indptr_dtype, rng)
    if not overlay:
        return base, None
    dirty = np.zeros(43, bool)
    dirty[rng.choice(40, 12, replace=False)] = True
    dirty[40:] = True
    dlen = np.where(dirty, rng.choice([0, 1, 5, 300], 43), 0)
    delta = _csr(dlen, 1 << 20, np.int32,
                 np.int64 if indptr_dtype == np.int32 else np.int32, rng)
    return base, DeltaOverlay(delta=delta, dirty=torch.from_numpy(dirty),
                              base_shadowed=0, dirty_host=dirty)


@pytest.mark.parametrize("n", [1, THREADS - 1, THREADS, THREADS + 1, 3 * THREADS + 17])
@pytest.mark.parametrize("max_blocks", [1, 2, MAX_BLOCKS])
def test_row_sample_plan_takes_every_element_once(n, max_blocks):
    plan = _plan(n, max_blocks)
    assert np.array_equal(np.sort(plan), np.arange(n))


@pytest.mark.parametrize("n,max_blocks", [(1, MAX_BLOCKS), (THREADS - 1, MAX_BLOCKS),
                                          (THREADS + 1, MAX_BLOCKS), (3 * THREADS + 17, 2)])
@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("widths", [(np.uint16, np.int32), (np.int32, np.int64)])
def test_row_sample_plan_equals_plain_version(n, max_blocks, overlay, widths):
    """The model of every thread's rows, rows -3 .. 45 (past both ends of
    the base and the dirty mask), equals ``ref.csr_row_sample_ref``."""
    base, ov = _row_layer(2704, *widths, overlay)
    rng = np.random.default_rng(2705 + n)  # seed 2705+n
    rows = rng.integers(-3, 46, n).astype(np.int32)
    rows[: min(n, 2)] = [7, 31][: min(n, 2)]  # the long rows
    k1, k2 = prng.split(prng.key(2706))
    got, ok = _model_sample(base, ov, rows, k1, k2, _plan(n, max_blocks))
    want, wok = ref.csr_row_sample_ref(base, ov, torch.from_numpy(rows), k1, k2)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(ok, wok.numpy())


# ---------------------------------------------------------------------------
# rglru_scan_bwd_kernel's ring (rglru_scan.cu)
# ---------------------------------------------------------------------------

CHANNELS, STEPS, STAGES = _constants("rglru_scan.cu", "kBwdChannels", "kBwdSteps",
                                     "kBwdStages")


def _ring_bwd(a, h, h0, dh, channels=CHANNELS, steps=STEPS, stages=STAGES, vec=None):
    """The backward kernel's blocks, one a (batch row, ``channels``
    channels), in torch f32: the ring of ``stages`` slots filled by
    copies of ``vec`` floats (4 where dr % 4 == 0, else 1; a copy lands
    whole or not at all) at the kernel's stage ranges, stage k + stages - 1
    copied before stage k is read, the slots NaN until copied, so a read
    of a slot no copy filled shows in the result."""
    B, S, dr = a.shape
    vec = vec or (4 if dr % 4 == 0 else 1)
    da, db = torch.full_like(a, float("nan")), torch.full_like(a, float("nan"))
    dh0 = None if h0 is None else torch.full_like(h0, float("nan"))
    n_stages = -(-S // steps)
    srcs = (a, dh, h)
    for row in range(B):
        for c0 in range(0, dr, channels):
            ring = torch.full((stages, 3, steps, channels), float("nan"))

            def copy(k):
                if k >= n_stages:
                    return
                t0 = S - (k + 1) * steps
                for tensor in range(3):
                    for j in range(steps):
                        t = t0 + j - (1 if tensor == 2 else 0)
                        if t < 0:
                            continue
                        for cc in range(0, channels, vec):
                            if c0 + cc < dr:
                                ring[k % stages, tensor, j, cc:cc + vec] = \
                                    srcs[tensor][row, t, c0 + cc:c0 + cc + vec]

            live = min(channels, dr - c0)
            start = torch.zeros(live) if h0 is None else h0[row, c0:c0 + live]
            g, a_next = torch.zeros(live), torch.zeros(live)
            for k in range(stages - 1):
                copy(k)
            for k in range(n_stages):
                copy(k + stages - 1)
                slot = ring[k % stages, :, :, :live]
                t0 = S - (k + 1) * steps
                for j in range(steps - 1, -1, -1):
                    t = t0 + j
                    if t < 0:
                        break
                    g = slot[1, j] + a_next * g
                    db[row, t, c0:c0 + live] = g
                    da[row, t, c0:c0 + live] = g * (slot[2, j] if t > 0 else start)
                    a_next = slot[0, j].clone()  # a register, not the slot
            if dh0 is not None:
                dh0[row, c0:c0 + live] = a_next * g
    return da, db, dh0


def _scan_operands(seed, B, S, dr, with_h0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, dr)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, S, dr)).astype(np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((B, dr)).astype(np.float32))
          if with_h0 else None)
    dh = torch.from_numpy(rng.standard_normal((B, S, dr)).astype(np.float32))
    return a, ref.rglru_scan_ref(a, b, h0), h0, dh


@pytest.mark.parametrize("B,S,dr", [
    (1, 1, 1),                    # one step, one channel
    (2, STEPS - 7, 6),            # S under one stage, dr % 4 != 0: 4-byte copies
    (1, 2 * STEPS, 8),            # S a multiple of the stage
    (2, 3 * STEPS + 5, 12),       # a ragged last stage
    (1, STEPS + 3, CHANNELS + 4),  # dr past one block, not a multiple of it
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_ring_equals_its_loop(B, S, dr, with_h0):
    """The ring's step order is ``rglru_scan_bwd_loop``'s bit for bit."""
    a, h, h0, dh = _scan_operands(2707 + S + dr, B, S, dr, with_h0)  # seed 2707+S+dr
    got = _ring_bwd(a, h, h0, dh)
    want = ref.rglru_scan_bwd_loop(a, h, h0, dh)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("steps,stages", [(4, 2), (4, 3), (5, 4)])
def test_rglru_ring_of_other_depths_equals_its_loop(steps, stages):
    """Short stages walk many slots: 23 steps over 2-, 3- and 4-slot rings,
    8 channels a block over 10 (two blocks, the second cut short)."""
    a, h, h0, dh = _scan_operands(2708, 2, 23, 10, True)  # seed 2708
    got = _ring_bwd(a, h, h0, dh, channels=8, steps=steps, stages=stages, vec=1)
    for g, w in zip(got, ref.rglru_scan_bwd_loop(a, h, h0, dh)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The threefry wrappers' launchers
# ---------------------------------------------------------------------------


class _Library:
    """Stands the built library in: counts lookups and argtypes bindings."""

    def __init__(self):
        self.lookups = []
        self.bindings = []

    def __getattr__(self, name):
        self.lookups.append(name)
        lib = self

        class Launcher:
            def __setattr__(self, key, value):
                if key == "argtypes":
                    lib.bindings.append(name)
                object.__setattr__(self, key, value)

        return Launcher()


@pytest.mark.parametrize("name", sorted(threefry.ARGTYPES))
def test_threefry_launcher_binds_its_argtypes_once(monkeypatch, name):
    lib = _Library()
    monkeypatch.setattr(threefry, "library", lambda source: lib)
    monkeypatch.setattr(threefry, "_launchers", {})
    first = threefry._fn(name)
    assert all(threefry._fn(name) is first for _ in range(3))
    assert lib.lookups == [name] and lib.bindings == [name]
    assert first.argtypes == threefry.ARGTYPES[name] and first.restype is ctypes.c_int
