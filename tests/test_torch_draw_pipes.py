"""CPU models of the thread plans of the threefry draw kernels in
``csrc/threefry.cu`` (``threefry_bits_kernel``, ``randint_kernel``), held
against ``jax.random`` (the JAX package's generator, on the CPU) and the
port's plain versions (``kernels/ref.py``).

The kernels run only on the card (``tests/test_torch_cuda.py``). These
tests model in numpy uint32 what each thread of them computes, with the
constants read from the source: the hash restructured for the FMA pipe
(the first key add per element of a group, the counter's high word 0
below 2^32 elements), the scalar-bound reduction
from the span, multiplier and reciprocal the host computes once (one hash
where the multiplier is 0, span 1 among them; a remainder by a high
product and one conditional subtraction, never a division), the per-element
reduction's one reciprocal a draw, and the grid: ``kPerThread`` elements
a thread in one 16-byte store and a scalar tail where the launch gives
every SM a whole block of such threads (else one element a thread),
blocks narrowed for small counts, a block for every group of threads up
to a cap an SM, past which they stride. Tolerance: none
(bit-identical). Keys and bounds are named in each test; the sweep of
spans and words is hypothesis's.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import ref

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "threefry.cu").read_text()
CPU = torch.device("cpu")
M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


PER_THREAD = _constant("kPerThread")
DRAW_THREADS = _constant("kDrawThreads")
MAX_BLOCKS_PER_SM = _constant("kMaxBlocksPerSm")
MIN_THREADS = int(re.search(r"while \(threads > (\d+) &&", SOURCE)[1])
NARROW = 1 << int(re.search(r"kNarrow = int64_t\{1\} << (\d+);", SOURCE)[1])
# ``rotation``: (i & 1) ? the odd blocks' rotations : the even blocks'
ROT_ODD, ROT_EVEN = (
    tuple(int(r) for r in m) for m in re.findall(
        r"r == 0 \? (\d+) : r == 1 \? (\d+) : r == 2 \? (\d+) : (\d+)\)", SOURCE))
SMS = 132  # an H100 SXM's SMs


def test_constants_read_from_the_source():
    assert PER_THREAD == 4 and DRAW_THREADS % MIN_THREADS == 0
    assert NARROW == 1 << 31
    assert (ROT_EVEN, ROT_ODD) == ((13, 15, 26, 6), (17, 29, 16, 24))


# ---------------------------------------------------------------------------
# the grid: groups of elements, narrowed blocks, a block for every group
# ---------------------------------------------------------------------------


def _grid(n: int, sms: int = SMS, max_blocks_per_sm: int = MAX_BLOCKS_PER_SM) -> tuple:
    """``draw_grid``: (blocks, threads, elements a thread) of a launch over
    n elements."""
    per = PER_THREAD if n >= PER_THREAD * DRAW_THREADS * sms else 1
    groups = -(-n // per)
    threads = DRAW_THREADS
    while threads > MIN_THREADS and -(-groups // threads) < sms:
        threads //= 2
    return min(-(-groups // threads), sms * max_blocks_per_sm), threads, per


def _group_starts(n: int, blocks: int, threads: int, per: int) -> np.ndarray:
    """The first element of every group the grid's threads take, thread by
    thread in launch order, each striding by the grid."""
    width = blocks * threads * per
    first = np.arange(blocks * threads, dtype=np.int64) * per
    starts = np.concatenate([first + k * width for k in range(-(-n // width))])
    return starts[starts < n]


def _stores(n: int, starts: np.ndarray, per: int) -> np.ndarray:
    """How often ``store_group`` writes each element: a 16-byte store where
    a group of 4 lies below n, else the elements below n one by one."""
    written = np.zeros(n + per, np.int64)
    for j in range(per):
        np.add.at(written, starts + j, (starts + j < n).astype(np.int64))
    return written[:n]


@pytest.mark.parametrize("max_blocks_per_sm", [MAX_BLOCKS_PER_SM, 1])
@pytest.mark.parametrize("n", [1, 3, 5, 255, 65_536, 4 * DRAW_THREADS * SMS - 1,
                               4 * DRAW_THREADS * SMS + 1, 1_638_400, 1_638_403])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_thread_plan_writes_every_element_once(n, max_blocks_per_sm, sms):
    """Every element once, with the source's cap on blocks an SM and with a
    cap of 1 (the threads stride)."""
    blocks, threads, per = _grid(n, sms, max_blocks_per_sm)
    assert MIN_THREADS <= threads <= DRAW_THREADS
    assert 1 <= blocks <= sms * max_blocks_per_sm
    # four a thread only where every SM gets a whole block of such threads
    assert per == (PER_THREAD if n >= PER_THREAD * DRAW_THREADS * sms else 1)
    # blocks are narrowed only while they leave an SM without one
    assert threads == MIN_THREADS or blocks >= sms or threads == DRAW_THREADS
    starts = _group_starts(n, blocks, threads, per)
    assert np.all(starts % per == 0)
    assert np.array_equal(_stores(n, starts, per), np.ones(n, np.int64))


# ---------------------------------------------------------------------------
# the hash as a thread of the draw kernels computes it
# ---------------------------------------------------------------------------


def _u32(x) -> np.uint32:
    return np.uint32(int(x) & M32)


def _thread_bits(key, starts: np.ndarray, per: int) -> list:
    """The bits a thread computes for its group starting at each of
    ``starts`` (32-bit indices): x0 = ks0 (the high word is 0), x1 = lo +
    (ks1 + j) for element j of the group, then the rounds and injections,
    every add wrapping mod 2^32 -> one uint32 array for each j."""
    k0, k1 = (int(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    lo = (starts & M32).astype(np.uint32)
    out = []
    for j in range(per):
        x0 = np.full(lo.shape, ks[0], np.uint32)
        x1 = lo + _u32(ks[1] + j)
        for i in range(5):
            for r in ROT_ODD if i & 1 else ROT_EVEN:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + _u32(ks[(i + 1) % 3])
            x1 = x1 + _u32(ks[(i + 2) % 3] + i + 1)
        out.append(x0 ^ x1)
    return out


def _model_bits(key, n: int) -> np.ndarray:
    """threefry_bits_kernel's output: each thread's groups, stored as
    ``store_group`` stores them."""
    out = np.zeros(n, np.uint32)
    if n == 0:
        return out
    blocks, threads, per = _grid(n)
    starts = _group_starts(n, blocks, threads, per)
    for j, v in enumerate(_thread_bits(key, starts, per)):
        keep = starts + j < n
        out[starts[keep] + j] = v[keep]
    return out


KEYS = [(0, 0), (0, 7), (3625411723, 1954958720), (M32, M32)]


@pytest.mark.parametrize("n", [0, 1, 3, 4 * 1001 + 1, (1 << 20) + 3])
@pytest.mark.parametrize("key", KEYS)
def test_restructured_hash_equals_jax_bits(key, n):
    got = _model_bits(key, n)
    want = np.asarray(jax.random.bits(jnp.asarray(key, dtype=jnp.uint32), (n,)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref.threefry_bits_ref(key, n, CPU).numpy())


# ---------------------------------------------------------------------------
# the randint reductions
# ---------------------------------------------------------------------------


def _mod_by(x, d, recip):
    """``mod_by``: x - umulhi(x, recip) * d, then min(r, r - d) in uint32."""
    x, d, recip = (np.atleast_1d(np.asarray(v, np.uint64)) for v in (x, d, recip))
    r = (x - ((x * recip) >> np.uint64(32)) * d) & np.uint64(M32)
    return np.minimum(r, (r - d) & np.uint64(M32))


def _span_plan(lo: int, hi: int) -> tuple:
    """``randint_launch``'s plan on the host: (span, multiplier,
    reciprocal, hashes a draw)."""
    span = 1 if hi <= lo else (hi - lo) & M32
    mult = ((65536 % span) ** 2 & M32) % span
    return span, mult, M32 // span, 1 if mult == 0 else 2


def _hashes_needed(lo: int, hi: int) -> int:
    """The hashes a draw needs at least: the plan's, but none at span 1,
    where every draw is lo (the count the smoke's bound takes)."""
    span, _, _, hashes = _span_plan(lo, hi)
    return 0 if span == 1 else hashes


def _model_randint_scalar(key, lo: int, hi: int, n: int) -> np.ndarray:
    """randint_kernel with scalar bounds: only the hashes the plan draws,
    the remainders by ``_mod_by``, lo + offset."""
    k1, k2 = prng.split(key)
    span, mult, recip, hashes = _span_plan(lo, hi)
    off = _mod_by(_model_bits(k2, n).astype(np.uint64), span, recip)
    if hashes == 2:
        hb = _model_bits(k1, n).astype(np.uint64)
        low = (_mod_by(hb, span, recip) * np.uint64(mult)) & np.uint64(M32)
        off = _mod_by((low + off) & np.uint64(M32), span, recip)
    return ((np.uint64(lo & M32) + off) & np.uint64(M32)).astype(np.uint32).view(np.int32)


SPANS = {
    "1": (0, 1), "2": (0, 2), "3": (0, 3), "7": (0, 7), "2^16-1": (0, 65535),
    "2^16": (0, 65536), "2^16+1": (0, 65537), "10^7": (0, 10_000_000),
    "2^31-1": (0, 2**31 - 1), "full-int32": (-(2**31), 2**31 - 1),
    "negative": (-50, 50), "hi<lo": (9, 2), "hi=lo": (5, 5),
}


@pytest.mark.parametrize("case", sorted(SPANS))
def test_scalar_span_reduction_equals_jax_randint(case):
    lo, hi = SPANS[case]
    key, n = prng.key(2801), 4 * 513 + 1
    got = _model_randint_scalar(key, lo, hi, n)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(2801), (n,), lo, hi))
    np.testing.assert_array_equal(got, want)
    k1, k2 = prng.split(key)
    np.testing.assert_array_equal(got, ref.randint_ref(k1, k2, lo, hi, n, CPU).numpy())


def test_scalar_plan_draws_the_hashes_the_offset_needs():
    """One hash where the multiplier is 0 (past 2^16, a span that divides
    2^16, span 1), two otherwise; at span 1 the draw needs none."""
    assert _span_plan(0, 10_000_000)[3] == 1 and _span_plan(0, 1 << 12)[3] == 1
    assert _span_plan(9, 2)[3] == 1 and _span_plan(0, 1)[3] == 1
    assert _hashes_needed(9, 2) == 0 and _hashes_needed(0, 1) == 0
    assert _span_plan(0, 7)[3] == 2 and _span_plan(0, 65535)[3] == 2


def test_per_element_reduction_equals_plain_version():
    """randint_kernel with per-element bounds: one reciprocal a draw, the
    multiplier and the three remainders all by ``_mod_by``."""
    rng = np.random.default_rng(2802)  # seed 2802
    n = 4 * 700 + 3
    lo = rng.integers(-5, 5, n).astype(np.int64)
    hi = rng.integers(-2, 70_000, n).astype(np.int64)
    hi[:6] = [lo[0] + 1, lo[1] + 65536, lo[2] + 65537, lo[3], lo[4] - 1, 2**31 - 1]
    k1, k2 = prng.split(prng.key(2803))
    hb = ref.threefry_bits_ref(k1, n, CPU).numpy().view(np.uint32).astype(np.uint64)
    lb = ref.threefry_bits_ref(k2, n, CPU).numpy().view(np.uint32).astype(np.uint64)
    span = np.where(hi <= lo, 1, (hi - lo) & M32).astype(np.uint64)
    recip = np.uint64(M32) // span
    mult = _mod_by(np.full(n, 65536, np.uint64), span, recip)
    mult = _mod_by((mult * mult) & np.uint64(M32), span, recip)
    low = (_mod_by(hb, span, recip) * mult) & np.uint64(M32)
    off = _mod_by((low + _mod_by(lb, span, recip)) & np.uint64(M32), span, recip)
    got = ((lo.astype(np.uint64) + off) & np.uint64(M32)).astype(np.uint32).view(np.int32)
    want = ref.randint_ref(k1, k2, torch.from_numpy(lo.astype(np.int32)),
                           torch.from_numpy(hi.astype(np.int32)), n, CPU).numpy()
    np.testing.assert_array_equal(got, want)


@settings(max_examples=400, deadline=None)
@given(st.integers(1, M32), st.integers(0, M32))
def test_mod_by_equals_remainder(d, x):
    recip = M32 // d
    # x, and the words next to a multiple of d, where the estimate is q - 1
    ys = np.array(sorted({x, x - x % d, (x - x % d + M32) & M32,
                          min(x - x % d + d - 1, M32)}), np.uint64)
    np.testing.assert_array_equal(_mod_by(ys, d, recip), ys % np.uint64(d))


# ---------------------------------------------------------------------------
# chip_smoke's count of the work a draw needs (its bound)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", sorted(SPANS))
def test_randint_ops_count_the_hashes_a_scalar_draw_needs(smoke, case):
    lo, hi = SPANS[case]
    n = 1001
    hashes = _hashes_needed(lo, hi)
    args = (None, None, lo, hi, n, CPU)
    want = {0: 0, 1: smoke.RANDINT_ONE_HASH_OPS, 2: smoke.RANDINT_OPS}[hashes]
    assert smoke.randint_ops(args) == n * want
    assert smoke.randint_hashes(args) == n * hashes
    # past 2^32 draws each hash of a draw also adds its high word
    wide = 2**32 + 3
    assert smoke.randint_ops((None, None, lo, hi, wide, CPU)) == wide * want + 3 * hashes


def test_randint_ops_count_per_element_bounds_draw_by_draw(smoke):
    rng = np.random.default_rng(2804)  # seed 2804
    lo = rng.integers(-5, 5, 500).astype(np.int32)
    hi = rng.integers(-2, 70_000, 500).astype(np.int32)
    hi[:3] = [lo[0] + 1, lo[1] + 1024, lo[2] + 7]  # none, one (1024 | 2^16), two
    hashes = np.array([_hashes_needed(int(a), int(b)) for a, b in zip(lo, hi)])
    assert list(hashes[:3]) == [0, 1, 2]
    args = (None, None, torch.from_numpy(lo), torch.from_numpy(hi), 500, CPU)
    assert smoke.randint_hashes(args) == int(hashes.sum())
    assert smoke.randint_ops(args) == int((hashes == 1).sum()) * smoke.RANDINT_ONE_HASH_OPS \
        + int((hashes == 2).sum()) * smoke.RANDINT_OPS


def test_row_sample_ops_draw_one_randint_a_row(smoke):
    """A row of length L draws over [0, max(L, 1)): empty and one-id rows
    need no hash, a row of 2^16 or 2^17 ids one, a row of 5 two."""
    indptr = torch.tensor([0, 0, 1, 1 + 65536, 1 + 65536 + 5, 1 + 65536 + 5 + 131072],
                          dtype=torch.int64)
    ids = torch.zeros(int(indptr[-1]), dtype=torch.int32)
    rows = torch.tensor([0, 1, 2, 3, 4, 9, -1], dtype=torch.int32)
    k1, k2 = prng.split(prng.key(2805))
    got = smoke.row_sample_ops((indptr, ids, rows, k1, k2), {})
    assert got == 2 * smoke.RANDINT_ONE_HASH_OPS + smoke.RANDINT_OPS


def test_draw_timing_rehearsed_on_the_cpu(smoke, monkeypatch):
    """``draw_timing`` end to end with the plain versions standing in for
    the kernels and the card's probes stubbed: one record a threefry
    kernel, the randint bound counted from its spans (one hash a draw at
    the mean-degree estimator's (0, 10M)), and the yardsticks and the
    ALU-pipe floor printed beside each."""
    import collections

    lines = []
    rate = smoke.int_ops_per_s(132, 1980.0)
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setattr(smoke, "card_int_ops_per_s", lambda: rate)
    monkeypatch.setattr(smoke, "device_line", lambda fields="": "stub card")
    monkeypatch.setattr(smoke, "draw_kernel", smoke.draw_plain)

    def device_activity(fn, iters):
        for _ in range(iters):
            fn()
        # 0.05 ms a call of each draw kernel: above any bound at these sizes
        return {f"{k}_kernel": [iters, 50.0 * iters] for k in ("threefry_bits", "randint")}

    monkeypatch.setattr(smoke, "device_activity", device_activity)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "cold_ms", lambda fn, iters, host_ahead=False: (fn(), 0.5)[1])
    k1, k2 = prng.split(prng.key(2806))
    indptr = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    ids = torch.arange(8, dtype=torch.int32)
    rows = torch.tensor([0, 1, 2, 5], dtype=torch.int32)
    heaviest = {
        "threefry_bits": (0, (k1, 4097, CPU), {}),
        "randint": (0, (k1, k2, 0, 10_000_000, 4097, CPU), {}),
        "csr_row_sample": (0, (indptr, ids, rows, k1, k2), {}),
    }
    sampling = {"launches": {"threefry_bits": 3, "randint": 2, "csr_row_sample": 1},
                "worst": {}, "heaviest": heaviest, "shapes": collections.Counter(),
                "first": {}}
    records = smoke.draw_timing(sampling)
    assert [r["name"] for r in records] == ["threefry_bits", "randint", "csr_row_sample"]
    bits, draws = records[0], records[1]
    assert bits["bound_ms"] == pytest.approx(
        max(4 * 4097 / smoke.HBM_BYTES_PER_S, 4097 * smoke.HASH_OPS / rate) * 1e3)
    assert draws["bound_ms"] == pytest.approx(
        max(4 * 4097 / smoke.HBM_BYTES_PER_S,
            4097 * smoke.RANDINT_ONE_HASH_OPS / rate) * 1e3)
    assert bits["ms"] == draws["ms"] == pytest.approx(0.05)
    side = [ln for ln in lines if "yardsticks on the card" in ln]
    assert len(side) == 2 and all("ALU-pipe floor" in ln and "torch.randint" in ln
                                  for ln in side)
