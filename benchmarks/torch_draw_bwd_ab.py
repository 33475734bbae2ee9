#!/usr/bin/env python3
"""Device time of the threefry draw kernels (``threefry_bits_kernel``,
``randint_kernel``, ``csr_row_sample_kernel``), ``rglru_scan_bwd_kernel``
and the padded-row ``intersect_count`` entry built from this tree's
``csrc`` against the same C entries built from another tree's, on the
same inputs in one process, and the SASS of both builds.

    python3 benchmarks/torch_draw_bwd_ab.py [--other-csrc DIR ...]
        [--parts draws,sample,scan,intersect]

Each ``DIR`` holds another commit's ``threefry.cu``, ``rglru_scan.cu`` and
``intersect.cu`` (a ``git archive`` of its ``src/repro_torch/csrc`` into
a gitignored directory), or a variant of them; the script compiles the
ones the chosen parts need with the port's own nvcc flags and names each
build by its directory. The entries ``threefry_bits_launch``,
``randint_launch``, ``csr_row_sample_launch``, ``rglru_scan_bwd_launch``
and ``intersect_count_launch`` must take the same arguments in every
tree. ``--parts`` picks what runs (all four by default). Inputs, seeded:

- draws: ``threefry_bits`` at 1,638,400 elements (the sampling phase's
  heaviest launch) and 65,536 (a walk step's); ``randint`` at 1,048,576
  draws with scalar bounds (0, 10,000,000) (the mean-degree estimator:
  one hash a draw, the high word is dead past a span of 2^16) and (0, 7)
  (two hashes a draw), and at 65,536 with ``lo`` 0 and a per-element
  ``hi`` of 1 + Poisson(3) (the sharded walk step's shape). Each build's
  launch is timed by the profiler (the kernel's device time, launches
  back to back, as ``chip_smoke.kernel_record`` times it) and on the
  card alone after a written L2 flush, in turns, beside two yardsticks
  on the same card: ``fill_(0)`` of as many int32 (launch and store) and
  ``torch.randint`` of as many int32 (PyTorch's Philox); then each
  build's launcher host time a call at 65,536;

- a CSR of ``N_ROWS`` = 10,000,000 rows (the smoke's ``N_NODES``) of
  Poisson(4) int32 ids over 500,000 columns with int32 ``indptr``, like
  the smoke's Workplaces memberships (4 a node over n / 20 groups); rows
  drawn uniformly at 409,600 (the sampling phase's heaviest launch) and
  262,144 (the walk fleet's), and at 262,144 with a delta overlay that
  dirties 1 % of the rows;
- a, h, dh [4, 2048, 4096] f32 and h0 [4, 4096] (recurrentgemma's
  training shape);
- intersect: ``INTERSECT_ROWS`` = 8,192 row pairs (the sharded phase's
  edge-value launches and the smoke's timed shape) of sorted, unique,
  SENTINEL-padded int32 rows, ``a`` and ``b`` both ``w`` wide, each row's
  real length uniform in [0, w] over ids below 4 w, at each width of
  ``INTERSECT_WIDTHS``: 1, 4 and 6 (the Households, Workplaces and
  Schools rows of the sharded path), 32 (the narrow route's widest), and
  128 and 512 (the Panel recipe's cap). Timed by the profiler and on the
  card alone in turns, beside yardsticks timed the same two ways: an
  empty kernel at the parent's grid (1,024 blocks of 256 threads) and at
  one-wave grids (32 blocks of 256, 64 of 128), and ``fill_(0)`` of
  8,192 int32; the bound is the bytes the function must move, 4 B an
  entry of both operands and 4 B a count.

Each launch's outputs must equal the plain version's bit for bit. Times:
``chip_smoke.cold_ms`` (CUDA events, the L2 flushed by writing 256 MB
before each launch), on the card alone (``host_ahead=True``) and cold
with the host's launch included; and on the card alone after a flush
that reads 256 MB instead, so the L2 holds clean lines and the call
evicts none that must be written back. Builds in the order given, then
this tree's, then back. Beside the row sample, torch's random gathers
of as many int32 (``torch.take``, one and two dependent levels) as a
yardstick of the card's random reads, and the wrapper's host time a
call with its launcher bound once or every call. Then for each build's
``SASS_KERNELS``: the SASS instruction count by opcode (``cuobjdump -sass``; the
hash's integer instructions in ``threefry_bits_kernel``), split by the
pipe that issues them (``PIPES``: the integer ALU and the FMA pipe at 64
lanes a clock an SM each, conversions and MUFU at 16), with what each
pipe's count alone predicts for the timed launches. Needs a CUDA device;
exits 2 without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

N_ROWS = 10_000_000
ROW_COUNTS = (409_600, 262_144)
SCAN_SHAPE = (4, 2048, 4096)
ITERS = 20
SEED = 27
BITS_COUNTS = (1_638_400, 65_536)
RANDINT_COUNT = 1_048_576
SCALAR_BOUNDS = ((0, 10_000_000), (0, 7))
WALK_STEP_COUNT = 65_536
PARTS = ("draws", "sample", "scan", "intersect")
# the csrc source each part builds
PART_SOURCES = {"draws": "threefry", "sample": "threefry", "scan": "rglru_scan",
                "intersect": "intersect"}
INTERSECT_ROWS = 8192
INTERSECT_WIDTHS = (1, 4, 6, 32, 128, 512)
EMPTY_GRIDS = ((1024, 256), (32, 256), (64, 128))
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# integer ALU instructions of the hash (csrc/threefry.cu): adds, shifts
# and funnel shifts, three-input logic, multiply-adds
INT_OPS = ("IADD3", "SHF", "LOP3", "IMAD", "LEA", "IADD", "ISETP", "SEL", "PRMT")
# the pipe each SASS opcode issues to on Hopper (by its name before the
# first dot), and that pipe's lanes a clock on one SM: the integer ALU
# (adds, logic, shifts, compares, selects) and the FMA pipe's IMAD (every
# form: .IADD, .SHL, .HI, .WIDE, .MOV) at 64, conversions and MUFU at 16
PIPES = {
    "alu": (("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IMNMX", "VIMNMX", "PRMT"),
            64),
    "fma": (("IMAD",), 64),
    "xu": (("MUFU", "I2F", "F2I"), 16),
}
SASS_KERNELS = ("threefry_bits_kernel", "randint_kernel", "csr_row_sample_kernel",
                "rglru_scan_bwd_kernel")


def build_other(csrc: Path, out: Path, tag: str, names) -> dict:
    """{name: library path}: the sources ``names`` of ``csrc``, built in
    parallel as the port builds its own."""
    from repro_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name in names:
        lib = out / f"lib{name}-{tag}.so"
        cmd = [build.nvcc_path(), "-Xptxas=-v", *build.NVCC_FLAGS, "-o", str(lib),
               str(csrc / f"{name}.cu")]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {csrc / name}.cu failed:\n{text}")
        print(f"# {csrc / name}.cu, ptxas:\n{ptxas_lines(text)}")
        libs[name] = lib
    return libs


def ptxas_lines(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if "registers" in ln or "Compiling entry" in ln or "spill" in ln)


def bound_entry(lib: ctypes.CDLL, name: str, argtypes):
    """``lib``'s C entry ``name`` with the port's argument types."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def sample_inputs(device):
    """(base indptr, ids, overlay, {label: rows}) on the card."""
    import torch

    rng = np.random.default_rng(SEED)
    lengths = rng.poisson(4.0, N_ROWS)
    indptr = np.zeros(N_ROWS + 1, np.int32)
    np.cumsum(lengths, out=indptr[1:])
    ids = rng.integers(0, N_ROWS // 20, int(indptr[-1]), dtype=np.int32)
    dirty = rng.random(N_ROWS) < 0.01
    dlen = np.where(dirty, rng.poisson(4.0, N_ROWS), 0)
    d_indptr = np.zeros(N_ROWS + 1, np.int32)
    np.cumsum(dlen, out=d_indptr[1:])
    d_ids = rng.integers(0, N_ROWS // 20, int(d_indptr[-1]), dtype=np.int32)
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    overlay = (t(dirty), t(d_indptr), t(d_ids))
    rows = {f"{n} rows": t(rng.integers(0, N_ROWS, n, dtype=np.int32))
            for n in ROW_COUNTS}
    rows[f"{ROW_COUNTS[1]} rows, overlay"] = t(
        rng.integers(0, N_ROWS, ROW_COUNTS[1], dtype=np.int32))
    return t(indptr), t(ids), overlay, rows


def sample_call(fn, indptr, ids, overlay, rows, keys, out, valid):
    """One launch of ``fn`` (a csr_row_sample_launch) on the current stream."""
    import torch

    d = (overlay[0].data_ptr(), overlay[0].numel(), overlay[1].data_ptr(), 0,
         overlay[2].data_ptr(), 1, overlay[1].numel() - 1) if overlay else (
        None, 0, None, 0, None, 0, 0)
    err = fn(*keys, indptr.data_ptr(), 0, ids.data_ptr(), 1, indptr.numel() - 1, *d,
             rows.data_ptr(), out.data_ptr(), valid.data_ptr(), rows.numel(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"csr_row_sample_launch: CUDA error {err}")


def clean_ms(fn, iters: int) -> float:
    """``chip_smoke.cold_ms(fn, iters, host_ahead=True)`` with the L2
    emptied by reading L2_FLUSH_BYTES, not writing them: the call finds
    clean lines and writes none back."""
    import torch

    import chip_smoke as cs

    flush = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    cs.sync()
    total = 0.0
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(cs.HOST_AHEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        cs.sync()
        total += start.elapsed_time(end)
    return total / iters


def ab(label, fns, bound_ms, extra=""):
    """Times each build's call on the card alone after a written and a
    read flush, and cold, in the order of ``fns`` and back; prints each
    build's readings and their ratio to this tree's."""
    import chip_smoke as cs

    names = list(fns)
    got = collections.defaultdict(lambda: {"alone": [], "clean": [], "cold": []})
    for who in names + names[::-1]:
        got[who]["alone"].append(cs.cold_ms(fns[who], ITERS, host_ahead=True))
        got[who]["clean"].append(clean_ms(fns[who], ITERS))
        got[who]["cold"].append(cs.cold_ms(fns[who], ITERS))
    for who, t in got.items():
        cs.log(f"{label}: {who}: on the card alone "
               f"{' / '.join(f'{x:.4f}' for x in t['alone'])} ms (read flush: "
               f"{' / '.join(f'{x:.4f}' for x in t['clean'])}), cold "
               f"{' / '.join(f'{x:.4f}' for x in t['cold'])} ms; bound {bound_ms:.4f} ms"
               f"{extra}")
    mine = np.mean(got["this"]["alone"])
    for who in names[:-1]:
        theirs = np.mean(got[who]["alone"])
        cs.log(f"{label}: on the card alone this tree {mine:.4f} ms against {who} "
               f"{theirs:.4f} ms: {theirs / mine:.2f}x")


def draw_launchers(lib: ctypes.CDLL) -> dict:
    """A threefry library's draw entries, bound to the port's argument
    types: ``bits`` and ``randint``."""
    from repro_torch.kernels import threefry

    return {key: bound_entry(lib, name, threefry.ARGTYPES[name])
            for key, name in (("bits", "threefry_bits_launch"),
                              ("randint", "randint_launch"))}


def checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def draw_calls(fns: dict, key, device) -> dict:
    """{label: (call, output, plain version, args)}: one build's launches
    of the draw kernels at the A/B's shapes, each into its own output;
    ``args`` are a randint's ``randint_cuda`` arguments (None for bits)."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels import ref

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    cpu = torch.device("cpu")
    calls = {}
    for n in BITS_COUNTS:
        out = torch.empty(n, dtype=torch.int32, device=device)
        calls[f"threefry_bits {n:,}"] = (
            lambda o=out, n=n: checked(fns["bits"](*key, o.data_ptr(), n, stream()),
                                       "threefry_bits_launch"),
            out, lambda n=n: ref.threefry_bits_ref(key, n, cpu), None)
    k1, k2 = prng.split(key)
    sub = (int(k1[0]), int(k1[1]), int(k2[0]), int(k2[1]))
    rng = np.random.default_rng(SEED)
    per_element = torch.from_numpy((1 + rng.poisson(3.0, WALK_STEP_COUNT)).astype(np.int32))
    cases = [(f"scalar ({lo}, {hi:,})", RANDINT_COUNT, lo, hi) for lo, hi in SCALAR_BOUNDS]
    cases.append(("per-element hi", WALK_STEP_COUNT, 0, per_element.to(device)))
    for what, n, lo, hi in cases:
        out = torch.empty(n, dtype=torch.int32, device=device)
        hi_p, hi_s = (hi.data_ptr(), 0) if isinstance(hi, torch.Tensor) else (None, hi)
        call = (lambda o=out, lo=lo, hi_p=hi_p, hi_s=hi_s, n=n: checked(
            fns["randint"](*sub, None, lo, hi_p, hi_s, o.data_ptr(), n, stream()),
            "randint_launch"))
        hi_cpu = hi.cpu() if isinstance(hi, torch.Tensor) else hi
        calls[f"randint {n:,} {what}"] = (
            call, out,
            lambda lo=lo, hi=hi_cpu, n=n: ref.randint_ref(k1, k2, lo, hi, n, cpu),
            (k1, k2, lo, hi, n, device))
    return calls


def busy_ms(fn, iters: int) -> float:
    """The card's busy time a call of ``fn``, which launches each of its
    kernels once: the sum of each device activity's mean duration over a
    profiled window of ``iters`` back-to-back calls
    (``chip_smoke.device_activity``), so an event the profiler drops
    lowers no reading."""
    import chip_smoke as cs

    acts = cs.device_activity(fn, iters)
    return sum(us / n for n, us in acts.values()) / 1e3


def run_draws(builds, device):
    """threefry_bits and randint of each build at the A/B's shapes: equal
    to the plain version bit for bit, then timed in turns (builds in
    order and back), by the profiler and on the card alone, beside the
    bound, the ALU-pipe floor and the two yardsticks."""
    import torch

    import chip_smoke as cs
    from repro_torch.core import prng

    calls = {who: draw_calls(draw_launchers(lib), prng.key(SEED), device)
             for who, lib in builds.items()}
    int_rate = cs.card_int_ops_per_s()
    names = list(builds)
    for label in calls["this"]:
        want = None
        for who in names:
            fn, out, plain, args = calls[who][label]
            fn()
            cs.sync()
            want = plain() if want is None else want
            if not torch.equal(out.cpu(), want):
                raise AssertionError(f"{label}: the {who} build differs from the plain "
                                     "version")
        got = collections.defaultdict(lambda: {"profiler": [], "alone": []})
        for who in names + names[::-1]:
            fn = calls[who][label][0]
            got[who]["profiler"].append(busy_ms(fn, 50))
            got[who]["alone"].append(cs.cold_ms(fn, ITERS, host_ahead=True))
        n = want.numel()
        if args is None:
            nbytes, ops, hashes = 4 * n, cs.bits_ops(n), n
        else:
            nbytes, ops = cs.draw_bytes("randint", args, {}), cs.randint_ops(args)
            hashes = cs.randint_hashes(args)
        bound = max(nbytes / cs.HBM_BYTES_PER_S, ops / int_rate) * 1e3
        alu = cs.alu_floor_ms(hashes * cs.HASH_ALU_OPS)
        for who, t in got.items():
            cs.log(f"{label}: {who}: profiler "
                   f"{' / '.join(f'{x:.4f}' for x in t['profiler'])} ms, on the card "
                   f"alone {' / '.join(f'{x:.4f}' for x in t['alone'])} ms; bound "
                   f"{bound:.4f} ms (bytes {nbytes}, operations {ops}); ALU-pipe floor "
                   f"{alu:.4f} ms ({hashes} hashes); equal to the plain version bit "
                   "for bit")
        mine = np.mean(got["this"]["profiler"])
        for who in names[:-1]:
            theirs = np.mean(got[who]["profiler"])
            alone = np.mean(got[who]["alone"]) / np.mean(got["this"]["alone"])
            cs.log(f"{label}: by the profiler this tree {mine:.4f} ms against {who} "
                   f"{theirs:.4f} ms: {theirs / mine:.2f}x (on the card alone "
                   f"{alone:.2f}x)")
        draw_yardsticks(label, n, device)
    launcher_host_us(calls, names)


def launcher_host_us(calls: dict, names: list, n_calls: int = 2000) -> None:
    """Host time a call of each build's threefry_bits and randint
    launchers at a walk step's 65,536 elements (the card's microsecond or
    two hides under it): wall time over ``n_calls`` back-to-back calls
    through ctypes, the builds in turns and back."""
    import time

    import chip_smoke as cs

    for label in (f"threefry_bits {WALK_STEP_COUNT:,}",
                  f"randint {WALK_STEP_COUNT:,} per-element hi"):
        got = collections.defaultdict(list)
        for who in names + names[::-1]:
            fn = calls[who][label][0]
            for _ in range(100):
                fn()
            cs.sync()
            t0 = time.perf_counter()
            for _ in range(n_calls):
                fn()
            cs.sync()
            got[who].append((time.perf_counter() - t0) / n_calls * 1e6)
        cs.log(f"{label}: host time a launcher call: " + "; ".join(
            f"{who} {' / '.join(f'{us:.2f}' for us in t)} us" for who, t in got.items()))


def draw_yardsticks(label: str, n: int, device) -> None:
    """``fill_(0)`` and ``torch.randint`` of ``n`` int32 on the card, timed
    as the draws are."""
    import torch

    import chip_smoke as cs

    buf = torch.empty(n, dtype=torch.int32, device=device)
    for what, fn in (("fill_(0)", lambda: buf.fill_(0)),
                     ("torch.randint", lambda: torch.randint(
                         0, 2**31 - 1, (n,), dtype=torch.int32, device=device))):
        cs.log(f"{label}: yardstick {what} of {n:,} int32: profiler "
               f"{busy_ms(fn, 50):.4f} ms, on the card alone "
               f"{cs.cold_ms(fn, ITERS, host_ahead=True):.4f} ms")


def run_sample(builds, device):
    import torch

    import chip_smoke as cs
    from repro_torch.core import prng

    indptr, ids, overlay, rows = sample_inputs(device)
    k1, k2 = prng.split(prng.key(SEED))
    keys = (int(k1[0]), int(k1[1]), int(k2[0]), int(k2[1]))
    int_rate = cs.card_int_ops_per_s()
    for label, r in rows.items():
        ov = overlay if "overlay" in label else None
        outs = {}
        fns = {}
        for who, fn in builds.items():
            out = torch.empty(r.numel(), dtype=torch.int32, device=device)
            valid = torch.empty(r.numel(), dtype=torch.bool, device=device)
            outs[who] = (out, valid)
            fns[who] = (lambda f=fn, o=out, v=valid:
                        sample_call(f, indptr, ids, ov, r, keys, o, v))
            fns[who]()
        args, kwargs = (indptr, ids, r, k1, k2), ({"overlay": ov} if ov else {})
        want = cs.draw_plain("csr_row_sample", args, kwargs)
        for who, (out, valid) in outs.items():
            if not (torch.equal(out, want[0]) and torch.equal(valid, want[1])):
                raise AssertionError(f"csr_row_sample {label}: the {who} build differs "
                                     "from the plain version")
        nbytes = cs.draw_bytes("csr_row_sample", args, kwargs)
        sectors = cs.draw_sector_bytes(args, kwargs)
        bound = max(nbytes / cs.HBM_BYTES_PER_S,
                    cs.row_sample_ops(args, kwargs) / int_rate) * 1e3
        ab(f"csr_row_sample {label}", fns, bound,
           f" (bytes {nbytes}; 32-byte sectors {sectors / cs.HBM_BYTES_PER_S * 1e3:.4f} "
           "ms); equal to the plain version bit for bit")
        gather_yardsticks(label, indptr, ids, r)
    wrapper_host_us(indptr, ids, k1, k2)


def wrapper_host_us(indptr, ids, k1, k2, calls: int = 2000) -> None:
    """Host time of one ``csr_row_sample_cuda`` call on one row (the card's
    work, a few microseconds, hides under it): its launcher bound once,
    and bound anew every call as the wrapper did before its cache
    (``threefry._launchers`` emptied before each call). Wall time over
    ``calls`` back-to-back calls, the two in turns, twice each."""
    import time

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import threefry

    row = torch.zeros(1, dtype=torch.int32, device=indptr.device)

    def once():
        threefry.csr_row_sample_cuda(indptr, ids, row, k1, k2)

    def rebound():
        threefry._launchers.clear()
        threefry.csr_row_sample_cuda(indptr, ids, row, k1, k2)

    got = collections.defaultdict(list)
    for who, fn in [("bound once", once), ("bound every call", rebound)] * 2:
        for _ in range(100):
            fn()
        cs.sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        cs.sync()
        got[who].append((time.perf_counter() - t0) / calls * 1e6)
    cs.log("csr_row_sample_cuda host time a call, one row: " + "; ".join(
        f"{who} {' / '.join(f'{us:.2f}' for us in t)} us" for who, t in got.items()))


def gather_yardsticks(label, indptr, ids, rows):
    """torch's random gathers at the row sample's count: one int32 read a
    row at random in ``ids``, and indptr[rows] then ids at those
    positions (two dependent levels), each on the card alone after a
    written and a read flush."""
    import torch

    import chip_smoke as cs

    g = torch.Generator(device=ids.device).manual_seed(SEED)
    pos = torch.randint(0, ids.numel(), (rows.numel(),), generator=g, device=ids.device)
    rl = rows.long()
    calls = {"one level": lambda: torch.take(ids, pos),
             "two levels": lambda: torch.take(ids, torch.take(indptr, rl).long())}
    for what, fn in calls.items():
        cs.log(f"csr_row_sample {label}: yardstick torch.take, {what}: on the card "
               f"alone {cs.cold_ms(fn, ITERS, host_ahead=True):.4f} ms (read flush: "
               f"{clean_ms(fn, ITERS):.4f})")


def run_scan(builds, device):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref

    B, S, dr = SCAN_SHAPE
    g = torch.Generator(device=device).manual_seed(SEED)
    a = torch.rand(SCAN_SHAPE, generator=g, device=device) * 0.5 + 0.5
    b = torch.randn(SCAN_SHAPE, generator=g, device=device)
    h0 = torch.randn((B, dr), generator=g, device=device)
    h = ref.rglru_scan_ref(a, b, h0)
    dh = torch.randn(SCAN_SHAPE, generator=g, device=device)
    want = ref.rglru_scan_bwd_loop(a, h, h0, dh)
    fns = {}
    for who, fn in builds.items():
        da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)

        def call(f=fn, da=da, db=db, dh0=dh0):
            err = f(a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
                    da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, S, dr,
                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rglru_scan_bwd_launch: CUDA error {err}")

        call()
        if not all(torch.equal(x, y) for x, y in zip((da, db, dh0), want)):
            raise AssertionError(f"rglru_scan_bwd: the {who} build differs from its loop")
        fns[who] = call
    nbytes = 4 * 5 * a.numel() + 8 * h0.numel()
    ab(f"rglru_scan_bwd at [{B},{S},{dr}] f32, h0 [{B},{dr}]", fns,
       nbytes / cs.HBM_BYTES_PER_S * 1e3, "; equal to its loop bit for bit")


def run_intersect(builds, device):
    """The padded-row intersect_count entry of each build (``builds``:
    {who: intersect_count_launch}) at each of INTERSECT_WIDTHS: equal to
    ``intersect_count_ref`` bit for bit, then timed by the profiler and on
    the card alone, the builds in order and back, beside the yardsticks."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref

    out_dir = ROOT / "build" / "draw_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "empty.cu").write_text(EMPTY_SOURCE)
    lib = out_dir / "libempty.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out_dir / "empty.cu")], check=True)
    empty = bound_entry(ctypes.CDLL(str(lib)), "empty_launch",
                        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    n = INTERSECT_ROWS
    yard = {f"empty kernel {b} x {t}": (lambda b=b, t=t: checked(
        empty(b, t, stream()), "empty_launch")) for b, t in EMPTY_GRIDS}
    buf = torch.empty(n, dtype=torch.int32, device=device)
    yard[f"fill_(0) of {n:,} int32"] = lambda: buf.fill_(0)
    for what, t in turns(yard).items():
        cs.log(f"intersect_count yardstick {what}: profiler {fmt5(t['profiler'])} ms, "
               f"on the card alone {fmt5(t['alone'])} ms")
    rng = np.random.default_rng(SEED)
    names = list(builds)
    for w in INTERSECT_WIDTHS:
        a = cs.sorted_rows(rng, n, w, 4 * w, device)
        b = cs.sorted_rows(rng, n, w, 4 * w, device)
        want = ref.intersect_count_ref(a, b)
        fns = {}
        for who, fn in builds.items():
            out = torch.empty(n, dtype=torch.int32, device=device)
            fns[who] = (lambda f=fn, o=out: checked(
                f(a.data_ptr(), b.data_ptr(), o.data_ptr(), n, w, w, stream()),
                "intersect_count_launch"))
            fns[who]()
            cs.sync()
            if not torch.equal(out, want):
                raise AssertionError(f"intersect_count width {w}: the {who} build "
                                     "differs from intersect_count_ref")
        bound = (4 * n * 2 * w + 4 * n) / cs.HBM_BYTES_PER_S * 1e3
        got = turns(fns)
        label = f"intersect_count [{n},{w}]x[{n},{w}]"
        for who, t in got.items():
            cs.log(f"{label}: {who}: profiler {fmt5(t['profiler'])} ms, on the card "
                   f"alone {fmt5(t['alone'])} ms; bound {bound:.6f} ms (bytes); equal "
                   "to intersect_count_ref bit for bit")
        mine = np.mean(got["this"]["profiler"])
        for who in names[:-1]:
            theirs = np.mean(got[who]["profiler"])
            alone = np.mean(got[who]["alone"]) / np.mean(got["this"]["alone"])
            cs.log(f"{label}: by the profiler this tree {mine:.5f} ms against {who} "
                   f"{theirs:.5f} ms: {theirs / mine:.2f}x (on the card alone "
                   f"{alone:.2f}x)")


def turns(fns: dict) -> dict:
    """{name: {"profiler": [...], "alone": [...]}}: each call timed by the
    profiler (``busy_ms``) and on the card alone, in the order of ``fns``
    and back."""
    import chip_smoke as cs

    got = collections.defaultdict(lambda: {"profiler": [], "alone": []})
    names = list(fns)
    for who in names + names[::-1]:
        got[who]["profiler"].append(busy_ms(fns[who], 50))
        got[who]["alone"].append(cs.cold_ms(fns[who], ITERS, host_ahead=True))
    return got


def fmt5(xs) -> str:
    return " / ".join(f"{x:.5f}" for x in xs)


def sass_counts(lib: Path, launches: dict) -> None:
    """Per kernel function of ``lib`` named in SASS_KERNELS: its SASS
    instructions by opcode, the integer ALU ones summed (one hash an
    element in threefry_bits_kernel), and by pipe (``PIPES``). For the
    functions named in ``launches`` ({name: {label: elements}}), each
    pipe's count an element (the static count over the elements a thread
    takes in a loop iteration, the function's first template argument or
    1, so the prologue and the tail's stores count too) and the time that
    count alone predicts at each launch, at the pipe's lanes a clock on
    every SM at the card's maximum clock."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    import chip_smoke as cs
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(cs.device_line("clocks.max.sm").split()[0])
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text,
                               re.S):
        if not any(k in fn for k in SASS_KERNELS):
            continue
        full = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                          body)
        ops = [op.split(".")[0] for op in full]
        kinds = collections.Counter(ops)
        int_ops = sum(kinds[k] for k in INT_OPS)
        top = ", ".join(f"{k} {v}" for k, v in kinds.most_common(12))
        print(f"#   {fn}: {len(ops)} instructions, integer ALU {int_ops}, MUFU "
              f"{kinds['MUFU']}, I2F {kinds['I2F']}, F2I {kinds['F2I']}; {top}")
        pipes = {p: sum(kinds[k] for k in names) for p, (names, _) in PIPES.items()}
        imad = collections.Counter(op for op in full if op.startswith("IMAD"))
        print(f"#     by pipe: {json.dumps(pipes)}, other "
              f"{len(ops) - sum(pipes.values())}; IMAD forms {json.dumps(dict(imad))}")
        per_thread = re.search(r"kernelILi(\d+)E", fn)
        per = int(per_thread[1]) if per_thread else 1
        for name, counts in launches.items():
            if name not in fn:
                continue
            for label, n in counts.items():
                parts = []
                for p, (_, lanes) in PIPES.items():
                    ms = n * pipes[p] / per / (lanes * sms * mhz * 1e6) * 1e3
                    parts.append(f"{p} {pipes[p] / per:.2f} an element -> {ms:.4f} ms")
                issue = n * len(ops) / per / (cs.INT_LANE_OPS_PER_CLOCK * sms * mhz
                                              * 1e6) * 1e3
                print(f"#     {name} at {label}: " + "; ".join(parts)
                      + f"; every instruction at the issue rate -> {issue:.4f} ms "
                      f"({sms} SMs at {mhz:.0f} MHz)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", type=Path, action="append", default=[],
                        help="directory with another tree's threefry.cu and rglru_scan.cu")
    parser.add_argument("--parts", default=",".join(PARTS),
                        help=f"comma-separated parts to run, of {', '.join(PARTS)}")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        parser.error(f"--parts takes {', '.join(PARTS)}")
    import torch

    if not torch.cuda.is_available():
        print("torch_draw_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import intersect, rglru_scan, threefry

    device = torch.device("cuda")
    cs.log(f"{cs.device_line()}; {cs.device_line(cs.CLOCK_FIELDS)}; torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    names = sorted({PART_SOURCES[p] for p in parts})
    build.build(names, verbose=True)
    paths = {str(csrc): build_other(csrc.resolve(), ROOT / "build" / "draw_bwd_ab",
                                    str(tag), names)
             for tag, csrc in enumerate(args.other_csrc)}
    paths["this"] = {name: build.library_path(name) for name in names}
    builds = {who: {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
              for who, libs in paths.items()}
    if "draws" in parts:
        run_draws({who: libs["threefry"] for who, libs in builds.items()}, device)
    if "sample" in parts:
        run_sample({who: bound_entry(libs["threefry"], "csr_row_sample_launch",
                                     threefry.ARGTYPES["csr_row_sample_launch"])
                    for who, libs in builds.items()}, device)
    if "scan" in parts:
        run_scan({who: bound_entry(libs["rglru_scan"], "rglru_scan_bwd_launch",
                                   rglru_scan._BWD_ARGTYPES)
                  for who, libs in builds.items()}, device)
    if "intersect" in parts:
        run_intersect({who: bound_entry(libs["intersect"], "intersect_count_launch",
                                        intersect._ARGTYPES)
                       for who, libs in builds.items()}, device)
    launches = {"threefry_bits_kernel": {f"{n:,}": n for n in BITS_COUNTS},
                "randint_kernel": {f"{RANDINT_COUNT:,}": RANDINT_COUNT}}
    for who, libs in paths.items():
        for name, lib in libs.items():
            if name != "intersect":
                print(f"# SASS of the {who} build's {name}:")
                sass_counts(lib, launches)
    cs.log(f"integer rate {cs.card_int_ops_per_s():.4g} a second; HASH_OPS "
           f"{cs.HASH_OPS} below 2^32 elements; {cs.device_line(cs.CLOCK_FIELDS)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
