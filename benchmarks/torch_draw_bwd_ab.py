#!/usr/bin/env python3
"""Device time of ``csr_row_sample_kernel`` and ``rglru_scan_bwd_kernel``
built from this tree's ``csrc`` against the same C entries built from
another tree's, on the same inputs in one process, and the SASS of both
builds.

    python3 benchmarks/torch_draw_bwd_ab.py [--other-csrc DIR ...]

Each ``DIR`` holds another commit's ``threefry.cu`` and ``rglru_scan.cu``
(a ``git archive`` of its ``src/repro_torch/csrc`` into a gitignored
directory), or a variant of them; the script compiles them with the
port's own nvcc flags and names each build by its directory. The entries
``csr_row_sample_launch`` and ``rglru_scan_bwd_launch`` must take the
same arguments in every tree. Inputs, seeded:

- a CSR of ``N_ROWS`` = 10,000,000 rows (the smoke's ``N_NODES``) of
  Poisson(4) int32 ids over 500,000 columns with int32 ``indptr``, like
  the smoke's Workplaces memberships (4 a node over n / 20 groups); rows
  drawn uniformly at 409,600 (the sampling phase's heaviest launch) and
  262,144 (the walk fleet's), and at 262,144 with a delta overlay that
  dirties 1 % of the rows;
- a, h, dh [4, 2048, 4096] f32 and h0 [4, 4096] (recurrentgemma's
  training shape).

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
hash's integer instructions in ``threefry_bits_kernel``). Needs a CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
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
# integer ALU instructions of the hash (csrc/threefry.cu): adds, shifts
# and funnel shifts, three-input logic, multiply-adds
INT_OPS = ("IADD3", "SHF", "LOP3", "IMAD", "LEA", "IADD", "ISETP", "SEL", "PRMT")
SASS_KERNELS = ("threefry_bits_kernel", "randint_kernel", "csr_row_sample_kernel",
                "rglru_scan_bwd_kernel")


def build_other(csrc: Path, out: Path, tag: int) -> dict:
    """Another tree's two sources, built as the port builds its own."""
    from repro_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name in ("threefry", "rglru_scan"):
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


def launchers(threefry_lib: ctypes.CDLL, rglru_lib: ctypes.CDLL) -> tuple:
    """(csr_row_sample_launch, rglru_scan_bwd_launch) of two libraries,
    bound to the port's argument types."""
    from repro_torch.kernels import rglru_scan, threefry

    sample, bwd = threefry_lib.csr_row_sample_launch, rglru_lib.rglru_scan_bwd_launch
    sample.argtypes = threefry.ARGTYPES["csr_row_sample_launch"]
    bwd.argtypes = rglru_scan._BWD_ARGTYPES
    sample.restype = bwd.restype = ctypes.c_int
    return sample, bwd


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
        for who, (fn, _) in builds.items():
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
                    r.numel() * cs.RANDINT_OPS / int_rate) * 1e3
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
    for who, (_, fn) in builds.items():
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


def sass_counts(lib: Path) -> None:
    """Per kernel function of ``lib`` named in SASS_KERNELS: its SASS
    instructions by opcode, the integer ALU ones summed (one hash an
    element in threefry_bits_kernel)."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text,
                               re.S):
        if not any(k in fn for k in SASS_KERNELS):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        kinds = collections.Counter(ops)
        int_ops = sum(kinds[k] for k in INT_OPS)
        top = ", ".join(f"{k} {v}" for k, v in kinds.most_common(12))
        print(f"#   {fn}: {len(ops)} instructions, integer ALU {int_ops}, MUFU "
              f"{kinds['MUFU']}, I2F {kinds['I2F']}, F2I {kinds['F2I']}; {top}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other-csrc", type=Path, action="append", default=[],
                        help="directory with another tree's threefry.cu and rglru_scan.cu")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_draw_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    device = torch.device("cuda")
    cs.log(f"{cs.device_line()}; {cs.device_line(cs.CLOCK_FIELDS)}; torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    build.build(("threefry", "rglru_scan"), verbose=True)
    builds, paths = {}, {}
    for tag, csrc in enumerate(args.other_csrc):
        who = str(csrc)
        other = build_other(csrc.resolve(), ROOT / "build" / "draw_bwd_ab", tag)
        builds[who] = launchers(ctypes.CDLL(str(other["threefry"])),
                                ctypes.CDLL(str(other["rglru_scan"])))
        paths[who] = other
    builds["this"] = launchers(build.library("threefry"), build.library("rglru_scan"))
    paths["this"] = {name: build.library_path(name) for name in ("threefry", "rglru_scan")}
    run_sample(builds, device)
    run_scan(builds, device)
    for who, libs in paths.items():
        for name, lib in libs.items():
            print(f"# SASS of the {who} build's {name}:")
            sass_counts(lib)
    cs.log(f"integer rate {cs.card_int_ops_per_s():.4g} a second; HASH_OPS "
           f"{cs.HASH_OPS}; {cs.device_line(cs.CLOCK_FIELDS)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
