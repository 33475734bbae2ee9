"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``build/repro_torch/`` at the repository root, named by a hash of
its source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds. Libraries load with
``ctypes``. :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them.

``launch_counts`` holds one plain integer per kernel: each wrapper adds
one where it launches its kernel, and nowhere else. The union kernels
count under ``"segmented_union"`` (in-block rows),
``"segmented_union_count"`` (in-block count-only rows) and, for rows
wider than its capacity, ``"segmented_union_wide"`` (tile sorts),
``"union_merge"`` (merge levels) and ``"union_compact"`` (final passes).
Frontier rows that the kernel cannot take and that go to the plain torch
path on the card are counted too, under ``"frontier_sort_rows"`` (k-hop
traversal). Union rows never take torch's sort on the card:
``chip_smoke.py`` holds ``"segmented_union_sort_rows"`` at 0.
``core/traversal.py`` counts its label sweeps under
``"components_sweeps"``. The LM kernels count under ``"rmsnorm"``,
``"flash_attention"`` (the bf16 tensor-core route),
``"flash_attention_fma"`` (the CUDA-core route: f32, and bf16 at head
dims 32 and 256), ``"ssd_scan"`` (the bf16 tensor-core route) and
``"ssd_scan_fma"`` (the CUDA-core route: f32, and the shapes the first
cannot take); operands flash's tensor-core route had to copy for TMA count
under ``"flash_attention_copies"``; the RG-LRU recurrence counts under
``"rglru_scan"``. The gradients count under ``"rmsnorm_bwd"``,
``"flash_attention_bwd"`` (the bf16 tensor-core route) and
``"flash_attention_bwd_fma"`` (the CUDA-core route: f32, and bf16 at head
dims 32 and 256), one a call (each call two and three launches), operands
the flash backward had to copy under ``"flash_attention_bwd_copies"``; the SSD scan's under
``"ssd_scan_bwd_states"`` and ``"ssd_scan_bwd"`` (the bf16 tensor-core
route's two kernels, one each a call) or ``"ssd_scan_bwd_states_fma"`` and
``"ssd_scan_bwd_fma"`` (the CUDA-core route: f32, and the shapes the first
cannot take), operands it had to copy under ``"ssd_scan_bwd_copies"``;
the RG-LRU scan's under ``"rglru_scan_bwd"``. The sampling path's threefry kernels
count under ``"threefry_bits"``, ``"randint"`` and ``"csr_row_sample"``.

No source needs a flag of its own: ``flash_attention.cu``,
``flash_attention_bwd.cu`` and ``ssd_scan.cu`` share ``csrc/tma.cuh`` (the
attention kernels also ``csrc/wgmma.cuh``), which fetches libcuda's
``cuTensorMapEncodeTiled`` through the runtime (``cudaGetDriverEntryPoint``)
and takes only the toolkit's ``cuda.h`` for its types, so nothing links
``-lcuda`` and the hash of source, headers and flags covers every choice.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_SOURCES = (
    "intersect", "segmented_union", "frontier",
    "rmsnorm", "flash_attention", "ssd_scan", "threefry", "rglru_scan",
    "flash_attention_bwd", "ssd_scan_bwd",
)
#: the sources of the graph query kernels (what a serve engine launches)
GRAPH_SOURCES = ("intersect", "segmented_union", "frontier", "threefry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: collections.Counter = collections.Counter()
_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNEL_SOURCES, *, verbose: bool = False) -> float:
    """Compile every missing library in ``names`` in parallel -> seconds.

    ``verbose`` adds ``-Xptxas=-v`` and prints what nvcc reports
    (registers, shared memory, spills per kernel).
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        if verbose:
            print(f"# nvcc {name}.cu\n{stdout}{stderr}".rstrip())
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    Safe from several threads: one builds and loads, the others wait."""
    lib = _libs.get(name)
    if lib is None:
        with _libs_lock:
            lib = _libs.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build([name])
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_operand(t, name: str, ndim: int, dtypes=(torch.int32,)) -> None:
    """Kernels take contiguous tensors of one of ``dtypes`` (int32 for the
    graph kernels) on a CUDA device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(
            f"{name} must be {' or '.join(str(d) for d in dtypes)}, got {t.dtype}"
        )
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def float_code(dtype: torch.dtype) -> int:
    """The dtype code the LM kernels' C interfaces take: 0 f32, 1 bf16."""
    return FLOAT_DTYPES.index(dtype)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte-aligned base (the LM kernels load 16
    bytes at a time); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
