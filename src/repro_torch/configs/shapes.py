"""Assigned input-shape cells and the (arch × shape) matrix, as in
``src/repro/configs/shapes.py`` (plain data, copied):

  train_4k    : train_step   seq 4096,   global batch 256
  prefill_32k : prefill_step seq 32768,  global batch 32
  decode_32k  : decode_step  1 new token, KV len 32768, batch 128
  long_500k   : decode_step  1 new token, KV len 524288, batch 1
                (sub-quadratic archs only; full-attention archs skip)

``launch/dryrun.py`` walks the 40 cells (10 archs × 4 shapes, 8 of them
skipped) on the meta device.
"""

from dataclasses import dataclass

from . import all_arch_names


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs whose every attention layer is full/global (quadratic) skip 500k
SUBQUADRATIC = {"mamba2-130m", "recurrentgemma-9b"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape_name[, skipped]) for the 40-cell matrix."""
    for arch in all_arch_names():
        for shape in SHAPES:
            ok = cell_applicable(arch, shape)
            if include_skipped:
                yield arch, shape, not ok
            elif ok:
                yield arch, shape
