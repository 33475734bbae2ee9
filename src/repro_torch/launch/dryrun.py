"""Dry run of the LM matrix: does each cell's placement fit the cards?

For every (architecture × input shape) cell of ``configs/shapes.py``, on
both production meshes (single-pod 16×16 and multi-pod 2×16×16 cards), the
port's ``Model`` is built on the meta device (``torch.device("meta")``:
shapes and dtypes, no values, no memory) and the cell is walked on paper:

- parameter bytes a card, from ``models/sharding.py::param_specs`` over
  the mesh's axis sizes (FSDP over the dp axes, TP/EP over ``model``);
- for a training cell, the optimizer state a card as
  ``train/optimizer.py::make_optimizer`` keeps it for the cell's
  ``cfg.optimizer`` (AdamW's f32 master, mu and nu; Adafactor's f32 master
  and factored statistics), its leaves placed by the same name rules, and
  ``default_accum``'s gradient accumulation with its remat carries;
- for a prefill or decode cell, the KV / state cache a card, placed as the
  reference places it (heads over ``model``, or the sequence where the
  kv heads do not divide it);
- the analytic FLOPs and HBM bytes of a step (``perf/analytic.py``) and
  the least time a card could take for its share;
- whether the card's share fits one card's memory:
  ``torch.cuda.get_device_properties(0).total_memory`` on the card, or the
  ``capacity`` the caller passes. A step's transient activations beyond
  the remat carries and the caches are not counted.

It is the counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell with XLA over 512 forced host devices. The port has no
compiler of whole programs, so XLA's fields (``memory_analysis``,
``cost_analysis``, ``collectives``) are absent, not estimated. Each cell
writes one JSON with the reference's other keys to
``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json`` (never to the
reference's ``artifacts/dryrun/``); a cell that raises is recorded with
``"status": "error"`` and the run exits 1.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh both [--capacity-bytes 80000000000]
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.shapes import SHAPES, cell_applicable
from repro_torch.launch.mesh import make_policy, make_production_mesh
from repro_torch.models.config import ModelConfig, active_param_count, param_count
from repro_torch.models.layers import model_dtype
from repro_torch.models.model import Model
from repro_torch.models.sharding import (
    MeshPolicy, named_leaves, param_specs, shard_numel,
)
from repro_torch.perf.analytic import roofline_ms, step_flops, step_hbm_bytes
from repro_torch.train.optimizer import AdamWConfig, make_optimizer

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
META = torch.device("meta")
CARRY_BYTES_AN_ELEMENT = 6  # default_accum's remat carry: bf16 + an f32 echo


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, torch.Tensor]:
    """Meta tensors of every model input of this (arch, shape) cell."""
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    K = cfg.n_codebooks
    Np = cfg.n_prefix_embeds
    S_text = S - Np  # vlm: patch stub occupies part of the backbone seq

    def tok(b, s):
        shape = (b, s, K) if K else (b, s)
        return torch.empty(shape, dtype=torch.int32, device=META)

    def prefix():
        return torch.empty((B, Np, cfg.d_model), dtype=model_dtype(cfg), device=META)

    out = {}
    if spec.kind == "train":
        out["tokens"] = tok(B, S_text)
        out["targets"] = tok(B, S_text)
        out["loss_mask"] = torch.empty((B, S_text), dtype=torch.float32, device=META)
        if Np:
            out["prefix_embeds"] = prefix()
    elif spec.kind == "prefill":
        out["tokens"] = tok(B, S_text)
        if Np:
            out["prefix_embeds"] = prefix()
    else:  # decode
        out["tokens"] = tok(B, 1)
        out["pos"] = torch.empty((B,), dtype=torch.int32, device=META)
    return out


def default_accum(cfg: ModelConfig, shape_name: str, policy: MeshPolicy) -> int:
    """Gradient-accumulation factor keeping remat carry stacks ≲ 4 GiB a
    card, as the reference picks it.

    The backward saves one (tokens a card, d_model) carry a layer (~6 B an
    element). Pick the smallest power-of-two accum dividing the global
    batch that brings the stack under budget, with the microbatch kept at
    no fewer sequences than dp ranks.
    """
    spec = SHAPES[shape_name]
    if spec.kind != "train":
        return 1
    n_dp = 1
    for a in policy.dp:
        n_dp *= policy.mesh.shape[a]
    tokens_dev = spec.global_batch * spec.seq_len // max(n_dp, 1)
    stack_bytes = tokens_dev * cfg.d_model * CARRY_BYTES_AN_ELEMENT * cfg.n_layers
    budget = 4 * 2**30
    accum = 1
    max_accum = max(spec.global_batch // max(n_dp, 1), 1)
    while (
        stack_bytes / accum > budget
        and accum * 2 <= max_accum
        and spec.global_batch % (accum * 2) == 0
    ):
        accum *= 2
    return accum


# ---------------------------------------------------------------------------
# bytes a card
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def meta_state(arch: str) -> tuple[Model, dict]:
    """The arch's ``Model`` on the meta device and its optimizer state for
    ``cfg.optimizer``, built once."""
    cfg = get_config(arch)
    model = Model(cfg, device=META)
    opt_init, _ = make_optimizer(cfg.optimizer, AdamWConfig())
    return model, opt_init(dict(model.named_parameters()))


def tree_bytes(tree, policy: MeshPolicy) -> int:
    """Bytes a card of every leaf of ``tree`` (a module's parameters or a
    nested dict of tensors), each placed by its name's spec."""
    specs = param_specs(tree, policy)
    return sum(shard_numel(policy.mesh, tuple(t.shape), specs[name]) * t.element_size()
               for name, t in named_leaves(tree))


def cache_leaf_entries(name: str, ndim: int, policy: MeshPolicy) -> tuple:
    """A cache leaf's spec entries by its name, as the reference places
    them: k/v (B, S, Hkv, Dh), conv (B, W-1, C), ssm (B, H, N, P), h (B, dr)."""
    if name in ("k", "v"):
        return policy.cache_entries()
    if name == "conv":
        return (policy.dp_spec, None, policy.tp)
    if name == "ssm":
        return (policy.dp_spec, policy.tp, None, None)
    if name == "h":
        return (policy.dp_spec, policy.tp)
    return (None,) * ndim


def cache_bytes(model: Model, batch: int, seq: int, policy: MeshPolicy) -> int:
    """Bytes a card of the caches a prefill or decode step holds."""
    total = 0
    for layer in model.init_cache(batch, seq):
        for name, t in layer.items():
            spec = policy.spec(*cache_leaf_entries(name, t.dim(), policy),
                               shape=tuple(t.shape))
            total += shard_numel(policy.mesh, tuple(t.shape), spec) * t.element_size()
    return total


def card_capacity(capacity: int | None) -> int | None:
    """``capacity`` if given, else the card's memory; None without a card."""
    if capacity is not None:
        return capacity
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return None


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_name: str, art_dir: Path = ART_DIR,
             capacity: int | None = None) -> dict:
    """Walks one cell on one mesh ('single' or 'multi'), writes its JSON
    under ``art_dir / mesh_name`` and returns the record."""
    spec = SHAPES[shape_name]
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    policy = make_policy(mesh, cfg)
    n_chips = mesh.size
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": n_chips,
        "params_total": param_count(cfg),
        "params_active": active_param_count(cfg),
        "optimizer": cfg.optimizer,
        "seq_len": spec.seq_len,
        "global_batch": spec.global_batch,
        "kind": spec.kind,
        "status": "ok",
    }
    t0 = time.perf_counter()
    try:
        model, opt_state = meta_state(arch)
        per_card = {"param_bytes": tree_bytes(model, policy)}
        if spec.kind == "train":
            accum = default_accum(cfg, shape_name, policy)
            record["accum_steps"] = accum
            per_card["optimizer_bytes"] = tree_bytes(opt_state, policy)
            n_dp = math.prod(mesh.shape[a] for a in policy.dp)
            tokens = spec.global_batch * spec.seq_len // max(n_dp, 1) // accum
            per_card["carry_bytes"] = (tokens * cfg.d_model * CARRY_BYTES_AN_ELEMENT
                                       * cfg.n_layers)
        else:
            per_card["cache_bytes"] = cache_bytes(model, spec.global_batch,
                                                  spec.seq_len, policy)
        per_card["total_bytes"] = sum(per_card.values())
        cap = card_capacity(capacity)
        per_card["capacity_bytes"] = cap
        per_card["fits"] = None if cap is None else per_card["total_bytes"] <= cap
        record["per_card"] = per_card
        flops = step_flops(cfg, shape_name)
        hbm = step_hbm_bytes(cfg, shape_name, n_chips, accum=record.get("accum_steps", 1))
        record["analytic"] = {
            "flops": flops,
            "hbm_bytes_per_device": hbm,
            "bound_ms_per_device": roofline_ms(flops["total"] / n_chips, hbm),
        }
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["walk_s"] = time.perf_counter() - t0

    out = art_dir / mesh_name
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}__{shape_name}.json").write_text(json.dumps(record, indent=1))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--capacity-bytes", type=int, default=None,
                    help="a card's memory (default: the card's own; none on a CPU)")
    ap.add_argument("--art-dir", type=Path, default=ART_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(all_arch_names())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_err = n_skip = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                if not cell_applicable(arch, shape):
                    print(f"SKIP  {mesh_name:6s} {arch:28s} {shape:12s} "
                          "(full attention at 500k)")
                    n_skip += 1
                    continue
                art = args.art_dir / mesh_name / f"{arch}__{shape}.json"
                if args.skip_existing and art.exists():
                    if json.loads(art.read_text()).get("status") == "ok":
                        n_ok += 1
                        continue
                rec = run_cell(arch, shape, mesh_name, args.art_dir, args.capacity_bytes)
                if rec["status"] == "ok":
                    n_ok += 1
                    pc = rec["per_card"]
                    fits = {None: "no capacity", True: "fits", False: "DOES NOT FIT"}
                    print(f"OK    {mesh_name:6s} {arch:28s} {shape:12s} "
                          f"{pc['total_bytes'] / 2**30:8.2f} GiB/card "
                          f"({fits[pc['fits']]})  "
                          f"{rec['analytic']['flops']['total'] / rec['chips']:.3e} "
                          f"FLOP/card  {rec['analytic']['bound_ms_per_device']:.2f} ms")
                else:
                    n_err += 1
                    print(f"ERROR {mesh_name:6s} {arch:28s} {shape:12s} {rec['error']}")
    print(f"\ndone: {n_ok} ok, {n_err} errors, {n_skip} skipped (by design)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
