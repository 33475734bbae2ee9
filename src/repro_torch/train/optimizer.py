"""AdamW with f32 master weights, an optional compressed-gradient path,
and Adafactor: ``src/repro/train/optimizer.py`` in plain torch.

The state is a dict of tensors keyed as the parameter tree it was made
from (a nested dict of tensors, or the port ``Model``'s flat name ->
parameter dict):

  {"master": f32 params, "mu": f32, "nu": f32, "count": int32 scalar,
   "ef": f32 error-feedback residuals (only when compression is on)}

Gradient compression (int8, error feedback): each leaf is quantized to
int8 with a per-leaf scale ``max|g| / 127`` (rounding half to even, as
``jnp.round`` does), the residual kept and added back at the next step:
the numbers a compressed all-reduce would deliver.

``adamw_update`` updates ``mu``, ``nu``, ``master`` and ``ef`` in place and
returns the new state around them (the JAX function returns new trees;
in place keeps one copy of the 12 bytes a parameter of optimizer state on
the card). The arithmetic is the reference's, leaf by leaf, in f32.

Leaves may be DTensors (the trainer under a device-mesh policy): the
moments and master weights take their layout, each leaf's int8 scale is
its whole leaf's largest magnitude and the global gradient norm sums every
element once, as the reference's do under GSPMD.

Adafactor factors the second moment of every leaf of two or more axes
over its last two. On the port's per-layer tree a norm weight is one
axis; the JAX tree stacks it over the groups into two, so there it is
factored across the groups: the two agree on the same tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.sharding import MeshPolicy


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False  # int8 + error feedback


def tree_leaves(tree) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) of a nested dict of tensors, keys sorted at each level
    (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return [(( key,) + path, leaf) for key in sorted(tree)
                for path, leaf in tree_leaves(tree[key])]
    return [((), tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves or
    subtrees of ``rest``) -> a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)


def _count(params) -> torch.Tensor:
    device = tree_leaves(params)[0][1].device
    return torch.zeros((), dtype=torch.int32, device=device)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """AdamW state for ``params`` (every leaf copied to f32 as master)."""
    state = {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "mu": tree_map(_zeros_f32, params),
        "nu": tree_map(_zeros_f32, params),
        "count": _count(params),
    }
    if cfg.compress_grads:
        state["ef"] = tree_map(_zeros_f32, params)
    return state


def _quantize_int8(g: torch.Tensor, ef: torch.Tensor):
    """Error-feedback int8 quantization of one leaf -> (deq, new_ef)."""
    gf = g.to(torch.float32) + ef
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


def adamw_update(grads, state: dict, cfg: AdamWConfig) -> tuple[dict, dict]:
    """One AdamW step -> (new f32 master params, new state). ``grads`` has
    the state's tree; ``mu``, ``nu``, ``master`` and ``ef`` change in place."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    leaves = tree_leaves(grads)
    if cfg.compress_grads:
        g32 = []
        for path, g in leaves:
            ef = _at(state["ef"], path)
            deq, new_ef = _quantize_int8(g, ef)
            ef.copy_(new_ef)
            g32.append(deq)
    else:
        g32 = [None] * len(leaves)  # cast leaf by leaf below

    def f32(i):
        return g32[i] if g32[i] is not None else leaves[i][1].to(torch.float32)

    # each leaf's sum whole on every rank before the stack: leaves differ in layout
    squares = [MeshPolicy.full(torch.sum(torch.square(f32(i))))
               for i in range(len(leaves))]
    gnorm = torch.sqrt(torch.sum(torch.stack(squares)))
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=count.device),
                        count.to(torch.float32))
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=count.device),
                        count.to(torch.float32))
    for i, (path, _) in enumerate(leaves):
        g = f32(i) * clip
        g32[i] = None
        m, v, p = (_at(state[k], path) for k in ("mu", "nu", "master"))
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p
        p.sub_(lr * step)
    new_state = {"master": state["master"], "mu": state["mu"], "nu": state["nu"],
                 "count": count}
    if cfg.compress_grads:
        new_state["ef"] = state["ef"]
    return state["master"], new_state


def cast_like(master, params_template):
    """f32 master -> compute-dtype params."""
    return tree_map(lambda m, p: m.to(p.dtype), master, params_template)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment): for models whose
# AdamW state (12 B/param) exceeds the memory at hand.
# ---------------------------------------------------------------------------


def init_adafactor_state(params, cfg: AdamWConfig) -> dict:
    def stats(p):
        if p.dim() >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                  device=p.device),
            }
        return {"v": _zeros_f32(p)}

    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "stats": tree_map(stats, params),
        "count": _count(params),
    }


def adafactor_update(grads, state: dict, cfg: AdamWConfig) -> tuple[dict, dict]:
    """One Adafactor step -> (new master, new state), functional."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    decay = 1.0 - torch.pow(count.to(torch.float32), -0.8)
    eps1 = 1e-30

    def upd(g, st, p):
        g = g.to(torch.float32)
        g2 = g * g + eps1
        if g.dim() >= 2:
            vr = decay * st["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * st["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps1)
            vhat = vr[..., :, None] * vc[..., None, :] / denom[..., None]
            u = g * torch.rsqrt(vhat + eps1)
            new_st = {"vr": vr, "vc": vc}
        else:
            v = decay * st["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(v + eps1)
            new_st = {"v": v}
        # update clipping (Adafactor d=1.0)
        rms_u = torch.sqrt(torch.mean(u * u) + eps1)
        u = u / torch.clamp_min(rms_u, 1.0)
        return p - lr * (u + cfg.weight_decay * p), new_st

    master, stats = {}, {}
    for path, g in tree_leaves(grads):
        new_p, new_st = upd(g, _at(state["stats"], path), _at(state["master"], path))
        _put(master, path, new_p)
        _put(stats, path, new_st)
    return master, {"master": master, "stats": stats, "count": count}


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_optimizer(kind: str, cfg: AdamWConfig):
    """Returns (init_fn, update_fn) for 'adamw' | 'adafactor'."""
    if kind == "adafactor":
        return (
            lambda p: init_adafactor_state(p, cfg),
            lambda g, s: adafactor_update(g, s, cfg),
        )
    return (
        lambda p: init_opt_state(p, cfg),
        lambda g, s: adamw_update(g, s, cfg),
    )
