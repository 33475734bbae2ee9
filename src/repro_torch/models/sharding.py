"""Mesh/sharding policy: DP(+pod) × FSDP × TP/EP over a torch
``DeviceMesh`` (DTensor), or as a description of one.

``src/repro/models/sharding.py`` maps every tensor class onto a device
mesh and lets GSPMD place it. Here the same policy does so with DTensor,
PyTorch's counterpart of ``NamedSharding``: each spec is the tuple of
axis entries (None, an axis name, or a tuple of names) that
``jax.sharding.PartitionSpec`` holds in the reference, pruned as
``prune_spec`` prunes it there, and ``placements`` turns it into one
``Shard(dim)`` / ``Replicate()`` a mesh dim (a tuple entry shards its dim
over each of its axes, major to minor in the mesh's order).

  dp axes  ('pod','data') / ('data',) — batch parallel + FSDP param shards
  tp axis  'model'                    — heads / d_ff / vocab / experts

A policy holds a ``MeshShape`` (axis names and sizes, no devices), which
``launch/dryrun.py`` reads to count each card's share, and optionally a
``DeviceMesh`` over the ranks of a ``torch.distributed`` world, its dims
named as the ``MeshShape``'s axes (``launch/mesh.py::make_device_mesh``).
With a device mesh the policy *places*: ``place_params`` lays every
parameter out by ``param_specs``, ``use`` gathers a parameter's FSDP (dp)
shards at the point of use (DTensor's autograd reduce-scatters its
gradient back, as GSPMD does), ``constrain`` and its ``act_*`` /
``cache`` helpers redistribute an activation to its pruned spec (uneven
dims allowed, as GSPMD pads), and ``shard_batch`` shards a global batch
on dp along dim 0. It places even when every axis has size 1, so one card
runs the same path. Without a device mesh the helpers return the tensor
unchanged when every axis has size 1 (a policy of one card, as
``launch/train.py`` passes for one process), and over a larger mesh they
raise ``NotImplementedError`` naming the multi-card path and how to build
a device mesh.

Parameter specs are derived from leaf *names* via the rule table below
and apply to the trailing dims, so a name of the port (``layers.3.mix.wq``)
reaches the same rule as the JAX tree path it comes from
(``groups/slot<i>/mix/wq``, stacked over the groups, ``models/convert.py``).

KV-cache sharding is adaptive: if the arch's kv-head count divides the tp
axis the heads are sharded, otherwise the cache's sequence dim.
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from repro_torch.kernels.ops import is_placed

MULTI_CARD = (
    "the multi-card path needs a policy over a device mesh: a policy that only "
    "describes a mesh places nothing; start a torch.distributed world "
    "(launch/mesh.py::init_distributed), build its mesh with "
    "launch/mesh.py::make_device_mesh and pass make_policy(that mesh, cfg), or "
    "pass a policy whose every mesh axis has size 1, or none"
)


@dataclass(frozen=True)
class MeshShape:
    """A device mesh's axis sizes and names, with no devices: what
    ``prune_spec`` and the policy read of ``jax.sharding.Mesh``."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axes {self.axis_names} differ")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def prune_spec(mesh, shape, entries, allow_uneven: bool = False) -> tuple:
    """Drop (or shrink) spec entries whose mesh size doesn't divide the dim.

    Production archs have dims like kv_heads=8 on a 16-way tp axis or
    batch=1 on the dp axes: those dims fall back to replication (or a
    dividing prefix of the dp tuple, e.g. batch 2 on ('pod','data') shards
    over 'pod' only). ``allow_uneven`` (activation constraints) keeps an
    axis as long as the dim is at least the axis size. ``mesh`` is read
    only for its ``.shape`` ({axis: size}).
    """
    out = []
    for d, entry in enumerate(entries):
        if entry is None or d >= len(shape):
            out.append(None)
            continue
        ok = (
            (lambda n, a: n % a == 0) if not allow_uneven
            else (lambda n, a: n >= a)
        )
        if isinstance(entry, tuple):
            chosen = None
            for take in range(len(entry), 0, -1):
                sub = entry[:take]
                if ok(shape[d], _axis_size(mesh, sub)):
                    chosen = sub if take > 1 else sub[0]
                    break
            out.append(chosen)
        else:
            out.append(entry if ok(shape[d], _axis_size(mesh, entry)) else None)
    return tuple(out)


def shard_numel(mesh, shape, spec) -> int:
    """Elements of one card's shard of a tensor of ``shape`` laid out by
    ``spec`` (pruned, so each sharded dim divides exactly)."""
    n = math.prod(shape)
    for entry in spec:
        n //= _axis_size(mesh, entry)
    return n


def _dtensor():
    from torch.distributed import tensor

    return tensor


@dataclass(frozen=True)
class MeshPolicy:
    mesh: MeshShape | None = None
    dp: tuple[str, ...] = ()  # data-parallel + FSDP axes
    tp: str | None = None  # tensor/expert axis
    shard_cache_seq: bool = False  # decode cache: shard S instead of heads
    seq_parallel: bool = False  # Megatron-SP: hidden (B,S,D) shards S on tp
    # the ranks the policy places tensors on; its dims named as mesh's axes
    device_mesh: object = field(default=None, compare=False)

    def __post_init__(self):
        dm = self.device_mesh
        if dm is None:
            return
        shape = MeshShape(tuple(dm.shape), tuple(dm.mesh_dim_names or ()))
        if self.mesh is None:
            object.__setattr__(self, "mesh", shape)
        elif self.mesh != shape:
            raise ValueError(f"device mesh {shape} is not the policy's mesh {self.mesh}")

    @property
    def dp_spec(self):
        return self.dp if self.dp else None

    @property
    def one_card(self) -> bool:
        """No mesh, or every axis of size 1."""
        return self.mesh is None or all(s == 1 for s in self.mesh.sizes)

    @property
    def placed(self) -> bool:
        """Whether the policy places tensors over a device mesh."""
        return self.device_mesh is not None

    def spec(self, *axes, shape=None) -> tuple:
        """The entries ``axes``, pruned against ``shape`` when given (the
        reference's ``sharding``, without the devices)."""
        assert self.mesh is not None
        return prune_spec(self.mesh, shape, axes) if shape is not None else tuple(axes)

    def placements(self, spec) -> list:
        """A spec's entries -> one placement a mesh dim: ``Shard(d)`` on each
        mesh dim named in entry d, ``Replicate()`` on the others. A tuple
        entry must list its axes in the mesh's order (major to minor)."""
        t = _dtensor()
        names = self.mesh.axis_names
        out = [t.Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
            for m in dims:
                out[m] = t.Shard(d)
        return out

    def constrain(self, x: torch.Tensor, *axes) -> torch.Tensor:
        """``x`` redistributed to the entries ``axes`` (pruned, uneven dims
        allowed); unchanged on one card without a device mesh."""
        if not self.placed:
            if self.one_card:
                return x
            raise NotImplementedError(
                f"constraining {tuple(x.shape)} to {axes} on mesh {self.mesh}: "
                f"{MULTI_CARD}")
        if not is_placed(x):
            raise TypeError(f"constraining a plain tensor {tuple(x.shape)} to {axes}: "
                            "under a device-mesh policy every activation is a DTensor")
        return x.redistribute(self.device_mesh, self.placements(
            prune_spec(self.mesh, x.shape, axes, allow_uneven=True)))

    # -- placing whole tensors ---------------------------------------------
    def distribute(self, x: torch.Tensor, spec) -> torch.Tensor:
        """A full tensor, the same on every rank, laid out by ``spec`` (each
        rank keeps its own shard: no communication)."""
        return _dtensor().distribute_tensor(x, self.device_mesh, self.placements(spec),
                                            src_data_rank=None)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """A full tensor, the same on every rank, as a replicated DTensor;
        unchanged without a device mesh or when already placed."""
        if not self.placed or is_placed(x):
            return x
        return self.distribute(x, ())

    def shard_batch(self, x) -> torch.Tensor:
        """A global batch tensor, the same on every rank, sharded on dp along
        dim 0 (a dividing prefix of the dp axes, or replicated, as
        ``prune_spec`` prunes); unchanged without a device mesh or when
        already placed."""
        if not self.placed or is_placed(x):
            return x
        x = torch.as_tensor(x)
        return self.distribute(x, prune_spec(self.mesh, x.shape, (self.dp_spec,)))

    def use(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter at its compute placement: its shards on the dp (FSDP)
        axes gathered, those on tp kept. The gradient flows back to the
        parameter's own placement (a reduce-scatter over dp). Unchanged
        when ``p`` is not a DTensor."""
        if not is_placed(p):
            return p
        dp_dims = {self.mesh.axis_names.index(a) for a in self.dp}
        want = [_dtensor().Replicate() if m in dp_dims else pl
                for m, pl in enumerate(p.placements)]
        return p if want == list(p.placements) else p.redistribute(p.device_mesh, want)

    @staticmethod
    def full(x):
        """A DTensor gathered whole on every rank (Partial sums reduced); a
        plain tensor unchanged."""
        return x.full_tensor() if is_placed(x) else x

    # -- activation constraint helpers --------------------------------------
    def act_bsd(self, x):  # (B, S, D) hidden
        if self.seq_parallel and x.shape[-2] > 1:  # decode (S=1) opts out
            return self.constrain(x, self.dp_spec, self.tp, None)
        return self.constrain(x, self.dp_spec, None, None)

    def act_bshd(self, x):  # (B, S, H, Dh) per-head
        return self.constrain(x, self.dp_spec, None, self.tp, None)

    def act_bsf(self, x):  # (B, S, F) ffn hidden
        return self.constrain(x, self.dp_spec, None, self.tp)

    def act_logits(self, x):  # (B, S, V)
        return self.constrain(x, self.dp_spec, None, self.tp)

    def act_ecd(self, x):  # (E, C, D) MoE dispatch buffers
        return self.constrain(x, self.tp, None, None)

    def cache_entries(self):  # (B, S, Hkv, Dh)
        if self.shard_cache_seq:
            return (self.dp_spec, self.tp, None, None)
        return (self.dp_spec, None, self.tp, None)

    def cache_spec(self, shape) -> tuple:
        """The decode cache's entries pruned against its ``shape`` (exact,
        as the reference's ``cache`` prunes)."""
        return prune_spec(self.mesh, shape, self.cache_entries())

    def cache(self, x):
        if not self.placed:
            return self.constrain(x, *self.cache_entries())
        return x.redistribute(self.device_mesh, self.placements(self.cache_spec(x.shape)))


# The active policy, a module-level context so that model code can stay
# signature-stable; the trainer installs the one it was given.
_ACTIVE = MeshPolicy()


def active_policy() -> MeshPolicy:
    return _ACTIVE


@contextmanager
def use_policy(policy: MeshPolicy):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = policy
    try:
        yield policy
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# Parameter sharding rules (FSDP over dp, TP/EP over tp), by leaf name,
# applied to the TRAILING dims; leading dims get None.
# ---------------------------------------------------------------------------

_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / head: vocab over tp, d_model over dp (FSDP)
    (r"embed", ("tp", "dp")),
    (r"head", ("dp", "tp")),
    # attention
    (r"\bwq$", ("dp", "tp", None)),
    (r"\bwk$", ("dp", "tp", None)),
    (r"\bwv$", ("dp", "tp", None)),
    (r"\bwo$", ("tp", None, "dp")),
    # mlp
    (r"w_gate$", ("dp", "tp")),
    (r"w_up$", ("dp", "tp")),
    (r"w_down$", ("tp", "dp")),
    # moe
    (r"router", (None, None)),
    (r"experts_gate$", ("tp", "dp", None)),
    (r"experts_up$", ("tp", "dp", None)),
    (r"experts_down$", ("tp", None, "dp")),
    (r"shared_(gate|up)$", ("dp", "tp")),
    (r"shared_down$", ("tp", "dp")),
    # mamba
    (r"in_proj$", ("dp", "tp")),
    (r"out_proj$", ("tp", "dp")),
    (r"conv_w$", (None, "tp")),
    # rglru
    (r"\bw_in$", ("dp", "tp")),
    (r"\bw_gate_branch$", ("dp", "tp")),
    (r"\bw_a$", (None, "tp")),
    (r"\bw_x$", (None, "tp")),
    (r"w_rnn_out$", ("tp", "dp")),
]


def _spec_for(name: str, shape, policy: MeshPolicy) -> tuple:
    ndim = len(shape)
    for pat, rule in _PARAM_RULES:
        if re.search(pat, name):
            trailing = [
                policy.dp_spec if r == "dp" else policy.tp if r == "tp" else None
                for r in rule
            ]
            if len(trailing) > ndim:  # tiny/fused param; replicate
                return ()
            entries = [None] * (ndim - len(trailing)) + trailing
            return prune_spec(policy.mesh, shape, entries)
    return ()  # norms, biases, scalars: replicated


def named_leaves(tree, prefix: str = ""):
    """(dotted name, tensor) of a module's parameters or of a nested dict
    of tensors (an optimizer state: ``mu.layers.3.mix.wq``)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters(prefix=prefix.rstrip("."))
        return
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from named_leaves(val, name + ".")
        else:
            yield name, val


def param_specs(tree, policy: MeshPolicy) -> dict[str, tuple]:
    """{leaf name: spec} over the port's parameter names (a ``Model``) or a
    nested dict of tensors keyed by them, by leaf name."""
    return {name: _spec_for(name, tuple(t.shape), policy)
            for name, t in named_leaves(tree)}


def place_params(module: torch.nn.Module, policy: MeshPolicy) -> None:
    """Every parameter of ``module`` that is not yet a DTensor becomes one,
    laid out over ``policy.device_mesh`` by ``param_specs`` from its
    current (full) value, which must be the same on every rank."""
    specs = param_specs(module, policy)
    for name, p in list(module.named_parameters()):
        if is_placed(p):
            continue
        owner, _, leaf = name.rpartition(".")
        placed = policy.distribute(p.detach(), specs[name])
        setattr(module.get_submodule(owner), leaf,
                torch.nn.Parameter(placed, requires_grad=p.requires_grad))


def set_full_(p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Copy a full ``value`` (the same on every rank) into ``p`` in place:
    a DTensor takes its own shard of it."""
    if is_placed(p):
        value = _dtensor().distribute_tensor(
            value.to(device=p.device, dtype=p.dtype), p.device_mesh, p.placements,
            src_data_rank=None)
    return p.copy_(value)
