"""Meshes and the ``MeshPolicy`` for them: descriptions, and device
meshes over the ranks of a ``torch.distributed`` world.

``src/repro/launch/mesh.py`` builds ``jax.sharding.Mesh`` objects over
real or forced host devices. Here a description is a ``models.sharding.
MeshShape`` (axis sizes and names): building one touches no device, so
the dry run can describe a 512-card deployment from one process. A
device mesh (``make_device_mesh``) is a ``torch.distributed.DeviceMesh``
over the current process group, its dims named as the axes: a policy
built on it (``make_policy``) places tensors across the ranks.
``init_distributed`` starts that group from torchrun's environment
(``python -m torch.distributed.run --nproc-per-node N ...``): NCCL, one
card a rank, on ``cuda``; gloo only when the caller asks for the CPU.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.models.sharding import MeshPolicy, MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 cards per pod; 2×16×16 = 512 cards across 2 pods."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


# Models below this size pay more in TP activation collectives than TP
# saves in memory; they run pure DP/FSDP with the 'model' axis folded into
# the data axes, as the reference's policy does.
TP_MIN_PARAMS = 1_000_000_000


def make_policy(mesh, model_cfg=None, *, seq_parallel: bool = False) -> MeshPolicy:
    """MeshPolicy for a mesh: a ``MeshShape`` (make_production_mesh,
    make_host_mesh), which the policy only describes, or a ``DeviceMesh``
    (make_device_mesh), over which it places tensors.

    * KV-cache sharding is adaptive: shard the cache's sequence dim when
      the arch's kv-head count doesn't divide the tp axis.
    * Sub-1B-param models drop TP entirely (the 'model' axis becomes an
      extra FSDP/data axis).
    * seq_parallel defaults off, as in the reference.
    """
    from repro_torch.models.config import param_count

    device_mesh = None
    if not isinstance(mesh, MeshShape):
        device_mesh = mesh
        mesh = MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    axes = mesh.axis_names
    dp = tuple(a for a in axes if a in ("pod", "data"))
    tp = "model" if "model" in axes else None
    shard_cache_seq = False
    if model_cfg is not None and tp is not None:
        if param_count(model_cfg) < TP_MIN_PARAMS:
            return MeshPolicy(
                mesh=mesh, dp=dp + (tp,), tp=None,
                shard_cache_seq=False, seq_parallel=False, device_mesh=device_mesh,
            )
        tp_size = mesh.shape[tp]
        shard_cache_seq = model_cfg.n_kv_heads % tp_size != 0
    return MeshPolicy(
        mesh=mesh, dp=dp, tp=tp, shard_cache_seq=shard_cache_seq,
        seq_parallel=seq_parallel and tp is not None, device_mesh=device_mesh,
    )


def make_host_mesh(n_devices: int | None = None, model: int = 1) -> MeshShape:
    """A (data, model) mesh over this host's cards: ``n_devices`` of them,
    by default ``torch.cuda.device_count()`` (1 where there is no card:
    the process itself, as JAX counts its CPU as one device)."""
    n = n_devices or torch.cuda.device_count() or 1
    if n % model:
        raise ValueError(f"{n} devices do not split into model axes of {model}")
    return MeshShape((n // model, model), ("data", "model"))


def init_distributed(device: str = "cuda") -> tuple[int, int]:
    """Joins the ``torch.distributed`` world that torchrun's environment
    describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) -> (rank, world size). On ``cuda`` each rank takes
    card ``LOCAL_RANK`` and the group is NCCL's; ``device="cpu"`` uses gloo.
    A world already joined is kept."""
    if not dist.is_initialized():
        if device == "cpu":
            backend = "gloo"
        else:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            backend = "nccl"
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def make_device_mesh(sizes, axes=("data", "model"), device: str = "cuda"):
    """A ``DeviceMesh`` of ``sizes`` over the ranks of the current process
    group, its dims named ``axes``; the ranks fill it in row-major order."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes, axes = tuple(sizes), tuple(axes)
    if math.prod(sizes) != dist.get_world_size():
        raise ValueError(f"a mesh of {sizes} over a world of {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, sizes, mesh_dim_names=axes)
