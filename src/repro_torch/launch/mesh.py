"""Production meshes and the ``MeshPolicy`` for them, as descriptions.

``src/repro/launch/mesh.py`` builds ``jax.sharding.Mesh`` objects over
real or forced host devices. Here a mesh is a ``models.sharding.
MeshShape`` (axis sizes and names): building one touches no device, so
the dry run can describe a 512-card deployment from one process.
"""

from __future__ import annotations

import torch

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


def make_policy(mesh: MeshShape, model_cfg=None, *,
                seq_parallel: bool = False) -> MeshPolicy:
    """MeshPolicy for a mesh built by make_production_mesh.

    * KV-cache sharding is adaptive: shard the cache's sequence dim when
      the arch's kv-head count doesn't divide the tp axis.
    * Sub-1B-param models drop TP entirely (the 'model' axis becomes an
      extra FSDP/data axis).
    * seq_parallel defaults off, as in the reference.
    """
    from repro_torch.models.config import param_count

    axes = mesh.axis_names
    dp = tuple(a for a in axes if a in ("pod", "data"))
    tp = "model" if "model" in axes else None
    shard_cache_seq = False
    if model_cfg is not None and tp is not None:
        if param_count(model_cfg) < TP_MIN_PARAMS:
            return MeshPolicy(
                mesh=mesh, dp=dp + (tp,), tp=None,
                shard_cache_seq=False, seq_parallel=False,
            )
        tp_size = mesh.shape[tp]
        shard_cache_seq = model_cfg.n_kv_heads % tp_size != 0
    return MeshPolicy(
        mesh=mesh, dp=dp, tp=tp, shard_cache_seq=shard_cache_seq,
        seq_parallel=seq_parallel and tp is not None,
    )


def make_host_mesh(n_devices: int | None = None, model: int = 1) -> MeshShape:
    """A (data, model) mesh over this host's cards: ``n_devices`` of them,
    by default ``torch.cuda.device_count()`` (1 where there is no card:
    the process itself, as JAX counts its CPU as one device)."""
    n = n_devices or torch.cuda.device_count() or 1
    if n % model:
        raise ValueError(f"{n} devices do not split into model axes of {model}")
    return MeshShape((n // model, model), ("data", "model"))
