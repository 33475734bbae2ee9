"""The decoder ``Model``: full forward, prefill and decode.

Ported from ``src/repro/models/model.py`` for the dense and SSM families.
The JAX package stacks the layers of each ``block_pattern`` slot over the
scanned groups; here the layers form a plain ``nn.ModuleList`` in order
(group 0's slots, group 1's, ..., then the tail), and
``convert.params_from_jax`` unstacks the JAX tree into it. The model
holds its parameters, so its methods take no ``params`` argument.

Caches are one dict of tensors per layer (``init_cache``), updated in
place by ``prefill`` and ``decode_step``, which also return them.

``Model(cfg)`` places its parameters on the CUDA card and raises when
there is none; pass ``device="cpu"`` to run on the CPU (the tests do).
Training is not ported: the kernels have no backward, so the forward
methods run under ``torch.no_grad``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.csr import resolve_device
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    Mamba,
    RMSNorm,
    _param,
    check_supported,
    init_attn_cache,
    init_mamba_cache,
    model_dtype,
    normal_,
)

_MIX = {"attn": Attention, "mamba": Mamba}


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer kind, ffn kind) of every layer, in order: the scanned groups'
    pattern slots, then the tail."""
    pat = cfg.block_pattern
    kinds = []
    for i, kind in [*enumerate(pat)] * cfg.n_groups + [*enumerate(cfg.tail_pattern)]:
        ffn = cfg.ffn_kind_at(i)
        kinds.append((kind, "mlp" if ffn == "mlp" and kind != "mamba" else "none"))
    return kinds


class Block(nn.Module):
    """One layer: mixer (attention or Mamba2) and, for attention, the MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, ffn: str, device):
        super().__init__()
        self.kind = kind
        self.mix = _MIX[kind](cfg, device)
        self.ffn = MLP(cfg, device) if ffn == "mlp" else None

    def init(self, generator) -> None:
        self.mix.init(generator)
        if self.ffn is not None:
            self.ffn.init(generator)

    def forward(self, x, positions, cache):
        mix_out, _ = self.mix(x, positions, cache)
        x = x + mix_out
        if self.ffn is not None:
            x = x + self.ffn(x)
        return x


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        dt = model_dtype(cfg)
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = _param((V, D), dt, self.device)
        self.head = None if cfg.tie_embeddings else _param((D, V), dt, self.device)
        self.final_ln = RMSNorm(D, cfg, self.device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, ffn, self.device) for kind, ffn in layer_kinds(cfg)
        )

    def init(self, generator: torch.Generator) -> "Model":
        """Random parameters with the JAX ``init``'s distributions: normal
        std 0.02, output projections std 0.02/sqrt(2L), Mamba2
        ``a_log_p = log(linspace(1, 16, hs))``, ``d_skip`` 1, biases 0, norm
        weights stored zero-centered. Drawn from ``generator`` (on its
        device), so a seed gives the same model; JAX's threefry draws are
        not reproduced."""
        normal_(self.embed, 0.02, generator)
        if self.head is not None:
            normal_(self.head, 0.02, generator)
        self.final_ln.init(generator)
        for layer in self.layers:
            layer.init(generator)
        return self

    # -- forward machinery ---------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = nn.functional.embedding(tokens.to(self.device), self.embed)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=torch.float32,
                                 device=x.device).to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_ln(x)
        return x @ (self.embed.T if self.head is None else self.head)

    def _stack(self, x, positions, caches):
        if caches is None:
            caches = [None] * len(self.layers)
        for layer, cache in zip(self.layers, caches):
            x = layer(x, positions, cache)
        return x

    # -- public API ------------------------------------------------------------

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor):
        """Full-sequence forward. tokens (B, S) -> (logits (B, S, V), aux);
        aux holds the JAX package's MoE terms, 0 here (no MoE layers)."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        logits = self._logits(self._stack(x, positions, None))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, {"moe_load_balance": zero, "moe_z_loss": zero}

    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        dt = model_dtype(self.cfg)
        return [
            init_attn_cache(self.cfg, batch, max_seq, dt, self.device)
            if layer.kind == "attn"
            else init_mamba_cache(self.cfg, batch, self.device)
            for layer in self.layers
        ]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int):
        """Process a prompt (B, S), build the caches -> (last logits
        (B, 1, V), caches)."""
        x = self._embed(tokens)
        caches = self.init_cache(x.shape[0], max_seq)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._stack(x, positions, caches)
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens_new: torch.Tensor, caches, pos: torch.Tensor):
        """One decode step. tokens_new (B, 1); pos int32[B], the lengths so
        far (the cache is written at pos[0] for the whole batch) -> (logits
        (B, 1, V), caches updated in place)."""
        x = self._embed(tokens_new)
        pos = pos.to(self.device)
        positions = pos[:, None] if pos.dim() == 1 else pos
        x = self._stack(x, positions, caches)
        return self._logits(x), caches
