"""The decoder ``Model``: full forward, prefill and decode.

Ported from ``src/repro/models/model.py`` for every family. The JAX
package stacks the layers of each ``block_pattern`` slot over the
scanned groups, with an unscanned tail where the pattern does not divide
``n_layers`` (recurrentgemma's 38 = 12 x (R, R, A) + (R, R)); here the
layers form a plain ``nn.ModuleList`` in order (group 0's slots, group
1's, ..., then the tail), and ``convert.params_from_jax`` unstacks the
JAX tree into it. Each layer's FFN follows ``cfg.ffn_kind_at(slot)``, so
maverick's ``moe_period=2`` interleaves dense and MoE layers. The model
holds its parameters, so its methods take no ``params`` argument.

Modality frontends are stubs, as in the reference: a VLM takes
precomputed patch embeddings (``prefix_embeds``, prepended after the
embedding; positions run over prefix and tokens, so the caller offsets
decode positions by the prefix length), audio takes ``n_codebooks``
token streams (tokens (B, S, K), embeddings summed over the codebooks,
logits (B, S, K, V)).

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
    RGLRU,
    Attention,
    Mamba,
    MoE,
    RMSNorm,
    _param,
    init_attn_cache,
    init_mamba_cache,
    init_rglru_cache,
    model_dtype,
    normal_,
)

_MIX = {"attn": Attention, "mamba": Mamba, "rglru": RGLRU}
_FFN = {"mlp": MLP, "moe": MoE}


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer kind, ffn kind) of every layer, in order: the scanned groups'
    pattern slots, then the tail. The FFN is the slot's
    ``ffn_kind_at``: an MLP (none after a Mamba2 mixer) or MoE."""
    pat = cfg.block_pattern
    kinds = []
    for i, kind in [*enumerate(pat)] * cfg.n_groups + [*enumerate(cfg.tail_pattern)]:
        ffn = cfg.ffn_kind_at(i)
        if ffn == "mlp" and kind == "mamba":
            ffn = "none"
        kinds.append((kind, ffn))
    return kinds


class Block(nn.Module):
    """One layer: a mixer (attention, Mamba2 or RG-LRU) and its FFN (MLP,
    MoE or none)."""

    def __init__(self, cfg: ModelConfig, kind: str, ffn: str, device):
        super().__init__()
        self.kind = kind
        self.mix = _MIX[kind](cfg, device)
        self.ffn = _FFN[ffn](cfg, device) if ffn in _FFN else None

    def init(self, generator) -> None:
        self.mix.init(generator)
        if self.ffn is not None:
            self.ffn.init(generator)

    def forward(self, x, positions, cache):
        """-> (x, aux): aux the MoE terms of this layer, or None."""
        mix_out, _ = self.mix(x, positions, cache)
        x = x + mix_out
        aux = None
        if isinstance(self.ffn, MoE):
            ffn_out, aux = self.ffn(x)
            x = x + ffn_out
        elif self.ffn is not None:
            x = x + self.ffn(x)
        return x, aux


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        dt = model_dtype(cfg)
        V, D, K = cfg.vocab_size, cfg.d_model, cfg.n_codebooks
        # audio: one embedding and head per codebook, (K, V, D) / (K, D, V)
        self.embed = _param((K, V, D) if K else (V, D), dt, self.device)
        self.head = None if cfg.tie_embeddings else _param(
            (K, D, V) if K else (D, V), dt, self.device)
        self.final_ln = RMSNorm(D, cfg, self.device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, ffn, self.device) for kind, ffn in layer_kinds(cfg)
        )

    def init(self, generator: torch.Generator) -> "Model":
        """Random parameters with the JAX ``init``'s distributions: normal
        std 0.02, output projections std 0.02/sqrt(2L), Mamba2
        ``a_log_p = log(linspace(1, 16, hs))``, ``d_skip`` 1, RG-LRU
        ``lam = log(expm1(linspace(0.3, 1.5, dr)))``, biases 0, norm
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

    def _embed(self, tokens: torch.Tensor, prefix_embeds=None) -> torch.Tensor:
        cfg = self.cfg
        tokens = tokens.to(self.device)
        if cfg.n_codebooks:  # tokens (B, S, K): codebook embeddings summed
            x = sum(nn.functional.embedding(tokens[..., k], self.embed[k])
                    for k in range(cfg.n_codebooks))
        else:
            x = nn.functional.embedding(tokens, self.embed)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                                 device=x.device).to(x.dtype)
        if prefix_embeds is not None:
            prefix = torch.as_tensor(prefix_embeds).to(device=x.device, dtype=x.dtype)
            x = torch.cat([prefix, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_ln(x)
        if self.cfg.n_codebooks:
            if self.head is None:
                return torch.einsum("bsd,kvd->bskv", x, self.embed)
            return torch.einsum("bsd,kdv->bskv", x, self.head)
        return x @ (self.embed.T if self.head is None else self.head)

    def _stack(self, x, positions, caches):
        """All layers in order -> (x, aux), aux the MoE terms summed over
        the layers (0 without MoE layers)."""
        if caches is None:
            caches = [None] * len(self.layers)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"moe_load_balance": zero, "moe_z_loss": zero}
        for layer, cache in zip(self.layers, caches):
            x, layer_aux = layer(x, positions, cache)
            if layer_aux is not None:
                aux = {k: v + layer_aux[k] for k, v in aux.items()}
        return x, aux

    # -- public API ------------------------------------------------------------

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor, prefix_embeds=None):
        """Full-sequence forward. tokens (B, S) or, for audio, (B, S, K);
        ``prefix_embeds`` (B, P, D) patch embeddings of a VLM -> (logits
        (B, P + S, V) or (B, P + S, K, V), aux): aux holds the MoE terms
        ``moe_load_balance`` and ``moe_z_loss`` summed over the layers."""
        x = self._embed(tokens, prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._stack(x, positions, None)
        return self._logits(x), aux

    def init_cache(self, batch: int, max_seq: int) -> list[dict]:
        dt = model_dtype(self.cfg)
        make = {
            "attn": lambda: init_attn_cache(self.cfg, batch, max_seq, dt, self.device),
            "mamba": lambda: init_mamba_cache(self.cfg, batch, self.device),
            "rglru": lambda: init_rglru_cache(self.cfg, batch, self.device),
        }
        return [make[layer.kind]() for layer in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int, prefix_embeds=None):
        """Process a prompt (B, S[, K]) after the optional ``prefix_embeds``
        (B, P, D), build the caches -> (last logits (B, 1, V) or
        (B, 1, K, V), caches). ``max_seq`` counts the prefix."""
        x = self._embed(tokens, prefix_embeds)
        caches = self.init_cache(x.shape[0], max_seq)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._stack(x, positions, caches)
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens_new: torch.Tensor, caches, pos: torch.Tensor):
        """One decode step. tokens_new (B, 1[, K]); pos int32[B], the
        lengths so far, prefix included (the cache is written at pos[0] for
        the whole batch) -> (logits (B, 1, V) or (B, 1, K, V), caches
        updated in place)."""
        x = self._embed(tokens_new)
        pos = pos.to(self.device)
        positions = pos[:, None] if pos.dim() == 1 else pos
        x, _ = self._stack(x, positions, caches)
        return self._logits(x), caches
