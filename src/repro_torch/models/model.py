"""The decoder ``Model``: full forward, loss, prefill and decode.

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
Its parameters are trainable: ``apply`` and ``loss`` leave grad mode to
the caller (the reference's full-sequence forward is its training
forward), ``prefill`` and ``decode_step`` run under ``torch.no_grad``. With
``cfg.remat == "full"`` and gradients on, each group of ``block_pattern``
layers is recomputed in the backward pass (the reference's
``jax.checkpoint`` of its scan body); the tail layers are not, as there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.csr import resolve_device
from .config import ModelConfig
from .layers import (
    MLP,
    recompute,
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
from .sharding import active_policy

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
        """-> (x, aux): aux the MoE terms of this layer, or None. The
        reference wraps each residual join's branch in ``grad_cast`` (its
        cotangent cast to the branch's dtype); autograd already gives the
        branch a gradient of its own dtype, so the joins are plain adds."""
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
        return active_policy().act_bsd(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_ln(x)
        if self.cfg.n_codebooks:
            if self.head is None:
                logits = torch.einsum("bsd,kvd->bskv", x, self.embed)
            else:
                logits = torch.einsum("bsd,kdv->bskv", x, self.head)
        else:
            logits = x @ (self.embed.T if self.head is None else self.head)
        return active_policy().act_logits(logits)

    def _layers(self, x, positions, layers, caches):
        """``layers`` in order -> (x, load-balance sum, z-loss sum)."""
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        lb = z = zero
        for layer, cache in zip(layers, caches):
            x, layer_aux = layer(x, positions, cache)
            if layer_aux is not None:
                lb = lb + layer_aux["moe_load_balance"]
                z = z + layer_aux["moe_z_loss"]
        return x, lb, z

    def _stack(self, x, positions, caches):
        """All layers in order -> (x, aux), aux the MoE terms summed over
        the layers (0 without MoE layers). Without caches, under
        ``remat == "full"``, each group of ``block_pattern`` layers is one
        recomputed unit (the tail layers run plainly)."""
        n = len(self.layers)
        if caches is not None or self.cfg.remat != "full":
            x, lb, z = self._layers(x, positions, self.layers, caches or [None] * n)
            return x, {"moe_load_balance": lb, "moe_z_loss": z}
        pat = len(self.cfg.block_pattern)
        n_units = self.cfg.n_groups
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        lb = z = zero
        for g in range(n_units):
            group = self.layers[g * pat:(g + 1) * pat]
            x, glb, gz = recompute(
                lambda h, grp=group: self._layers(h, positions, grp, [None] * pat), x)
            lb, z = lb + glb, z + gz
        tail = self.layers[n_units * pat:]
        x, tlb, tz = self._layers(x, positions, tail, [None] * len(tail))
        return x, {"moe_load_balance": lb + tlb, "moe_z_loss": z + tz}

    # -- public API ------------------------------------------------------------

    def _hidden(self, tokens: torch.Tensor, prefix_embeds=None):
        """Embed + every layer -> (hidden (B, P + S, D), aux)."""
        x = self._embed(tokens, prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        return self._stack(x, positions, None)

    def apply(self, tokens: torch.Tensor, prefix_embeds=None):
        """Full-sequence forward. tokens (B, S) or, for audio, (B, S, K);
        ``prefix_embeds`` (B, P, D) patch embeddings of a VLM -> (logits
        (B, P + S, V) or (B, P + S, K, V), aux): aux holds the MoE terms
        ``moe_load_balance`` and ``moe_z_loss`` summed over the layers.
        Grad mode is the caller's: call it under ``torch.no_grad()`` to
        only evaluate."""
        x, aux = self._hidden(tokens, prefix_embeds)
        return self._logits(x), aux

    #: tokens of logits materialized per cross-entropy chunk (the
    #: reference's ``LOSS_CHUNK_TOKENS``)
    LOSS_CHUNK_TOKENS = 16_384

    def _ce_terms(self, x_c, targets_c, mask_c):
        """Sum of the masked next-token NLL over one chunk, in f32; audio
        takes the mean over the codebooks."""
        logits_f = self._logits(x_c).float()
        logz = torch.logsumexp(logits_f, dim=-1)
        gold = torch.gather(logits_f, -1, targets_c[..., None].long())[..., 0]
        nll = logz - gold
        if self.cfg.n_codebooks:
            nll = nll.mean(-1)
        return (nll * mask_c).sum()

    def loss(self, batch: dict):
        """Next-token cross-entropy plus the MoE aux terms -> (total,
        metrics), as the reference's ``Model.loss``. ``batch``: tokens,
        targets, loss_mask[, prefix_embeds] (tensors or arrays). A VLM's
        prefix positions take no loss. The sequence is cut into
        ``B * S // LOSS_CHUNK_TOKENS`` chunks (lowered until the count
        divides S), each chunk's logits recomputed in the backward pass, so
        the (B, S, V) logits are never held whole. metrics: ``ce``,
        ``moe_load_balance``, ``moe_z_loss``, ``tokens``."""
        x, aux = self._hidden(batch["tokens"], batch.get("prefix_embeds"))
        targets = torch.as_tensor(batch["targets"]).to(x.device)
        mask = torch.as_tensor(batch["loss_mask"]).to(device=x.device,
                                                      dtype=torch.float32)
        if prefix := x.shape[1] - targets.shape[1]:
            x = x[:, prefix:]  # vlm: no loss on patch positions
        B, S = x.shape[:2]
        n_chunks = max(1, (B * S) // max(self.LOSS_CHUNK_TOKENS, 1))
        while n_chunks > 1 and S % n_chunks:
            n_chunks -= 1
        if n_chunks <= 1:
            nll_sum = self._ce_terms(x, targets, mask)
        else:
            sc = S // n_chunks
            nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            for c in range(n_chunks):
                part = slice(c * sc, (c + 1) * sc)
                nll_sum = nll_sum + recompute(
                    self._ce_terms, x[:, part], targets[:, part], mask[:, part])
        denom = torch.clamp_min(mask.sum(), 1.0)
        ce = nll_sum / denom
        total = ce + 0.01 * aux["moe_load_balance"] + 0.001 * aux["moe_z_loss"]
        metrics = {
            "ce": ce,
            "moe_load_balance": aux["moe_load_balance"],
            "moe_z_loss": aux["moe_z_loss"],
            "tokens": mask.sum(),
        }
        return total, metrics

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
