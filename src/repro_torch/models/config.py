"""Model configuration covering all assigned architecture families.

Copied from ``src/repro/models/config.py`` so that configs and parameter
counts are the JAX package's own. One frozen dataclass drives the decoder
stack in ``model.py``; family-specific fields are ignored by other
families. The port builds the dense and SSM families; the others raise
``NotImplementedError`` there (``models/layers.py``).

``use_pallas`` has no meaning in the port: the device of the tensors
decides (a CUDA tensor launches the hand-written kernel, a CPU tensor
runs its plain version). The field stays so that configs round-trip
between the packages, and the port ignores it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_window: int | None = None  # sliding-window size (local attention)
    attn_logit_softcap: float | None = None

    # --- mlp ---
    mlp_act: str = "silu"  # 'silu' (SwiGLU) | 'gelu' (GeGLU)

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_token: int = 1
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    moe_period: int = 1  # MoE every k-th layer (others dense MLP); llama4
    # maverick interleaves (period 2), scout is every layer (period 1)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- hybrid (RG-LRU) ---
    # repeating unit of block kinds; 'attn' | 'rglru' | 'mamba'
    block_pattern: tuple[str, ...] = ("attn",)
    rnn_width: int = 0  # RG-LRU lateral width (0 -> d_model)

    # --- embeddings / modality frontends (stubs per assignment) ---
    tie_embeddings: bool = True
    n_prefix_embeds: int = 0  # vlm: precomputed patch embeddings prepended
    n_codebooks: int = 0  # audio: EnCodec codebook streams

    # --- norm ---
    rmsnorm_eps: float = 1e-6
    norm_plus_one: bool = False  # gemma-style (1 + w) scale
    embed_scale: bool = False  # gemma-style sqrt(d_model) embed scaling

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: str = "full"  # 'none' | 'full'
    use_pallas: bool = False  # ignored by the port (see module docstring)
    optimizer: str = "adamw"  # 'adamw' | 'adafactor' (factored stats; used
    # for llama4-maverick where AdamW's 12 B/param exceeds single-pod HBM)

    # ------------------------------------------------------------------
    @property
    def ffn_kind(self) -> str:
        if self.family == "moe":
            return "moe"
        if self.family == "ssm":
            return "none"
        return "mlp"

    def ffn_kind_at(self, layer_idx: int) -> str:
        """FFN kind for a concrete layer (moe_period interleaving)."""
        kind = self.ffn_kind
        if kind == "moe" and (layer_idx + 1) % self.moe_period != 0:
            return "mlp"
        return kind

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def n_groups(self) -> int:
        """Full scanned repetitions of block_pattern."""
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        """Trailing layers not covered by full groups (e.g. 38 = 12*3 + 2)."""
        tail = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:tail]

    def validate(self) -> "ModelConfig":
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.family == "moe":
            assert self.n_experts > 0
        if self.family == "ssm":
            assert self.ssm_state > 0
            assert self.ssm_d_inner % self.ssm_head_dim == 0
        assert self.n_groups >= 1, "pattern longer than layer count"
        return self

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test-sized version of the same family (CPU-runnable)."""
        base = dict(
            n_layers=max(len(self.block_pattern), 2),
            d_model=64,
            n_heads=2,
            n_kv_heads=1 if self.n_kv_heads < self.n_heads else 2,
            head_dim=32,
            d_ff=128,
            vocab_size=256,
            n_experts=4 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            rnn_width=64 if self.rnn_width else 0,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            n_prefix_embeds=8 if self.n_prefix_embeds else 0,
            dtype="float32",
            remat="none",
        )
        if self.family == "hybrid":
            base["n_layers"] = len(self.block_pattern) + len(self.tail_pattern)
        base.update(overrides)
        return dataclasses.replace(self, **base).validate()


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding + blocks + head)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    embed = v * d * (cfg.n_codebooks or 1)
    head = 0 if cfg.tie_embeddings else v * d * (cfg.n_codebooks or 1)
    per_attn = d * h * dh + 2 * d * hkv * dh + h * dh * d + 2 * d
    if cfg.qk_norm:
        per_attn += 2 * dh
    per_mlp = 3 * d * f + d
    per_moe = d * cfg.n_experts + 3 * d * f * cfg.n_experts + d
    if cfg.moe_shared_expert:
        per_moe += 3 * d * f
    di, n, hs = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    per_mamba = (
        d * (2 * di + 2 * n + hs) + cfg.ssm_conv_width * (di + 2 * n)
        + 3 * hs + di + di * d + d
    )
    dr = cfg.rnn_dim
    per_rglru = 2 * d * dr + cfg.ssm_conv_width * dr + 2 * dr * dr + 3 * dr + dr * d + 2 * d

    layers = list(cfg.block_pattern) * cfg.n_groups + list(cfg.tail_pattern)
    total = embed + head + 2 * d  # final norm (+ scale)
    pat = len(cfg.block_pattern)
    for idx, kind in enumerate(layers):
        if kind == "attn":
            total += per_attn
        elif kind == "mamba":
            total += per_mamba
        elif kind == "rglru":
            total += per_rglru
        ffn = cfg.ffn_kind_at(idx % pat) if pat else cfg.ffn_kind
        if ffn == "mlp" and kind != "mamba":
            total += per_mlp
        elif ffn == "moe":
            total += per_moe
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) params: MoE counts only routed-in experts."""
    if cfg.family != "moe":
        return param_count(cfg)
    full = param_count(cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    n_moe_layers = sum(
        1 for i in range(cfg.n_layers)
        if cfg.ffn_kind_at(i % len(cfg.block_pattern)) == "moe"
    )
    inactive = 3 * d * f * (e - cfg.n_experts_per_token) * n_moe_layers
    return full - inactive
