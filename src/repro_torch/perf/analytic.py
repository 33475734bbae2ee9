"""Analytic per-step FLOP / HBM-byte models for the roofline.

The closed forms of ``src/repro/perf/analytic.py``, over the port's
``models/config.py::param_count`` and ``active_param_count``; the
formulas are the same, so the two packages agree on every cell.

Conventions (per *global* step, then divided by chip count):
  dense matmul train:  fwd 2·N·T, bwd 4·N·T, full remat +2·N·T  = 8·N·T
  attention (causal):  4·S·Dh per token-head per pass-pair → see below
  decode:              2·N per token + full KV cache read
where N = active params, T = tokens per step.

The card's constants are those of the NVIDIA H100 SXM5 80 GB (NVIDIA H100
Tensor Core GPU datasheet: dense bf16 tensor-core rate, HBM3 bandwidth,
fourth-generation NVLink), the card ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` reads as "NVIDIA H100 80GB HBM3,
700.00 W" on the machine the port is measured on. The rates assume the
full 700 W limit; a card set lower runs slower under load. They are the
port's one copy: ``chip_smoke.py``'s bounds read ``HBM_BW`` and
``PEAK_FLOPS`` from here. ``NVLINK_BW`` is the reference's ``ICI_BW``
counterpart, which no formula reads there either.
"""

from __future__ import annotations

from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import ModelConfig, active_param_count, param_count

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s a card (H100 SXM5 datasheet)
HBM_BW = 3.35e12  # HBM3 bytes/s a card (H100 SXM5 datasheet)
NVLINK_BW = 450e9  # NVLink bytes/s a card, each way (900 GB/s both ways)


def _attn_layers(cfg: ModelConfig) -> int:
    pat = list(cfg.block_pattern) * cfg.n_groups + list(cfg.tail_pattern)
    return sum(1 for k in pat if k == "attn")


def attention_flops_fwd(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Causal QK^T + PV flops across attention layers (one forward)."""
    L = _attn_layers(cfg)
    if L == 0:
        return 0.0
    win = cfg.attn_window
    if win is not None and win < seq:
        ctx = win  # sliding window: each query sees ≤ win keys
        pairs = batch * seq * ctx
    else:
        pairs = batch * seq * (seq + 1) / 2  # causal half
    # scores (2·Dh) + weighted sum (2·Dh) per (q,k) pair per head
    return L * cfg.n_heads * pairs * 4 * cfg.head_dim


def ssm_flops_fwd(cfg: ModelConfig, batch: int, seq: int) -> float:
    """SSD state-update + readout flops (linear in S)."""
    pat = list(cfg.block_pattern) * cfg.n_groups + list(cfg.tail_pattern)
    L = sum(1 for k in pat if k in ("mamba", "rglru"))
    if L == 0:
        return 0.0
    if "mamba" in pat:
        hs, n, p = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        per_tok = hs * n * p * 6  # B̃x^T outer + state decay + C·S readout
    else:  # rglru: elementwise recurrence
        per_tok = cfg.rnn_dim * 8
    return L * batch * seq * per_tok


def step_flops(cfg: ModelConfig, shape_name: str) -> dict:
    """Analytic global FLOPs for one step of this cell."""
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    n_active = active_param_count(cfg)

    if spec.kind == "train":
        T = B * S
        matmul = 6.0 * n_active * T
        remat = 2.0 * n_active * T if cfg.remat == "full" else 0.0
        attn = attention_flops_fwd(cfg, B, S) * (3.0 + (1.0 if cfg.remat == "full" else 0.0))
        ssm = ssm_flops_fwd(cfg, B, S) * (3.0 + (1.0 if cfg.remat == "full" else 0.0))
        model = 6.0 * n_active * T  # the spec's MODEL_FLOPS definition
        total = matmul + remat + attn + ssm
    elif spec.kind == "prefill":
        T = B * S
        total = 2.0 * n_active * T + attention_flops_fwd(cfg, B, S) + ssm_flops_fwd(cfg, B, S)
        model = 2.0 * n_active * T
    else:  # decode: one token per sequence
        T = B
        ctx = min(cfg.attn_window or S, S)
        attn = _attn_layers(cfg) * cfg.n_heads * B * ctx * 4 * cfg.head_dim
        total = 2.0 * n_active * T + attn + ssm_flops_fwd(cfg, B, 1)
        model = 2.0 * n_active * T
    return {"total": total, "model": model, "tokens": float(T)}


def step_hbm_bytes(cfg: ModelConfig, shape_name: str, n_chips: int,
                   accum: int = 1) -> float:
    """Analytic per-device HBM traffic for one step (documented model).

    Train: weights are FSDP-sharded; each device reads its shard and the
    gathered copies arrive over the interconnect (counted in the
    collective term, not HBM) but are written and read once in HBM per use
    ⇒ ~3 passes (fwd, remat, bwd) × params (local working copy) + grad
    (fp32 rw) + optimizer state rw. Activations: remat carries written and
    read once per layer. Decode: params read once + full KV cache read.
    """
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    n_params = param_count(cfg)
    p_bytes = 2.0  # bf16
    dev = float(n_chips)

    if spec.kind == "train":
        w_traffic = n_params * p_bytes * 2 * 3 * accum / dev  # gather w+r per pass
        g_traffic = n_params * 4 * 2 * accum / dev
        opt_traffic = n_params * (12 if cfg.optimizer == "adamw" else 5) / dev
        tokens_dev = B * S / dev * 1  # dp sharding ≈ chip count on batch+tp
        carries = cfg.n_layers * tokens_dev * cfg.d_model * 2 * 2  # w + r
        return w_traffic + g_traffic + opt_traffic + carries
    if spec.kind == "prefill":
        w = n_params * p_bytes * 2 / dev
        acts = B * S * cfg.d_model * 2 * cfg.n_layers * 2 / dev
        return w + acts
    # decode
    w = n_params * p_bytes / dev  # every weight read once per token step
    ctx = min(cfg.attn_window or S, S)
    cache = (
        2 * _attn_layers(cfg) * B * ctx * cfg.n_kv_heads * cfg.head_dim * 2
        / dev
    )
    return w + cache


def roofline_ms(flops: float, hbm_bytes: float) -> float:
    """The least time one card takes for a step's share: the larger of its
    FLOPs at ``PEAK_FLOPS`` and its bytes at ``HBM_BW``, in ms."""
    return max(flops / PEAK_FLOPS, hbm_bytes / HBM_BW) * 1e3
