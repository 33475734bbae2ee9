"""Decoder building blocks of the LM serving path, as ``nn.Module``s.

Ported from ``src/repro/models/layers.py`` for what the dense (qwen3) and
SSM (mamba2) configurations need: RMSNorm, rope, grouped-query attention
with qk-norm (prefill through ``ops.flash_attention``, decode in plain
torch against the cache), the SwiGLU/GeGLU MLP and the Mamba2 block.
Parameter names and layouts are the JAX package's, so
``convert.params_from_jax`` copies its tree across unchanged. Numerics
as there: parameters and activations in ``cfg.dtype``, norms, softmax,
convolution and scan states in f32.

Caches are dicts of tensors, one per layer, updated in place (the JAX
package returns new caches instead).

A layer kind or family the port does not build yet (MoE, RG-LRU, VLM
prefix embeddings, audio codebooks, sliding-window or soft-capped
attention) raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from .config import ModelConfig

UNPORTED = "ROADMAP Queue 1 item 13"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the serving slice lacks."""
    unported = []
    if cfg.family == "moe" or cfg.n_experts:
        unported.append("MoE layers")
    if "rglru" in cfg.block_pattern:
        unported.append("RG-LRU layers")
    if cfg.n_prefix_embeds:
        unported.append("VLM prefix embeddings (n_prefix_embeds)")
    if cfg.n_codebooks:
        unported.append("audio codebooks (n_codebooks)")
    if cfg.attn_window is not None:
        unported.append("sliding-window attention (attn_window)")
    if cfg.attn_logit_softcap is not None:
        unported.append("attention logit soft-capping (attn_logit_softcap)")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported yet ({UNPORTED})"
        )


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``p`` with N(0, std²) drawn in f32 on the generator's device,
    then cast, as the JAX package's ``_normal``."""
    draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    p.copy_(draw.mul_(std))


# ---------------------------------------------------------------------------
# Norm + RoPE
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """Weights stored zero-centered; the effective scale is w + 1."""

    def __init__(self, d: int, cfg: ModelConfig, device):
        super().__init__()
        self.eps = cfg.rmsnorm_eps
        self.w = _param((d,), torch.float32, device)

    def init(self, generator) -> None:
        self.w.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x, self.w, eps=self.eps, plus_one=True).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves, in f32. x: (B, S, H, D),
    positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + optional qk-norm)
# ---------------------------------------------------------------------------


def attention_decode(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Single-token attention against a cache, grouped GQA einsum, f32.

    q (B, 1, H, Dh); caches (B, S, Hkv, Dh); pos (B,) current lengths. A
    slot counts when its absolute position ``pos - ((pos - j) mod S)`` lies
    in [0, pos]."""
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh).float() * (1.0 / math.sqrt(Dh))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    j = torch.arange(S, device=q.device)
    p = pos.long()[:, None]
    abs_j = p - torch.remainder(p - j[None, :], S)
    mask = (abs_j >= 0) & (abs_j <= p)
    s = torch.where(mask[:, None, None], s, -1e30)
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def _fit_seq_(cache: torch.Tensor, x: torch.Tensor) -> None:
    """Write x (B, S, ...) into cache (B, S_cache, ...) in place: zero
    padded when S < S_cache, its last S_cache steps when longer."""
    S, S_cache = x.shape[1], cache.shape[1]
    if S >= S_cache:
        cache.copy_(x[:, S - S_cache:])
    else:
        cache[:, :S].copy_(x)
        cache[:, S:].zero_()


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = model_dtype(cfg)
        self.cfg = cfg
        self.ln = RMSNorm(d, cfg, device)
        self.wq = _param((d, h, dh), dt, device)
        self.wk = _param((d, hkv, dh), dt, device)
        self.wv = _param((d, hkv, dh), dt, device)
        self.wo = _param((h, dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, cfg, device)
            self.k_norm = RMSNorm(dh, cfg, device)

    def init(self, generator) -> None:
        for p in (self.wq, self.wk, self.wv):
            normal_(p, 0.02, generator)
        normal_(self.wo, 0.02 / math.sqrt(2 * self.cfg.n_layers), generator)
        for m in self.children():
            m.init(generator)

    def _qkv(self, x, positions):
        B, S, d = x.shape
        x2 = x.reshape(B * S, d)
        q, k, v = (
            (x2 @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])
            for w in (self.wq, self.wk, self.wv)
        )
        if self.cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        theta = self.cfg.rope_theta
        return rope(q, positions, theta), rope(k, positions, theta), v

    @staticmethod
    def _flash(q, k, v):
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True
        )
        return o.transpose(1, 2)

    def forward(self, x, positions, cache=None):
        """Returns (out, cache). ``cache`` None -> no cache kept; a dict
        {'k', 'v'} -> prefill (S > 1) fills it, decode (S == 1) writes step
        ``pos[0]`` for the whole batch and attends over the cache."""
        B, S, _ = x.shape
        q, k, v = self._qkv(self.ln(x), positions)
        if cache is None or S > 1:
            o = self._flash(q, k, v)
            if cache is not None:
                S_cache = cache["k"].shape[1]
                if S > S_cache and S % S_cache:
                    raise ValueError(
                        f"windowed prefill length {S} must be a multiple of "
                        f"the cache window {S_cache}"
                    )
                _fit_seq_(cache["k"], k)
                _fit_seq_(cache["v"], v)
        else:
            pos = positions if positions.dim() == 1 else positions[:, 0]
            write_at = torch.remainder(pos[:1].long(), cache["k"].shape[1])
            cache["k"].index_copy_(1, write_at, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, write_at, v.to(cache["v"].dtype))
            o = attention_decode(q, cache["k"], cache["v"], pos)
        h, dh, d = self.wo.shape
        out = o.reshape(B, S, h * dh) @ self.wo.reshape(h * dh, d)
        return out, cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def _act(name: str):
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = model_dtype(cfg)
        self.cfg = cfg
        self.ln = RMSNorm(d, cfg, device)
        self.w_gate = _param((d, f), dt, device)
        self.w_up = _param((d, f), dt, device)
        self.w_down = _param((f, d), dt, device)

    def init(self, generator) -> None:
        normal_(self.w_gate, 0.02, generator)
        normal_(self.w_up, 0.02, generator)
        normal_(self.w_down, 0.02 / math.sqrt(2 * self.cfg.n_layers), generator)
        self.ln.init(generator)

    def forward(self, x):
        h = self.ln(x)
        z = _act(self.cfg.mlp_act)(h @ self.w_gate) * (h @ self.w_up)
        return z @ self.w_down


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B, S, C), w (W, C), state (B, W-1, C) or
    None -> (y (B, S, C), new_state)."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+W-1, C)
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return y + b[None, None, :], new_state


def _ssd_final_state(xh, dt, a_log, bmat):
    """Final SSM state after a prefill, in plain torch (no kernel).
    xh (B, hs, S, P), dt/a_log (B, S, hs), bmat (B, S, N) -> (B, hs, N, P)
    f32: sum_s B_s dt_s exp(l_S - l_s) x_s^T, with B shared by the heads."""
    lc = torch.cumsum(a_log, dim=1)
    weight = dt * torch.exp(lc[:, -1:, :] - lc)  # (B, S, hs)
    xw = xh.float() * weight.transpose(1, 2)[..., None]  # (B, hs, S, P)
    return torch.einsum("bsn,bhsp->bhnp", bmat.float(), xw)


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        di, n, hs, w = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
        dt = model_dtype(cfg)
        f32 = torch.float32
        self.cfg = cfg
        self.ln = RMSNorm(d, cfg, device)
        # order: [z (di), x (di), B (n), C (n), dt (hs)]
        self.in_proj = _param((d, 2 * di + 2 * n + hs), dt, device)
        self.conv_w = _param((w, di + 2 * n), f32, device)
        self.conv_b = _param((di + 2 * n,), f32, device)
        self.dt_bias = _param((hs,), f32, device)
        self.a_log_p = _param((hs,), f32, device)
        self.d_skip = _param((hs,), f32, device)
        self.gate_ln = RMSNorm(di, cfg, device)
        self.out_proj = _param((di, d), dt, device)

    @torch.no_grad()
    def init(self, generator) -> None:
        hs = self.cfg.ssm_heads
        normal_(self.in_proj, 0.02, generator)
        normal_(self.conv_w, 0.02, generator)
        self.conv_b.zero_()
        self.dt_bias.zero_()
        # A in [-16, -1]
        self.a_log_p.copy_(torch.log(torch.linspace(1.0, 16.0, hs, dtype=torch.float32)))
        self.d_skip.fill_(1.0)
        normal_(self.out_proj, 0.02 / math.sqrt(2 * self.cfg.n_layers), generator)
        self.ln.init(generator)
        self.gate_ln.init(generator)

    def forward(self, x, positions=None, cache=None):
        """Returns (out, cache); cache = {'conv': (B, W-1, C), 'ssm':
        (B, hs, N, P)} f32, updated in place."""
        cfg = self.cfg
        B, S, _ = x.shape
        di, n, hs, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        mdt = model_dtype(cfg)

        h = self.ln(x)
        zxbcdt = h @ self.in_proj
        z = zxbcdt[..., :di]
        dt_raw = zxbcdt[..., 2 * di + 2 * n:]
        conv_in = zxbcdt[..., di:2 * di + 2 * n].float()
        conv_out, new_conv = _causal_conv(
            conv_in, self.conv_w, self.conv_b, None if cache is None else cache["conv"]
        )
        conv_out = F.silu(conv_out).to(h.dtype)
        xin = conv_out[..., :di]
        bmat = conv_out[..., di:di + n]
        cmat = conv_out[..., di + n:]

        dt = F.softplus(dt_raw.float() + self.dt_bias)  # (B, S, hs)
        a_log = dt * -torch.exp(self.a_log_p)[None, None, :]
        xh = xin.reshape(B, S, hs, P).transpose(1, 2)  # (B, hs, S, P)
        if cache is None or S > 1:
            y = ops.ssd_scan(
                xh.to(mdt), dt.transpose(1, 2), a_log.transpose(1, 2),
                bmat.to(mdt), cmat.to(mdt), chunk=min(cfg.ssm_chunk, S),
            )  # (B, hs, S, P)
            new_ssm = None
            if cache is not None:  # prefill: rebuild the final state for decode
                new_ssm = _ssd_final_state(xh, dt, a_log, bmat)
        else:  # single-step decode
            s_prev = cache["ssm"]
            dt1 = dt[:, 0]  # (B, hs)
            a1 = torch.exp(a_log[:, 0])
            bt = bmat[:, 0].float()[:, None, :] * dt1[..., None]  # (B, hs, N)
            new_ssm = (a1[..., None, None] * s_prev
                       + bt[..., :, None] * xh[:, :, 0].float()[:, :, None, :])
            y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), new_ssm)
            y = y[:, :, None, :].to(x.dtype)

        y = y.transpose(1, 2).to(x.dtype)  # (B, S, hs, P)
        y = y + (self.d_skip.to(x.dtype)[None, None, :, None]
                 * xh.transpose(1, 2).to(x.dtype))
        y = y.reshape(B, S, di)
        gate = F.silu(z.float()).to(x.dtype)
        y = self.gate_ln(y * gate)
        out = (y @ self.out_proj).to(x.dtype)
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(new_ssm)
        return out, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device):
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=f32,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=f32, device=device),
    }
