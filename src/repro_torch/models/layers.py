"""Decoder building blocks of the LM serving and training paths, as
``nn.Module``s.

Ported from ``src/repro/models/layers.py`` for every family the JAX
package serves and trains: RMSNorm, rope, grouped-query attention with qk-norm,
sliding windows (ring caches) and logit soft-capping, the SwiGLU/GeGLU
MLP, the capacity-dispatched MoE with its aux terms, the Mamba2 block and
the RG-LRU (Griffin) block. Parameter names and layouts are the JAX
package's, so ``convert.params_from_jax`` copies its tree across
unchanged. Numerics as there: parameters and activations in
``cfg.dtype``; norms, softmax, router, convolution and scan states in f32.

Kernels: RMSNorm through ``ops.rmsnorm``; unwindowed, uncapped prefill
attention through ``ops.flash_attention`` (windowed or soft-capped layers
take ``attention_blocked``, plain torch, as the reference sends them past
its Pallas kernel); the Mamba2 scan through ``ops.ssd_scan``; the RG-LRU
recurrence through ``ops.rglru_scan`` (the reference's
``jax.lax.associative_scan``). Decode attention, the MoE dispatch and
expert products, and the S = 1 recurrent steps are plain torch, as they
are XLA ops in the reference.

Caches are dicts of tensors, one per layer, updated in place (the JAX
package returns new caches instead); a prefill puts its fitted k and v
into an attention layer's dict.

Under a policy over a device mesh (``models/sharding.py``) parameters and
activations are DTensors: each weight is gathered from its FSDP shards
where it is used (``MeshPolicy.use``), activations are constrained as the
reference constrains them, and the kernels run through ``local_map`` on
each rank's shard. Attention, the MLP and the Mamba2 block run so (the
families of ``Model.place``); a decode cache is replaced by a new DTensor
at each write (the step's slot selected elementwise) rather than written in
place.

Parameters are trainable. On the card the gradients of RMSNorm, the flash
attention and the Mamba2 and RG-LRU scans run through their hand-written
backward kernels (``ops.rmsnorm``, ``ops.flash_attention``,
``ops.ssd_scan``, ``ops.rglru_scan``). On the CPU autograd differentiates
the plain versions. With
gradients on, ``attention_blocked`` recomputes each chunk's scores in the
backward pass, as the reference's ``jax.checkpoint`` of its chunk step
does. The reference's ``grad_cast`` (an identity whose cotangent is cast
to its primal's dtype, at q, k, v) has no counterpart: autograd already
gives every tensor a gradient of its own dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from .config import ModelConfig
from .sharding import active_policy, prune_spec, set_full_


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def recompute(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    gradients are on (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``); a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


@torch.no_grad()
def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``p`` with N(0, std²) drawn in f32 on the generator's device,
    then cast, as the JAX package's ``_normal``."""
    draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    set_full_(p, draw.mul_(std))


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
    pol = active_policy()
    cos = pol.replicate(torch.cos(ang)[:, :, None, :])
    sin = pol.replicate(torch.sin(ang)[:, :, None, :])
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + optional qk-norm + optional sliding window / soft-cap)
# ---------------------------------------------------------------------------

ATTN_CHUNK = 1024  # query rows a step of ``attention_blocked``


def _softcap(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    return s if not cap else torch.tanh(s / cap) * cap


def attention_blocked(q, k, v, cfg: ModelConfig, *, chunk: int = ATTN_CHUNK):
    """Causal (optionally windowed, soft-capped) attention over query
    chunks in plain torch, f32 scores: the reference's
    ``attention_blocked``. q (B, S, H, Dh), k/v (B, S, Hkv, Dh) -> (B, S,
    H, Dh) in q's dtype. A chunk reads every key (O(chunk * S)), or for a
    windowed layer with ``window + chunk <= S`` a span of window + chunk
    keys; masked scores are -1e30."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by q-chunk {chunk}")
    win = cfg.attn_window
    use_window = win is not None and win + chunk <= S
    kspan = win + chunk if use_window else S
    pol = active_policy()
    kf, vf = k.float(), v.float()
    ar_q = torch.arange(chunk, device=q.device)
    ar_k = torch.arange(kspan, device=q.device)

    def step(qc, kc, vc, q_pos, k_pos):
        qc = qc.float().reshape(B, chunk, Hkv, G, Dh)
        s = torch.einsum("bcngd,bsnd->bngcs", qc, kc) * scale
        s = _softcap(s, cfg.attn_logit_softcap)
        s = pol.constrain(s, pol.dp_spec, pol.tp, None, None, None)  # heads on tp
        mask = q_pos[:, None] >= k_pos[None, :]
        if win is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - win
        s = torch.where(mask, s, -1e30)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bngcs,bsnd->bcngd", e, vc)
        o = o / e.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
        return o.reshape(B, chunk, H, Dh).to(q.dtype)

    outs = []
    for q0 in range(0, S, chunk):
        start = min(max(q0 - win, 0), S - kspan) if use_window else 0
        outs.append(recompute(
            step, q[:, q0:q0 + chunk], kf[:, start:start + kspan],
            vf[:, start:start + kspan], q0 + ar_q, start + ar_k))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attention_decode(q, k_cache, v_cache, pos, cfg: ModelConfig) -> torch.Tensor:
    """Single-token attention against a cache, grouped GQA einsum, f32.

    q (B, 1, H, Dh); caches (B, S, Hkv, Dh); pos (B,) current lengths. Slot
    j was last written at absolute position ``pos - ((pos - j) mod S)``
    (the ring of a windowed cache); it counts when that lies in [0, pos]
    and, for a windowed layer, after ``pos - window``."""
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh).float() * (1.0 / math.sqrt(Dh))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    s = _softcap(s, cfg.attn_logit_softcap)
    j = torch.arange(S, device=q.device)
    p = pos.long()[:, None]
    abs_j = p - torch.remainder(p - j[None, :], S)
    mask = (abs_j >= 0) & (abs_j <= p)
    if cfg.attn_window is not None:
        mask &= abs_j > p - cfg.attn_window
    s = torch.where(mask[:, None, None], s, -1e30)
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def attention_decode_placed(q, k_cache, v_cache, pos, cfg: ModelConfig) -> torch.Tensor:
    """``attention_decode`` on DTensors, each rank on its own rows and heads
    (``local_map``): batch on dp; kv heads, with the q heads that read them,
    on tp where they divide it, else every head on each rank of tp. A cache
    sharded on its sequence is gathered first. ``pos`` (B,) is the same on
    every rank."""
    from torch.distributed.tensor.experimental import local_map

    pol = active_policy()
    Hkv = k_cache.shape[2]
    tp = pol.tp if pol.tp and Hkv % pol.mesh.shape[pol.tp] == 0 else None
    spec = prune_spec(pol.mesh, q.shape, (pol.dp_spec, None, tp, None))
    pl = pol.placements(spec)
    q, k_cache, v_cache = (t.redistribute(t.device_mesh, pl) for t in (q, k_cache, v_cache))
    pos = pol.distribute(pos, spec[:1])
    return local_map(lambda *a: attention_decode(*a, cfg), out_placements=pl,
                     in_placements=(pl, pl, pl, pos.placements),
                     device_mesh=pol.device_mesh)(q, k_cache, v_cache, pos)


def _fit_seq(x: torch.Tensor, S_cache: int) -> torch.Tensor:
    """x (B, S, ...) fitted to S_cache steps: zero padded when S < S_cache,
    its last S_cache steps when longer."""
    S = x.shape[1]
    if S >= S_cache:
        return x[:, S - S_cache:]
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, S_cache - S))


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
        pol = active_policy()
        q, k, v = (
            pol.act_bshd((x2 @ pol.use(w).reshape(d, -1)).view(
                B, S, w.shape[1], w.shape[2]))
            for w in (self.wq, self.wk, self.wv)
        )
        if self.cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        theta = self.cfg.rope_theta
        return rope(q, positions, theta), rope(k, positions, theta), v

    def _attend(self, q, k, v):
        """Prefill attention: the flash kernel, or for a windowed or
        soft-capped layer ``attention_blocked`` (the reference's
        ``_maybe_flash``)."""
        cfg = self.cfg
        if cfg.attn_window is not None or cfg.attn_logit_softcap is not None:
            return attention_blocked(q, k, v, cfg)
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True
        )
        return o.transpose(1, 2)

    def forward(self, x, positions, cache=None):
        """Returns (out, cache). ``cache`` None -> no cache kept; a dict
        {'k', 'v'} -> prefill (S > 1) fills it (its last S_cache steps when
        longer: a windowed ring), decode (S == 1) writes step ``pos[0]`` at
        slot ``pos[0] mod S_cache`` for the whole batch and attends over the
        cache."""
        B, S, _ = x.shape
        pol = active_policy()
        q, k, v = self._qkv(self.ln(x), positions)
        if cache is None or S > 1:
            o = self._attend(q, k, v)
            if cache is not None:
                S_cache = cache["k"].shape[1]
                if S > S_cache and S % S_cache:
                    raise ValueError(
                        f"windowed prefill length {S} must be a multiple of "
                        f"the cache window {S_cache}"
                    )
                cache["k"], cache["v"] = (pol.cache(_fit_seq(t.to(cache[n].dtype), S_cache))
                                          for n, t in (("k", k), ("v", v)))
        else:
            pos = positions if positions.dim() == 1 else positions[:, 0]
            write_at = torch.remainder(pos[:1].long(), cache["k"].shape[1])
            if pol.placed:  # a new cache: the step's slot selected elementwise
                slot = pol.replicate((torch.arange(
                    cache["k"].shape[1], device=write_at.device) == write_at)[
                        None, :, None, None])
                kc, vc = (pol.cache(torch.where(slot, t.to(cache[n].dtype), cache[n]))
                          for n, t in (("k", k), ("v", v)))
                cache["k"], cache["v"] = kc, vc
                o = attention_decode_placed(q, kc, vc, pos, self.cfg)
            else:
                cache["k"].index_copy_(1, write_at, k.to(cache["k"].dtype))
                cache["v"].index_copy_(1, write_at, v.to(cache["v"].dtype))
                kc, vc = pol.cache(cache["k"]), pol.cache(cache["v"])
                o = attention_decode(q, kc, vc, pos, self.cfg)
        h, dh, d = self.wo.shape
        out = o.reshape(B, S, h * dh) @ pol.use(self.wo).reshape(h * dh, d)
        return pol.act_bsd(out), cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device):
    """{'k', 'v'} of max_seq steps, or of min(window, max_seq) for a
    windowed layer (a ring)."""
    S = max_seq if cfg.attn_window is None else min(cfg.attn_window, max_seq)
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
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
        pol = active_policy()
        h = self.ln(x)
        z = _act(self.cfg.mlp_act)(pol.act_bsf(h @ pol.use(self.w_gate))) * pol.act_bsf(
            h @ pol.use(self.w_up))
        return pol.act_bsd(z @ pol.use(self.w_down))


# ---------------------------------------------------------------------------
# MoE (capacity-based top-k dispatch)
# ---------------------------------------------------------------------------

MOE_CHUNK_TOKENS = 16_384  # tokens a dispatch: bounds the (E, C, D) buffers


class MoE(nn.Module):
    """Routed experts with a capacity per expert, top-k by repeated argmax,
    and an optional shared expert: the reference's ``apply_moe``.

    ``route_stats``: None, or a list to which each dispatch appends, per
    k, (tokens routed to each expert int64[E], tokens dropped past the
    capacity) as tensors on the card; for the caller's accounting."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = model_dtype(cfg)
        self.cfg = cfg
        self.ln = RMSNorm(d, cfg, device)
        self.router = _param((d, e), torch.float32, device)
        self.experts_gate = _param((e, d, f), dt, device)
        self.experts_up = _param((e, d, f), dt, device)
        self.experts_down = _param((e, f, d), dt, device)
        if cfg.moe_shared_expert:
            self.shared_gate = _param((d, f), dt, device)
            self.shared_up = _param((d, f), dt, device)
            self.shared_down = _param((f, d), dt, device)
        self.route_stats = None

    def init(self, generator) -> None:
        down_std = 0.02 / math.sqrt(2 * self.cfg.n_layers)
        normal_(self.router, 0.02, generator)
        for name in ("experts", "shared"):
            if hasattr(self, f"{name}_gate"):
                normal_(getattr(self, f"{name}_gate"), 0.02, generator)
                normal_(getattr(self, f"{name}_up"), 0.02, generator)
                normal_(getattr(self, f"{name}_down"), down_std, generator)
        self.ln.init(generator)

    def forward(self, x):
        """x (B, S, D) -> (out, aux). More than ``MOE_CHUNK_TOKENS`` tokens
        (and S > 1) route in chunks of the sequence, each on its own; the
        aux terms are the chunks' means."""
        B, S, D = x.shape
        T = B * S
        if T <= MOE_CHUNK_TOKENS or S == 1:
            return self._dispatch(x)
        n_chunks = max(1, -(-T // MOE_CHUNK_TOKENS))
        while S % n_chunks:
            n_chunks += 1
        sc = S // n_chunks
        outs, lbs, zs = [], [], []
        for c in range(n_chunks):
            out, aux = self._dispatch(x[:, c * sc:(c + 1) * sc])
            outs.append(out)
            lbs.append(aux["moe_load_balance"])
            zs.append(aux["moe_z_loss"])
        return torch.cat(outs, dim=1), {
            "moe_load_balance": torch.stack(lbs).mean(),
            "moe_z_loss": torch.stack(zs).mean(),
        }

    def _dispatch(self, x):
        cfg = self.cfg
        B, S, D = x.shape
        T, E, K = B * S, cfg.n_experts, cfg.n_experts_per_token
        C = min(max(int(cfg.moe_capacity_factor * T * K / E), 1), T)
        act = _act(cfg.mlp_act)
        pol = active_policy()

        h = self.ln(x).reshape(T, D)
        logits = h.float() @ self.router  # (T, E) f32
        probs = torch.softmax(logits, dim=-1)
        out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
        masked = probs
        f_frac = torch.zeros((E,), dtype=torch.float32, device=x.device)
        tok = torch.arange(T, device=x.device)
        for _ in range(K):
            eidx = torch.argmax(masked, dim=-1)  # the first maximum
            gate = masked[tok, eidx]
            onehot = F.one_hot(eidx, E)
            pos_t = (torch.cumsum(onehot, dim=0) - 1)[tok, eidx]  # token order
            keep = pos_t < C
            slot = torch.where(keep, pos_t, C)  # slot C: dropped
            buf = torch.zeros((E, C + 1, D), dtype=h.dtype, device=x.device)
            buf[eidx, slot] = h
            buf = pol.act_ecd(buf[:, :C])
            g = act(torch.bmm(buf, self.experts_gate))
            u = torch.bmm(buf, self.experts_up)
            eo = F.pad(pol.act_ecd(torch.bmm(g * u, self.experts_down)), (0, 0, 0, 1))
            out = out + eo[eidx, slot].float() * (gate * keep)[:, None]
            f_frac = f_frac + onehot.float().mean(dim=0)
            masked = masked * (1.0 - onehot)  # the chosen expert is out for the next k
            if self.route_stats is not None:
                self.route_stats.append((onehot.sum(dim=0), (~keep).sum()))

        # aux: load balance (Switch) and router z-loss
        p_frac = probs.mean(dim=0)
        aux = {
            "moe_load_balance": E * torch.sum(f_frac / K * p_frac),
            "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        }
        routed = out.reshape(B, S, D).to(x.dtype)
        if cfg.moe_shared_expert:
            hs = h.reshape(B, S, D)
            routed = routed + (act(hs @ self.shared_gate) * (hs @ self.shared_up)
                               ) @ self.shared_down
        return pol.act_bsd(routed), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B, S, C), w (W, C), state (B, W-1, C) or
    None -> (y (B, S, C), new_state)."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
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
        set_full_(self.a_log_p, torch.log(torch.linspace(1.0, 16.0, hs,
                                                         dtype=torch.float32)))
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
        pol = active_policy()
        use = pol.use

        h = self.ln(x)
        zxbcdt = h @ use(self.in_proj)
        z = zxbcdt[..., :di]
        dt_raw = zxbcdt[..., 2 * di + 2 * n:]
        conv_in = zxbcdt[..., di:2 * di + 2 * n].float()
        conv_out, new_conv = _causal_conv(
            conv_in, use(self.conv_w), self.conv_b,
            None if cache is None else cache["conv"]
        )
        conv_out = F.silu(conv_out).to(h.dtype)
        xin = conv_out[..., :di]
        bmat = conv_out[..., di:di + n]
        cmat = conv_out[..., di + n:]

        dt = F.softplus(dt_raw.float() + self.dt_bias)  # (B, S, hs)
        a_log = dt * -torch.exp(self.a_log_p)[None, None, :]
        xh = xin.reshape(B, S, hs, P).transpose(1, 2)  # (B, hs, S, P)
        if cache is None or S > 1:
            y = ops.ssd_scan(  # heads on tp where the policy places them
                pol.constrain(xh.to(mdt), pol.dp_spec, pol.tp, None, None),
                dt.transpose(1, 2), a_log.transpose(1, 2),
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
        out = (y @ use(self.out_proj)).to(x.dtype)
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(new_ssm)
        return pol.act_bsd(out), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device):
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=f32,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=f32, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin) block
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dr, w = cfg.d_model, cfg.rnn_dim, cfg.ssm_conv_width
        dt = model_dtype(cfg)
        f32 = torch.float32
        self.cfg = cfg
        self.ln = RMSNorm(d, cfg, device)
        self.w_in = _param((d, dr), dt, device)
        self.w_gate_branch = _param((d, dr), dt, device)
        self.conv_w = _param((w, dr), f32, device)
        self.conv_b = _param((dr,), f32, device)
        self.w_a = _param((dr, dr), f32, device)
        self.b_a = _param((dr,), f32, device)
        self.w_x = _param((dr, dr), f32, device)
        self.b_x = _param((dr,), f32, device)
        self.lam = _param((dr,), f32, device)
        self.w_rnn_out = _param((dr, d), dt, device)

    @torch.no_grad()
    def init(self, generator) -> None:
        for p in (self.w_in, self.w_gate_branch, self.conv_w, self.w_a, self.w_x):
            normal_(p, 0.02, generator)
        for p in (self.conv_b, self.b_a, self.b_x):
            p.zero_()
        # Λ so that a^c lies near 0.9..0.999 (long memory)
        lin = torch.linspace(0.3, 1.5, self.cfg.rnn_dim, dtype=torch.float32)
        set_full_(self.lam, torch.log(torch.expm1(lin)))
        normal_(self.w_rnn_out, 0.02 / math.sqrt(2 * self.cfg.n_layers), generator)
        self.ln.init(generator)

    def forward(self, x, positions=None, cache=None):
        """Returns (out, cache); cache = {'conv': (B, W-1, dr), 'h': (B, dr)}
        f32, updated in place. More than one step runs the recurrence
        ``h_t = a_t h_(t-1) + b_t`` through ``ops.rglru_scan`` from the
        cache's h (or 0); a decode step is ``a h + b`` in plain torch."""
        S = x.shape[1]
        pol = active_policy()
        hin = self.ln(x)
        u = pol.act_bsf(hin @ self.w_in)
        gate = _act("gelu")(pol.act_bsf(hin @ self.w_gate_branch))
        uc, new_conv = _causal_conv(
            u.float(), self.conv_w, self.conv_b, None if cache is None else cache["conv"]
        )
        r = torch.sigmoid(uc @ self.w_a + self.b_a)  # (B, S, dr) f32
        i = torch.sigmoid(uc @ self.w_x + self.b_x)
        a = torch.exp(-RGLRU_C * F.softplus(self.lam)[None, None, :] * r)
        b = torch.sqrt(torch.clamp_min(1.0 - a**2, 1e-12)) * (i * uc)
        if cache is None or S > 1:
            h = ops.rglru_scan(a, b, None if cache is None else cache["h"])
            new_h = h[:, -1]
        else:
            new_h = a[:, 0] * cache["h"] + b[:, 0]
            h = new_h[:, None]
        out = (h.to(x.dtype) * gate) @ self.w_rnn_out
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["h"].copy_(new_h)
        return pol.act_bsd(out), cache


def init_rglru_cache(cfg: ModelConfig, batch: int, device):
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.rnn_dim), dtype=f32,
                            device=device),
        "h": torch.zeros((batch, cfg.rnn_dim), dtype=f32, device=device),
    }
