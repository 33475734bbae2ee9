"""PyTorch port, LM serving: the RG-LRU hybrid (recurrentgemma), sliding
windows with ring caches and logit soft-capping, against the JAX package.

Reduced ``recurrentgemma-9b`` (one (R, R, A) group and the (R, R) tail,
window 64, MQA, GeGLU, f32) and reduced ``qwen3-1.7b`` with
``attn_window=16`` or ``attn_logit_softcap=30.0``. The JAX model is
initialized from ``PRNGKey(0)`` and ``convert.params_from_jax`` carries its
parameters across; tokens come from ``np.random.default_rng`` with the seed
named in each test.

Tolerances: atol 1e-4 on f32 logits (the JAX package's own prefill/decode
tolerance, ``tests/test_arch_smoke.py``). The RG-LRU scan: rtol 1e-5 (and
atol 1e-6) against ``jax.lax.associative_scan``, which associates the
products of a in another order than the port's sequential loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro.configs import get_config as jget_config
from repro.models.lm_serve import Request as JRequest
from repro.models.lm_serve import ServeEngine as JServeEngine
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm_serve import Request, ServeEngine
from repro_torch.models.model import Model, layer_kinds

ATOL = 1e-4
CASES = {
    "recurrentgemma": ("recurrentgemma-9b", {}),
    "window16": ("qwen3-1.7b", {"attn_window": 16}),
    "softcap30": ("qwen3-1.7b", {"attn_logit_softcap": 30.0}),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(case, JAX cfg, JAX model, JAX params, port model) on shared weights."""
    arch, overrides = CASES[request.param]
    jcfg = jget_config(arch).reduced(**overrides)
    jmodel = JModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**overrides)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return request.param, jcfg, jmodel, params, model


def _tokens(seed, vocab, B, S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def test_apply_matches_jax(pair):
    case, jcfg, jmodel, params, model = pair
    tokens = _tokens(1, jcfg.vocab_size, 2, 64)  # seed 1
    want, _ = jmodel.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# (prompt, decode steps, max_seq): each windowed cache is a ring of
# min(window, max_seq) slots that the decode steps wrap; recurrentgemma's
# 128-step prompt is two rings of its window of 64
STEPS = {"recurrentgemma": (128, 4, 160), "window16": (16, 12, 32),
         "softcap30": (16, 8, 32)}


def test_prefill_and_decode_match_jax(pair):
    """Prefill, then teacher-forced decode steps past the window, against
    JAX's decode and the port's own full forward."""
    case, jcfg, jmodel, params, model = pair
    prompt, steps, max_seq = STEPS[case]
    tokens = _tokens(2, jcfg.vocab_size, 2, prompt + steps)  # seed 2
    with torch.no_grad():
        full, _ = model.apply(torch.from_numpy(tokens))
    jlast, jcache = jmodel.prefill(params, jnp.asarray(tokens[:, :prompt]), max_seq)
    last, cache = model.prefill(torch.from_numpy(tokens[:, :prompt]), max_seq)
    if jcfg.attn_window:
        ring = min(jcfg.attn_window, max_seq)
        assert all(c["k"].shape[1] == ring for c in cache if "k" in c)
        assert prompt + steps > ring
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, prompt - 1].numpy(),
                               atol=ATOL)
    for t in range(prompt, prompt + steps):
        pos = np.full((2,), t, np.int32)
        jlogits, jcache = jmodel.decode_step(
            params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(
            torch.from_numpy(tokens[:, t:t + 1]), cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL,
                                   err_msg=f"{case} decode step at t={t}")
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)


def test_generate_greedy_matches_jax(pair):
    case, jcfg, jmodel, params, model = pair
    prompts = np.random.default_rng(3).integers(2, jcfg.vocab_size, (3, 8))  # seed 3
    n_new, max_seq = 6, 16
    jeng = JServeEngine(jmodel, params, max_seq=max_seq)
    jout = jeng.generate(
        [JRequest(prompt=p, max_new_tokens=n_new, rid=i) for i, p in enumerate(prompts)])
    # every greedy step's top-2 margin on the JAX side, fed its own tokens
    jtok = np.stack([np.asarray(j.tokens) for j in jout])
    logits, cache = jeng._prefill(params, jnp.asarray(prompts))
    margins = []
    for t in range(n_new):
        top2 = np.sort(np.asarray(logits[:, 0]), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if t + 1 < n_new:
            pos = jnp.full((3,), 8 + t, jnp.int32)
            logits, cache = jeng._decode(params, jnp.asarray(jtok[:, t:t + 1]), cache, pos)
    assert np.min(margins) > 1e-3, f"seed 3 gives a near tie: {np.min(margins)}"
    out = ServeEngine(model, max_seq=max_seq).generate(
        [Request(prompt=p, max_new_tokens=n_new, rid=i) for i, p in enumerate(prompts)])
    for j, o in zip(jout, out):
        np.testing.assert_array_equal(o.tokens, np.asarray(j.tokens))


def test_recurrentgemma_pattern_and_cache():
    cfg = get_config("recurrentgemma-9b")
    kinds = layer_kinds(cfg)
    assert len(kinds) == 38 and cfg.n_groups == 12 and cfg.tail_pattern == ("rglru",) * 2
    assert [k for k, _ in kinds] == ["rglru", "rglru", "attn"] * 12 + ["rglru"] * 2
    assert all(ffn == "mlp" for _, ffn in kinds)
    small = Model(get_config("recurrentgemma-9b").reduced(), device="cpu")
    caches = small.init_cache(3, 100)
    rc = small.cfg
    for layer, c in zip(small.layers, caches):
        if layer.kind == "rglru":
            assert c["conv"].shape == (3, rc.ssm_conv_width - 1, rc.rnn_dim)
            assert c["h"].shape == (3, rc.rnn_dim) and c["h"].dtype == torch.float32
        else:
            assert c["k"].shape == (3, 64, rc.n_kv_heads, rc.head_dim)


@pytest.mark.parametrize("case", ["recurrentgemma", "window16"])
def test_windowed_prefill_longer_than_the_ring_must_be_a_multiple(case):
    arch, overrides = CASES[case]
    cfg = get_config(arch).reduced(**overrides)
    model = Model(cfg, device="cpu")
    win = cfg.attn_window
    tokens = torch.from_numpy(_tokens(5, cfg.vocab_size, 1, win + 3))  # seed 5
    with pytest.raises(ValueError, match="multiple of the cache window"):
        model.prefill(tokens, 2 * win)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_attention_blocked_reads_the_window_span(softcap):
    """At chunk 16 a window of 16 over 64 steps takes the span of 32 keys
    a chunk; against the JAX function at the same chunk."""
    jcfg = jget_config("qwen3-1.7b").reduced(attn_window=16, attn_logit_softcap=softcap)
    cfg = get_config("qwen3-1.7b").reduced(attn_window=16, attn_logit_softcap=softcap)
    rng = np.random.default_rng(6)  # seed 6
    q = rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    want = jlayers.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jcfg, chunk=16)
    got = layers.attention_blocked(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), cfg, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _jax_scan(a, b, h0):
    """The reference's scan (``src/repro/models/layers.py:676-690``)."""
    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    h0 = jnp.zeros_like(a[:, :1]) if h0 is None else jnp.asarray(h0)[:, None]
    a_all = jnp.concatenate([jnp.ones_like(h0), jnp.asarray(a)], axis=1)
    b_all = jnp.concatenate([h0, jnp.asarray(b)], axis=1)
    return np.asarray(jax.lax.associative_scan(combine, (a_all, b_all), axis=1)[1][:, 1:])


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_ref_matches_associative_scan(with_h0):
    rng = np.random.default_rng(7)  # seed 7
    a = rng.uniform(0.8, 0.999, (2, 100, 64)).astype(np.float32)
    b = rng.standard_normal((2, 100, 64)).astype(np.float32) * 0.1
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 else None
    want = _jax_scan(a, b, h0)
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                             None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and got.shape == (2, 100, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # ops routes a CPU tensor to the plain version
    again = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert torch.equal(again, got)


def test_rglru_scan_cuda_refuses_cpu_tensors():
    a = torch.ones((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(a, a)


def test_rglru_init_draws_the_jax_distributions():
    cfg = get_config("recurrentgemma-9b").reduced(d_model=128, rnn_width=128)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mix = model.layers[0].mix
    assert mix.w_a.dtype == mix.w_x.dtype == mix.lam.dtype == torch.float32
    assert abs(float(mix.w_a.std()) - 0.02) < 2e-3
    want = jnp.log(jnp.expm1(jnp.linspace(0.3, 1.5, 128)))
    # linspace rounds differently in the two libraries: 1 ulp of its
    # values, 2.4e-7 after log(expm1(.)) where lam crosses 0
    np.testing.assert_allclose(mix.lam.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=3e-7)
    assert float(mix.b_a.abs().max()) == 0.0 == float(mix.conv_b.abs().max())
