"""PyTorch port, LM serving: the MoE family (llama4 scout and maverick)
against the JAX package.

Reduced ``llama4-scout-17b-a16e`` (every layer MoE) and reduced
``llama4-maverick-400b-a17b`` (``moe_period=2``: dense and MoE layers
interleaved), 4 experts, top-1, shared expert, f32. The JAX model is
initialized from ``PRNGKey(0)`` and ``convert.params_from_jax`` carries
its parameters across; tokens come from ``np.random.default_rng`` with the
seed named in each test.

Tolerance: atol 1e-4 on the logits and the aux terms (the JAX package's
own prefill/decode tolerance, ``tests/test_arch_smoke.py``): both sides
run the same f32 function with sums in another order. At the default
capacity factor 1.25 tokens are dropped, and both sides must drop the
same ones; at ``moe_capacity_factor = n_experts`` none is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
import repro_torch.models.layers as layers
from repro.configs import get_config as jget_config
from repro.models.lm_serve import Request as JRequest
from repro.models.lm_serve import ServeEngine as JServeEngine
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm_serve import Request, ServeEngine
from repro_torch.models.model import Model, layer_kinds

ATOL = 1e-4
ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX cfg, JAX model, JAX params, port state dict) on shared
    weights."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    jmodel = JModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    state = params_from_jax(jax.tree.map(np.asarray, params), get_config(arch).reduced())
    return arch, jcfg, jmodel, params, state


def _port(arch, state, **overrides) -> Model:
    model = Model(get_config(arch).reduced(**overrides), device="cpu")
    model.load_state_dict(state)
    return model


def _tokens(seed, vocab, B, S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _route_stats(model):
    stats = []
    for layer in model.layers:
        if isinstance(layer.ffn, layers.MoE):
            layer.ffn.route_stats = stats
    return stats


def test_layer_kinds_follow_ffn_kind_at(pair):
    arch, jcfg, *_ = pair
    kinds = layer_kinds(get_config(arch).reduced())
    want = [jcfg.ffn_kind_at(i % len(jcfg.block_pattern)) for i in range(jcfg.n_layers)]
    assert [ffn for _, ffn in kinds] == want
    assert "moe" in want and (arch.startswith("llama4-maverick") == ("mlp" in want))


@pytest.mark.parametrize("capacity", ["default", "n_experts"])
def test_apply_and_aux_match_jax(pair, capacity):
    arch, jcfg, _, params, state = pair
    overrides = {} if capacity == "default" else {"moe_capacity_factor": 4.0}
    tokens = _tokens(1, jcfg.vocab_size, 2, 32)  # seed 1
    want, jaux = JModel(dataclasses.replace(jcfg, **overrides)).apply(
        params, jnp.asarray(tokens))
    model = _port(arch, state, **overrides)
    stats = _route_stats(model)
    with torch.no_grad():
        got, aux = model.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for k in ("moe_load_balance", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=ATOL, err_msg=k)
        assert float(aux[k]) > 0.0
    dropped = sum(int(d) for _, d in stats)
    assert sum(int(c.sum()) for c, _ in stats) == 64 * len(stats)
    assert (dropped > 0) == (capacity == "default"), dropped


def test_multi_chunk_dispatch_matches_jax(pair, monkeypatch):
    """24 tokens a dispatch: 64 tokens of 2 x 32 route in 4 chunks of the
    sequence (3 does not divide 32), aux terms averaged over the chunks."""
    arch, jcfg, _, params, state = pair
    monkeypatch.setattr(jlayers, "MOE_CHUNK_TOKENS", 24)
    monkeypatch.setattr(layers, "MOE_CHUNK_TOKENS", 24)
    tokens = _tokens(4, jcfg.vocab_size, 2, 32)  # seed 4
    want, jaux = JModel(jcfg).apply(params, jnp.asarray(tokens))
    model = _port(arch, state)
    stats = _route_stats(model)
    with torch.no_grad():
        got, aux = model.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for k in ("moe_load_balance", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=ATOL, err_msg=k)
    n_moe = sum(isinstance(layer.ffn, layers.MoE) for layer in model.layers)
    assert len(stats) == 4 * n_moe
    assert all(int(c.sum()) == 16 for c, _ in stats)


def test_prefill_and_decode_match_jax(pair):
    """Prefill then 8 teacher-forced decode steps at the default capacity
    (decode's 2 tokens get capacity 1 over 4 experts: drops on both
    sides) against JAX's, and at capacity n_experts against the port's own
    full forward."""
    arch, jcfg, jmodel, params, state = pair
    prompt, steps, max_seq = 16, 8, 32
    tokens = _tokens(2, jcfg.vocab_size, 2, prompt + steps)  # seed 2
    model = _port(arch, state)
    jlast, jcache = jmodel.prefill(params, jnp.asarray(tokens[:, :prompt]), max_seq)
    last, cache = model.prefill(torch.from_numpy(tokens[:, :prompt]), max_seq)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    for t in range(prompt, prompt + steps):
        pos = np.full((2,), t, np.int32)
        jlogits, jcache = jmodel.decode_step(
            params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(
            torch.from_numpy(tokens[:, t:t + 1]), cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL,
                                   err_msg=f"{arch} decode step at t={t}")

    model = _port(arch, state, moe_capacity_factor=4.0)
    with torch.no_grad():
        full, _ = model.apply(torch.from_numpy(tokens))
    last, cache = model.prefill(torch.from_numpy(tokens[:, :prompt]), max_seq)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, prompt - 1].numpy(),
                               atol=ATOL)
    for t in range(prompt, prompt + steps):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]),
                                          cache, pos)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)


def test_generate_greedy_matches_jax(pair):
    arch, jcfg, jmodel, params, state = pair
    # seed 4: seed 3 gives maverick a top-2 margin of 1.0e-4 at one step
    prompts = np.random.default_rng(4).integers(2, jcfg.vocab_size, (3, 8))  # seed 4
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
    assert np.min(margins) > 1e-3, f"seed 4 gives a near tie: {np.min(margins)}"
    out = ServeEngine(_port(arch, state), max_seq=max_seq).generate(
        [Request(prompt=p, max_new_tokens=n_new, rid=i) for i, p in enumerate(prompts)])
    for j, o in zip(jout, out):
        assert o.rid == j.rid
        np.testing.assert_array_equal(o.tokens, np.asarray(j.tokens))


def test_moe_init_draws_the_jax_distributions():
    cfg = get_config("llama4-scout-17b-a16e").reduced(d_model=128, d_ff=256)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    moe = model.layers[0].ffn
    L = cfg.n_layers
    assert moe.router.dtype == torch.float32
    assert abs(float(moe.router.std()) - 0.02) < 2e-3
    assert abs(float(moe.experts_gate.std()) - 0.02) < 1e-3
    assert abs(float(moe.experts_down.std()) - 0.02 / np.sqrt(2 * L)) < 1e-3
    assert abs(float(moe.shared_up.std()) - 0.02) < 1e-3
    assert float(moe.ln.w.abs().max()) == 0.0
