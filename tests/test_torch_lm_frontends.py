"""PyTorch port, LM serving: the modality frontends — the VLM prefix
(internvl2) and the audio codebooks (musicgen) — against the JAX package.

Reduced ``internvl2-26b`` (8 precomputed patch embeddings ahead of the
tokens) and reduced ``musicgen-large`` (4 codebook streams, summed
embeddings, per-codebook heads), f32. The JAX model is initialized from
``PRNGKey(0)`` and ``convert.params_from_jax`` carries its parameters
across; tokens and patch embeddings come from ``np.random.default_rng``
with the seed named in each test.

Tolerance: atol 1e-4 on f32 logits (the JAX package's own prefill/decode
tolerance, ``tests/test_arch_smoke.py``). Greedy tokens must be equal; the
JAX side's top-2 margin at every step exceeds 1e-3. Temperature draws use
a ``torch.Generator``, not JAX's threefry: checked for shape, range and
determinism.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.lm_serve import Request as JRequest
from repro.models.lm_serve import ServeEngine as JServeEngine
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm_serve import Request, ServeEngine
from repro_torch.models.model import Model

ATOL = 1e-4


def _pair(arch):
    jcfg = jget_config(arch).reduced()
    jmodel = JModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, jmodel, params, model


@pytest.fixture(scope="module")
def vlm():
    return _pair("internvl2-26b")


@pytest.fixture(scope="module")
def audio():
    return _pair("musicgen-large")


def _prefix(seed, cfg, B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)


def _audio_tokens(seed, cfg, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S, cfg.n_codebooks))


# ---------------------------------------------------------------------------
# VLM prefix
# ---------------------------------------------------------------------------


def test_vlm_apply_with_prefix_matches_jax(vlm):
    jcfg, jmodel, params, model = vlm
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))  # seed 1
    prefix = _prefix(11, jcfg, 2)  # seed 11
    assert prefix.shape == (2, 8, jcfg.d_model)
    want, _ = jmodel.apply(params, jnp.asarray(tokens), jnp.asarray(prefix))
    with torch.no_grad():
        got, _ = model.apply(torch.from_numpy(tokens), torch.from_numpy(prefix))
    assert got.shape == (2, 8 + 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the prefix is read: without it the token positions' logits change
    with torch.no_grad():
        plain, _ = model.apply(torch.from_numpy(tokens))
    assert float((plain - got[:, 8:]).abs().max()) > 1e-3


def test_vlm_prefill_with_prefix_and_offset_decode_match_jax(vlm):
    """Prefill of prefix + prompt, then 8 decode steps at positions offset
    by the prefix (as ``tests/test_arch_smoke.py`` drives it), against JAX
    and against the port's full forward."""
    jcfg, jmodel, params, model = vlm
    P, steps, n_pre = 12, 8, jcfg.n_prefix_embeds
    max_seq = n_pre + P + steps
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, P + steps))  # seed 2
    prefix = _prefix(12, jcfg, 2)  # seed 12
    with torch.no_grad():
        full, _ = model.apply(torch.from_numpy(tokens), torch.from_numpy(prefix))
    jlast, jcache = jmodel.prefill(params, jnp.asarray(tokens[:, :P]), max_seq,
                                   jnp.asarray(prefix))
    last, cache = model.prefill(torch.from_numpy(tokens[:, :P]), max_seq,
                                torch.from_numpy(prefix))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, n_pre + P - 1].numpy(),
                               atol=ATOL)
    for t in range(P, P + steps):
        pos = np.full((2,), n_pre + t, np.int32)
        jlogits, jcache = jmodel.decode_step(
            params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(
            torch.from_numpy(tokens[:, t:t + 1]), cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL,
                                   err_msg=f"vlm decode step at t={t}")
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, n_pre + t].numpy(),
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# Audio codebooks
# ---------------------------------------------------------------------------


def test_audio_apply_logits_per_codebook_match_jax(audio):
    jcfg, jmodel, params, model = audio
    tokens = _audio_tokens(1, jcfg, 2, 32)  # seed 1
    want, _ = jmodel.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model.apply(torch.from_numpy(tokens))
    assert got.shape == (2, 32, 4, jcfg.vocab_size) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_audio_prefill_and_decode_match_jax(audio):
    jcfg, jmodel, params, model = audio
    P, steps, max_seq = 16, 8, 32
    tokens = _audio_tokens(2, jcfg, 2, P + steps)  # seed 2
    with torch.no_grad():
        full, _ = model.apply(torch.from_numpy(tokens))
    jlast, jcache = jmodel.prefill(params, jnp.asarray(tokens[:, :P]), max_seq)
    last, cache = model.prefill(torch.from_numpy(tokens[:, :P]), max_seq)
    assert last.shape == (2, 1, 4, jcfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, P - 1].numpy(), atol=ATOL)
    for t in range(P, P + steps):
        pos = np.full((2,), t, np.int32)
        jlogits, jcache = jmodel.decode_step(
            params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.asarray(pos))
        logits, cache = model.decode_step(
            torch.from_numpy(tokens[:, t:t + 1]), cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL,
                                   err_msg=f"audio decode step at t={t}")
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)


def _greedy_matches_jax(jmodel, params, model, prompts, seed):
    """Greedy ``generate`` of the port against the JAX engine's on the same
    prompts (6 new tokens), after asserting that every greedy choice on
    the JAX side has a top-2 margin above 1e-3."""
    n_new, max_seq, B, P = 6, 16, prompts.shape[0], prompts.shape[1]
    jeng = JServeEngine(jmodel, params, max_seq=max_seq)
    jout = jeng.generate(
        [JRequest(prompt=p, max_new_tokens=n_new, rid=i) for i, p in enumerate(prompts)])
    # every greedy step's top-2 margin on the JAX side, fed its own tokens
    jtok = np.stack([np.asarray(j.tokens) for j in jout])
    logits, cache = jeng._prefill(params, jnp.asarray(prompts))
    margins = []
    for t in range(n_new):
        top2 = np.sort(np.asarray(logits[:, 0]), axis=-1)[..., -2:]
        margins.append(top2[..., 1] - top2[..., 0])
        if t + 1 < n_new:
            pos = jnp.full((B,), P + t, jnp.int32)
            logits, cache = jeng._decode(params, jnp.asarray(jtok[:, t:t + 1]), cache, pos)
    assert np.min(margins) > 1e-3, f"seed {seed} gives a near tie: {np.min(margins)}"
    out = ServeEngine(model, max_seq=max_seq).generate(
        [Request(prompt=p, max_new_tokens=n_new, rid=i) for i, p in enumerate(prompts)])
    for j, o in zip(jout, out):
        assert o.tokens.shape == np.asarray(j.tokens).shape == (n_new,) + prompts.shape[2:]
        np.testing.assert_array_equal(o.tokens, np.asarray(j.tokens))


def test_vlm_generate_greedy_matches_jax(vlm):
    """The engine takes no prefix (the reference's has none): text prompts."""
    jcfg, jmodel, params, model = vlm
    prompts = np.random.default_rng(3).integers(2, jcfg.vocab_size, (3, 8))  # seed 3
    _greedy_matches_jax(jmodel, params, model, prompts, 3)


def test_audio_generate_greedy_matches_jax(audio):
    jcfg, jmodel, params, model = audio
    # seed 4: (P, K) prompts; seed 3 gives a top-2 margin of 2.0e-4 at one
    # of the 72 greedy choices (3 requests x 6 steps x 4 codebooks)
    _greedy_matches_jax(jmodel, params, model, _audio_tokens(4, jcfg, 3, 8), 4)


def test_audio_temperature_draws_per_codebook(audio):
    jcfg, _, _, model = audio
    prompts = _audio_tokens(8, jcfg, 4, 6)  # seed 8
    reqs = [Request(prompt=p, max_new_tokens=5, temperature=0.8, rid=i)
            for i, p in enumerate(prompts)]
    a = ServeEngine(model, max_seq=16, seed=5).generate(reqs)
    b = ServeEngine(model, max_seq=16, seed=5).generate(reqs)
    for x, y in zip(a, b):
        assert x.tokens.shape == (5, 4)
        assert x.tokens.min() >= 0 and x.tokens.max() < jcfg.vocab_size
        np.testing.assert_array_equal(x.tokens, y.tokens)
    draws = ServeEngine(model, seed=9)._sample(
        torch.zeros((3, 4, jcfg.vocab_size)), reqs[:3])
    assert draws.shape == (3, 4) and draws.dtype == torch.int32
    assert len(set(draws.flatten().tolist())) > 1  # a flat softmax: varied draws


def test_audio_greedy_sample_is_argmax_over_the_vocabulary(audio):
    _, _, _, model = audio
    logits = torch.tensor([[[0.0, 2.0, 2.0], [3.0, 1.0, 0.0]],
                           [[1.0, 1.0, 1.0], [0.0, 0.0, 5.0]]])
    got = ServeEngine(model)._sample(logits, [Request(prompt=np.zeros((1, 2)))] * 2)
    assert got.tolist() == [[1, 0], [0, 2]]
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist()


def test_launch_serve_musicgen_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "musicgen-large", "--device", "cpu", "--n-requests", "2",
          "--max-new-tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["request 0", "request 1"]
    for line in lines:
        toks = np.asarray(eval(line.split(":")[1]))
        assert toks.shape == (3, 4)
