"""PyTorch port, LM serving: configs, ``Model`` and ``ServeEngine`` against
the JAX package.

Reduced ``qwen3-1.7b`` (2 layers, d_model 64, GQA group 2) and reduced
``mamba2-130m`` (2 layers, chunk 16), both f32. The JAX model is
initialized from ``PRNGKey(0)`` and ``convert.params_from_jax`` carries
its parameters across, so both packages run the same weights; tokens come
from ``np.random.default_rng`` with the seed named in each test. The JAX
side runs through its Pallas kernels in interpret mode (``use_pallas``)
and through its plain path.

Tolerance: atol 1e-4 on the logits (the JAX package's own prefill/decode
tolerance, ``tests/test_arch_smoke.py``): both sides run the same f32
function with sums in another order. Greedy tokens must be equal; the
test asserts on the JAX side that every step's top-2 logit margin
exceeds 1e-3, so that order-of-summation differences cannot flip one.
Temperature sampling draws with a ``torch.Generator``, not JAX's
threefry: it is checked for determinism and against the softmax by
frequency, not token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models.config import param_count as jparam_count
from repro.models.lm_serve import Request as JRequest
from repro.models.lm_serve import ServeEngine as JServeEngine
from repro.models.model import Model as JModel
from repro_torch.configs import ARCH_IDS, all_arch_names, get_config
from repro_torch.models.config import param_count
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm_serve import Request, ServeEngine
from repro_torch.models.model import Model

ATOL = 1e-4
ARCHS = ("qwen3-1.7b", "mamba2-130m", "gemma-7b", "deepseek-coder-33b", "qwen3-4b")
# prompt length for the full-forward checks: 128 takes the JAX flash
# kernel (S % 128 == 0) for the dense configs; 48 is 3 chunks of mamba2's 16
SEQ = {"qwen3-1.7b": 128, "mamba2-130m": 48, "gemma-7b": 128,
       "deepseek-coder-33b": 128, "qwen3-4b": 128}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX cfg, JAX model, JAX params, port model) on shared weights."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    jmodel = JModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return arch, jcfg, jmodel, params, model


def _tokens(seed, vocab, B, S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_matches_jax(pair, use_pallas):
    arch, jcfg, _, params, model = pair
    tokens = _tokens(1, jcfg.vocab_size, 2, SEQ[arch])  # seed 1
    want, _ = JModel(dataclasses.replace(jcfg, use_pallas=use_pallas)).apply(
        params, jnp.asarray(tokens))
    got, aux = model.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux["moe_load_balance"]) == 0.0


# a 13-token prompt is not a multiple of mamba2's chunk of 16 (the JAX op
# takes its sequential path there)
PROMPT = {"qwen3-1.7b": 16, "mamba2-130m": 13, "gemma-7b": 16,
          "deepseek-coder-33b": 16, "qwen3-4b": 16}


def test_prefill_and_decode_match_jax(pair):
    """Prefill then 8 teacher-forced decode steps, against JAX's and against
    the port's own full forward."""
    arch, jcfg, jmodel, params, model = pair
    prompt, steps, max_seq = PROMPT[arch], 8, 32
    tokens = _tokens(2, jcfg.vocab_size, 2, prompt + steps)  # seed 2
    full, _ = model.apply(torch.from_numpy(tokens))
    jlast, jcache = jmodel.prefill(params, jnp.asarray(tokens[:, :prompt]), max_seq)
    last, cache = model.prefill(torch.from_numpy(tokens[:, :prompt]), max_seq)
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
                                   err_msg=f"{arch} decode step at t={t}")
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL)


def test_generate_greedy_matches_jax(pair):
    arch, jcfg, jmodel, params, model = pair
    rng = np.random.default_rng(3)  # seed 3
    prompts = rng.integers(2, jcfg.vocab_size, (3, 8))
    n_new, max_seq = 6, 16
    jeng = JServeEngine(jmodel, params, max_seq=max_seq)
    jout = jeng.generate(
        [JRequest(prompt=p, max_new_tokens=n_new, rid=i) for i, p in enumerate(prompts)])
    # every greedy step's top-2 margin on the JAX side, with the engine's
    # own jitted prefill and decode fed its own tokens
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
        assert o.rid == j.rid
        np.testing.assert_array_equal(o.tokens, np.asarray(j.tokens))


def test_generate_respects_max_new_tokens_and_refuses_ragged(pair):
    _, jcfg, _, _, model = pair
    eng = ServeEngine(model, max_seq=16)
    out = eng.generate([Request(prompt=np.arange(4), max_new_tokens=n, rid=n)
                        for n in (1, 3)])
    assert [len(o.tokens) for o in out] == [1, 3]
    assert all(0 <= t < jcfg.vocab_size for o in out for t in o.tokens)
    with pytest.raises(ValueError, match="ragged"):
        eng.generate([Request(prompt=np.arange(4)), Request(prompt=np.arange(5))])
    with pytest.raises(ValueError, match="empty"):
        eng.generate([])


def test_temperature_sampling_seeded_and_varied(pair):
    _, _, _, _, model = pair
    reqs = [Request(prompt=np.arange(6), max_new_tokens=8, temperature=0.8, rid=i)
            for i in range(4)]
    a = ServeEngine(model, max_seq=16, seed=5).generate(reqs)
    b = ServeEngine(model, max_seq=16, seed=5).generate(reqs)
    c = ServeEngine(model, max_seq=16, seed=6).generate(reqs)
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    # same prompt, independent draws: the requests do not all agree
    assert len({tuple(x.tokens) for x in a}) > 1
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))


def test_temperature_draws_follow_softmax():
    """Frequencies of 20,000 draws from one logit vector at t = 0.7 lie
    within 4 sigma of softmax(logits / t)."""
    cfg = get_config("qwen3-1.7b").reduced()
    eng = ServeEngine(Model(cfg, device="cpu"), seed=7)  # seed 7
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, -3.0, 0.2, 1.5])
    n = 20_000
    reqs = [Request(prompt=np.zeros(1), temperature=0.7)] * n
    draws = eng._sample(logits.expand(n, -1), reqs).numpy()
    p = torch.softmax(logits / 0.7, dim=-1).numpy()
    freq = np.bincount(draws, minlength=8) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * sigma + 1e-12), (freq, p)


def test_greedy_argmax_takes_the_first_maximum():
    cfg = get_config("qwen3-1.7b").reduced()
    eng = ServeEngine(Model(cfg, device="cpu"))
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, 5.0, 5.0, 5.0]])
    got = eng._sample(logits, [Request(prompt=np.zeros(1))] * 2)
    assert got.tolist() == [1, 0] == np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist()


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("mamba2-130m").reduced())


def test_configs_and_param_counts_match_jax():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in all_arch_names():
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), arch
        assert param_count(cfg) == jparam_count(jcfg), arch
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert param_count(get_config("qwen3-1.7b")) == 1_720_634_368
    assert param_count(get_config("mamba2-130m")) == 128_941_248


@pytest.mark.parametrize("arch", all_arch_names())
def test_every_arch_builds_and_serves(arch):
    """Every configuration of the registry builds and serves greedy tokens
    on the CPU at its reduced size (the families' parity with the JAX
    package is in tests/test_torch_lm_moe.py, test_torch_lm_hybrid.py and
    test_torch_lm_frontends.py)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shape = (5, cfg.n_codebooks) if cfg.n_codebooks else (5,)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, shape)  # seed 9
    out = ServeEngine(model, max_seq=16).generate([Request(prompt=prompt, max_new_tokens=3)])
    assert out[0].tokens.shape == (3,) + shape[1:]
    assert 0 <= out[0].tokens.min() and out[0].tokens.max() < cfg.vocab_size


def test_init_draws_the_jax_distributions():
    cfg = get_config("qwen3-1.7b").reduced(d_model=256, d_ff=512)
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    L = cfg.n_layers
    assert abs(float(a.embed.std()) - 0.02) < 1e-3
    attn = a.layers[0].mix
    assert abs(float(attn.wq.std()) - 0.02) < 1e-3
    assert abs(float(attn.wo.std()) - 0.02 / np.sqrt(2 * L)) < 1e-3
    assert abs(float(a.layers[1].ffn.w_down.std()) - 0.02 / np.sqrt(2 * L)) < 1e-3
    assert float(attn.q_norm.w.abs().max()) == 0.0 == float(a.final_ln.w.abs().max())

    mcfg = get_config("mamba2-130m").reduced()
    m = Model(mcfg, device="cpu").init(torch.Generator().manual_seed(0))
    mix = m.layers[0].mix
    want = jnp.log(jnp.linspace(1.0, 16.0, mcfg.ssm_heads, dtype=jnp.float32))
    # linspace and log round differently in the two libraries: 1 ulp
    np.testing.assert_allclose(mix.a_log_p.numpy(), np.asarray(want), rtol=1e-6)
    assert float(mix.d_skip.min()) == 1.0 == float(mix.d_skip.max())
    assert float(mix.conv_b.abs().max()) == 0.0 == float(mix.dt_bias.abs().max())


def test_params_from_jax_unstacks_every_group(pair):
    arch, jcfg, _, params, model = pair
    assert jcfg.n_groups == len(model.layers) == 2
    name = "in_proj" if arch.startswith("mamba") else "wq"
    for g in range(2):
        np.testing.assert_array_equal(
            getattr(model.layers[g].mix, name).numpy(),
            np.asarray(params["groups"]["slot0"]["mix"][name][g]))


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "mamba2-130m", "--device", "cpu", "--n-requests", "2",
          "--max-new-tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["request 0", "request 1"]
    assert all(len(eval(line.split(":")[1])) == 3 for line in lines)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--device", "cpu", "--ckpt-dir", "/nonexistent"])


def test_serving_modules_import_neither_jax_nor_the_reference():
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys, repro_torch.models.lm_serve, repro_torch.models.convert, "
        "repro_torch.models.layers, repro_torch.models.model, "
        "repro_torch.kernels.rglru_scan, repro_torch.launch.serve, "
        "repro_torch.configs.qwen3_1_7b, repro_torch.configs.llama4_scout_17b_a16e, "
        "repro_torch.configs.recurrentgemma_9b, repro_torch.configs.internvl2_26b, "
        "repro_torch.configs.musicgen_large; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(src)},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
