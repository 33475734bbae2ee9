"""PyTorch port, training: the optimizer, checkpoints, the trainer, the
walk corpus and the launchers against the JAX package on the CPU.

The optimizer gets the same numpy gradients in both packages: AdamW (with
and without int8 error feedback) and Adafactor must agree to atol 1e-6
(both run the same f32 arithmetic, in another order inside XLA's fused
loops). Checkpoints cross packages both ways, f32 trees exactly; a bf16
leaf, written by the JAX package as raw 2-byte ``|V2`` bytes, the port
reads back exactly (the JAX package's own restore refuses it: ROADMAP
Queue 3 fault 7). The trainer runs a reduced qwen3 (2 layers, d_model 32,
f32) from the JAX parameters carried across, on synthetic batches: the
loss history must stay within 1e-4 of the JAX trainer's over 10 steps,
and the gradients at the JAX trainer's parameters before every step
within rtol 1e-4 plus 1e-6 of the largest (parameters are not compared
step by step: AdamW's first steps turn a 1e-9 difference in a near-zero
gradient into a step of plus or minus lr). Batches of the walk corpus and
the synthetic stream must equal the JAX package's bit for bit (the VLM
stub's normal draws within 1e-5 relative: ``erfinv`` differs in the last
bits, most in the tails).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models.model import Model as JModel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_loop import Trainer as JTrainer
from repro.train.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import Trainer, TrainerConfig

from _torch_parity import assert_network_identical

ATOL_OPT = 1e-6
SHAPES = {"a": (4, 8), "b": (8,), "c": (3, 2, 5)}


def _tree(rng, scale=1.0):
    """A parameter tree of numpy f32 leaves; a few entries near zero."""
    out = {}
    for k, shape in SHAPES.items():
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        x.reshape(-1)[:2] = np.float32(1e-9)
        out[k] = x
    return out


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, atol=ATOL_OPT):
    for (path, g), (_, w) in zip(opt.tree_leaves(got), opt.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg="/".join(path))


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_jax(compress):
    rng = np.random.default_rng(50)  # seed 50
    cfg = jopt.AdamWConfig(lr_peak=1e-2, warmup_steps=2, decay_steps=6,
                           compress_grads=compress)
    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    params = _tree(rng)
    jstate = jopt.init_opt_state(_j(params), cfg)
    state = opt.init_opt_state(_t(params), pcfg)
    for _ in range(4):
        grads = _tree(rng, 0.1)
        jmaster, jstate = jopt.adamw_update(_j(grads), jstate, cfg)
        master, state = opt.adamw_update(_t(grads), state, pcfg)
        _close(master, jmaster)
        for k in ("mu", "nu") + (("ef",) if compress else ()):
            _close(state[k], jstate[k])
        assert int(state["count"]) == int(jstate["count"])
        assert state["count"].dtype == torch.int32
    cast = opt.cast_like(master, {k: torch.zeros(1, dtype=torch.bfloat16) for k in SHAPES})
    assert all(t.dtype == torch.bfloat16 for t in cast.values())


def test_int8_quantization_rounds_half_to_even_as_jax():
    g = np.array([2.5, -2.5, 0.5, 1.5, -0.5, 127.0, 3.49], np.float32)
    ef = np.zeros_like(g)
    jdeq, jef = jopt._quantize_int8(jnp.asarray(g), jnp.asarray(ef))
    deq, new_ef = opt._quantize_int8(torch.from_numpy(g), torch.from_numpy(ef))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(new_ef.numpy(), np.asarray(jef))
    np.testing.assert_array_equal(deq.numpy()[:5], [2.0, -2.0, 0.0, 2.0, -0.0])


def test_adafactor_update_matches_jax():
    rng = np.random.default_rng(51)  # seed 51
    cfg = jopt.AdamWConfig(lr_peak=1e-2, warmup_steps=2, decay_steps=6)
    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    params = _tree(rng)
    jinit, jupd = jopt.make_optimizer("adafactor", cfg)
    init, upd = opt.make_optimizer("adafactor", pcfg)
    jstate, state = jinit(_j(params)), init(_t(params))
    for _ in range(3):
        grads = _tree(rng, 0.1)
        jmaster, jstate = jupd(_j(grads), jstate)
        master, state = upd(_t(grads), state)
        _close(master, jmaster)
        _close(state["stats"], jstate["stats"])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 200])
def test_lr_schedule_matches_jax(step):
    cfg = jopt.AdamWConfig(lr_peak=3e-3, lr_min=3e-4, warmup_steps=10, decay_steps=100)
    want = float(jopt.lr_schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = float(opt.lr_schedule(opt.AdamWConfig(**dataclasses.asdict(cfg)),
                                torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_atomicity_and_gc(tmp_path):
    state = {"x": torch.arange(8.0), "step_data": torch.ones((2, 2))}
    for step in (10, 20, 30, 40):
        ckpt.save_checkpoint(tmp_path, step, state, keep_last=2)
    (tmp_path / ".tmp_half_written").mkdir()
    ckpt.save_checkpoint(tmp_path, 50, state, keep_last=2)
    kept = sorted(d.name for d in tmp_path.glob("step_*"))
    assert kept == ["step_00000040", "step_00000050"]
    assert not list(tmp_path.glob(".tmp_*"))
    (tmp_path / "step_00000099").mkdir()  # uncommitted: invisible
    assert ckpt.latest_checkpoint(tmp_path).name == "step_00000050"
    assert ckpt.latest_checkpoint(tmp_path / "none") is None
    with pytest.raises(ValueError, match="not committed"):
        ckpt.restore_checkpoint(tmp_path / "step_00000099", state)


def test_restore_shape_guard_and_missing_leaf(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, {"w": torch.ones((3,))})
    latest = ckpt.latest_checkpoint(tmp_path)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(latest, {"w": torch.ones((4,))})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_checkpoint(latest, {"v": torch.ones((3,))})
    manifest = json.loads((latest / "manifest.json").read_text())
    assert manifest == {"step": 1, "keys": ["w"], "data_state": {},
                        "format": "repro-ckpt/1"}


def _nested(rng):
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "groups": {"slot0": {"b": rng.normal(size=(2, 5)).astype(np.float32)}}},
            "opt": {"count": np.asarray(7, np.int32)}}


def test_checkpoints_cross_packages_both_ways(tmp_path):
    rng = np.random.default_rng(52)  # seed 52
    tree = _nested(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    jckpt.save_checkpoint(tmp_path / "j", 3, jtree, data_state={"seed": 1, "step": 3})
    ckpt.save_checkpoint(tmp_path / "t", 3, ttree, data_state={"seed": 1, "step": 3})
    for d in ("j", "t"):  # same manifest, byte for byte
        assert ((tmp_path / d / "step_00000003" / "manifest.json").read_text()
                == (tmp_path / "j" / "step_00000003" / "manifest.json").read_text())
    got, step, data = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(tmp_path / "j"), ttree)
    assert (step, data) == (3, {"seed": 1, "step": 3})
    for (_, g), (_, w) in zip(opt.tree_leaves(got), opt.tree_leaves(ttree)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jgot, jstep, _ = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(tmp_path / "t"), jtree)
    assert jstep == 3
    for g, w in zip(jax.tree.leaves(jgot), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bf16_leaf_written_by_jax_restores_in_the_port(tmp_path):
    vals = np.array([1.0, -2.5, 3.140625, 65280.0, 1e-3], np.float32)
    leaf = jnp.asarray(vals, jnp.bfloat16)
    jckpt.save_checkpoint(tmp_path, 1, {"w": leaf})
    latest = jckpt.latest_checkpoint(tmp_path)
    with np.load(latest / "arrays.npz") as z:
        assert z["w"].dtype == np.dtype("V2")  # raw bytes, as numpy keeps bf16
    # the reference's own restore: numpy has no cast from |V2 (fault 7)
    with pytest.raises((TypeError, ValueError), match="cast"):
        jckpt.restore_checkpoint(latest, {"w": leaf})
    got, _, _ = ckpt.restore_checkpoint(latest, {"w": torch.zeros(5, dtype=torch.bfloat16)})
    want = np.asarray(leaf).astype(np.float32)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), want)
    # and the port writes bf16 the same way
    ckpt.save_checkpoint(tmp_path / "t", 1, {"w": got["w"]})
    with np.load(ckpt.latest_checkpoint(tmp_path / "t") / "arrays.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            z["w"].view(ml_dtypes.bfloat16).astype(np.float32), want)


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer
# ---------------------------------------------------------------------------

OPT = dict(lr_peak=1e-2, warmup_steps=2, decay_steps=20)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX model, JAX params, port cfg) of a reduced qwen3, f32."""
    over = dict(n_layers=2, d_model=32, d_ff=64)
    jcfg = jget_config("qwen3-1.7b").reduced(**over)
    jmodel = JModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    return jcfg, jmodel, params, get_config("qwen3-1.7b").reduced(**over)


def _port_model(cfg, jparams):
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return model


def _batches(vocab):
    def jbatch(step):
        return jpipe.synthetic_batch_at(step, seed=7, batch_size=4, seq_len=16,
                                        vocab_size=vocab)

    def tbatch(step):
        return pipeline.synthetic_batch_at(step, seed=7, batch_size=4, seq_len=16,
                                           vocab_size=vocab, device="cpu")
    return jbatch, tbatch


def _grads_close(tgrads, jgrads, cfg):
    tj = params_to_jax(tgrads, cfg)
    for (path, g), w in zip(opt.tree_leaves(tj), jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg="/".join(path))


def test_trainer_matches_jax_trainer(tiny, tmp_path):
    jcfg, jmodel, params, cfg = tiny
    jbatch, tbatch = _batches(cfg.vocab_size)
    jopt_cfg = jopt.AdamWConfig(**OPT)
    jtr = JTrainer(jmodel, jopt_cfg, JTrainerConfig(
        steps=10, ckpt_dir=str(tmp_path / "j"), ckpt_every=100, log_every=1))
    seen = [params]
    _, jhist = jtr.fit({"params": params, "opt": jopt.init_opt_state(params, jopt_cfg)},
                       jbatch, resume=False,
                       on_step=lambda step, state, m: seen.append(state["params"]))
    model = _port_model(cfg, params)
    tr = Trainer(model, opt.AdamWConfig(**OPT), TrainerConfig(
        steps=10, ckpt_dir=str(tmp_path / "t"), ckpt_every=100, log_every=1))
    _, hist = tr.fit(tr.state_of_model(), tbatch, resume=False)
    assert [s for s, _ in hist] == [s for s, _ in jhist] == list(range(1, 11))
    np.testing.assert_allclose([x for _, x in hist], [x for _, x in jhist], atol=1e-4)
    # the gradients at the JAX trainer's parameters before each step
    jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    for step in range(10):
        jp = seen[step]
        m = _port_model(cfg, jp)
        loss, _ = m.loss(tbatch(step))
        names = [n for n, _ in m.named_parameters()]
        tg = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
        _grads_close(dict(zip(names, tg)), jgrad(jp, jbatch(step)), cfg)


def _trainer(cfg, params, tmp, **kw):
    model = _port_model(cfg, params)
    tcfg = dict(steps=8, ckpt_dir=str(tmp), ckpt_every=100, log_every=100, seed=3)
    tcfg.update(kw)
    return Trainer(model, opt.AdamWConfig(**OPT), TrainerConfig(**tcfg))


def test_resume_is_bitwise_identical_and_crosses_to_jax(tiny, tmp_path):
    jcfg, jmodel, params, cfg = tiny
    _, tbatch = _batches(cfg.vocab_size)
    tr = _trainer(cfg, params, tmp_path / "a")
    state_a, _ = tr.fit(tr.state_of_model(), tbatch, resume=False)
    tr = _trainer(cfg, params, tmp_path / "b", steps=4, ckpt_every=4)
    tr.fit(tr.state_of_model(), tbatch, resume=False)
    tr = _trainer(cfg, jmodel.init(jax.random.PRNGKey(9)), tmp_path / "b", ckpt_every=4)
    state_b, _ = tr.fit(None, tbatch, resume=True)  # restores step 4 into it
    for name, p in state_a["params"].items():
        assert torch.equal(p, state_b["params"][name]), name
    for k in ("master", "mu", "nu"):
        for name, t in state_a["opt"][k].items():
            assert torch.equal(t, state_b["opt"][k][name]), (k, name)
    assert int(state_b["opt"]["count"]) == 8
    latest = ckpt.latest_checkpoint(tmp_path / "b")
    manifest = json.loads((latest / "manifest.json").read_text())
    assert manifest["data_state"] == {"seed": 3, "step": 8}
    # the JAX package restores the port's trainer checkpoint
    jtpl = {"params": params, "opt": jopt.init_opt_state(params, jopt.AdamWConfig())}
    jstate, step, _ = jckpt.restore_checkpoint(latest, jtpl)
    assert step == 8
    for (path, t), w in zip(opt.tree_leaves(params_to_jax(state_b["params"], cfg)),
                            jax.tree.leaves(jstate["params"])):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(w))
    # and the port's trainer restores the JAX trainer's checkpoint
    jtr = JTrainer(jmodel, jopt.AdamWConfig(**OPT), JTrainerConfig(
        steps=2, ckpt_dir=str(tmp_path / "j"), ckpt_every=100, log_every=100))
    jfinal, _ = jtr.fit({"params": params,
                         "opt": jopt.init_opt_state(params, jopt.AdamWConfig(**OPT))},
                        _batches(cfg.vocab_size)[0], resume=False)
    tr = _trainer(cfg, jmodel.init(jax.random.PRNGKey(9)), tmp_path / "j")
    state = tr.state_of_model()
    assert tr.restore(ckpt.latest_checkpoint(tmp_path / "j"), state) == 2
    for (path, t), w in zip(opt.tree_leaves(params_to_jax(state["params"], cfg)),
                            jax.tree.leaves(jfinal["params"])):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(w))
    assert int(state["opt"]["count"]) == 2


def test_grad_accum_matches_full_batch(tiny, tmp_path):
    jcfg, jmodel, params, cfg = tiny
    _, tbatch = _batches(cfg.vocab_size)
    outs = []
    for accum in (1, 2):
        tr = _trainer(cfg, params, tmp_path / f"acc{accum}", steps=3, accum_steps=accum)
        state, _ = tr.fit(tr.state_of_model(), tbatch, resume=False)
        outs.append(state)
    for name, p in outs[0]["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   outs[1]["params"][name].detach().numpy(), atol=2e-2)


def test_trainer_refuses_a_mesh_policy(tiny):
    with pytest.raises(NotImplementedError, match="13.5"):
        Trainer(Model(tiny[3], device="cpu"), opt.AdamWConfig(), TrainerConfig(),
                policy=object())


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    jnet = jpipe.demo_population_network(400, seed=2)
    tnet = pipeline.demo_population_network(400, seed=2, device="cpu")
    assert_network_identical(tnet, jnet)  # the port's generators, same network
    return jnet, tnet


@pytest.mark.parametrize("case", [
    dict(),
    dict(n_codebooks=2),
    dict(prefix_embeds=3, d_model=8, walk_layers=("Random", "Workplaces"),
         layer_weights=(1.0, 3.0)),
])
def test_walk_corpus_batches_equal_jax(nets, case):
    jnet, tnet = nets
    cfg = dict(seed=11, batch_size=3, seq_len=12, **case)
    jc = jpipe.WalkCorpus(jnet, jpipe.WalkCorpusConfig(**cfg), vocab_size=97)
    tc = pipeline.WalkCorpus(tnet, pipeline.WalkCorpusConfig(**cfg), vocab_size=97)
    for step in (0, 1, 17):
        want, got = jc.batch_at(step), tc.batch_at(step)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "targets", "loss_mask"):
            assert got[key].dtype == {"loss_mask": torch.float32}.get(key, torch.int32)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        if "prefix_embeds" in want:
            np.testing.assert_allclose(got["prefix_embeds"].numpy(),
                                       np.asarray(want["prefix_embeds"]), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("case", [dict(), dict(n_codebooks=3),
                                  dict(prefix_embeds=2, d_model=4)])
def test_synthetic_batches_equal_jax(case):
    for step in (0, 3):
        kw = dict(seed=5, batch_size=3, seq_len=9, vocab_size=53, **case)
        want = jpipe.synthetic_batch_at(step, **kw)
        got = pipeline.synthetic_batch_at(step, device="cpu", **kw)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "targets", "loss_mask"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        if "prefix_embeds" in want:
            np.testing.assert_allclose(got["prefix_embeds"].numpy(),
                                       np.asarray(want["prefix_embeds"]), atol=1e-6,
                                       rtol=0)


def test_normal_draws_equal_jax():
    from repro_torch.core import prng

    for seed, shape in ((0, (1000,)), (7, (3, 33))):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(prng.key(seed), shape, "cpu").numpy()
        # erfinv is steep near +-1: the tails differ by up to ~3e-6 relative
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def test_launch_train_then_serve_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve, train

    args = ["--arch", "qwen3-1.7b", "--device", "cpu", "--batch-size", "2",
            "--seq-len", "16", "--graph-nodes", "300", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train.main(args + ["--steps", "3"])
    assert sorted(d.name for d in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003"]
    train.main(args + ["--steps", "4"])  # resumes at 3, takes one more step
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["data_state"] == {"seed": 0, "step": 4}
    capsys.readouterr()
    serve.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                "--n-requests", "2", "--max-new-tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "restored params from step 4"
    assert [line.split(":")[0] for line in lines[1:]] == ["request 0", "request 1"]
