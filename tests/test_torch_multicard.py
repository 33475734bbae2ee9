"""The port's multi-card path on the CPU: policies over device meshes of
gloo worlds, held against the JAX package's single-device run and the
port's one-card run.

One subprocess (``tests/_torch_multicard_worker.py``, at most 120 s) runs
two worlds: four ranks that train a reduced qwen3 under a (2, 2)
DP x TP mesh (SGD on the JAX package's parameters, the ``Trainer`` with
AdamW, global-norm clipping and once int8 compression with gradient
accumulation), the reduced
mamba2-130m under the DP-only fold, save a checkpoint and serve greedy
tokens with a heads-sharded cache and, on a (1, 4) mesh, a
sequence-sharded one; then two ranks that restore that checkpoint and
save it again. While it runs, this process computes the JAX package's
losses (``tests/test_distributed.py`` holds its own sharded run to the
same single-device losses) and the port's one-card results from the same
seeds. Tolerances are stated beside each check.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models.model import Model as JModel
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.models.sharding import MeshPolicy, MeshShape
from repro_torch.train.checkpoint import latest_checkpoint

import _torch_multicard_worker as worker

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD_TIMEOUT_S = 120
# the port's placed run against its one-card run: the same arithmetic on
# each rank's shard; sums over ranks reorder only a few reductions
PORT_RTOL = 1e-5
# AdamW's parameters after 3 steps of lr 1e-2: a step moves each by about
# lr whatever its gradient's size, so the rounding of a gradient near 0 (or,
# compressed, an int8 rounding boundary) moves it by a share of lr
PARAM_ATOL = 1e-2 * 1e-2
JAX_RTOL = 2e-2  # tests/test_distributed.py:69 holds its sharded run to this


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Starts the two worlds, then, while they run, writes the JAX
    package's parameters for them and computes the references of this
    process -> (what rank 0 of each world wrote, the references, workdir)."""
    work = tmp_path_factory.mktemp("multicard")
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{TESTS}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(TESTS / "_torch_multicard_worker.py"),
                             str(work)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        jcfg = jget_config("qwen3-1.7b").reduced(**worker.QWEN)
        jmodel = JModel(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = worker.qwen_cfg()
        state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
        torch.save(state, work / "qwen3_state.tmp")
        os.replace(work / "qwen3_state.tmp", work / "qwen3_state.pt")
        ref = _references(jmodel, jparams, cfg, state)
        out, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-6000:]
    return (torch.load(work / "world4.pt", weights_only=False),
            torch.load(work / "world2.pt", weights_only=False), ref, work)


def _references(jmodel, jparams, cfg, state) -> dict:
    @jax.jit
    def step(p, b):
        loss, g = jax.value_and_grad(lambda pp: jmodel.loss(pp, b)[0])(p)
        return loss, jax.tree.map(lambda pp, gg: pp - worker.SGD_LR * gg.astype(pp.dtype),
                                  p, g)

    jax_losses, p = [], jparams
    for t in range(worker.SGD_STEPS):
        b = jpipe.synthetic_batch_at(t, seed=3, batch_size=8, seq_len=16,
                                     vocab_size=cfg.vocab_size)
        loss, p = step(p, b)
        jax_losses.append(float(loss))
    model = Model(cfg, device="cpu")
    model.load_state_dict(state)
    return {"jax": jax_losses, "sgd": worker.sgd_losses(model, MeshPolicy()),
            "trainer": {c: worker.trainer_run(cfg, None, c) for c in (False, True)},
            "mamba": worker.mamba_run(MeshPolicy()),
            "serve": worker.serve_run(None)}


def test_sgd_under_dp_tp_matches_jax_and_one_card(worlds):
    """(a) 4 SGD steps under a (2, 2) mesh, dp ('data',), tp 'model'."""
    w4, _, ref, _ = worlds
    np.testing.assert_allclose(w4["sgd"], ref["jax"], rtol=JAX_RTOL)
    np.testing.assert_allclose(w4["sgd"], ref["sgd"], rtol=PORT_RTOL)


def test_parameters_are_dtensors_laid_out_by_param_specs(worlds):
    w4, *_ = worlds
    assert w4["all_placed"]
    pl = w4["placements"]
    # wq (d, heads, dh): d on 'data' (FSDP), heads on 'model'
    assert pl["layers.0.mix.wq"] == ["S0", "S1"]
    assert w4["local_wq"] == (32, 1, 32)
    # the reduced qwen3's single kv head does not divide tp 2: replicated there
    assert pl["layers.0.mix.wk"] == ["S0", "R"]
    assert pl["layers.0.mix.wo"] == ["S2", "S0"]
    assert pl["embed"] == ["S1", "S0"]  # vocab on tp, d on dp
    assert pl["layers.0.mix.ln.w"] == ["R", "R"]


@pytest.mark.parametrize("compress", [False, True])
def test_trainer_under_dp_tp_matches_one_card(worlds, compress):
    """(b) the Trainer's AdamW steps (clip 0.5 global norm; int8 error
    feedback and 2 accumulated microbatches when ``compress``): losses and
    final parameters."""
    w4, _, ref, _ = worlds
    got, want = w4["trainer"][compress], ref["trainer"][compress]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=PORT_RTOL)
    for name, p in want["params"].items():
        torch.testing.assert_close(got["params"][name], p, rtol=0, atol=PARAM_ATOL,
                                   msg=name)


def test_mamba_dp_only_fold_matches_one_card(worlds):
    """(c) mamba2-130m reduced, dp ('data', 'model') and no tp."""
    w4, _, ref, _ = worlds
    np.testing.assert_allclose(w4["mamba"]["losses"], ref["mamba"]["losses"],
                               rtol=PORT_RTOL)
    np.testing.assert_allclose(w4["mamba"]["grad_sq"], ref["mamba"]["grad_sq"],
                               rtol=1e-4)


def _npz(path: Path) -> dict:
    with np.load(path / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("where", ["two ranks", "one process"])
def test_checkpoint_restores_across_topologies(worlds, where, tmp_path):
    """(d) a checkpoint saved under (2, 2) restores bit for bit on a 2-rank
    (2, 1) mesh and in one process, and a save from either equals it key
    by key."""
    w4, w2, _, work = worlds
    saved = w4["saved"]
    if where == "two ranks":
        assert w2["step"] == 1
        restored, again = w2["restored"], work / "ckpt2"
    else:
        tr = worker.trainer(worker.qwen_cfg(), None, False, str(tmp_path))
        state = tr.state_of_model()
        assert tr.restore(latest_checkpoint(work / "ckpt4"), state) == 1
        tr.save(state, 1)
        restored = {k: {n: t.detach() for n, t in tree.items()} for k, tree in (
            ("params", state["params"]),
            *((k, state["opt"][k]) for k in ("master", "mu", "nu")))}
        again = tmp_path
    for k, tree in saved.items():
        for n, t in tree.items():
            assert torch.equal(restored[k][n], t), (k, n)
    first, second = _npz(latest_checkpoint(work / "ckpt4")), _npz(latest_checkpoint(again))
    assert first.keys() == second.keys()
    for key, a in first.items():
        assert a.dtype == second[key].dtype and np.array_equal(a, second[key]), key


@pytest.mark.parametrize("cache", ["heads", "seq"])
def test_serve_matches_one_card(worlds, cache):
    """(e) greedy tokens and every step's logits (atol 1e-5; f32) of the
    engine under (2, 2) with 2 kv heads on tp 2 (heads-sharded cache) and
    under (1, 4), where they do not divide tp (sequence-sharded cache)."""
    w4, _, ref, _ = worlds
    got, want = w4["serve"][cache], ref["serve"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    torch.testing.assert_close(got["logits"], want["logits"], rtol=0, atol=1e-5)
    assert got["cache"] == (["S0", "S1"] if cache == "seq" else ["S0", "S2"])


@pytest.mark.parametrize("arch,missing", [
    ("llama4-scout-17b-a16e", "MoE expert parallelism"),
    ("recurrentgemma-9b", "RG-LRU hybrid"),
    ("internvl2-26b", "VLM prefix"),
    ("musicgen-large", "audio codebooks"),
    ("qwen3-1.7b", "seq_parallel"),
])
def test_families_outside_the_slice_refuse_by_name(worlds, arch, missing):
    msg = worlds[0]["refusals"][arch]
    assert msg is not None and missing in msg and "multi-card path" in msg
    assert msg.startswith(arch)


@pytest.mark.parametrize("op", ["flash_attention", "rmsnorm", "ssd_scan", "rglru_scan"])
def test_kernel_routes_on_dtensors_match_whole_tensors(worlds, op):
    """Each LM op's ``local_map`` route on (2, 2), its first operand laid
    out as the layers lay it out and the others on the batch only: outputs
    and gradients of every operand equal the op on whole tensors within
    1e-5 of their largest magnitude (f32; a weight's gradient sums partial
    sums across ranks in another order)."""
    out_err, grad_err = worlds[0]["kernel_routes"][op]
    assert out_err < 1e-5 and grad_err < 1e-5, (out_err, grad_err)


def test_placements_follow_the_spec():
    """A spec's entries as placements, one a mesh dim, without a world: a
    tuple entry shards its dim over each of its axes in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    pol = MeshPolicy(MeshShape((2, 2), ("data", "model")), dp=("data", "model"))
    assert pol.placements((("data", "model"), None)) == [Shard(0), Shard(0)]
    assert pol.placements((None, "model", "data")) == [Shard(2), Shard(1)]
    assert pol.placements(()) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        pol.placements((("model", "data"),))
    assert not pol.placed
    with pytest.raises(NotImplementedError, match="multi-card path"):
        pol.act_bsd(torch.zeros(2, 3, 4))
