"""PyTorch port, training: ``Model.loss`` and the gradient of every
parameter against ``jax.value_and_grad(Model.loss)`` on the CPU, for each
model family at ``reduced()`` (f32): dense qwen3, MoE scout, the RG-LRU
hybrid recurrentgemma, Mamba2, the VLM internvl2 with its patch prefix,
and the audio musicgen with its codebooks. The parameters are carried
across the other way: the port's model is drawn from a seeded generator
(the JAX ``init``'s distributions) and ``convert.params_to_jax`` gives the
JAX tree, groups stacked; the batch is the JAX package's synthetic batch
(seed 7), handed to both as numpy arrays. The port's gradients are mapped
to the JAX tree the same way.

On the CPU the port differentiates the plain versions of its kernels, so
this checks the port's forward, loss and autograd against JAX's, which
trains through its plain path too. Extra cases run the chunked
cross-entropy (``LOSS_CHUNK_TOKENS`` cut to 16 in both packages: every
chunk recomputed in the backward pass) and ``remat="full"`` (groups
recomputed; recurrentgemma's tail not).

Tolerance: the loss within 1e-5 (f32, sums in another order); each
gradient within rtol 1e-4 plus 1e-6 of the largest gradient magnitude of
the model (a leaf whose gradients are all near zero, as Mamba2's at 1e-8,
carries the rounding of the sums that cancel to it, not its own scale).
The JAX side runs jitted.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import synthetic_batch_at
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models.convert import params_to_jax
from repro_torch.models.model import Model
from repro_torch.train.optimizer import tree_leaves

CASES = [
    ("qwen3-1.7b", {}, None),
    ("llama4-scout-17b-a16e", {}, None),
    ("recurrentgemma-9b", {}, None),
    ("mamba2-130m", {}, None),
    ("internvl2-26b", {}, None),
    ("musicgen-large", {}, None),
    ("qwen3-1.7b", {"remat": "full"}, 16),
    ("recurrentgemma-9b", {"remat": "full"}, None),
]


@pytest.mark.parametrize("arch,over,loss_chunk", CASES,
                         ids=[f"{a}{'-' + '-'.join(o.values()) if o else ''}"
                              f"{'-chunk' + str(c) if c else ''}" for a, o, c in CASES])
def test_loss_and_gradients_match_jax(arch, over, loss_chunk, monkeypatch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    if loss_chunk:
        monkeypatch.setattr(JModel, "LOSS_CHUNK_TOKENS", loss_chunk)
        monkeypatch.setattr(Model, "LOSS_CHUNK_TOKENS", loss_chunk)
    jmodel = JModel(jcfg)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    params = jax.tree.map(lambda t: jax.numpy.asarray(t.detach().numpy()),
                          params_to_jax(model.state_dict(), cfg))
    seq = 32 if cfg.family == "ssm" else 16  # mamba2: two chunks of 16
    batch = synthetic_batch_at(
        0, seed=7, batch_size=2, seq_len=seq, vocab_size=cfg.vocab_size,
        n_codebooks=cfg.n_codebooks, prefix_embeds=cfg.n_prefix_embeds,
        d_model=cfg.d_model)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        params, batch)

    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics = model.loss(tbatch)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named, grads)}

    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5)
    for key in ("ce", "moe_load_balance", "moe_z_loss", "tokens"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]), abs=1e-5), key
    if cfg.family == "moe":
        assert float(metrics["moe_load_balance"]) > 0
    got = tree_leaves(params_to_jax(grads, cfg))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(got) == len(want)
    largest = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
    for (path, g), (jpath, w) in zip(got, want):
        assert "/".join(path) == "/".join(str(p.key) for p in jpath)
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6 * largest,
            err_msg=f"{arch}: d loss / d {'/'.join(path)}")
