"""The ranks of ``tests/test_torch_multicard.py``: gloo worlds on the CPU.

    PYTHONPATH=src python tests/_torch_multicard_worker.py WORKDIR

runs two worlds one after the other, each started by
``torch.multiprocessing.spawn`` on a free localhost port: four ranks that
train, save and serve under policies over device meshes they build from
the one group ((2, 2), and (1, 4) for the sequence-sharded cache), then
two ranks that restore the four-rank checkpoint and save it again. Inputs
come from ``WORKDIR`` (``qwen3_state.pt``, the port's state dict of the
JAX package's parameters, which the test writes while the first cases
run; the ranks wait up to 60 s for it); rank 0 writes what the test compares into
``WORKDIR`` (``world4.pt``, ``world2.pt``; the checkpoints under
``ckpt4/`` and ``ckpt2/``). Each rank runs on one thread.
"""

from __future__ import annotations

import logging
import socket
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

QWEN = dict(n_layers=2, d_model=64, d_ff=128)
SERVE_QWEN = dict(n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2)
SGD_STEPS = 4
SGD_LR = 1e-2
TRAINER_STEPS = 3
SERVE_NEW = 4
SERVE_MAX_SEQ = 16


def qwen_cfg(**over):
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b").reduced(**{**QWEN, **over})


def sgd_batch(t: int, vocab: int) -> dict:
    from repro_torch.data.pipeline import synthetic_batch_at

    return synthetic_batch_at(t, seed=3, batch_size=8, seq_len=16, vocab_size=vocab,
                              device="cpu")


def sgd_losses(model, policy) -> list[float]:
    """SGD_STEPS steps of ``p - SGD_LR * g`` under ``policy`` -> the losses."""
    from repro_torch.models.sharding import MeshPolicy, is_placed, use_policy

    out = []
    params = list(model.parameters())
    with use_policy(policy):
        for t in range(SGD_STEPS):
            loss, _ = model.loss(sgd_batch(t, model.cfg.vocab_size))
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    if is_placed(p) and g.placements != p.placements:
                        g = g.redistribute(p.device_mesh, p.placements)
                    p.sub_(SGD_LR * g)
            out.append(float(MeshPolicy.full(loss.detach())))
    return out


def trainer(cfg, policy, compress: bool, ckpt_dir: str = "unused", accum: int = 1):
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    return Trainer(Model(cfg, device="cpu"),
                   AdamWConfig(lr_peak=1e-2, warmup_steps=1, decay_steps=TRAINER_STEPS,
                               grad_clip=0.5, compress_grads=compress),
                   TrainerConfig(steps=TRAINER_STEPS, ckpt_dir=ckpt_dir, seed=1,
                                 accum_steps=accum),
                   policy=policy)


def trainer_run(cfg, policy, compress: bool) -> dict:
    """TRAINER_STEPS AdamW steps (global-norm clip at 0.5; compressed, in 2
    accumulated microbatches) -> losses and the final parameters, whole."""
    from repro_torch.models.sharding import MeshPolicy

    tr = trainer(cfg, policy, compress, accum=2 if compress else 1)
    state = tr.init_state(1)
    losses = []
    for t in range(TRAINER_STEPS):
        state, metrics = tr.train_step(state, sgd_batch(t, cfg.vocab_size))
        losses.append(float(metrics["loss"]))
    return {"losses": losses,
            "params": {n: MeshPolicy.full(p).detach().clone()
                       for n, p in state["params"].items()}}


def mamba_run(policy) -> dict:
    """Two SGD steps of the reduced mamba2-130m -> losses and the gradient's
    squared norm at the first."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import MeshPolicy, use_policy

    cfg = get_config("mamba2-130m").reduced()
    model = Model(cfg, device="cpu")
    if policy.placed:
        model.place(policy)
    model.init(torch.Generator().manual_seed(0))
    losses = sgd_losses(model, policy)[:2]
    with use_policy(policy):
        loss, _ = model.loss(sgd_batch(0, cfg.vocab_size))
        grads = torch.autograd.grad(loss, list(model.parameters()))
    sq = sum(float(MeshPolicy.full(g).float().square().sum()) for g in grads)
    return {"losses": losses, "grad_sq": sq}


def serve_run(policy) -> dict:
    """Greedy tokens of 4 prompts of 8 tokens, SERVE_NEW new each, the
    logits each step drew from (whole), and the attention caches'
    placements after the prefill."""
    from repro_torch.models.lm_serve import Request, ServeEngine
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import MeshPolicy

    cfg = qwen_cfg(**SERVE_QWEN)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    prompts = np.random.default_rng(5).integers(2, cfg.vocab_size, (4, 8))
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW, rid=i)
            for i, p in enumerate(prompts)]
    engine = ServeEngine(model, max_seq=SERVE_MAX_SEQ, policy=policy)
    steps, cache_pl = [], []
    prefill, sample = model.prefill, engine._sample

    def prefill_seen(*args, **kwargs):
        logits, caches = prefill(*args, **kwargs)
        if policy is not None:
            cache_pl.extend(placements(caches[0]["k"]))
        return logits, caches

    def sample_seen(logits, requests):
        steps.append(MeshPolicy.full(logits))
        return sample(logits, requests)

    model.prefill, engine._sample = prefill_seen, sample_seen
    tokens = np.stack([c.tokens for c in engine.generate(reqs)])
    return {"tokens": tokens, "logits": torch.stack(steps), "cache": cache_pl or None}


def placements(t) -> list[str]:
    """A DTensor's placements: "S<dim>" or "R" a mesh dim."""
    return [f"S{p.dim}" if p.is_shard() else "R" for p in t.placements]


def refusals(mesh) -> dict:
    """{family: the message} of placing each family outside the slice."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import MeshPolicy

    out = {}
    for arch, over in (("llama4-scout-17b-a16e", {}), ("recurrentgemma-9b", {}),
                       ("internvl2-26b", {}), ("musicgen-large", {}),
                       ("qwen3-1.7b", {"seq_parallel": True})):
        cfg = get_config(arch).reduced()
        policy = MeshPolicy(dp=("data",), tp="model", device_mesh=mesh, **over)
        try:
            Model(cfg, device="cpu").place(policy)
            out[arch] = None
        except NotImplementedError as e:
            out[arch] = str(e)
    return out


def kernel_routes(mesh) -> dict:
    """Each LM op on DTensors (its plain version through ``local_map``)
    against the same op on whole tensors: {op: (output error, worst
    gradient error)}, each the largest absolute error over the reference's
    largest magnitude. The first operand lies as the layers lay it out
    (batch on 'data', heads or channels on 'model'), the others on the
    batch only, so the routes move them to the first's shards. Flash runs 6
    q heads on 3 kv heads over tp 2, so each rank's 3 q heads read kv heads
    the slicing cannot keep whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops

    first = {"flash_attention": Shard(1), "rmsnorm": Shard(1), "ssd_scan": Shard(1),
             "rglru_scan": Shard(2)}
    gen = torch.Generator().manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    cases = {
        "flash_attention": ((rand(2, 6, 8, 4), rand(2, 3, 8, 4), rand(2, 3, 8, 4)),
                            lambda q, k, v: ops.flash_attention(q, k, v)),
        "rmsnorm": ((rand(2, 8, 6, 4), rand(4)),
                    lambda x, w: ops.rmsnorm(x, w, eps=1e-6, plus_one=True)),
        "ssd_scan": ((rand(2, 4, 8, 4), rand(2, 4, 8).abs(), -rand(2, 4, 8).abs(),
                      rand(2, 8, 4), rand(2, 8, 4)),
                     lambda *a: ops.ssd_scan(*a, chunk=4)),
        "rglru_scan": ((rand(2, 8, 6).sigmoid(), rand(2, 8, 6), rand(2, 6)),
                       ops.rglru_scan),
    }
    out = {}
    for name, (args, fn) in cases.items():
        plain = [a.clone().requires_grad_() for a in args]
        want = fn(*plain)
        want_g = torch.autograd.grad(want.square().sum(), plain)
        placed = [distribute_tensor(a, mesh, [Shard(0), first[name] if i == 0 else Replicate()],
                                    src_data_rank=None).requires_grad_()
                  for i, a in enumerate(args)]
        got = fn(*placed)
        got_g = torch.autograd.grad(got.square().sum(), placed)
        out[name] = (float((got.full_tensor() - want).abs().max() / want.abs().max()),
                     max(float((g.redistribute(mesh, [Replicate()] * 2).to_local() - w)
                               .abs().max() / w.abs().max()) for g, w in zip(got_g, want_g)))
    return out


def world4(rank: int, work: Path) -> dict:
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import MeshPolicy, is_placed

    mesh = make_device_mesh((2, 2), ("data", "model"), "cpu")
    dp_tp = MeshPolicy(dp=("data",), tp="model", device_mesh=mesh)
    cfg = qwen_cfg()
    out = {"trainer": {c: trainer_run(cfg, dp_tp, c) for c in (False, True)},
           "mamba": mamba_run(MeshPolicy(dp=("data", "model"), device_mesh=mesh))}
    # a checkpoint of the state after one step, and that state whole
    tr = trainer(cfg, dp_tp, False, str(work / "ckpt4"))
    state = tr.init_state(7)
    state, _ = tr.train_step(state, sgd_batch(0, cfg.vocab_size))
    tr.save(state, 1)
    out["saved"] = _whole(state)
    seq = make_device_mesh((1, 4), ("data", "model"), "cpu")
    out["serve"] = {
        "heads": serve_run(MeshPolicy(dp=("data",), tp="model", device_mesh=mesh)),
        "seq": serve_run(MeshPolicy(dp=("data",), tp="model", shard_cache_seq=True,
                                    device_mesh=seq)),
    }
    out["refusals"] = refusals(mesh)
    out["kernel_routes"] = kernel_routes(mesh)
    # last: the test process writes the JAX parameters while the rest runs
    model = Model(cfg, device="cpu")
    model.load_state_dict(torch.load(_written(work / "qwen3_state.pt")))
    model.place(dp_tp)
    out.update(placements={n: placements(t) for n, t in model.named_parameters()},
               all_placed=all(is_placed(p) for p in model.parameters()),
               local_wq=tuple(model.layers[0].mix.wq.to_local().shape),
               sgd=sgd_losses(model, dp_tp))
    return out


def _written(path: Path, timeout_s: float = 60.0) -> Path:
    """``path`` once its writer has renamed it into place."""
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout_s} s")
        time.sleep(0.05)
    return path


def world2(rank: int, work: Path) -> dict:
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.sharding import MeshPolicy
    from repro_torch.train.checkpoint import latest_checkpoint

    mesh = make_device_mesh((2, 1), ("data", "model"), "cpu")
    tr = trainer(qwen_cfg(), MeshPolicy(dp=("data",), tp="model", device_mesh=mesh),
                 False, str(work / "ckpt2"))
    state = tr.state_of_model()
    step = tr.restore(latest_checkpoint(work / "ckpt4"), state)
    tr.save(state, step)
    return {"step": step, "restored": _whole(state)}


def _whole(state: dict) -> dict:
    from repro_torch.models.sharding import MeshPolicy

    return {k: {n: MeshPolicy.full(t).detach().clone() for n, t in tree.items()}
            for k, tree in (("params", state["params"]),
                            *((k, state["opt"][k]) for k in ("master", "mu", "nu")))}


def _rank(rank: int, world: int, port: int, work: str) -> None:
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = (world4 if world == 4 else world2)(rank, Path(work))
        if rank == 0:
            torch.save(out, Path(work) / f"world{world}.pt")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(work: str) -> None:
    for world in (4, 2):
        mp.spawn(_rank, args=(world, free_port(), work), nprocs=world, join=True)


if __name__ == "__main__":
    main(sys.argv[1])
