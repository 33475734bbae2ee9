"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The JAX launcher's flags (``src/repro/launch/train.py``): a reduced config
of the architecture (its reduction) on the graph-walk corpus of a demo
population network, or the published config with ``--full``. Runs on the
CUDA card; ``--device cpu`` runs on the CPU. Fault tolerance is on by
default: atomic checkpoints every ``--ckpt-every`` steps and at the last,
auto-resume from the latest committed one, SIGTERM-safe. One process
trains on one card under the policy of a one-card host mesh
(``launch/mesh.py::make_policy(make_host_mesh(1), cfg)``), which places
nothing; every family trains so, the Mamba2 and RG-LRU scans through their
backward kernels. Started by torchrun with ``WORLD_SIZE`` > 1,

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m repro_torch.launch.train --arch qwen3-1.7b [...]

each rank joins the world (NCCL, one card a rank; gloo with ``--device
cpu``), builds a (N / --model-parallel, --model-parallel) ``("data",
"model")`` device mesh and trains under ``make_policy(mesh, cfg)``, as the
reference builds a policy when it sees more than one device: parameters
and optimizer state sharded, each batch split on dp. The families whose
placement is not ported (``Model.place``) refuse to start so.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import (
    WalkCorpus,
    WalkCorpusConfig,
    demo_population_network,
    synthetic_batch_at,
)
from repro_torch.launch.mesh import (
    init_distributed,
    make_device_mesh,
    make_host_mesh,
    make_policy,
)
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", choices=["walks", "synthetic"], default="walks")
    ap.add_argument("--graph-nodes", type=int, default=2_000)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the device mesh's 'model' axis under torchrun")
    args = ap.parse_args(argv)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _, world = init_distributed(args.device)
        mesh = make_device_mesh((world // args.model_parallel, args.model_parallel),
                                ("data", "model"), args.device)
    else:
        mesh = make_host_mesh(1)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(
            n_layers=max(len(cfg.block_pattern) * 2, 4),
            d_model=256, d_ff=512, vocab_size=4096,
            n_kv_heads=2, n_heads=4, head_dim=64,
        )
    model = Model(cfg, device=args.device)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} device={model.device}")

    if args.data == "walks":
        net = demo_population_network(args.graph_nodes, seed=args.seed,
                                      device=model.device)
        corpus = WalkCorpus(
            net,
            WalkCorpusConfig(
                seed=args.seed, batch_size=args.batch_size, seq_len=args.seq_len,
                n_codebooks=cfg.n_codebooks, prefix_embeds=cfg.n_prefix_embeds,
                d_model=cfg.d_model,
            ),
            vocab_size=cfg.vocab_size,
        )
        batch_at = corpus.batch_at
    else:
        def batch_at(step):
            return synthetic_batch_at(
                step, seed=args.seed, batch_size=args.batch_size,
                seq_len=args.seq_len, vocab_size=cfg.vocab_size,
                n_codebooks=cfg.n_codebooks, prefix_embeds=cfg.n_prefix_embeds,
                d_model=cfg.d_model, device=model.device,
            )

    trainer = Trainer(
        model,
        AdamWConfig(
            lr_peak=args.lr, warmup_steps=max(args.steps // 20, 5),
            decay_steps=args.steps, compress_grads=args.compress_grads,
        ),
        TrainerConfig(
            steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            accum_steps=args.accum, seed=args.seed,
        ),
        policy=make_policy(mesh, cfg),
    )
    _, history = trainer.fit(None, batch_at, resume=not args.no_resume)
    if history:
        print(f"final loss: {history[-1][1]:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
