"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Random-inits a reduced config of the architecture (the JAX launcher's
own reduction, ``src/repro/launch/serve.py``) from ``--seed`` and serves
a batch of demo prompts (of ``n_codebooks`` streams for an audio model)
through the prefill + decode engine. Every ``--arch`` of the registry
serves. Runs on the CUDA card; ``--device cpu`` runs on the CPU.
Checkpoint restore (``--ckpt-dir``) is not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm_serve import Request, ServeEngine
from repro_torch.models.model import Model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--n-requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        raise NotImplementedError(
            "checkpoint restore (--ckpt-dir) is not ported yet (ROADMAP Queue 1 "
            "item 13.7)"
        )

    cfg = get_config(args.arch).reduced(
        n_layers=max(len(get_config(args.arch).block_pattern) * 2, 4),
        d_model=256, d_ff=512, vocab_size=4096,
        n_kv_heads=2, n_heads=4, head_dim=64,
    )
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))

    rng = np.random.default_rng(args.seed)
    shape = ((args.prompt_len, cfg.n_codebooks) if cfg.n_codebooks
             else (args.prompt_len,))
    reqs = [
        Request(
            prompt=rng.integers(2, cfg.vocab_size, size=shape),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            rid=i,
        )
        for i in range(args.n_requests)
    ]
    eng = ServeEngine(model, max_seq=args.max_seq, seed=args.seed)
    for o in eng.generate(reqs):
        print(f"request {o.rid}: {o.tokens.tolist()}")


if __name__ == "__main__":
    main()
