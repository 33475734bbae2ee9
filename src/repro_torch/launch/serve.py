"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Random-inits a reduced config of the architecture (the JAX launcher's
own reduction, ``src/repro/launch/serve.py``) from ``--seed``, or with
``--ckpt-dir`` restores its parameters from the latest committed
checkpoint there (one ``launch/train.py`` wrote, or the JAX package's
trainer: the layout is shared), and serves a batch of demo prompts (of
``n_codebooks`` streams for an audio model) through the prefill + decode
engine. Every ``--arch`` of the registry serves. Runs on the CUDA card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.lm_serve import Request, ServeEngine
from repro_torch.models.model import Model
from repro_torch.train.checkpoint import latest_checkpoint, restore_checkpoint


def restore_params(model: Model, ckpt_dir) -> int:
    """Loads ``model``'s parameters from the latest committed checkpoint
    under ``ckpt_dir`` -> its step. Reads the ``params`` leaves, falling
    back to the full {"params", "opt"} layout as the reference does; no
    committed checkpoint raises ``SystemExit``."""
    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        raise SystemExit(f"no committed checkpoint under {ckpt_dir}")
    meta = {n: p.detach().to("meta") for n, p in model.named_parameters()}
    tpl = {"params": params_to_jax(meta, model.cfg)}
    try:
        state, step, _ = restore_checkpoint(latest, tpl, device="cpu")
        print(f"restored params from step {step}")
    except (KeyError, ValueError):
        # the checkpoint includes the optimizer state: restore the full layout
        from repro_torch.train.optimizer import AdamWConfig, init_opt_state

        opt = init_opt_state(meta, AdamWConfig())
        tpl["opt"] = {k: params_to_jax(v, model.cfg) if isinstance(v, dict) else v
                      for k, v in opt.items()}
        state, step, _ = restore_checkpoint(latest, tpl, device="cpu")
        print(f"restored params (+opt) from step {step}")
    model.load_state_dict(params_from_jax(state["params"], model.cfg))
    return step


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

    cfg = get_config(args.arch).reduced(
        n_layers=max(len(get_config(args.arch).block_pattern) * 2, 4),
        d_model=256, d_ff=512, vocab_size=4096,
        n_kv_heads=2, n_heads=4, head_dim=64,
    )
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    if args.ckpt_dir:
        restore_params(model, args.ckpt_dir)

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
