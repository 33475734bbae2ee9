"""The training loop: ``src/repro/train/train_loop.py`` on one device.

* checkpoint/restart: atomic checkpoints every ``ckpt_every`` steps, at a
  preemption and at the last step, auto-resume from the latest committed
  one, bitwise-identical batch replay (the data state (seed, step) is in
  the manifest and ``batch_at(step)`` is pure);
* preemption: SIGTERM/SIGINT set a flag, and the loop checkpoints and
  stops at the next step boundary (off the main thread the handler is not
  installed, as there);
* gradient accumulation: ``accum_steps`` microbatches, their gradients
  summed in f32 and divided;
* mixed precision: parameters and activations in the model's dtype, f32
  master weights and moments (``optimizer.adamw_update``).

The state is ``{"params": the model's parameters (name -> Parameter),
"opt": the AdamW state keyed by the same names}``. A step updates both
in place. Checkpoints hold the JAX package's tree (``params`` and each
moment through ``convert.params_to_jax``), so the JAX trainer restores
the port's and the other way round.

``policy`` is a ``models.sharding.MeshPolicy``. One whose every mesh axis
has size 1 (``launch/mesh.py::make_policy(make_host_mesh(1), cfg)``)
places nothing: the trainer installs it as the active policy around each
step and trains exactly as without one. A policy over more than one card
raises ``NotImplementedError``: the multi-card path is not ported.

Unlike the reference, ``fit(None, ...)`` resumes too: it builds the state
first and restores into it (the reference asserts a template and so
cannot resume from its own launcher, ROADMAP Queue 3 fault 8).
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import Model
from repro_torch.models.sharding import MULTI_CARD, MeshPolicy, use_policy
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, adamw_update, init_opt_state

_PARAM_TREES = ("master", "mu", "nu", "ef")  # opt entries keyed like params


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    log_every: int = 10
    accum_steps: int = 1
    keep_ckpts: int = 3
    seed: int = 0


class Trainer:
    def __init__(self, model: Model, opt_cfg: AdamWConfig,
                 trainer_cfg: TrainerConfig, policy: MeshPolicy | None = None):
        if policy is not None and not policy.one_card:
            raise NotImplementedError(f"training under {policy}: {MULTI_CARD}")
        self.policy = MeshPolicy() if policy is None else policy
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = trainer_cfg
        self._preempted = False

    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> dict:
        """Random parameters from ``seed`` (``Model.init`` on a generator on
        the model's device) and a fresh AdamW state."""
        self.model.init(torch.Generator(device=self.model.device).manual_seed(seed))
        return self.state_of_model()

    def state_of_model(self) -> dict:
        """The state around the model's current parameters, with a fresh
        AdamW state."""
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": init_opt_state(params, self.opt_cfg)}

    def _grads(self, batch: dict, params: dict):
        loss, metrics = self.model.loss(batch)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One optimizer step on ``batch`` -> (state, metrics); the
        parameters and the optimizer state change in place."""
        with use_policy(self.policy):
            return self._train_step(state, batch)

    def _train_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        accum = self.cfg.accum_steps
        if accum > 1:
            loss_sum = grads = None
            for i in range(accum):
                micro = {k: _micro(v, accum, i) for k, v in batch.items()}
                loss, _, g = self._grads(micro, params)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if grads is None:
                    grads = {n: t.to(torch.float32) for n, t in g.items()}
                else:
                    for n, t in g.items():
                        grads[n] = grads[n] + t.to(torch.float32)
                del g
            loss = loss_sum / accum
            grads = {n: t / accum for n, t in grads.items()}
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = self._grads(batch, params)
        master, opt = adamw_update(grads, state["opt"], self.opt_cfg)
        del grads
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(master[name])  # cast_like, in place
        metrics = dict(metrics)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    # -- checkpoints ---------------------------------------------------------

    def _jax_state(self, state: dict, move) -> dict:
        """The state as the JAX package's tree, each leaf through ``move``."""
        cfg = self.model.cfg
        opt = state["opt"]
        out = {"params": params_to_jax({n: move(t) for n, t in state["params"].items()},
                                       cfg),
               "opt": {"count": move(opt["count"])}}
        for k in _PARAM_TREES:
            if k in opt:
                out["opt"][k] = params_to_jax({n: move(t) for n, t in opt[k].items()},
                                              cfg)
        return out

    def save(self, state: dict, step: int) -> None:
        """Checkpoints ``state`` as step ``step`` under ``ckpt_dir``."""
        cfg = self.cfg
        save_checkpoint(
            cfg.ckpt_dir, step, self._jax_state(state, lambda t: t.detach().cpu()),
            data_state={"seed": cfg.seed, "step": step}, keep_last=cfg.keep_ckpts,
        )

    def restore(self, path, state: dict) -> int:
        """Loads the checkpoint at ``path`` into ``state`` in place -> its
        step."""
        template = self._jax_state(state, lambda t: t.detach().to("meta"))
        loaded, step, _ = restore_checkpoint(path, template, device="cpu")
        cfg = self.model.cfg
        with torch.no_grad():
            for name, t in params_from_jax(loaded["params"], cfg).items():
                state["params"][name].copy_(t)
            opt = state["opt"]
            opt["count"].copy_(loaded["opt"]["count"])
            for k in _PARAM_TREES:
                if k in opt:
                    for name, t in params_from_jax(loaded["opt"][k], cfg).items():
                        opt[k][name].copy_(t)
        return step

    # ------------------------------------------------------------------

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def fit(
        self,
        state: dict | None,
        batch_at: Callable[[int], dict],
        steps: int | None = None,
        resume: bool = True,
        on_step=None,
    ):
        """Run (or resume) training -> (state, history of (step, loss)).
        ``batch_at(step)`` must be pure."""
        cfg = self.cfg
        steps = steps if steps is not None else cfg.steps
        self._install_preemption_handler()
        if state is None:
            state = self.init_state(cfg.seed)
        start_step = 0
        if resume:
            latest = latest_checkpoint(cfg.ckpt_dir)
            if latest is not None:
                start_step = self.restore(latest, state)

        history = []
        t0 = time.time()
        for step in range(start_step, steps):
            batch = batch_at(step)
            state, metrics = self.train_step(state, batch)
            if on_step is not None:
                on_step(step, state, metrics)
            if (step + 1) % cfg.log_every == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                history.append((step + 1, loss))
                print(f"step {step + 1:6d}  loss {loss:.4f}  "
                      f"({dt / cfg.log_every:.2f}s/step)")
                t0 = time.time()
            must_ckpt = (step + 1) % cfg.ckpt_every == 0
            if must_ckpt or self._preempted or step + 1 == steps:
                self.save(state, step + 1)
            if self._preempted:
                print(f"preempted: checkpointed at step {step + 1}, exiting")
                break
        return state, history


def _micro(x, accum: int, i: int):
    """Microbatch ``i`` of ``accum`` along the batch axis."""
    x = torch.as_tensor(x)
    n = x.shape[0] // accum
    return x[i * n:(i + 1) * n]
