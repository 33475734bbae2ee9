"""Batched LM serving engine: prefill, then decode with greedy or
temperature sampling.

Ported from ``src/repro/models/lm_serve.py`` for one device (the JAX
engine's ``MeshPolicy`` sharding is not ported). Prompts of one batch must
have one length; the cache holds ``max_seq`` steps. An audio model takes
prompts (P, K) of its K codebooks and decodes K tokens a step. Greedy decoding is
``argmax``, which picks the first of equal maxima as ``jnp.argmax`` does.
Temperature sampling draws from ``softmax(logits / max(t, 1e-4))`` with a
``torch.Generator`` seeded from ``seed`` on the model's device: seeded and
deterministic, but not JAX's threefry draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .model import Model


@dataclass
class Request:
    prompt: np.ndarray  # (P,) or (P, K)
    max_new_tokens: int = 32
    temperature: float = 0.0
    rid: int = 0


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray


class ServeEngine:
    def __init__(self, model: Model, *, max_seq: int = 256, seed: int = 0):
        self.model = model
        self.max_seq = max_seq
        self.generator = torch.Generator(device=model.device).manual_seed(seed)

    def generate(self, requests: list[Request]) -> list[Completion]:
        """Serve a batch of requests whose prompts have one length ->
        completions of tokens (n,) or, for audio, (n, K)."""
        if not requests:
            raise ValueError("empty batch")
        P = len(requests[0].prompt)
        if any(len(r.prompt) != P for r in requests):
            raise ValueError(
                "ragged prompts: generate serves prompts of one length; batch "
                "requests by prompt length"
            )
        B = len(requests)
        device = self.model.device
        tokens = torch.from_numpy(np.stack([r.prompt for r in requests])).to(device)
        logits, caches = self.model.prefill(tokens, self.max_seq)
        cur = self._sample(logits[:, 0], requests)
        generated = [cur]
        for t in range(1, max(r.max_new_tokens for r in requests)):
            pos = torch.full((B,), P + t - 1, dtype=torch.int32, device=device)
            logits, caches = self.model.decode_step(cur[:, None], caches, pos)
            cur = self._sample(logits[:, 0], requests)
            generated.append(cur)
        gen = torch.stack(generated, dim=1).cpu().numpy()
        return [
            Completion(rid=r.rid, tokens=gen[i, : r.max_new_tokens])
            for i, r in enumerate(requests)
        ]

    def _sample(self, logits: torch.Tensor, requests) -> torch.Tensor:
        """logits (B, V) or (B, K, V) -> int32 (B,) or (B, K)."""
        temps = np.array([r.temperature for r in requests], dtype=np.float32)
        if (temps == 0).all():
            return torch.argmax(logits, dim=-1).to(torch.int32)
        t = torch.from_numpy(np.maximum(temps, 1e-4)).to(logits.device)
        t = t.reshape((-1,) + (1,) * (logits.dim() - 1))
        probs = torch.softmax(logits.float() / t, dim=-1)
        draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=self.generator)
        return draw.reshape(logits.shape[:-1]).to(torch.int32)
