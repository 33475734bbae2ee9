"""Data pipeline: the population-graph walk corpus (the paper as a
substrate), ported from ``src/repro/data/pipeline.py``.

Training sequences are multilayer random walks over a population network
(walk as sentence), node ids bucketed into tokens; the walks run on the
port's graph engine (``core/walks.py``), two-mode layers stepped through
pseudo-projected samples, never projecting.

Statelessly resumable: batch t is a pure function of (seed, t). Every draw
goes through ``core/prng.py`` (``fold_in(key(seed), step)``, ``split`` into
three, an int32 ``randint`` of the starts, the walk), so on the CPU tokens,
targets and masks equal the JAX package's bit for bit; on the card a
near-tie in a walker's layer choice may resolve otherwise (``prng``). The
VLM stub's ``prefix_embeds`` come from ``prng.normal``, whose ``erfinv``
may differ from XLA's in the last bits.

``synthetic_batch_at`` is the synthetic token stream for pure-LM runs.

Across the ranks of a device mesh every rank draws the same global batch
(the same pure function of seed and step, on identical cards) and the
model keeps its rank's rows (``MeshPolicy.shard_batch``, dim 0 on dp): no
rank draws a batch of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import torch

from repro_torch.core import prng
from repro_torch.core.api import addlayer, createnetwork, createnodeset, generate
from repro_torch.core.csr import resolve_device
from repro_torch.core.network import Network
from repro_torch.core.walks import random_walk

N_SPECIAL = 2  # 0: pad, 1: bos


@dataclass(frozen=True)
class WalkCorpusConfig:
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 128
    walk_layers: tuple[str, ...] | None = None  # None = all layers
    layer_weights: tuple[float, ...] | None = None
    n_codebooks: int = 0  # audio-family targets
    prefix_embeds: int = 0  # vlm-family stub patches
    d_model: int = 0


def demo_population_network(n_nodes: int = 2_000, seed: int = 0,
                            device=None) -> Network:
    """A small instance of the paper's Listing 2 benchmark network, on
    ``device`` (the card when None)."""
    net = createnetwork(createnodeset(n_nodes, device=device), device=device)
    net = generate(addlayer(net, "Random", 1), "Random",
                   type="er", p=8.0 / n_nodes, seed=seed)
    net = generate(addlayer(net, "Neighbors", 1), "Neighbors",
                   type="ws", k=10, beta=0.1, seed=seed + 1)
    net = generate(addlayer(net, "Communication", 1), "Communication",
                   type="ba", m=5, seed=seed + 2)
    net = generate(addlayer(net, "Workplaces", 2), "Workplaces",
                   type="2mode", h=max(n_nodes // 200, 2), a=4, seed=seed + 3)
    return net


def _mask(batch_size: int, seq_len: int, device) -> torch.Tensor:
    mask = torch.ones((batch_size, seq_len), dtype=torch.float32, device=device)
    mask[:, -1] = 0.0
    return mask


class WalkCorpus:
    """Graph-walk LM corpus over a Network. Tokens = bucketed node ids.
    Batches lie on the network's device."""

    def __init__(self, net: Network, cfg: WalkCorpusConfig, vocab_size: int):
        self.net = net
        self.cfg = cfg
        self.vocab_size = vocab_size

    def _tokens_for(self, nodes: torch.Tensor) -> torch.Tensor:
        return nodes % (self.vocab_size - N_SPECIAL) + N_SPECIAL

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step) -> training batch: tokens and
        targets int32 (B, seq_len[, K]), loss_mask f32 (B, seq_len)[,
        prefix_embeds f32 (B, P, D)]."""
        cfg = self.cfg
        device = self.net.device
        key = prng.fold_in(prng.key(cfg.seed), step)
        k_start, k_walk, k_aux = prng.split(key, 3)
        starts = prng.randint(k_start, (cfg.batch_size,), 0, self.net.n_nodes, device)
        paths = random_walk(
            self.net, starts, cfg.seq_len - 1, k_walk,
            layer_names=cfg.walk_layers,
            layer_weights=list(cfg.layer_weights) if cfg.layer_weights else None,
        )  # (B, seq_len) int32
        if cfg.n_codebooks:
            # audio family: K parallel codebook streams derived per walk
            offs = torch.arange(cfg.n_codebooks, dtype=torch.int32, device=device)
            tokens = (paths[..., None] + offs) % (self.vocab_size - N_SPECIAL) + N_SPECIAL
        else:
            tokens = self._tokens_for(paths)
        batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1),
                 "loss_mask": _mask(cfg.batch_size, cfg.seq_len, device)}
        if cfg.prefix_embeds:
            batch["prefix_embeds"] = prng.normal(
                k_aux, (cfg.batch_size, cfg.prefix_embeds, cfg.d_model), device) * 0.02
        return batch

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        t = start_step
        while True:
            yield self.batch_at(t)
            t += 1


def synthetic_batch_at(
    step: int, *, seed: int, batch_size: int, seq_len: int,
    vocab_size: int, n_codebooks: int = 0,
    prefix_embeds: int = 0, d_model: int = 0, device=None,
) -> dict:
    """Deterministic synthetic LM batch (arithmetic sequences mod vocab:
    the next token is predictable), on ``device`` (the card when None)."""
    device = resolve_device(device)
    key = prng.fold_in(prng.key(seed), step)
    k1, k2 = prng.split(key)
    start = prng.randint(k1, (batch_size, 1), 0, vocab_size, device)
    stride = prng.randint(k2, (batch_size, 1), 1, 7, device)
    ar = torch.arange(seq_len, dtype=torch.int32, device=device)
    seq = (start + stride * ar[None, :]) % vocab_size
    tokens = seq[..., None].repeat(1, 1, n_codebooks) if n_codebooks else seq
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1),
             "loss_mask": _mask(batch_size, seq_len, device)}
    if prefix_embeds:
        batch["prefix_embeds"] = prng.normal(
            k2, (batch_size, prefix_embeds, d_model), device) * 0.02
    return batch
