"""Sharded k-hop and point queries of the PyTorch port on one card.

The JAX package's ``benchmarks/sharded_perf.py`` rebuilt on
``repro_torch`` (this module imports nothing of the JAX package): the
same seeded hub-skewed graph (background degree ~8; 64 hubs and 8 giant
hyperedges, all at low node ids, inside shard 0's range at every shard
count), the same k-hop (32 sources, k 3, ``max_frontier`` 4096, layer
``ties``) and point queries (8,192 pairs; alters of 256 at cap 64;
degree), at 1/2/4/8 shards.

On one card the shards do not run at the same time; the claim is the
per-shard alter bound: a hop gathers ``Σ_s B·F_s·cap_s`` candidates, each
shard paying its own exact bound, instead of ``B·F·cap`` with every slot
paying the hub's. The script prints that candidate width beside each
k-hop's wall. Every shard count's results are asserted bit-identical to
the unsharded port's before any timing; then per call it reports the
CUDA-synchronised median wall, the device busy and idle of one profiled
call, and the launches by kernel. The JAX package gates the 1-over-4
k-hop ratio at 2x, a figure taken on 8 CPU devices that ran shards
concurrently; here ``--min-speedup`` is off unless given.

    PYTHONPATH=src python benchmarks/torch_sharded_perf.py            # the card
    PYTHONPATH=src python benchmarks/torch_sharded_perf.py --smoke --device cpu

``chip_smoke.py``'s ``sharded:`` phase runs ``measure`` at the full
default.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time

import numpy as np
import torch

SHARD_COUNTS = (1, 2, 4, 8)


def build_skewed_network(n_nodes: int, hub_degree: int, device, seed: int = 0):
    """The JAX package's ``build_skewed_network``, draw for draw: mean
    degree ~8 everywhere; 64 hubs of ``hub_degree`` and 8 giant
    hyperedges over the lowest eighth of the ids, 192 hyperedges of 12
    everywhere."""
    from repro_torch.core import api
    from repro_torch.core.layers import one_mode_from_edges, two_mode_from_memberships

    rng = np.random.default_rng(seed)
    n_bg = 4 * n_nodes  # undirected -> mean degree ~8
    src = [rng.integers(0, n_nodes, n_bg)]
    dst = [rng.integers(0, n_nodes, n_bg)]
    for h in np.arange(64):
        src.append(np.full(hub_degree, h))
        dst.append(rng.integers(0, n_nodes, hub_degree))
    net = api.createnetwork(n_nodes, device=device)
    net = net.with_layer("ties", one_mode_from_edges(
        n_nodes, np.concatenate(src), np.concatenate(dst), directed=False,
        device=device))
    nodes, hes = [], []
    for g in range(8):
        members = rng.integers(0, n_nodes // 8, hub_degree)
        nodes.append(members)
        hes.append(np.full(members.size, g))
    for h in range(8, 200):
        members = rng.integers(0, n_nodes, 12)
        nodes.append(members)
        hes.append(np.full(members.size, h))
    return net.with_layer("aff", two_mode_from_memberships(
        n_nodes, 200, np.concatenate(nodes), np.concatenate(hes), device=device))


class CandidateWidth:
    """Within the block, sums the entries of every hop-expansion gather
    (``traversal._frontier_alters``: B x slots x cap), the unsharded and
    the sharded k-hop's alike."""

    def __init__(self):
        self.entries = 0

    def __enter__(self):
        from repro_torch.core import traversal

        self._real = real = traversal._frontier_alters

        def counted(*args, **kw):
            cand = real(*args, **kw)
            self.entries += int(cand.shape[0]) * int(cand.shape[1])
            return cand

        traversal._frontier_alters = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import traversal

        traversal._frontier_alters = self._real


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device, n_warmup: int, n_iter: int) -> float:
    """Median wall ms a call, each call synchronised with the card (the
    results stay on the device; serving pays its host copy apart)."""
    for _ in range(n_warmup):
        fn()
    _sync(device)
    ts = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def device_busy_ms(fn, device) -> float | None:
    """Device time of one call (torch.profiler's CUDA activities), None on
    the CPU or when the profiler delivered no device event."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy or None


def launches_of(fn) -> dict:
    """Launch counts one call adds, by kernel."""
    from repro_torch.kernels.build import launch_counts

    before = collections.Counter(launch_counts)
    fn()
    delta = collections.Counter(launch_counts)
    delta.subtract(before)
    return {k: v for k, v in sorted(delta.items()) if v}


def _assert_identical(ref, got, what: str) -> None:
    for x, y in zip(ref, got):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: the sharded result differs from the "
                                 "unsharded port's")


def measure(n_nodes: int, hub_degree: int, smoke: bool, device, log=print) -> dict:
    """Build the graph, assert every shard count bit-identical to the
    unsharded port, then time each call at 1/2/4/8 shards -> {metric:
    value} (wall and busy in ms, widths in gathered entries)."""
    from repro_torch.core.sharded import shard_network

    device = torch.device(device)
    out: dict = {"sharded/n_nodes": n_nodes, "sharded/hub_degree": hub_degree}
    t0 = time.perf_counter()
    net = build_skewed_network(n_nodes, hub_degree, device)
    _sync(device)
    log(f"sharded perf: skewed network of {n_nodes} nodes, hub degree "
        f"{hub_degree}, built in {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(1)
    n_warmup, n_iter = (1, 2) if smoke else (2, 5)
    B = 16 if smoke else 32
    k = 2 if smoke else 3
    mf = 512 if smoke else 4096
    sources = rng.integers(n_nodes // 8, n_nodes, B).astype(np.int32)
    P = 1024 if smoke else 8192
    u = rng.integers(0, n_nodes, P).astype(np.int32)
    v = rng.integers(0, n_nodes, P).astype(np.int32)

    def calls(g) -> dict:
        return {
            "khop": lambda: g.khop(sources, k, max_frontier=mf, layer_names=["ties"]),
            "getedge": lambda: (g.edge_value("ties", u, v),),
            "alters": lambda: g.node_alters(u[:256], 64),
            "degree": lambda: (g.degree(u),),
        }

    views = {s: (shard_network(net, s) if s > 1 else net) for s in SHARD_COUNTS}
    ref = {name: fn() for name, fn in calls(net).items()}
    for s, g in views.items():  # every result checked before any timing
        for name, fn in calls(g).items():
            _assert_identical(ref[name], fn(), f"{name} @ {s} shards")
    log(f"sharded perf: khop (B {B}, k {k}, max_frontier {mf}), getedge x{P}, "
        f"alters x256 (cap 64), degree x{P}: bit-identical to the unsharded "
        f"port at {', '.join(map(str, SHARD_COUNTS))} shards")

    for s, g in views.items():
        for name, fn in calls(g).items():
            width = None
            if name == "khop":
                with CandidateWidth() as cw:
                    fn()
                width = cw.entries
                out[f"sharded/khop_{s}shard_candidates"] = width
            ms = median_ms(fn, device, n_warmup, n_iter)
            busy = device_busy_ms(fn, device)
            per_call = launches_of(fn)
            out[f"sharded/{name}_{s}shard_ms"] = ms
            out[f"sharded/{name}_{s}shard_busy_ms"] = busy
            idle = ("not measured" if busy is None
                    else f"{max(0.0, 1.0 - busy / ms) * 100:.1f}%")
            log(f"sharded perf: {name} at {s} shard(s): median {ms:.3f} ms, device "
                f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}, idle "
                f"{idle}; launches {json.dumps(per_call, sort_keys=True)}"
                + ("" if width is None else f"; candidate entries gathered {width}"))
    ratio = out["sharded/khop_1shard_ms"] / out["sharded/khop_4shard_ms"]
    out["sharded/khop_4shard_speedup_x"] = ratio
    log(f"sharded perf: khop 1-over-4-shard wall ratio {ratio:.3f}x; candidate "
        f"entries {out['sharded/khop_1shard_candidates']} unsharded vs "
        f"{out['sharded/khop_4shard_candidates']} at 4 shards "
        f"({out['sharded/khop_1shard_candidates'] / out['sharded/khop_4shard_candidates']:.3f}x)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=120_000)
    ap.add_argument("--hub-degree", type=int, default=800)
    ap.add_argument("--smoke", action="store_true",
                    help="24k nodes, hub degree 400, B 16, k 2 — the same shape")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--min-speedup", type=float, default=None,
                    help="fail if the khop 1-over-4-shard ratio falls below this "
                         "(default: not gated)")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    from repro_torch.core.csr import resolve_device

    device = resolve_device(args.device)
    n_nodes = 24_000 if args.smoke else args.nodes
    hub_degree = 400 if args.smoke else args.hub_degree
    out = measure(n_nodes, hub_degree, args.smoke, device,
                  log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(out, indent=2, sort_keys=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
    ratio = out["sharded/khop_4shard_speedup_x"]
    if args.min_speedup is not None and ratio < args.min_speedup:
        print(f"FAIL: khop 1-over-4-shard ratio {ratio:.3f}x below "
              f"{args.min_speedup:.3f}x", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
