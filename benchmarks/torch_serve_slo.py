"""Serve-SLO load generator for the PyTorch port: the serving trace, a
closed loop that finds the frontend's capacity and an open loop that
measures tail latency over the wire under a fault burst.

The JAX package's ``benchmarks/run.py::build_serve_trace`` and
``benchmarks/serve_slo.py`` rebuilt on ``repro_torch`` (this module
imports nothing of the JAX package): the same draws from the same seed,
the same fault burst, the same open-loop rule. Requests are timestamped
by their scheduled arrival, not by when the previous one finished, so
slow responses back later arrivals up and inflate the measured tail
(no coordinated omission); latency is ``completion - scheduled
arrival``, end to end through the wire, the engine's queues and the
client's retry loop. Every wire result is returned, so the caller checks
each against its reference once the window has closed.

``chip_smoke.py``'s ``serving:`` phase drives these against the 10M-node
register network on the card. Standalone, on a small seeded network:

    PYTHONPATH=src python benchmarks/torch_serve_slo.py --device cpu \\
        --nodes 20000 --requests 2000
"""

from __future__ import annotations

import threading
import time

import numpy as np

#: the reference's kinds and their shares of the trace
TRACE_KINDS = ("getedge", "alters", "degree", "fgetedge", "falters", "khop",
               "walkbatch")
TRACE_SHARES = (0.40, 0.20, 0.15, 0.05, 0.05, 0.10, 0.05)
#: the register network's layers in the reference's roles: getedge probes
#: the two-mode Workplaces, alters and k-hop union Households and Random
#: (the reference's two one-mode layers), walks step on Random
EDGE_LAYER = "Workplaces"
ALTER_LAYERS = ("Households", "Random")
WALK_LAYERS = ("Random",)


def build_serve_trace(net, n_requests: int, flt: dict,
                      seed: int = 17) -> list[dict]:
    """A mixed threadleR-style request trace with realistic repetition.

    Kind mix: 40% getedge / 20% alters / 15% degree / 5% filtered getedge
    / 5% filtered alters / 10% khop / 5% walkbatch. Arguments draw from
    small hot pools (n/5 pairs, n/10 nodes, n/40 k-hop sources, n/80
    walk starts for n requests), so a served stream sees repeats — the
    result cache's workload — while first occurrences still dominate.
    The draws are the JAX package's ``build_serve_trace``'s, in order, on
    the layers above: alters with ``max_alters`` 128, khop with k = 1 and
    ``max_frontier`` 128, walks of 8 steps, 4 walkers, seed 3; degree
    reads every layer. ``flt`` filters the filtered kinds (the reference
    filters on a ``grp`` column the register network does not have).
    """
    rng = np.random.default_rng(seed)
    n = net.n_nodes
    pair_pool = rng.integers(0, n, (max(n_requests // 5, 8), 2))
    node_pool = rng.integers(0, n, max(n_requests // 10, 8))
    khop_pool = rng.integers(0, n, max(n_requests // 40, 4))
    walk_pool = rng.integers(0, n, max(n_requests // 80, 2))
    kinds = rng.choice(list(TRACE_KINDS), size=n_requests,
                       p=list(TRACE_SHARES))
    trace: list[dict] = []
    for kind in kinds:
        if kind in ("getedge", "fgetedge"):
            u, v = pair_pool[rng.integers(0, len(pair_pool))]
            req = {"kind": "getedge", "layer": EDGE_LAYER,
                   "u": int(u), "v": int(v)}
            if kind == "fgetedge":
                req["filter"] = dict(flt)
        elif kind in ("alters", "falters"):
            req = {"kind": "alters",
                   "u": int(node_pool[rng.integers(0, len(node_pool))]),
                   "layers": list(ALTER_LAYERS), "max_alters": 128}
            if kind == "falters":
                req["filter"] = dict(flt)
        elif kind == "degree":
            req = {"kind": "degree",
                   "u": int(node_pool[rng.integers(0, len(node_pool))])}
        elif kind == "khop":
            req = {"kind": "khop",
                   "sources": int(khop_pool[rng.integers(0, len(khop_pool))]),
                   "k": 1, "max_frontier": 128,
                   "layers": list(ALTER_LAYERS)}
        else:
            req = {"kind": "walkbatch",
                   "starts": int(walk_pool[rng.integers(0, len(walk_pool))]),
                   "steps": 8, "walkers": 4, "seed": 3,
                   "layers": list(WALK_LAYERS)}
        trace.append(req)
    return trace


def trace_kind(req: dict) -> str:
    """The trace kind of a request: its kind, prefixed ``f`` if filtered."""
    return ("f" if "filter" in req else "") + req["kind"]


def default_fault_plan(n_requests: int):
    """The injected burst, scaled to the trace: ~1% of responses get a
    +10ms delay (contiguous, from the 35 % mark) and every other response
    of a burst from the 65 % mark is torn, forcing retries. Deterministic
    for a fixed ``n_requests``."""
    from repro_torch.serve import FaultPlan

    burst = max(n_requests // 100, 5)
    delay_start = max(int(n_requests * 0.35), 1)
    torn_start = max(int(n_requests * 0.65), delay_start + burst)
    return FaultPlan({
        "reply.delay": {
            "kind": "delay", "delay": 0.010,
            "at": tuple(range(delay_start, delay_start + burst)),
        },
        "write": {
            "kind": "torn", "frac": 0.5,
            "at": tuple(range(torn_start, torn_start + burst, 2)),
        },
    }, seed=17)


def _drive(address, trace, *, n_threads: int, deadline_ms: float,
           rate: float | None, seed_base: int) -> dict:
    """Replay ``trace`` over ``n_threads`` client sessions: closed loop
    (each session sends its next request when the last one answered) when
    ``rate`` is None, else open loop at ``rate`` requests/s. Returns the
    outcomes in trace order, the latencies and the wall. Client ``w`` is
    seeded ``seed_base + w``: the seed makes its idempotency keys, so two
    runs against one frontend need different bases, or the second run's
    keys would replay the first run's responses."""
    from repro_torch.serve import (
        GraphServeClient, RetryPolicy, ServeError, Unavailable,
    )
    from repro_torch.serve.resilience import DeadlineExceeded

    n = len(trace)
    host, port = address
    lat_s = np.full(n, np.nan)
    outcomes: list = [None] * n
    errors: list = []
    # 32 attempts, not 8: the fault burst tears every other response, and
    # a session whose retries keep landing on torn writes is torn several
    # times running (8 attempts were once spent so on an H100). 32 attempts
    # wait 1.55 s at most (31 waits of at most 0.05 s), inside the 2 s
    # deadline, which stays each request's bound.
    retry = RetryPolicy(max_attempts=32, base=0.002, cap=0.05)
    start_at = time.monotonic() + 0.05  # let every worker get ready

    def worker(wid: int):
        try:
            with GraphServeClient(host, port, retry=retry,
                                  seed=seed_base + wid) as client:
                for i in range(wid, n, n_threads):
                    sched = time.monotonic()
                    if rate is not None:
                        sched = start_at + i / rate
                        now = time.monotonic()
                        if now < sched:
                            time.sleep(sched - now)
                    try:
                        val = client.query(dict(trace[i]),
                                           deadline_ms=deadline_ms)
                        outcomes[i] = ("ok", val)
                    except (ServeError, Unavailable, DeadlineExceeded) as e:
                        outcomes[i] = ("err", f"{type(e).__name__}: {e}")
                    lat_s[i] = time.monotonic() - sched
        except Exception as e:  # a worker crash = lost requests
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"load-generator worker died: {errors[0]!r}")
    if any(o is None for o in outcomes):
        raise AssertionError("a request was lost")
    return {"outcomes": outcomes, "lat_s": lat_s, "wall_s": wall}


def run_closed_loop(address, trace, *, n_threads: int = 8,
                    deadline_ms: float = 2000.0) -> dict:
    """The frontend's capacity: ``trace`` through ``n_threads`` sessions
    as fast as they answer -> requests/s, outcomes and wall. Its clients
    are seeded apart from ``run_open_loop``'s, so both can run against
    one frontend."""
    res = _drive(address, trace, n_threads=n_threads,
                 deadline_ms=deadline_ms, rate=None, seed_base=1000)
    res["qps"] = len(trace) / res["wall_s"]
    return res


def run_open_loop(fe, trace, *, rate: float, n_threads: int = 8,
                  deadline_ms: float = 2000.0) -> dict:
    """Replay ``trace`` open-loop at ``rate`` req/s against the started
    frontend ``fe``; return the latency distribution, every outcome and
    the server's accounting (faults fired, torn writes, idempotent
    replays, sheds), with the fault counts read from the frontend's
    plan."""
    res = _drive(fe.address, trace, n_threads=n_threads,
                 deadline_ms=deadline_ms, rate=rate, seed_base=0)
    stats = fe.stats
    outcomes = res["outcomes"]
    ok_mask = np.array([o[0] == "ok" for o in outcomes])
    ok_ms = res["lat_s"][ok_mask] * 1e3
    faults = stats["faults"] or {}

    def pct(q):
        return float(np.percentile(ok_ms, q)) if ok_ms.size else float("nan")

    return {
        "requests": len(trace),
        "outcomes": outcomes,
        "ok": int(ok_mask.sum()),
        "errors": int((~ok_mask).sum()),
        "error_kinds": sorted({o[1].split(":")[0] for o in outcomes
                               if o[0] == "err"}),
        "wall_s": res["wall_s"],
        "qps": len(trace) / res["wall_s"],
        "p50_ms": pct(50), "p90_ms": pct(90), "p99_ms": pct(99),
        "max_ms": float(ok_ms.max()) if ok_ms.size else float("nan"),
        "faults_fired": int(faults.get("total_fired", 0)),
        "torn_writes": int(stats["transport"].get("torn_writes", 0)),
        "idempotent_replays": int(stats["idempotency"]["replays"]),
        "shed": int(stats["admission"]["shed"]),
        "degraded": int(stats["admission"]["degraded"]),
        "engine_served": int(stats["engine"]["served"]),
    }


def _standalone_net(n_nodes: int, device):
    """A small seeded register-style network with the trace's layers."""
    from repro_torch.core import api

    net = api.createnetwork(api.createnodeset(n_nodes, device=device))
    net = api.generate(api.addlayer(net, "Households", 2), "Households",
                       type="2mode", h=max(int(n_nodes / 2.5), 2), a=1,
                       seed=1)
    net = api.generate(api.addlayer(net, "Workplaces", 2), "Workplaces",
                       type="2mode", h=max(n_nodes // 20, 2), a=4, seed=2)
    net = api.generate(api.addlayer(net, "Random", 1), "Random", type="er",
                       p=min(10.0 / n_nodes, 0.1), seed=3)
    income = np.random.default_rng(0).integers(0, 100_000, n_nodes)
    net = api.setnodeattr(net, "income", np.arange(n_nodes), income,
                          kind="int")
    return net, int(np.median(income))


def main() -> None:
    import argparse
    import json

    from repro_torch.core import api

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--requests", type=int, default=2_000)
    ap.add_argument("--load", type=float, default=0.8,
                    help="open-loop rate as a share of the measured capacity")
    args = ap.parse_args()

    net, median = _standalone_net(args.nodes, args.device)
    flt = {"attr": "income", "op": "gt", "value": median}
    trace = build_serve_trace(net, args.requests, flt)
    fe = api.servenet(net, port=0, fault_plan=default_fault_plan(len(trace)))
    try:
        cap = run_closed_loop(fe.address, trace[: max(len(trace) // 5, 1)])
        fe._plan.reset()  # the burst counts from the open loop's start
        res = run_open_loop(fe, trace, rate=args.load * cap["qps"])
    finally:
        fe.close()
    res.pop("outcomes")
    res["capacity_qps"] = cap["qps"]
    print(json.dumps(res, sort_keys=True))


if __name__ == "__main__":
    main()
