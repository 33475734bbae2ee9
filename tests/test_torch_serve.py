"""Graph-query serving engine of the PyTorch port on the CPU: the cases
of the JAX package's ``tests/test_serve.py`` (micro-batching
bit-identity, LRU cache semantics, mutation invalidation, bounded-queue
backpressure, error isolation, threaded clients, deadlines, the durable
store and the trace-file surface) run against ``repro_torch.serve``, plus
parity with the JAX package's engine: the same seeded network built by
both packages' generators, the same mixed trace, equal records and equal
batch, cache-hit and coalescing counts. Only the pump thread runs
queries: see ``test_torch_serve_frontend.py``."""

import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import api
from repro_torch.core.cli import Session
from repro_torch.serve import (
    GraphServeEngine,
    QueueFull,
    REQUEST_KINDS,
    assert_results_equal as _assert_same,
    parse_trace,
    run_request,
)


@pytest.fixture()
def net():
    n = 300
    net = api.createnetwork(api.createnodeset(n, device="cpu"))
    net = api.generate(api.addlayer(net, "er", 1), "er",
                       type="er", p=0.03, seed=1)
    net = api.generate(api.addlayer(net, "wk", 2), "wk",
                       type="2mode", h=30, a=4, seed=2)
    rng = np.random.default_rng(0)
    net = api.setnodeattr(
        net, "grp", np.arange(n), rng.integers(0, 3, n).astype(np.int64)
    )
    return net


def _mixed_trace(net, n_requests: int, seed: int = 0) -> list[dict]:
    """Randomized request stream hitting every kind, ± filters."""
    rng = np.random.default_rng(seed)
    n = net.n_nodes
    flt = {"attr": "grp", "op": "eq", "value": 1}
    trace = []
    for _ in range(n_requests):
        kind = REQUEST_KINDS[rng.integers(0, len(REQUEST_KINDS))]
        use_filter = bool(rng.integers(0, 2))
        if kind == "getedge":
            req = {"kind": kind, "layer": "wk",
                   "u": int(rng.integers(0, n)), "v": int(rng.integers(0, n))}
        elif kind == "alters":
            req = {"kind": kind, "u": int(rng.integers(0, n)),
                   "max_alters": 64}
        elif kind == "degree":
            req = {"kind": kind,
                   "u": [int(i) for i in rng.integers(0, n, 3)]}
        elif kind == "khop":
            req = {"kind": kind, "sources": int(rng.integers(0, n)),
                   "k": int(rng.integers(1, 3)), "max_frontier": 64}
        else:
            req = {"kind": kind, "starts": int(rng.integers(0, n)),
                   "steps": 4, "walkers": 2, "seed": int(rng.integers(0, 3))}
        if use_filter and kind != "walkbatch":
            req["filter"] = flt
        trace.append(req)
    return trace


# -- micro-batching bit-identity ---------------------------------------------


def test_served_results_bit_identical_to_per_call_loop(net):
    """Coalesced dispatch == one-call-at-a-time, across all five kinds,
    with and without filters (the serve_perf benchmark's contract)."""
    trace = _mixed_trace(net, 60)
    engine = GraphServeEngine(net)
    served = engine.serve(trace)
    assert [r.rid for r in served] == list(range(60))
    for req, res in zip(trace, served):
        assert res.error is None, res.error
        _assert_same(res.value, run_request(net, req))
    # every kind actually went through a coalesced batch
    assert all(engine.stats["batches"][k] >= 1 for k in REQUEST_KINDS)


def test_getedge_group_coalesces_into_one_dispatch(net):
    reqs = [{"kind": "getedge", "layer": "er", "u": i, "v": i + 1}
            for i in range(20)]
    engine = GraphServeEngine(net)
    engine.serve(reqs)
    assert engine.stats["batches"]["getedge"] == 1
    assert engine.stats["dispatched"]["getedge"] == 20


# -- result cache -------------------------------------------------------------


def test_cache_hits_bit_identical_to_cold_misses_all_kinds(net):
    trace = _mixed_trace(net, 40, seed=3)
    engine = GraphServeEngine(net, cache_size=1024)
    cold = engine.serve(trace)
    hot = engine.serve(trace)
    for c, h in zip(cold, hot):
        assert h.cached
        _assert_same(c.value, h.value)
    stats = engine.stats["cache"]
    assert stats["hits"] >= len(trace)


def test_cache_lru_eviction_and_stats(net):
    engine = GraphServeEngine(net, cache_size=4)
    reqs = [{"kind": "degree", "u": i} for i in range(6)]
    engine.serve(reqs)
    s = engine.stats["cache"]
    assert s["entries"] == 4 and s["evictions"] == 2
    # 0 and 1 were evicted (oldest), 2..5 still hit
    assert not engine.serve([{"kind": "degree", "u": 0}])[0].cached
    assert engine.serve([{"kind": "degree", "u": 5}])[0].cached


def test_cache_disabled_with_zero_capacity(net):
    engine = GraphServeEngine(net, cache_size=0)
    r1 = engine.serve([{"kind": "degree", "u": 1}])[0]
    r2 = engine.serve([{"kind": "degree", "u": 1}])[0]
    assert not r1.cached and not r2.cached
    _assert_same(r1.value, r2.value)


def test_duplicate_requests_in_one_round_share_one_dispatch(net):
    engine = GraphServeEngine(net)
    res = engine.serve([{"kind": "degree", "u": 7}] * 5)
    assert engine.stats["dispatched"]["degree"] == 1
    assert engine.stats["coalesced_dupes"] == 4
    for r in res:
        _assert_same(r.value, res[0].value)


# -- mutation invalidation (never serve a stale result) -----------------------


def test_setattr_invalidates_filtered_results(net):
    """A served filtered query after set_attr must reflect the new
    attribute values — the filter spec re-resolves AND the cache drops."""
    engine = GraphServeEngine(net)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    req = {"kind": "alters", "u": 5, "max_alters": 64, "filter": flt}
    before = engine.serve([req])[0]
    # flip every node into group 1: the filtered result must widen
    engine.set_attr("grp", list(range(net.n_nodes)),
                    [1] * net.n_nodes)
    after = engine.serve([req])[0]
    assert not after.cached
    _assert_same(after.value, run_request(engine.net, req))
    unfiltered = run_request(
        engine.net, {"kind": "alters", "u": 5, "max_alters": 64}
    )
    np.testing.assert_array_equal(after.value, unfiltered)
    assert before.value.size <= after.value.size


def test_filter_spec_resolved_once_per_generation(net, monkeypatch):
    """Repeated dict filter specs resolve (attribute select + mask hash)
    once per mutation epoch, not once per request; a mutation forces a
    fresh resolve so the memo never serves a pre-mutation mask."""
    calls = {"n": 0}
    cls = type(net.nodeset)
    real_select = cls.select

    def counting_select(self, *a, **kw):
        calls["n"] += 1
        return real_select(self, *a, **kw)

    monkeypatch.setattr(cls, "select", counting_select)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    reqs = [{"kind": "degree", "u": i, "filter": dict(flt)}
            for i in range(20)]
    engine = GraphServeEngine(net, cache_size=0)  # memo, not result cache
    out_before = engine.serve(reqs)
    assert calls["n"] == 1
    engine.set_attr("grp", list(range(net.n_nodes)), [1] * net.n_nodes)
    out_after = engine.serve(reqs)
    assert calls["n"] == 2
    monkeypatch.undo()
    for req, res in zip(reqs, out_before):
        _assert_same(res.value, run_request(net, req))
    for req, res in zip(reqs, out_after):
        _assert_same(res.value, run_request(engine.net, req))


def test_deletelayer_invalidates_all_layer_results(net):
    engine = GraphServeEngine(net)
    req = {"kind": "degree", "u": 3}  # all layers
    before = engine.serve([req])[0]
    engine.delete_layer("wk")
    after = engine.serve([req])[0]
    assert not after.cached
    _assert_same(after.value, run_request(engine.net, req))
    assert "wk" not in engine.net.layer_names
    assert before.error is None


def test_importlayer_invalidates_same_key_results(net, tmp_path):
    """import_layer swaps a layer's content under an unchanged cache key —
    the canonical stale-cache hazard."""
    f = tmp_path / "edges.tsv"
    f.write_text("".join(f"{u}\t{u + 1}\n" for u in range(0, 50, 2)))
    engine = GraphServeEngine(net)
    req = {"kind": "getedge", "layer": "er", "u": 0, "v": 1}
    engine.serve([req])  # cached against the generated er layer
    engine.import_layer("er", str(f))
    after = engine.serve([req])[0]
    assert not after.cached
    _assert_same(after.value, run_request(engine.net, req))
    assert after.value == 1.0  # edge 0-1 exists in the imported layer


def test_mutation_sweep_never_serves_stale(net, tmp_path):
    """Property sweep: interleave random queries with random mutations;
    every served result must equal a fresh per-call execution against the
    engine's current network, for all five request kinds."""
    rng = np.random.default_rng(11)
    engine = GraphServeEngine(net)
    f = tmp_path / "imp.tsv"
    f.write_text("".join(f"{u}\t{u + 2}\n" for u in range(0, 40, 4)))
    trace = _mixed_trace(net, 30, seed=7)
    for i, req in enumerate(trace):
        if i % 7 == 3:
            mutation = rng.integers(0, 3)
            if mutation == 0:
                ids = rng.integers(0, engine.net.n_nodes, 10)
                engine.set_attr("grp", [int(x) for x in ids],
                                [int(rng.integers(0, 3))] * 10)
            elif mutation == 1 and "extra" not in engine.net.layer_names:
                engine.import_layer("extra", str(f))
            elif "extra" in engine.net.layer_names:
                engine.delete_layer("extra")
        res = engine.serve([req])[0]
        assert res.error is None, res.error
        _assert_same(res.value, run_request(engine.net, req))


def test_queued_filtered_request_recanonicalized_on_mutation(net):
    """A filter spec resolved at submit time must NOT execute with a
    pre-mutation mask: mutation re-resolves queued requests against the
    new network before they dispatch."""
    engine = GraphServeEngine(net)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    req = {"kind": "alters", "u": 5, "max_alters": 64, "filter": flt}
    rid = engine.submit(req)  # queued, not yet pumped
    engine.set_attr("grp", list(range(net.n_nodes)), [1] * net.n_nodes)
    engine.pump()
    out = engine.result(rid)
    assert out is not None and out.error is None
    _assert_same(out.value, run_request(engine.net, req))


def test_queued_request_for_deleted_layer_errors_when_dispatched(net):
    engine = GraphServeEngine(net)
    rid = engine.submit({"kind": "getedge", "layer": "wk", "u": 0, "v": 1})
    engine.delete_layer("wk")
    engine.pump()
    out = engine.result(rid)
    assert out is not None and out.error is not None
    assert "wk" in out.error


def test_mutation_during_dispatch_never_repopulates_cache(net, monkeypatch):
    """An in-flight batch finishing after update_network delivers its
    (pre-mutation) results but must not re-enter the invalidated cache."""
    from repro_torch.serve import graph_engine as ge

    engine = GraphServeEngine(net)
    real = ge._EXECUTORS["degree"]

    def mutate_mid_dispatch(n, gk, creqs):
        vals = real(n, gk, creqs)
        engine.set_attr("grp", [0], [2])  # lands while batch is in flight
        return vals

    monkeypatch.setitem(ge._EXECUTORS, "degree", mutate_mid_dispatch)
    engine.serve([{"kind": "degree", "u": 9}])
    monkeypatch.undo()
    assert engine.stats["cache"]["entries"] == 0
    again = engine.serve([{"kind": "degree", "u": 9}])[0]
    assert not again.cached  # recomputed against the current network
    _assert_same(again.value, run_request(engine.net, {"kind": "degree",
                                                       "u": 9}))


def test_mutation_racing_submit_recanonicalizes(net, monkeypatch):
    """A mutation landing between submit's filter resolution and the
    enqueue must not slip a stale mask into the queue (submit detects
    the generation change and re-resolves)."""
    from repro_torch.serve import graph_engine as ge

    engine = GraphServeEngine(net)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    req = {"kind": "alters", "u": 5, "max_alters": 64, "filter": flt}
    real = ge.canonical_request
    fired = []

    def racing(n, r, **kw):
        creq = real(n, r, **kw)
        if not fired:
            fired.append(True)  # mutate after resolution, before enqueue
            engine.set_attr("grp", list(range(net.n_nodes)),
                            [1] * net.n_nodes)
        return creq

    monkeypatch.setattr(ge, "canonical_request", racing)
    rid = engine.submit(req)
    monkeypatch.undo()
    assert len(fired) == 1
    engine.pump()
    out = engine.result(rid)
    assert out.error is None
    _assert_same(out.value, run_request(engine.net, req))


def test_serve_with_background_pump_running(net):
    """serve() on a start()ed engine must wait for in-flight batches
    (pending can read 0 while the pump thread holds a popped batch)."""
    with GraphServeEngine(net).start() as engine:
        for _ in range(5):
            res = engine.serve(_mixed_trace(net, 8, seed=13))
            assert len(res) == 8
            assert all(r.error is None for r in res)


def test_serve_isolates_malformed_trace_lines(net):
    """One bad trace line becomes an error record; the rest still serve."""
    trace = [
        {"kind": "degree", "u": 1},
        {"kind": "getedge", "layer": "no_such_layer", "u": 0, "v": 1},
        {"kind": "teleport", "u": 2},
        {"kind": "degree", "u": 2},
    ]
    res = GraphServeEngine(net).serve(trace)
    assert [r.rid for r in res] == [0, 1, 2, 3]
    assert res[0].error is None and res[3].error is None
    assert "no_such_layer" in res[1].error
    assert "teleport" in res[2].error
    _assert_same(res[0].value, run_request(net, trace[0]))
    # a non-dict entry is isolated too (AttributeError path)
    res = GraphServeEngine(net).serve([{"kind": "degree", "u": 1}, ["oops"]])
    assert res[0].error is None and res[1].error is not None


def test_zero_queue_limit_clamped_no_livelock(net):
    engine = GraphServeEngine(net, queue_limit=0)
    res = engine.serve([{"kind": "degree", "u": 1},
                        {"kind": "degree", "u": 2}])
    assert all(r.error is None for r in res)


# -- backpressure -------------------------------------------------------------


def test_heavy_flood_cannot_starve_point_queries(net):
    """khop floods saturate their own bounded queue (QueueFull) while
    point queries still enqueue and get served first each round."""
    engine = GraphServeEngine(
        net, heavy_queue_limit=8, max_heavy_per_round=2
    )
    for i in range(8):
        engine.submit({"kind": "khop", "sources": i, "k": 1})
    with pytest.raises(QueueFull):
        engine.submit({"kind": "khop", "sources": 99, "k": 1})
    # the point lane is unaffected by the flood
    rid = engine.submit({"kind": "degree", "u": 1})
    served = engine.pump()
    # one round serves the point query and only max_heavy_per_round khops
    assert served == 3
    assert engine.result(rid) is not None
    assert engine.pending == 6


def test_point_queue_backpressure(net):
    engine = GraphServeEngine(net, queue_limit=2)
    engine.submit({"kind": "degree", "u": 0})
    engine.submit({"kind": "degree", "u": 1})
    with pytest.raises(QueueFull):
        engine.submit({"kind": "degree", "u": 2})
    engine.pump()
    engine.submit({"kind": "degree", "u": 2})  # drained -> accepted
    assert engine.stats["rejected"] == 1


# -- robustness ---------------------------------------------------------------


def test_uncollected_results_bounded(net):
    """Fire-and-forget clients (submit without result()) must not grow
    the result store without bound: overflow drops oldest-stored results
    and counts them, while recent results stay collectable."""
    engine = GraphServeEngine(
        net, cache_size=0, queue_limit=4, max_heavy_per_round=1,
        result_limit=1,  # clamps to 2 * (queue_limit + heavy_limit) = 16
    )
    rids = []
    for i in range(64):
        while True:
            try:
                rids.append(engine.submit({"kind": "degree", "u": i % 300}))
                break
            except QueueFull:
                engine.pump()
    while engine.pending:
        engine.pump()
    s = engine.stats
    assert s["uncollected"] <= 16
    assert s["results_dropped"] == 64 - s["uncollected"]
    assert engine.result(rids[0]) is None  # oldest: dropped
    newest = engine.result(rids[-1])  # newest: still collectable
    assert newest is not None
    _assert_same(newest.value, run_request(net, {"kind": "degree",
                                                 "u": 63 % 300}))


def test_malformed_flood_cannot_drop_replay_results(net):
    """Regression: a burst of malformed trace lines between valid
    requests must not push the result store over its bound and trim the
    replay's own uncollected results (error records bypass the store)."""
    engine = GraphServeEngine(
        net, cache_size=0, queue_limit=4, max_heavy_per_round=1,
        result_limit=1,  # clamps to 16
    )
    trace = (
        [{"kind": "degree", "u": i % 300} for i in range(16)]
        + [{"kind": "bogus"}] * 20
        + [{"kind": "degree", "u": (16 + i) % 300} for i in range(8)]
    )
    out = engine.serve(trace)
    assert len(out) == 44
    assert [r.rid for r in out] == list(range(44))
    for i, r in enumerate(out):
        if 16 <= i < 36:
            assert r.error is not None and "bogus" in r.error
        else:
            assert r.error is None, (i, r.error)
            _assert_same(r.value, run_request(net, trace[i]))
    assert engine.stats["results_dropped"] == 0
    assert not engine._claimed  # no leaked claims after the replay


def test_concurrent_flood_cannot_drop_threaded_replay(net):
    """A fire-and-forget client overflowing the shared result store must
    drop only its own uncollected results, never the rids a concurrent
    serve() replay has claimed (which would deadlock its drain)."""
    engine = GraphServeEngine(
        net, cache_size=0, queue_limit=4, max_heavy_per_round=1,
        result_limit=1,  # clamps to 16
    ).start()
    with engine:
        trace = [{"kind": "degree", "u": i % 300} for i in range(40)]

        def flood():
            for i in range(64):  # submit-and-forget, never collected
                while True:
                    try:
                        engine.submit({"kind": "degree", "u": i % 300})
                        break
                    except QueueFull:
                        time.sleep(0.002)

        t = threading.Thread(target=flood)
        t.start()
        out = engine.serve(trace)
        t.join()
    assert len(out) == 40
    for req, r in zip(trace, out):
        assert r.error is None
        _assert_same(r.value, run_request(net, req))
    s = engine.stats
    assert s["results_dropped"] > 0  # the flood's results were trimmed
    assert s["uncollected"] <= 16
    assert not engine._claimed


def test_malformed_request_rejected_at_submit(net):
    engine = GraphServeEngine(net)
    with pytest.raises(ValueError):
        engine.submit({"kind": "teleport", "u": 0})
    with pytest.raises(KeyError):
        engine.submit({"kind": "getedge", "layer": "nope", "u": 0, "v": 1})
    with pytest.raises(ValueError):
        engine.submit({"kind": "khop", "sources": 0, "k": -1})


def test_runtime_error_isolated_per_request(net, monkeypatch):
    """A dispatch blowing up marks its own requests failed; the rest of
    the round still serves."""
    from repro_torch.serve import graph_engine as ge

    def boom(*a, **k):
        raise RuntimeError("kernel exploded")

    monkeypatch.setitem(ge._EXECUTORS, "khop", boom)
    engine = GraphServeEngine(net)
    res = engine.serve([
        {"kind": "degree", "u": 1},
        {"kind": "khop", "sources": 1, "k": 1},
    ])
    assert res[0].error is None
    assert res[1].error is not None and "kernel exploded" in res[1].error
    # errors are not cached: a later fixed dispatch recomputes
    monkeypatch.undo()
    ok = engine.serve([{"kind": "khop", "sources": 1, "k": 1}])[0]
    assert ok.error is None and not ok.cached


def test_threaded_clients_background_pump(net):
    """Many client threads submit concurrently against the background
    pump; every result arrives and matches the per-call reference."""
    with GraphServeEngine(net).start() as engine:
        results = {}

        def client(base):
            for i in range(5):
                req = {"kind": "degree", "u": (base + i) % net.n_nodes}
                rid = engine.submit(req)
                out = engine.result(rid, timeout=30.0)
                results[(base, i)] = (req, out)

        threads = [threading.Thread(target=client, args=(b,))
                   for b in (0, 50, 100, 150)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) == 20
    for req, out in results.values():
        assert out is not None and out.error is None
        _assert_same(out.value, run_request(net, req))


def test_started_engine_applies_mutations_on_the_pump(net, monkeypatch):
    """With the background pump running, a mutation called from another
    thread is applied by the pump between rounds: the caller gets the new
    network back, or the mutation's own exception, and the pump serves on."""
    ran_on = []
    real = api.addedges

    def recording(*a, **kw):
        ran_on.append(threading.current_thread())
        return real(*a, **kw)

    monkeypatch.setattr(api, "addedges", recording)
    req = {"kind": "degree", "u": 0, "layers": ["er"]}
    with GraphServeEngine(net).start() as engine:
        pump = engine.pump_thread
        before = engine.serve([req])[0].value
        assert engine.add_edges("er", [0], [250]) is engine.net
        with pytest.raises(KeyError, match="missing"):
            engine.add_edges("missing", [0], [1])
        after = engine.serve([req])[0]
    assert ran_on == [pump, pump]
    assert after.error is None and after.value == before + 1
    _assert_same(after.value, run_request(engine.net, req))


# -- trace files + api/CLI surface -------------------------------------------


def test_parse_trace_comments_and_errors():
    text = '# a comment\n\n{"kind": "degree", "u": 1}\n'
    assert parse_trace(text) == [{"kind": "degree", "u": 1}]
    # terminated bad-JSON line: generic parse error (an *unterminated*
    # bad final line is a torn tail — TruncatedFileError, tested below)
    with pytest.raises(ValueError, match="line 1"):
        parse_trace("not json\n")
    with pytest.raises(ValueError, match="expected an object"):
        parse_trace("[1, 2]")


def test_api_serve_trace_file(net, tmp_path):
    trace = _mixed_trace(net, 12, seed=5)
    path = tmp_path / "trace.jsonl"
    path.write_text(
        "# mixed trace\n" + "".join(json.dumps(r) + "\n" for r in trace)
    )
    records, stats = api.serve(net, str(path))
    assert len(records) == 12
    assert [r["id"] for r in records] == list(range(12))
    for req, rec in zip(trace, records):
        assert rec["kind"] == req["kind"]
        assert "result" in rec
    assert stats["served"] == 12


def test_cli_serve_text_and_json(net, tmp_path, capsys):
    trace_path = tmp_path / "t.jsonl"
    trace_path.write_text(
        '{"kind": "degree", "u": 1}\n{"kind": "degree", "u": 1}\n'
        '{"kind": "getedge", "layer": "er", "u": 0, "v": 1}\n'
    )
    script = (
        "nodes = createnodeset(createnodes = 120)\n"
        "net = createnetwork(nodeset = nodes)\n"
        'addlayer(net, "er", mode = 1)\n'
        'generate(net, "er", type = er, p = 0.05, seed = 1)\n'
        f'serve(net, file = "{trace_path}")\n'
    )
    out_text = Session(mode="text", device="cpu").run_script(script)
    assert len(out_text) == 1 and "served 3 requests" in out_text[0]
    out_json = Session(mode="json", device="cpu").run_script(script)
    payload = json.loads(out_json[0])
    assert payload["command"] == "serve"
    result = payload["result"]
    assert result["served"] == 3
    assert len(result["results"]) == 3
    assert result["results"][1]["cached"] is True
    # the duplicate was served without recomputation: an LRU hit when it
    # lands in a later round, a coalesced dupe when in the same round
    stats = result["stats"]
    assert stats["cache"]["hits"] + stats["coalesced_dupes"] >= 1


# -- scoped invalidation (durable mutation engine PR) ------------------------


def _apply_sweep_mutation(engine, step: int, n: int) -> None:
    """Deterministic mutation for sweep step ``step``: rotates through
    one-mode edge insert/delete, attribute writes, and two-mode
    membership inserts so every invalidation scope gets exercised."""
    k = step % 4
    if k == 0:
        engine.add_edges(
            "er", [(7 * step) % n, (11 * step) % n],
            [(13 * step + 1) % n, (17 * step + 2) % n],
        )
    elif k == 1:
        engine.set_attr("grp", [(5 * step) % n], [step % 3])
    elif k == 2:
        engine.delete_edges("er", [(7 * step) % n], [(13 * step + 1) % n])
    else:
        engine.add_edges("wk", [(3 * step) % n], [step % 30])


def test_scoped_invalidation_bit_identical_to_full(net):
    """The acceptance property: a mixed mutation/query sweep served under
    scoped invalidation is bit-identical to the nuke-everything reference
    engine AND to the per-call ground truth — while hitting the cache
    strictly more often."""
    scoped = GraphServeEngine(net, scoped_invalidation=True)
    full = GraphServeEngine(net, scoped_invalidation=False)
    trace = _mixed_trace(net, 30, seed=3)
    for step in range(8):
        rs = scoped.serve(trace)
        rf = full.serve(trace)
        for req, a, b in zip(trace, rs, rf):
            assert (a.error is None) == (b.error is None), (a, b)
            if a.error is None:
                _assert_same(a.value, b.value)
                _assert_same(a.value, run_request(scoped.net, req))
        _apply_sweep_mutation(scoped, step, net.n_nodes)
        _apply_sweep_mutation(full, step, net.n_nodes)
    s, f = scoped.stats["cache"], full.stats["cache"]
    assert s["hits"] > f["hits"], (s, f)
    assert s["misses"] < f["misses"], (s, f)


def test_unrelated_layer_mutation_keeps_cache_entries(net):
    """A mutation to layer B evicts only B-scoped (and whole-network)
    entries; an A-only entry survives and keeps serving hits."""
    engine = GraphServeEngine(net)
    req_a = {"kind": "degree", "u": 5, "layers": ["er"]}
    req_b = {"kind": "degree", "u": 5, "layers": ["wk"]}
    req_all = {"kind": "degree", "u": 5}
    engine.serve([req_a, req_b, req_all])
    engine.add_edges("wk", [3], [2])
    ra, rb, rall = engine.serve([req_a, req_b, req_all])
    assert ra.cached, "unrelated-layer entry was evicted"
    assert not rb.cached and not rall.cached
    _assert_same(rb.value, run_request(engine.net, req_b))
    _assert_same(rall.value, run_request(engine.net, req_all))
    cache = engine.stats["cache"]
    assert cache["scoped_invalidations"] == 1
    assert cache["entries_invalidated"] == 2


def test_scoped_never_serves_stale_after_layer_mutation(net):
    """Scoped eviction still drops everything the mutation could have
    changed: the mutated layer's entry recomputes and reflects the op."""
    engine = GraphServeEngine(net)
    req = {"kind": "degree", "u": 0, "layers": ["er"]}
    before = engine.serve([req])[0]
    engine.add_edges("er", [0, 0], [290, 291])
    after = engine.serve([req])[0]
    assert not after.cached
    _assert_same(after.value, run_request(engine.net, req))
    assert after.value == before.value + 2


def test_scoped_setattr_keeps_unrelated_filter_entries(net):
    """set_attr evicts nothing from the result cache: entries under an
    unchanged mask content stay hits (bit-identical), entries under the
    touched attribute become unreachable through the fingerprint."""
    engine = GraphServeEngine(net)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    req = {"kind": "degree", "u": 5, "layers": ["er"], "filter": flt}
    engine.serve([req])
    engine.set_attr("other", [0], [1])  # unrelated attribute
    hit = engine.serve([req])[0]
    assert hit.cached
    _assert_same(hit.value, run_request(engine.net, req))
    # now flip node 5's own group membership: the mask changes, the old
    # entry is unreachable, and the recompute reflects the new state
    cur = int(api.getnodeattr(engine.net, "grp", [5])[0][0])
    engine.set_attr("grp", [5], [0 if cur == 1 else 1])
    miss = engine.serve([req])[0]
    assert not miss.cached
    _assert_same(miss.value, run_request(engine.net, req))


# -- per-request deadlines ---------------------------------------------------


def test_request_deadline_expires_in_queue(net):
    engine = GraphServeEngine(net)
    rid = engine.submit({"kind": "degree", "u": 3, "timeout": 0.001})
    time.sleep(0.01)
    engine.pump()
    r = engine.result(rid)
    assert r.error is not None and "DeadlineExceeded" in r.error
    assert engine.stats["deadline_expired"] == 1
    # the same request without a deadline serves normally afterwards
    rid = engine.submit({"kind": "degree", "u": 3})
    engine.pump()
    assert engine.result(rid).error is None


def test_default_timeout_and_validation(net):
    engine = GraphServeEngine(net, default_timeout=0.001)
    rid = engine.submit({"kind": "degree", "u": 3})
    time.sleep(0.01)
    engine.pump()
    assert "DeadlineExceeded" in engine.result(rid).error
    with pytest.raises(ValueError, match="timeout"):
        engine.submit({"kind": "degree", "u": 3, "timeout": -1})
    # a generous deadline never fires on a healthy pump
    engine2 = GraphServeEngine(net, default_timeout=60)
    assert engine2.serve([{"kind": "degree", "u": 3}])[0].error is None
    assert engine2.stats["deadline_expired"] == 0


# -- guarded pump (satellite bugfix regression) ------------------------------


def test_pump_thread_survives_injected_fault(net):
    """A fault OUTSIDE the per-group executor guard (here: the cache
    pass) must produce error results for the popped requests and leave
    the background pump thread alive for the next round — the pre-fix
    engine hung queued clients forever."""
    engine = GraphServeEngine(net).start()
    try:
        orig_get = engine._cache.get

        def broken_get(key):
            raise RuntimeError("injected cache fault")

        engine._cache.get = broken_get
        rid = engine.submit({"kind": "degree", "u": 3})
        r = engine.result(rid, timeout=10)
        assert r is not None, "client hung on a pump fault"
        assert "pump fault" in r.error and "injected cache fault" in r.error
        # the thread survived and serves cleanly once the fault clears
        engine._cache.get = orig_get
        assert engine._thread.is_alive()
        rid = engine.submit({"kind": "degree", "u": 4})
        r = engine.result(rid, timeout=10)
        assert r is not None and r.error is None
        assert engine.stats["pump_faults"] >= 1
    finally:
        engine.stop()


def test_pump_fault_inline_reports_all_popped_requests(net):
    """Inline pump: every request popped into the faulting round gets an
    error result (none silently lost), queued-later requests unaffected."""
    engine = GraphServeEngine(net)
    rids = [engine.submit({"kind": "degree", "u": i}) for i in range(4)]
    engine._cache.get = lambda key: (_ for _ in ()).throw(
        RuntimeError("boom")
    )
    engine.pump()
    for rid in rids:
        r = engine.result(rid)
        assert r is not None and "pump fault" in r.error
    engine._cache.get = _ResultCacheGet = type(engine._cache).get.__get__(
        engine._cache
    )
    assert engine.serve([{"kind": "degree", "u": 9}])[0].error is None


# -- durable store integration -----------------------------------------------


def test_durable_engine_mutations_recover(net, tmp_path):
    """Engine mutations routed through a DurableStore replay to the
    exact served network after a (simulated) crash."""
    from repro_torch.core.snapshot import DurableStore, recover

    store = DurableStore.create(tmp_path / "s", net)
    engine = GraphServeEngine(store=store)
    engine.add_edges("er", [0, 1], [5, 6])
    engine.set_attr("grp", [2], [2])
    engine.delete_edges("er", [0], [5])
    api.exportlayer(net, "er", str(tmp_path / "er.tsv"))
    engine.import_layer("imported", str(tmp_path / "er.tsv"))
    reqs = [
        {"kind": "degree", "u": 0, "layers": ["er"]},
        {"kind": "degree", "u": 0, "layers": ["imported"]},
        {"kind": "alters", "u": 2, "max_alters": 64},
    ]
    served = engine.serve(reqs)
    assert engine.stats["durable_lsn"] == 3
    store.close()  # crash: only the disk state survives
    rnet, info = recover(tmp_path / "s", device="cpu")
    assert info.replayed == 4
    for req, r in zip(reqs, served):
        _assert_same(r.value, run_request(rnet, req))


def test_durable_engine_fail_closed_keeps_serving(net, tmp_path,
                                                  monkeypatch):
    """A WAL write error rejects the mutation and the engine keeps
    serving the acknowledged (pre-mutation) state — which recovery
    agrees with."""
    from repro_torch.core import wal as walmod
    from repro_torch.core.snapshot import DurableStore, recover
    from repro_torch.core.wal import WALWriteError

    store = DurableStore.create(tmp_path / "s", net)
    engine = GraphServeEngine(store=store)
    req = {"kind": "degree", "u": 0, "layers": ["er"]}
    before = engine.serve([req])[0]
    monkeypatch.setattr(
        walmod.os, "fsync",
        lambda fd: (_ for _ in ()).throw(OSError("injected")),
    )
    with pytest.raises(WALWriteError):
        engine.add_edges("er", [0], [250])
    monkeypatch.undo()
    after = engine.serve([req])[0]
    assert after.cached  # nothing was invalidated by the rejected op
    _assert_same(after.value, before.value)
    rnet, _ = recover(tmp_path / "s", device="cpu")
    _assert_same(before.value, run_request(rnet, req))
    store.close()


# -- close() / context manager (lifecycle satellite) --------------------------


def test_close_drains_and_rejects_late_submissions(net):
    from repro_torch.serve import EngineClosed

    engine = GraphServeEngine(net).start()
    rids = [engine.submit({"kind": "degree", "u": i}) for i in range(8)]
    engine.close()
    # everything queued before close() was answered, nothing lost
    for rid in rids:
        r = engine.result(rid, timeout=5)
        assert r is not None and r.error is None
    # the pump thread is joined and late clients get a clear error
    assert engine.closed and not engine.pump_started
    with pytest.raises(EngineClosed):
        engine.submit({"kind": "degree", "u": 0})
    with pytest.raises(EngineClosed):
        engine.add_edges("er", [0], [1])
    with pytest.raises(EngineClosed):
        engine.start()
    engine.close()  # idempotent


def test_close_inline_engine_without_thread(net):
    from repro_torch.serve import EngineClosed

    engine = GraphServeEngine(net)
    rid = engine.submit({"kind": "degree", "u": 3})
    engine.close()  # drains inline (no pump thread was ever started)
    assert engine.result(rid).error is None
    with pytest.raises(EngineClosed):
        engine.submit({"kind": "degree", "u": 3})


def test_context_manager_closes_engine(net):
    from repro_torch.serve import EngineClosed

    with GraphServeEngine(net).start() as engine:
        rid = engine.submit({"kind": "degree", "u": 3})
        assert engine.result(rid, timeout=5).error is None
    assert engine.closed and not engine.pump_started
    with pytest.raises(EngineClosed):
        engine.submit({"kind": "degree", "u": 3})


# -- post-batch deadline check (satellite regression) -------------------------


def test_deadline_expiring_mid_batch_returns_error(net):
    """A request whose budget lapses DURING dispatch must answer
    DeadlineExceeded, not a stale success — regression for the
    dequeue-only deadline check, driven by an injected batch delay."""
    from repro_torch.serve import FaultPlan

    plan = FaultPlan({
        "pump.batch_delay": {"kind": "delay", "at": (0,), "delay": 0.05},
    })
    engine = GraphServeEngine(net, fault_plan=plan)
    rid = engine.submit({"kind": "degree", "u": 3, "timeout": 0.02})
    engine.pump()  # deadline is alive at dequeue, dead after the delay
    r = engine.result(rid)
    assert r.error is not None and "DeadlineExceeded" in r.error
    assert "during dispatch" in r.error
    assert engine.stats["deadline_expired"] == 1
    # the computed value was still cached (valid for the key): the same
    # request with budget to spare is a hit, not a recomputation
    rid = engine.submit({"kind": "degree", "u": 3, "timeout": 30})
    engine.pump()
    r2 = engine.result(rid)
    assert r2.error is None and r2.cached


def test_generous_deadline_survives_batch_delay(net):
    from repro_torch.serve import FaultPlan

    plan = FaultPlan({
        "pump.batch_delay": {"kind": "delay", "at": (0,), "delay": 0.02},
    })
    engine = GraphServeEngine(net, fault_plan=plan)
    rid = engine.submit({"kind": "degree", "u": 3, "timeout": 30})
    engine.pump()
    assert engine.result(rid).error is None
    assert engine.stats["deadline_expired"] == 0


# -- trailing-line handling (trace-replay satellite fix) ----------------------


def test_parse_trace_final_line_without_newline_parses(net):
    """A complete final record missing only its newline terminator must
    be served, not silently dropped."""
    text = ('{"kind": "degree", "u": 1}\n'
            '{"kind": "degree", "u": 2}')  # no trailing \n
    reqs = parse_trace(text)
    assert [r["u"] for r in reqs] == [1, 2]


def test_parse_trace_torn_final_line_raises_truncated(tmp_path):
    from repro_torch.core.io import TruncatedFileError
    from repro_torch.serve import load_trace

    p = tmp_path / "t.jsonl"
    p.write_text('{"kind": "degree", "u": 1}\n{"kind": "degr')
    with pytest.raises(TruncatedFileError, match="torn mid-write"):
        load_trace(p)
    # the same garbage MID-file is a plain malformed-line error, not a
    # truncation (the writer terminated it — it was never torn)
    with pytest.raises(ValueError, match="bad JSON"):
        parse_trace('{"kind": "degr\n{"kind": "degree", "u": 1}\n')


def test_cli_serve_trailing_partial_line(net, tmp_path):
    p = tmp_path / "trace.jsonl"
    p.write_text('{"kind": "degree", "u": 1}\n{"kind": "degree", "u": 2}')
    records, stats = api.serve(net, str(p))
    assert len(records) == 2 and all("error" not in r for r in records)


# -- the submit path does no device work ---------------------------------------


def test_submit_defers_filter_resolution_to_the_pump(net, monkeypatch):
    """A filter spec the memo does not hold is checked on the host at
    submit (a bad spec still fails there) and resolved by the pump; once
    the memo holds it, submit takes it from there."""
    calls = []
    cls = type(net.nodeset)
    real_select = cls.select

    def recording_select(self, *a, **kw):
        calls.append(threading.current_thread())
        return real_select(self, *a, **kw)

    monkeypatch.setattr(cls, "select", recording_select)
    engine = GraphServeEngine(net)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    rid = engine.submit({"kind": "degree", "u": 4, "filter": flt})
    assert calls == []  # nothing resolved on the submitting thread
    with pytest.raises(KeyError, match="nope"):
        engine.submit({"kind": "degree", "u": 4,
                       "filter": {"attr": "nope", "op": "eq", "value": 1}})
    with pytest.raises(ValueError, match="selection op"):
        engine.submit({"kind": "degree", "u": 4,
                       "filter": {"attr": "grp", "op": "~", "value": 1}})
    with pytest.raises(ValueError, match="value"):
        engine.submit({"kind": "degree", "u": 4,
                       "filter": {"attr": "grp", "op": "gt"}})
    engine.pump()
    assert len(calls) == 1
    got = engine.result(rid).value
    rid = engine.submit({"kind": "degree", "u": 5, "filter": dict(flt)})
    assert len(calls) == 1  # a memo hit at submit: no second resolve
    engine.pump()
    assert len(calls) == 1
    monkeypatch.undo()
    assert got == run_request(net, {"kind": "degree", "u": 4, "filter": flt})
    assert engine.result(rid).value == run_request(
        net, {"kind": "degree", "u": 5, "filter": flt})


def test_shards_above_one_name_the_sharded_item(net):
    """``shards=2`` serves through the sharded view, with records equal to
    ``shards=1``'s; None and 1 serve the network itself; 0 is refused."""
    from repro_torch.core.sharded import ShardedNetwork

    trace = _mixed_trace(net, 40, seed=4)
    sharded = GraphServeEngine(net, shards=2)
    assert isinstance(sharded._sharded, ShardedNetwork)
    assert sharded.stats["shards"] == 2
    want = _records(GraphServeEngine(net, shards=1).serve(trace))
    got = _records(sharded.serve(trace))
    assert all("error" not in r for r in got)
    assert got == want
    for shards in (None, 1):
        engine = GraphServeEngine(net, shards=shards)
        assert engine.stats["shards"] == 1
        res = engine.serve([{"kind": "degree", "u": 3}])[0]
        _assert_same(res.value, run_request(net, {"kind": "degree", "u": 3}))
    with pytest.raises(ValueError, match="shards"):
        GraphServeEngine(net, shards=0)


EMPTY_SELECTION = "Need at least one array to concatenate."


@pytest.mark.parametrize("shards", [None, 2])
def test_empty_layer_selection_raises_the_reference_text(net, shards):
    """An empty layer list in getnodealters, khop and the served alters
    and khop raises the JAX package's ValueError text, also through the
    sharded view; getdegree's sum over no layer stays 0."""
    with pytest.raises(ValueError, match=EMPTY_SELECTION):
        api.getnodealters(net, 5, layernames=[])
    with pytest.raises(ValueError, match=EMPTY_SELECTION):
        api.khop(net, [3], 1, layernames=[])
    engine = GraphServeEngine(net, shards=shards)
    alters, khop, degree = engine.serve([
        {"kind": "alters", "u": 5, "layers": []},
        {"kind": "khop", "sources": [3], "k": 1, "layers": []},
        {"kind": "degree", "u": 5, "layers": []},
    ])
    assert alters.error == khop.error == f"ValueError: {EMPTY_SELECTION}"
    assert degree.error is None and degree.value == 0


def test_round_stats_count_rounds(net):
    engine = GraphServeEngine(net)
    engine.serve(_mixed_trace(net, 10, seed=2))
    rs = engine.round_stats
    assert rs["rounds"] >= 1 and rs["round_s"] > 0.0
    assert rs["pump_wait_s"] == 0.0  # no background pump ran


# -- parity with the JAX package's engine ------------------------------------


def _parity_trace(n: int) -> list[dict]:
    """~200 requests over all five kinds, with filters and duplicates."""
    rng = np.random.default_rng(5)
    flt = {"attr": "grp", "op": "eq", "value": 1}
    base = []
    for i in range(150):
        kind = REQUEST_KINDS[i % len(REQUEST_KINDS)]
        if kind == "getedge":
            req = {"kind": kind, "layer": ("wk", "er")[i % 2],
                   "u": int(rng.integers(0, n)), "v": int(rng.integers(0, n))}
        elif kind == "alters":
            req = {"kind": kind, "u": int(rng.integers(0, n)),
                   "max_alters": 64}
        elif kind == "degree":
            req = {"kind": kind, "u": [int(x) for x in rng.integers(0, n, 3)]}
        elif kind == "khop":
            req = {"kind": kind, "sources": int(rng.integers(0, n)),
                   "k": int(rng.integers(1, 3)), "max_frontier": 64,
                   "layers": ["er"]}
        else:
            req = {"kind": kind, "starts": [int(rng.integers(0, n))],
                   "steps": 4, "walkers": 2, "seed": int(i % 3)}
        if i % 3 == 0 and kind != "walkbatch":
            req["filter"] = flt
        base.append(req)
    dupes = [dict(base[int(i)]) for i in rng.integers(0, len(base), 50)]
    return base + dupes


def _records(results) -> list:
    return [json.loads(json.dumps(r.to_record())) for r in results]


def test_engine_parity_with_jax_package():
    from repro.core import api as japi
    from repro.serve import GraphServeEngine as JaxEngine

    from _torch_parity import assert_network_identical

    n = 300
    grp = np.random.default_rng(0).integers(0, 3, n).astype(np.int64)
    nets = []
    for mod, kw in ((japi, {}), (api, {"device": "cpu"})):
        g = mod.createnetwork(mod.createnodeset(n, **kw))
        g = mod.generate(mod.addlayer(g, "er", 1), "er", type="er",
                         p=0.03, seed=1)
        g = mod.generate(mod.addlayer(g, "wk", 2), "wk", type="2mode",
                         h=30, a=4, seed=2)
        nets.append(mod.setnodeattr(g, "grp", np.arange(n), grp))
    jnet, tnet = nets
    assert_network_identical(tnet, jnet)
    trace = _parity_trace(n)
    jeng, teng = JaxEngine(jnet), GraphServeEngine(tnet)
    want, got = _records(jeng.serve(trace)), _records(teng.serve(trace))
    assert all("error" not in r for r in got)
    assert got == want
    js, ts = jeng.stats, teng.stats
    assert ts["batches"] == js["batches"]
    assert ts["cache"]["hits"] == js["cache"]["hits"]
    assert ts["coalesced_dupes"] == js["coalesced_dupes"]
    assert ts["coalesced_dupes"] + ts["cache"]["hits"] >= 1


def test_empty_layer_selection_records_equal_jax_package():
    """The records of alters and khop over an empty layer list equal the
    JAX package's engine's, error text included."""
    from repro.core import api as japi
    from repro.serve import GraphServeEngine as JaxEngine

    nets = []
    for mod, kw in ((japi, {}), (api, {"device": "cpu"})):
        g = mod.createnetwork(mod.createnodeset(60, **kw))
        nets.append(mod.generate(mod.addlayer(g, "er", 1), "er", type="er",
                                 p=0.1, seed=1))
    trace = [{"kind": "alters", "u": 5, "layers": []},
             {"kind": "khop", "sources": [3], "k": 1, "layers": []},
             {"kind": "degree", "u": [5, 6], "layers": []}]
    want = _records(JaxEngine(nets[0]).serve(trace))
    assert _records(GraphServeEngine(nets[1]).serve(trace)) == want
    assert want[0]["error"] == "ValueError: Need at least one array to concatenate."
