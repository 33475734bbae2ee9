"""Chaos suite of the PyTorch port on the CPU: the cases of the JAX
package's ``tests/test_faultinject.py`` run against ``repro_torch.serve``,
the serve stack driven through every fault-injection site
(serve/faults.py) with seeded, replay-deterministic plans.

Invariants asserted throughout:

* **no request silently lost** — every issued request ends in a correct
  result or a *typed* error; nothing hangs, nothing vanishes;
* **retries never duplicate mutations** — a retry after a lost/torn ack
  replays the committed response (idempotency keys), observable as the
  mutation's effect landing exactly once;
* **degraded responses are flagged and checkable** — bit-identical to
  honestly running the truncated reference request;
* **the server recovers to ready** after every transient fault burst.

All tests here carry the ``faultinject`` marker. The port's plans replay
the JAX package's fault schedules for the same seed and rules.
"""

import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import api
from repro_torch.serve import (
    AdmissionPolicy,
    FaultPlan,
    GraphServeClient,
    GraphServeFrontend,
    RetryPolicy,
    ServeError,
    Unavailable,
    degraded_reference,
    run_request,
)
from repro_torch.serve.graph_engine import _pythonic
from repro_torch.serve.resilience import DeadlineExceeded

pytestmark = pytest.mark.faultinject


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


def _ref(net, req):
    """Wire-comparable reference for one request."""
    return json.loads(json.dumps(_pythonic(run_request(net, req))))


_FAST_RETRY = RetryPolicy(max_attempts=6, base=0.002, cap=0.05)


def _assert_ready(fe):
    with GraphServeClient(*fe.address, retry=_FAST_RETRY) as probe:
        r = probe.readyz()
        assert r["ready"], f"server not ready after faults: {r['reasons']}"
        # and it actually serves
        assert probe.ping()


# -- one test per fault site --------------------------------------------------


def test_connection_drop_on_accept_retried_and_recovers(net):
    plan = FaultPlan({
        "accept": {"kind": "drop", "at": (0,), "times": 1},
    }, seed=1)
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        with GraphServeClient(*fe.address, retry=_FAST_RETRY, seed=1) as c:
            # first connection is reset before a byte is served; the
            # retry loop reconnects and the request completes
            assert c.query({"kind": "degree", "u": 3}) == _ref(
                net, {"kind": "degree", "u": 3})
            assert c.retries >= 1
        assert plan.stats["fired"]["accept"] == 1
        _assert_ready(fe)


def test_read_drop_mid_session_recovers(net):
    plan = FaultPlan({
        "read": {"kind": "drop", "at": (1,), "times": 1},
    }, seed=2)
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        with GraphServeClient(*fe.address, retry=_FAST_RETRY, seed=2) as c:
            for u in range(6):
                assert c.query({"kind": "degree", "u": u}) == _ref(
                    net, {"kind": "degree", "u": u})
        assert plan.stats["fired"].get("read") == 1
        _assert_ready(fe)


def test_torn_write_retry_never_duplicates_mutation(net):
    """The lost-ack case: the mutation applies, its response is torn
    mid-record, the retry must REPLAY, not re-apply."""
    plan = FaultPlan({
        # responses 1 and 3 are torn (0 is the ping), transient burst
        "write": {"kind": "torn", "at": (1, 3), "frac": 0.3, "times": 2},
    }, seed=3)
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        with GraphServeClient(*fe.address, retry=_FAST_RETRY, seed=3) as c:
            assert c.ping()
            before = _ref(net, {"kind": "degree", "u": 0, "layers": ["er"]})
            r = c.mutate("addedges",
                         {"layer": "er", "src": [0], "dst": [250]})
            assert r["ok"]
            after = c.query({"kind": "degree", "u": 0, "layers": ["er"]})
            # applied exactly once across however many wire attempts
            assert after == before + 1
        assert fe.stats["transport"].get("torn_writes", 0) >= 1
        assert fe.idempotency.stats["replays"] >= 1
        _assert_ready(fe)


def test_response_delay_slows_but_loses_nothing(net):
    plan = FaultPlan({
        "reply.delay": {"kind": "delay", "every": 3, "delay": 0.03},
    }, seed=4)
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        with GraphServeClient(*fe.address, retry=_FAST_RETRY, seed=4) as c:
            for u in range(9):
                assert c.query({"kind": "degree", "u": u}) == _ref(
                    net, {"kind": "degree", "u": u})
        assert plan.stats["fired"]["reply.delay"] == 3
        _assert_ready(fe)


def test_engine_exception_becomes_typed_error_then_recovers(net):
    plan = FaultPlan({
        "engine.exec": {"kind": "error", "at": (0,), "times": 1,
                        "message": "chaos executor fault"},
    }, seed=5)
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        retry = RetryPolicy(max_attempts=1)
        with GraphServeClient(*fe.address, retry=retry, seed=5) as c:
            # the faulted batch answers a typed engine_error — the
            # request is not silently lost and the pump survives
            with pytest.raises(ServeError) as ei:
                c.query({"kind": "degree", "u": 3})
            assert ei.value.code == "engine_error"
            assert "chaos executor fault" in str(ei.value)
            # burst over: the identical request now serves (and was NOT
            # poisoned into the result cache by the faulted round)
            assert c.query({"kind": "degree", "u": 3}) == _ref(
                net, {"kind": "degree", "u": 3})
        assert fe.engine.pump_alive
        _assert_ready(fe)


def test_slow_consumer_stalls_only_its_own_session(net):
    """A client that sits on its socket (client.consume stall) must not
    block the threaded server's other sessions."""
    stall = 0.6
    plan = FaultPlan({
        "client.consume": {"kind": "stall", "at": (0,), "delay": stall},
    }, seed=6)
    with GraphServeFrontend(net=net) as fe:
        done = threading.Event()
        slow_result = {}

        def slow():
            with GraphServeClient(*fe.address, fault_plan=plan,
                                  retry=_FAST_RETRY) as c:
                slow_result["v"] = c.query({"kind": "degree", "u": 7})
            done.set()

        t = threading.Thread(target=slow)
        t0 = time.monotonic()
        t.start()
        # while the slow session stalls, a healthy session completes a
        # full sweep well inside the stall window
        with GraphServeClient(*fe.address, retry=_FAST_RETRY) as fast:
            for u in range(20):
                assert fast.query({"kind": "degree", "u": u}) == _ref(
                    net, {"kind": "degree", "u": u})
        assert time.monotonic() - t0 < stall, \
            "fast session was blocked behind the slow consumer"
        assert not done.is_set()
        t.join(timeout=10)
        assert slow_result["v"] == _ref(net, {"kind": "degree", "u": 7})
        _assert_ready(fe)


def test_client_send_drop_safe_for_mutations(net):
    """client.send drop = the request never reached the server; the
    retry carries the same key, so even the it-did-reach-the-server
    ambiguity is safe."""
    plan = FaultPlan({
        "client.send": {"kind": "drop", "at": (0,), "times": 1},
    }, seed=7)
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address, fault_plan=plan,
                              retry=_FAST_RETRY, seed=7) as c:
            before = _ref(net, {"kind": "degree", "u": 1, "layers": ["er"]})
            r = c.mutate("addedges",
                         {"layer": "er", "src": [1], "dst": [251]})
            assert r["ok"] and c.retries >= 1
            assert c.query(
                {"kind": "degree", "u": 1, "layers": ["er"]}
            ) == before + 1
        _assert_ready(fe)


# -- mixed-fault sweeps -------------------------------------------------------


def test_no_request_lost_under_probabilistic_fault_storm(net):
    """Seeded probabilistic drops/delays/torn writes across transport
    sites; every request ends in a correct answer or a typed error."""
    plan = FaultPlan({
        "accept": {"kind": "drop", "p": 0.1},
        "read": {"kind": "drop", "p": 0.03},
        "write": [
            {"kind": "torn", "p": 0.03, "frac": 0.5},
            {"kind": "delay", "p": 0.05, "delay": 0.005},
        ],
        "reply.delay": {"kind": "delay", "p": 0.05, "delay": 0.005},
    }, seed=42)
    reqs = [{"kind": "degree", "u": u % 300} for u in range(60)]
    outcomes = []
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        with GraphServeClient(
            *fe.address, retry=RetryPolicy(max_attempts=8, base=0.002,
                                           cap=0.05), seed=42,
        ) as c:
            for req in reqs:
                try:
                    outcomes.append(("ok", c.query(dict(req))))
                except (ServeError, Unavailable, DeadlineExceeded) as e:
                    outcomes.append(("err", type(e).__name__))
        # accounting: exactly one outcome per request, and every success
        # is bit-identical to the reference — faults never corrupt an
        # answer, they only delay or (rarely) fail it loudly
        assert len(outcomes) == len(reqs)
        for (status, got), req in zip(outcomes, reqs):
            if status == "ok":
                assert got == _ref(net, req)
        ok = sum(1 for s, _ in outcomes if s == "ok")
        assert ok >= len(reqs) * 0.9  # the retry loop absorbs the storm
        assert plan.stats["total_fired"] >= 1
        _assert_ready(fe)


def test_degraded_under_overload_flagged_and_bit_identical(net):
    """Overload + faults together: every khop served degraded is
    flagged and exactly equals the truncated reference."""
    policy = AdmissionPolicy(heavy_shed_depth=0, degrade_max_frontier=8)
    plan = FaultPlan({
        "reply.delay": {"kind": "delay", "p": 0.2, "delay": 0.005},
    }, seed=9)
    with GraphServeFrontend(net=net, policy=policy, fault_plan=plan) as fe:
        with GraphServeClient(*fe.address, retry=_FAST_RETRY, seed=9) as c:
            for src in range(6):
                req = {"kind": "khop", "sources": src, "k": 2,
                       "max_frontier": 4096}
                resp = c.query(dict(req), full=True)
                assert resp["degraded"] is True
                assert resp["result"] == _ref(
                    net, degraded_reference(req, policy))
        assert fe.admission.stats["degraded"] == 6


def test_fault_plan_replays_identically(net):
    """Same seed + rules -> the identical fault schedule (the property
    that makes every test in this file deterministic)."""
    rules = {
        "write": {"kind": "torn", "p": 0.2, "frac": 0.4},
        "reply.delay": {"kind": "delay", "p": 0.3, "delay": 0.0},
    }

    def drive(plan):
        with GraphServeFrontend(net=net, fault_plan=plan) as fe:
            with GraphServeClient(*fe.address, retry=_FAST_RETRY,
                                  seed=0) as c:
                for u in range(15):
                    try:
                        c.query({"kind": "degree", "u": u})
                    except (ServeError, Unavailable, DeadlineExceeded):
                        pass
        return [(e.site, e.call, e.kind) for e in plan.log]

    a = drive(FaultPlan(rules, seed=123))
    b = drive(FaultPlan(rules, seed=123))
    assert a == b and len(a) >= 1


# -- concurrent mutation + threaded clients (coverage satellite) --------------


def test_concurrent_mutation_threaded_clients_cache_consistent(net):
    """Threaded read clients + a wire mutator under fault injection:
    cache stats stay consistent and no invalidated entry is served
    after its generation bump (reads-after-mutation see fresh state)."""
    plan = FaultPlan({
        "reply.delay": {"kind": "delay", "p": 0.05, "delay": 0.002},
        "write": {"kind": "torn", "p": 0.02, "frac": 0.5},
    }, seed=31)
    stop = threading.Event()
    errors: list = []
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        def reader(seed):
            try:
                with GraphServeClient(*fe.address, retry=_FAST_RETRY,
                                      seed=seed) as c:
                    rng = np.random.default_rng(seed)
                    while not stop.is_set():
                        u = int(rng.integers(0, 300))
                        try:
                            c.query({"kind": "degree", "u": u,
                                     "layers": ["er"]})
                        except (ServeError, Unavailable,
                                DeadlineExceeded):
                            pass  # typed failure, not a lost request
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        try:
            with GraphServeClient(*fe.address, retry=_FAST_RETRY,
                                  seed=99) as mutator:
                for step in range(8):
                    dst = 200 + step
                    r = mutator.mutate(
                        "addedges",
                        {"layer": "er", "src": [0], "dst": [dst]},
                    )
                    assert r["ok"]
                    # generation bumped: the very next read of the
                    # mutated key must match the engine's CURRENT
                    # network, never an invalidated cache entry
                    got = mutator.query(
                        {"kind": "degree", "u": 0, "layers": ["er"]})
                    assert got == _ref(
                        fe.engine.net,
                        {"kind": "degree", "u": 0, "layers": ["er"]})
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not errors
        cache = fe.engine.stats["cache"]
        # conservation: every entry now resident, evicted, or
        # invalidated was once a miss that populated the cache
        assert (cache["entries"] + cache["evictions"]
                + cache["entries_invalidated"]) <= cache["misses"]
        assert cache["hits"] + cache["misses"] >= 8
        assert cache["entries_invalidated"] >= 1  # mutations did bite
        _assert_ready(fe)


def test_fault_plans_replay_the_jax_package_schedule():
    """Same seed and rules -> the same fired events as the JAX package's
    plan, call for call, at every trigger kind."""
    from repro.serve import FaultPlan as JaxPlan

    rules = {
        "write": [{"kind": "torn", "p": 0.2, "frac": 0.4},
                  {"kind": "delay", "every": 7, "delay": 0.0}],
        "accept": {"kind": "drop", "at": (1, 4), "times": 1},
        "reply.delay": {"kind": "delay", "p": 0.3, "delay": 0.0},
    }
    logs = []
    for cls in (FaultPlan, JaxPlan):
        plan = cls(rules, seed=123)
        for _ in range(200):
            for site in ("write", "accept", "reply.delay", "read"):
                plan.decide(site)
        logs.append([(e.site, e.call, e.kind) for e in plan.log])
        logs.append(plan.stats)
    assert logs[0] == logs[2] and logs[1] == logs[3]
    assert len(logs[0]) > 10
