"""Network serve frontend of the PyTorch port on the CPU: the cases of
the JAX package's ``tests/test_serve_frontend.py`` (NDJSON/TCP
round-trips bit-identical to the in-process engine, multi-session
routing, idempotent retries, deadline propagation over the wire, the
admission shed-vs-degrade matrix, health endpoints over NDJSON and plain
HTTP, and the api/CLI surface) run against ``repro_torch.serve``; the
JAX package's client talking to the port's frontend; and the pump thread
as the one thread that runs queries while six sessions submit."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from repro_torch.core import api
from repro_torch.core.cli import Session
from repro_torch.serve import (
    AdmissionPolicy,
    EngineClosed,
    GraphServeClient,
    GraphServeEngine,
    GraphServeFrontend,
    RetryPolicy,
    ServeError,
    assert_results_equal as _assert_same,
    degraded_reference,
    run_request,
)
from repro_torch.serve.resilience import DeadlineExceeded


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


def _requests(net):
    flt = {"attr": "grp", "op": "eq", "value": 1}
    return [
        {"kind": "getedge", "layer": "er", "u": 3, "v": 7},
        {"kind": "alters", "u": 5, "max_alters": 64},
        {"kind": "degree", "u": [1, 2, 3], "node_filter": flt},
        {"kind": "khop", "sources": 9, "k": 2, "max_frontier": 64},
        {"kind": "walkbatch", "starts": [4, 5], "steps": 5, "walkers": 2,
         "seed": 11},
    ]


def _http_get(addr, path: str) -> tuple[int, dict]:
    s = socket.create_connection(addr, timeout=5)
    try:
        s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        buf = b""
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
    finally:
        s.close()
    head, body = buf.split(b"\r\n\r\n", 1)
    status = int(head.split()[1])
    return status, json.loads(body)


# -- transport round-trips ----------------------------------------------------


def test_wire_results_bit_identical_to_engine(net):
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address) as c:
            from repro_torch.serve.graph_engine import _pythonic

            for req in _requests(net):
                got = c.query(dict(req))
                # reference: the in-process execution path, JSON-round-
                # tripped the same way the wire does
                ref = json.loads(json.dumps(_pythonic(
                    run_request(net, req)
                )))
                assert got == ref


def test_multiple_sessions_share_one_engine(net):
    with GraphServeFrontend(net=net) as fe:
        results: dict[int, list] = {}
        errors = []

        def worker(i):
            try:
                with GraphServeClient(*fe.address, seed=i) as c:
                    results[i] = [
                        c.query({"kind": "degree", "u": u})
                        for u in range(10)
                    ]
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        ref = [run_request(net, {"kind": "degree", "u": u})
               for u in range(10)]
        for vals in results.values():
            assert vals == [int(r) for r in ref]
        st = fe.stats
        assert st["sessions"]["opened"] >= 6
        # a session leaves the table when its server thread reads the
        # client's EOF, which may come after the client's close returns
        deadline = time.monotonic() + 5.0
        while st["sessions"]["active"] and time.monotonic() < deadline:
            time.sleep(0.01)
            st = fe.stats
        assert st["sessions"]["active"] == 0  # all disconnected


def test_wire_mutations_serve_updated_state(net):
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address) as c:
            before = c.query({"kind": "degree", "u": 0,
                              "layers": ["er"]})
            resp = c.mutate("addedges",
                            {"layer": "er", "src": [0], "dst": [250]})
            assert resp["ok"] and resp["applied"] == "addedges"
            after = c.query({"kind": "degree", "u": 0, "layers": ["er"]})
            assert after == before + 1


def test_bad_requests_not_retried(net):
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address) as c:
            with pytest.raises(ServeError, match="unknown request kind"):
                c.query({"kind": "nope"})
            assert c.attempts == 1  # bad_request must not burn retries
            with pytest.raises(ServeError, match="unknown op"):
                c._call(c._envelope("frobnicate"))
            with pytest.raises(ServeError, match="bad_request"):
                c.mutate("dropdatabase", {})
        # a raw garbage line answers bad_request instead of hanging
        s = socket.create_connection(fe.address, timeout=5)
        try:
            s.sendall(b"not json at all\n")
            line = s.makefile("rb").readline()
        finally:
            s.close()
        resp = json.loads(line)
        assert resp["ok"] is False and resp["code"] == "bad_request"


def test_bad_envelope_error_echoes_request_id(net):
    """Malformed envelopes still answer with a parseable request id, so
    pipelined clients can match the error to the in-flight call instead
    of desynchronizing the whole connection."""
    cases = [
        # trailing garbage after valid JSON -> parse error, int id salvaged
        (b'{"id": 42, "op": "query"} trailing junk\n', 42),
        # string id, JSON-escaped content survives the salvage
        (b'{"id": "req-\\"7\\"", oops}\n', 'req-"7"'),
        # no id anywhere -> id is null, still a bad_request reply
        (b"not json at all\n", None),
    ]
    with GraphServeFrontend(net=net) as fe:
        for raw, want_id in cases:
            s = socket.create_connection(fe.address, timeout=5)
            try:
                s.sendall(raw)
                line = s.makefile("rb").readline()
            finally:
                s.close()
            resp = json.loads(line)
            assert resp["ok"] is False and resp["code"] == "bad_request"
            assert resp["id"] == want_id, raw


# -- idempotency --------------------------------------------------------------


def test_mutation_retry_replays_not_reapplies(net):
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address) as c:
            key = c.fresh_key("m")
            args = {"layer": "er", "src": [1], "dst": [251]}
            r1 = c.mutate("addedges", args, key=key)
            r2 = c.mutate("addedges", args, key=key)  # the "lost ack" retry
            assert not r1.get("idempotent_replay")
            assert r2["idempotent_replay"] is True
            # applied exactly once: degree grew by one, not two
            d = c.query({"kind": "degree", "u": 1, "layers": ["er"]})
            ref = run_request(net, {"kind": "degree", "u": 1,
                                    "layers": ["er"]})
            assert d == int(ref) + 1
        assert fe.idempotency.stats["replays"] == 1


def test_failed_mutation_not_committed(net):
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address) as c:
            key = c.fresh_key("m")
            with pytest.raises(ServeError, match="engine_error"):
                c.mutate("addedges",
                         {"layer": "absent", "src": [0], "dst": [1]},
                         key=key)
            # the key was aborted, not committed: a corrected retry with
            # the SAME key runs (it is not a replay of the failure)
            r = c.mutate("addedges",
                         {"layer": "er", "src": [0], "dst": [252]},
                         key=key)
            assert r["ok"] and not r.get("idempotent_replay")


# -- admission: the shed-vs-degrade matrix ------------------------------------


def test_overload_degrades_khop_flagged_and_bit_identical(net):
    policy = AdmissionPolicy(heavy_shed_depth=0, degrade_max_frontier=8)
    with GraphServeFrontend(net=net, policy=policy) as fe:
        with GraphServeClient(*fe.address) as c:
            req = {"kind": "khop", "sources": 9, "k": 2,
                   "max_frontier": 4096}
            resp = c.query(dict(req), full=True)
            assert resp["degraded"] is True
            assert "max_frontier" in resp["degrade_reason"]
            # checkable degradation: bit-identical to honestly running
            # the truncated request
            ref = run_request(net, degraded_reference(req, policy))
            from repro_torch.serve.graph_engine import _pythonic
            assert resp["result"] == json.loads(
                json.dumps(_pythonic(ref))
            )
            # a khop already within the degraded budget is NOT rewritten
            small = c.query({"kind": "khop", "sources": 9, "k": 1,
                             "max_frontier": 4}, full=True)
            assert small["degraded"] is False
        assert fe.admission.stats["degraded"] >= 1


def test_overload_sheds_walkbatch_with_retry_after(net):
    policy = AdmissionPolicy(heavy_shed_depth=0, retry_after=0.01)
    with GraphServeFrontend(net=net, policy=policy) as fe:
        retry = RetryPolicy(max_attempts=3, base=0.001, cap=0.01)
        with GraphServeClient(*fe.address, retry=retry, seed=5) as c:
            from repro_torch.serve import Unavailable

            with pytest.raises(Unavailable, match="shed"):
                c.query({"kind": "walkbatch", "starts": [1], "steps": 3,
                         "walkers": 1, "seed": 0})
            assert c.retries == 2  # backed off between shed verdicts
            # point queries keep serving through the same overload
            assert c.query({"kind": "degree", "u": 3}) == run_request(
                net, {"kind": "degree", "u": 3}
            )
        assert fe.admission.stats["shed"] >= 3


# -- deadlines over the wire --------------------------------------------------


def test_wire_deadline_propagates_to_engine(net):
    from repro_torch.serve import FaultPlan

    # every batch stalls 80ms: a 20ms budget must come back as a
    # deadline error (here raised client-side as DeadlineExceeded)
    plan = FaultPlan({
        "pump.batch_delay": {"kind": "delay", "every": 1, "delay": 0.08},
    })
    with GraphServeFrontend(net=net, fault_plan=plan) as fe:
        retry = RetryPolicy(max_attempts=2, base=0.001, cap=0.01)
        with GraphServeClient(*fe.address, retry=retry) as c:
            with pytest.raises(DeadlineExceeded):
                c.query({"kind": "degree", "u": 3}, deadline_ms=20)
            # the stalled pump round finishes AFTER the client gave up;
            # poll until the engine has scattered the expiry
            import time

            for _ in range(100):
                if c.stats()["engine"]["deadline_expired"] >= 1:
                    break
                time.sleep(0.02)
            assert c.stats()["engine"]["deadline_expired"] >= 1


def test_default_deadline_applies_when_client_sends_none(net):
    from repro_torch.serve import FaultPlan

    plan = FaultPlan({
        "pump.batch_delay": {"kind": "delay", "every": 1, "delay": 0.08},
    })
    with GraphServeFrontend(net=net, fault_plan=plan,
                            default_deadline_ms=20) as fe:
        with GraphServeClient(
            *fe.address, retry=RetryPolicy(max_attempts=1)
        ) as c:
            with pytest.raises((ServeError, DeadlineExceeded)) as ei:
                c.query({"kind": "degree", "u": 4})
            if isinstance(ei.value, ServeError):
                assert ei.value.code == "deadline"


# -- health endpoints ---------------------------------------------------------


def test_health_and_readiness_over_ndjson_and_http(net):
    with GraphServeFrontend(net=net) as fe:
        with GraphServeClient(*fe.address) as c:
            assert c.ping()
            h = c.healthz()
            assert h["ok"] and not h["closed"]
            r = c.readyz()
            assert r["ready"] and r["reasons"] == []
        status, doc = _http_get(fe.address, "/healthz")
        assert status == 200 and doc["ok"]
        status, doc = _http_get(fe.address, "/readyz")
        assert status == 200 and doc["ready"]
        status, doc = _http_get(fe.address, "/stats")
        assert status == 200 and doc["engine"]["served"] >= 0
        status, doc = _http_get(fe.address, "/nope")
        assert status == 404


def test_closed_engine_fails_readiness_and_rejects(net):
    engine = GraphServeEngine(net)
    with GraphServeFrontend(engine) as fe:
        engine.close()
        status, doc = _http_get(fe.address, "/readyz")
        assert status == 503
        assert any("closed" in r for r in doc["reasons"])
        with GraphServeClient(*fe.address) as c:
            assert c.readyz()["ready"] is False
            with pytest.raises(ServeError) as ei:
                c.query({"kind": "degree", "u": 3})
            assert ei.value.code == "closed"
    # frontend did not own the engine: closing it twice is fine
    with pytest.raises(EngineClosed):
        engine.submit({"kind": "degree", "u": 0})


def test_client_readyz_unreachable_is_not_ready():
    c = GraphServeClient("127.0.0.1", 1)  # nothing listens on port 1
    r = c.readyz()
    assert r["ready"] is False and r["reasons"]


# -- CLI / api surface --------------------------------------------------------


def test_api_servenet_pingnet_roundtrip(net):
    fe = api.servenet(net, port=0)
    try:
        host, port = fe.address
        probe = api.pingnet(host, port)
        assert probe["ok"] and probe["ready"]
        assert probe["latency_ms"] is not None
    finally:
        fe.close()
    down = api.pingnet("127.0.0.1", 1)
    assert down["ok"] is False and down["reasons"]


def test_cli_servenet_pingnet_stopserve(net, capsys):
    s = Session(mode="json", device="cpu")
    s.env["net"] = net
    out = s.run_line("srv = servenet(net, port = 0)")
    started = json.loads(out)["result"]
    assert started["serving"] is True
    port = started["port"]
    out = s.run_line(f'pingnet(host = "127.0.0.1", port = {port})')
    assert json.loads(out)["result"]["ok"] is True
    out = s.run_line("stopserve(srv)")
    stopped = json.loads(out)["result"]
    assert stopped["stopped"] is True and stopped["requests"] >= 2
    assert s.env["srv"].engine.closed


# -- parity with the JAX package over the wire --------------------------------


def test_jax_client_gets_the_jax_values_from_the_port_frontend(net):
    """The JAX package's client against the port's frontend: every value
    equals the JAX package's in-process result for the same request and
    what the port's own client receives. The JAX references are computed
    before any socket opens, so no JAX compile runs while a client waits
    on its socket."""
    from repro.core import api as japi
    from repro.serve import GraphServeClient as JaxClient
    from repro.serve import run_request as jax_run_request
    from repro.serve.graph_engine import _pythonic as jax_pythonic

    n = net.n_nodes
    jnet = japi.createnetwork(japi.createnodeset(n))
    jnet = japi.generate(japi.addlayer(jnet, "er", 1), "er",
                         type="er", p=0.03, seed=1)
    jnet = japi.generate(japi.addlayer(jnet, "wk", 2), "wk",
                         type="2mode", h=30, a=4, seed=2)
    grp = np.random.default_rng(0).integers(0, 3, n).astype(np.int64)
    jnet = japi.setnodeattr(jnet, "grp", np.arange(n), grp)
    reqs = _requests(net) + [
        {"kind": "getedge", "layer": "wk", "u": 3, "v": 7,
         "filter": {"attr": "grp", "op": "eq", "value": 2}},
        {"kind": "alters", "u": 11, "layers": ["wk"], "max_alters": 64},
        {"kind": "khop", "sources": [2, 3], "k": 1, "layers": ["er"]},
    ]
    want = [json.loads(json.dumps(jax_pythonic(jax_run_request(jnet, r))))
            for r in reqs]
    with GraphServeFrontend(net=net) as fe:
        with JaxClient(*fe.address) as jc, GraphServeClient(*fe.address) as tc:
            for req, ref in zip(reqs, want):
                assert jc.query(dict(req)) == ref
                assert tc.query(dict(req)) == ref


# -- one thread owns the card --------------------------------------------------


def test_pump_thread_runs_every_query(net, monkeypatch):
    """Six sessions submit over the wire while the background pump runs:
    every executor call and every filter resolution happens on the pump
    thread, none on a session thread."""
    from repro_torch.serve import graph_engine as ge

    seen = []
    for kind, real in list(ge._EXECUTORS.items()):
        def wrapped(n, gk, creqs, _real=real):
            seen.append(("exec", threading.current_thread()))
            return _real(n, gk, creqs)

        monkeypatch.setitem(ge._EXECUTORS, kind, wrapped)
    cls = type(net.nodeset)
    real_select = cls.select

    def recording_select(self, *a, **kw):
        seen.append(("select", threading.current_thread()))
        return real_select(self, *a, **kw)

    monkeypatch.setattr(cls, "select", recording_select)
    errors = []
    with GraphServeFrontend(net=net) as fe:
        pump = fe.engine.pump_thread

        def worker(i):
            try:
                with GraphServeClient(*fe.address, seed=i) as c:
                    for req in _requests(net):
                        c.query(dict(req, **({"u": i} if "u" in req else {})))
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors
    assert pump is not None and any(k == "select" for k, _ in seen)
    assert sum(k == "exec" for k, _ in seen) >= 5
    assert {t for _, t in seen} == {pump}


def test_pump_thread_applies_wire_mutations(net, monkeypatch):
    """Mutations sent over the wire while six sessions query are applied
    by the pump thread, never by a session thread, and read back."""
    seen = []
    for name in ("addedges", "setnodeattr"):
        real = getattr(api, name)

        def recording(*a, _real=real, **kw):
            seen.append(threading.current_thread())
            return _real(*a, **kw)

        monkeypatch.setattr(api, name, recording)
    errors = []
    with GraphServeFrontend(net=net) as fe:
        pump = fe.engine.pump_thread

        def worker(i):
            try:
                with GraphServeClient(*fe.address, seed=i) as c:
                    for j, req in enumerate(_requests(net)):
                        c.query(dict(req, **({"u": i} if "u" in req else {})))
                        if j == 1:
                            assert c.mutate("addedges", {
                                "layer": "er", "src": [i], "dst": [290 - i],
                            })["ok"]
                            assert c.mutate("setattr", {
                                "name": "probe", "nodes": [i],
                                "values": [i + 1],
                            })["ok"]
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        served = fe.engine.net
    assert not errors
    assert len(seen) == 12 and set(seen) == {pump}
    for i in range(6):
        assert api.checkedge(served, "er", i, 290 - i)
    probe, has = api.getnodeattr(served, "probe", list(range(6)))
    assert has.all() and probe.tolist() == [1, 2, 3, 4, 5, 6]
