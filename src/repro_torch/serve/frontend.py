"""Network-facing serve frontend: newline-delimited JSON over TCP.

The paper positions Threadle as a query *engine* for population-scale
registers; this is the piece that puts a wire in front of
``GraphServeEngine`` (stdlib only — ``socketserver`` threads, one
handler thread per connection, the engine's background pump owning all
device work: a session thread parses, submits or hands a mutation to the
pump, and waits; it never touches the card). One frontend serves many
concurrent client sessions, multiplexing every session onto the engine's
bounded point/heavy queues.

Wire protocol — one JSON object per line, in both directions:

    {"op": "query",  "id": 7, "key": "k-abc", "deadline_ms": 250,
     "request": {"kind": "degree", "u": 12}}
    {"op": "mutate", "id": 8, "key": "m-xyz", "action": "addedges",
     "args": {"layer": "er", "src": [1], "dst": [2]}}
    {"op": "healthz" | "readyz" | "stats" | "ping"}

    -> {"id": 7, "ok": true, "result": 3, "cached": false,
        "degraded": false}
    -> {"id": 8, "ok": false, "error": "...", "code": "shed",
        "retry_after": 0.05}

Error ``code``s: ``bad_request`` (malformed envelope/request — never
retry), ``shed`` (admission control rejected under overload — retry
after ``retry_after``), ``in_flight`` (a retry raced its own first
attempt — retry after ``retry_after``), ``deadline`` (the request's
budget lapsed anywhere along wire -> queue -> dispatch -> reply),
``closed`` (server shutting down), ``engine_error`` (the engine answered
with a per-request error).

Resilience contract (see ``serve/resilience.py`` for the policy pieces):

* every request may carry an idempotency ``key``; responses to keyed
  requests are cached server-side and a retry of an already-committed
  request REPLAYS the stored response — mutations run exactly once no
  matter how many times the client resends (``idempotent_replay: true``
  marks a replayed response);
* ``deadline_ms`` propagates end-to-end: it becomes the engine's
  per-request ``timeout`` (queue expiry + post-batch expiry) and is
  re-checked before the response is written;
* under heavy-queue overload the admission controller degrades ``khop``
  (clamped ``max_frontier``, ``degraded: true``) and sheds ``walkbatch``
  with ``Retry-After`` semantics, while point queries keep serving;
* ``healthz`` / ``readyz`` report liveness and traffic-fitness; the same
  documents are served over plain HTTP — a connection whose first bytes
  are ``GET /healthz`` (or ``/readyz``, ``/stats``) gets a one-shot
  ``HTTP/1.0`` JSON response (200, or 503 when not ok/ready), so
  orchestrator probes need no protocol shim.

Fault injection: construct with ``fault_plan=`` (serve/faults.py) and
the handler consults sites ``accept`` / ``read`` / ``write`` /
``reply.delay``; the plan is shared with the engine (``engine.exec``,
``pump.batch_delay``) when the frontend builds the engine itself.
"""

from __future__ import annotations

import json
import re
import socket
import socketserver
import threading
import time

from repro_torch.core.request import QueryRequest

from .faults import ConnectionDropped
from .graph_engine import EngineClosed, GraphServeEngine, QueueFull
from .resilience import (
    AdmissionController,
    AdmissionPolicy,
    IdempotencyCache,
    deadline_from_ms,
    health,
    readiness,
)

__all__ = ["GraphServeFrontend", "MUTATION_ACTIONS"]

#: wire-exposed mutation actions -> engine method names
MUTATION_ACTIONS = {
    "addedges": "add_edges",
    "deleteedges": "delete_edges",
    "setattr": "set_attr",
    "deletelayer": "delete_layer",
}

_HTTP_PATHS = ("/healthz", "/readyz", "/stats")


def _response(rid, **kw) -> dict:
    out = {"id": rid}
    out.update(kw)
    return out


def _err(rid, code: str, error: str, retry_after: float | None = None) -> dict:
    out = {"id": rid, "ok": False, "code": code, "error": error}
    if retry_after is not None:
        out["retry_after"] = retry_after
    return out


_ID_INT = re.compile(r'"id"\s*:\s*(-?\d+)')
_ID_STR = re.compile(r'"id"\s*:\s*"((?:[^"\\]|\\.)*)"')


def _salvage_id(text: str):
    """Best-effort request id from an UNPARSEABLE envelope line.

    A client that sent malformed JSON still usually produced a readable
    ``"id": ...`` pair; echoing it lets the client correlate the
    ``bad_request`` reply with its in-flight retry state instead of
    treating the reply as an unsolicited error. Returns None when no id
    is recognizable (nothing to correlate).
    """
    m = _ID_INT.search(text)
    if m:
        try:
            return int(m.group(1))
        except ValueError:  # pragma: no cover - \d+ always parses
            return None
    m = _ID_STR.search(text)
    if m:
        try:
            return json.loads('"' + m.group(1) + '"')
        except ValueError:
            return m.group(1)
    return None


class _Handler(socketserver.StreamRequestHandler):
    """One thread per connection; one JSON request per line."""

    def setup(self):
        self.request.settimeout(self.server.frontend._io_timeout)
        # request/response over one socket: Nagle + delayed ACK would
        # add ~40ms to every small exchange
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        super().setup()

    def handle(self):
        fe: GraphServeFrontend = self.server.frontend
        plan = fe._plan
        sid = fe._open_session(self.client_address)
        try:
            if plan:
                plan.fire("accept")  # ConnectionDropped -> reset on connect
            first = self.rfile.readline(fe._max_line)
            if not first:
                return
            if first.startswith(b"GET "):
                self._handle_http(fe, first)
                return
            line = first
            while line:
                self._handle_line(fe, sid, line)
                if plan:
                    plan.fire("read")
                line = self.rfile.readline(fe._max_line)
        except (ConnectionDropped, BrokenPipeError, ConnectionResetError):
            fe._count("dropped_connections")
        except socket.timeout:
            fe._count("io_timeouts")
        finally:
            fe._close_session(sid)

    # -- HTTP probe surface --------------------------------------------------

    def _handle_http(self, fe: "GraphServeFrontend", first: bytes) -> None:
        fe._count("http_requests")
        try:
            path = first.decode("latin-1").split()[1].split("?")[0]
        except IndexError:
            path = ""
        if path == "/healthz":
            doc = health(fe.engine, fe._store)
            status = 200 if doc["ok"] else 503
        elif path == "/readyz":
            doc = readiness(fe.engine, fe.policy, fe._store)
            status = 200 if doc["ready"] else 503
        elif path == "/stats":
            doc, status = fe.stats, 200
        else:
            doc, status = {"error": f"unknown path {path!r}",
                           "paths": list(_HTTP_PATHS)}, 404
        body = (json.dumps(doc) + "\n").encode()
        reason = {200: "OK", 404: "Not Found",
                  503: "Service Unavailable"}[status]
        head = (
            f"HTTP/1.0 {status} {reason}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode()
        self.connection.sendall(head + body)

    # -- NDJSON sessions -----------------------------------------------------

    def _handle_line(self, fe: "GraphServeFrontend", sid: int,
                     line: bytes) -> None:
        text = line.decode("utf-8", errors="replace").strip()
        if not text:
            return
        try:
            env = json.loads(text)
            if not isinstance(env, dict):
                raise ValueError("envelope must be a JSON object")
        except ValueError as e:
            # echo the request id when one is recognizable in the broken
            # line, so clients can correlate the error to their retry
            self._reply(fe, _err(_salvage_id(text), "bad_request",
                                 f"bad envelope: {e}"))
            return
        resp = fe._dispatch(sid, env)
        if resp is not None:
            self._reply(fe, resp)

    def _reply(self, fe: "GraphServeFrontend", resp: dict) -> None:
        plan = fe._plan
        if plan:
            plan.fire("reply.delay")  # injected response latency
        data = (json.dumps(resp) + "\n").encode()
        if plan:
            spec = plan.decide("write")
            if spec is not None:
                if spec.kind == "torn":
                    # the torn-write fault: a prefix of the response hits
                    # the wire, then the connection dies mid-record
                    self.connection.sendall(
                        data[: max(1, int(len(data) * spec.frac))]
                    )
                    fe._count("torn_writes")
                    raise ConnectionDropped("write: torn response")
                if spec.kind == "drop":
                    raise ConnectionDropped("write: connection dropped")
                if spec.kind in ("delay", "stall"):
                    time.sleep(spec.delay)
        self.connection.sendall(data)
        fe._count("responses")


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    frontend: "GraphServeFrontend"


class GraphServeFrontend:
    """TCP frontend over one resident engine; multi-session, resilient.

    >>> with GraphServeFrontend(net=net) as fe:
    ...     host, port = fe.address
    ...     # connect GraphServeClient(host, port) from anywhere

    Pass ``engine=`` to front an existing engine (it is NOT closed on
    frontend close), or ``net=`` / ``store=`` to build and own one.
    """

    def __init__(
        self,
        engine: GraphServeEngine | None = None,
        *,
        net=None,
        store=None,
        host: str = "127.0.0.1",
        port: int = 0,
        policy: AdmissionPolicy | None = None,
        fault_plan=None,
        idempotency_capacity: int = 4096,
        default_deadline_ms: float | None = None,
        io_timeout: float = 30.0,
        result_timeout: float = 30.0,
        max_line_bytes: int = 1 << 20,
        **engine_kw,
    ):
        if engine is None:
            engine = GraphServeEngine(
                net, store=store, fault_plan=fault_plan, **engine_kw
            )
            self._own_engine = True
        else:
            if net is not None or store is not None or engine_kw:
                raise ValueError(
                    "pass either engine= or net=/store=+engine kwargs"
                )
            self._own_engine = False
        self.engine = engine
        self._store = store if store is not None else engine._store
        self.policy = policy or AdmissionPolicy()
        self.admission = AdmissionController(engine, self.policy)
        self.idempotency = IdempotencyCache(idempotency_capacity)
        self._plan = fault_plan
        self._default_deadline_ms = default_deadline_ms
        self._io_timeout = float(io_timeout)
        self._result_timeout = float(result_timeout)
        self._max_line = int(max_line_bytes)
        self._mutate_lock = threading.Lock()
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._sessions: dict[int, dict] = {}
        self._next_sid = 0
        self._sessions_opened = 0
        self._server = _Server((host, int(port)), _Handler,
                               bind_and_activate=True)
        self._server.frontend = self
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "GraphServeFrontend":
        if self._thread is not None:
            return self
        self.engine.start()  # background pump owns all device dispatch
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="graph-serve-frontend", daemon=True,
        )
        self._thread.start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def close(self) -> None:
        """Stop accepting, close the listener, and close the engine if
        this frontend built it (drain + join pump; EngineClosed for
        late submitters). Idempotent."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()
        if self._own_engine:
            self.engine.close()

    def __enter__(self) -> "GraphServeFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- bookkeeping ---------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def _open_session(self, peer) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._sessions_opened += 1
            self._sessions[sid] = {
                "peer": str(peer), "queries": 0, "mutations": 0,
                "errors": 0,
            }
        return sid

    def _close_session(self, sid: int) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    def _session_count(self, sid: int, key: str) -> None:
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                s[key] += 1

    # -- request dispatch ----------------------------------------------------

    def _dispatch(self, sid: int, env: dict) -> dict | None:
        self._count("requests")
        op = str(env.get("op", ""))
        rid = env.get("id")
        if op == "query":
            return self._do_query(sid, rid, env)
        if op == "mutate":
            return self._do_mutate(sid, rid, env)
        if op == "healthz":
            return _response(rid, ok=True, health=health(
                self.engine, self._store))
        if op == "readyz":
            doc = readiness(self.engine, self.policy, self._store)
            return _response(rid, ok=doc["ready"], ready=doc["ready"],
                             readiness=doc)
        if op == "stats":
            return _response(rid, ok=True, stats=self.stats)
        if op == "ping":
            return _response(rid, ok=True, pong=True)
        self._session_count(sid, "errors")
        return _err(rid, "bad_request", f"unknown op {op!r}")

    def _begin_keyed(self, key):
        """Claim an idempotency key -> (fresh, replay_response|None)."""
        if key is None:
            return True, None
        return self.idempotency.begin(str(key))

    def _do_query(self, sid: int, rid, env: dict) -> dict:
        self._session_count(sid, "queries")
        request = env.get("request")
        if not isinstance(request, dict):
            self._session_count(sid, "errors")
            return _err(rid, "bad_request", "query needs a request object")
        key = env.get("key")
        fresh, replay = self._begin_keyed(key)
        if not fresh:
            if replay is None:
                return _err(rid, "in_flight",
                            "first attempt still running",
                            retry_after=self.policy.retry_after)
            out = dict(replay)
            out["id"] = rid
            out["idempotent_replay"] = True
            return out
        try:
            resp = self._run_query(rid, request, env)
        except BaseException:
            if key is not None:
                self.idempotency.abort(str(key))
            raise
        if key is not None:
            # commit only settled outcomes: a retry of a shed/expired/
            # faulted query should RE-RUN, not replay the transient error
            if resp.get("ok"):
                self.idempotency.commit(str(key), resp)
            else:
                self.idempotency.abort(str(key))
        return resp

    def _run_query(self, rid, request: dict, env: dict) -> dict:
        try:
            deadline = deadline_from_ms(
                env.get("deadline_ms", self._default_deadline_ms)
            )
        except ValueError as e:
            return _err(rid, "bad_request", str(e))
        adm = self.admission.admit(request)
        if adm.action == "shed":
            self._count("shed")
            return _err(rid, "shed", adm.reason or "overload",
                        retry_after=adm.retry_after)
        request = adm.request
        if deadline is not None:
            # deadline -> the engine's queue-expiry + post-batch checks
            request = dict(request)
            request["timeout"] = max(deadline - time.monotonic(), 1e-4)
        try:
            # the wire envelope's request object becomes the same typed
            # QueryRequest the api/CLI/engine construct — one currency,
            # validated once, across all four surfaces
            qid = self.engine.submit(QueryRequest.from_dict(request))
        except QueueFull:
            self.admission.record_shed()
            self._count("shed")
            return _err(rid, "shed", "queue full",
                        retry_after=self.policy.retry_after)
        except EngineClosed:
            return _err(rid, "closed", "server shutting down")
        except (ValueError, KeyError, TypeError) as e:
            return _err(rid, "bad_request", f"{type(e).__name__}: {e}")
        wait = self._result_timeout
        if deadline is not None:
            wait = max(min(wait, deadline - time.monotonic()), 1e-4)
        res = self.engine.result(qid, timeout=wait)
        if res is None:
            return _err(rid, "deadline",
                        "DeadlineExceeded: no result within budget")
        if res.error is not None:
            code = ("deadline" if res.error.startswith("DeadlineExceeded")
                    else "engine_error")
            return _err(rid, code, res.error)
        if deadline is not None and time.monotonic() >= deadline:
            self._count("late_responses")
            return _err(rid, "deadline",
                        "DeadlineExceeded: budget lapsed before reply")
        rec = res.to_record()
        return _response(
            rid, ok=True, result=rec.get("result"), cached=res.cached,
            degraded=adm.action == "degrade",
            **({"degrade_reason": adm.reason}
               if adm.action == "degrade" else {}),
        )

    def _do_mutate(self, sid: int, rid, env: dict) -> dict:
        self._session_count(sid, "mutations")
        action = str(env.get("action", ""))
        method = MUTATION_ACTIONS.get(action)
        args = env.get("args")
        if method is None or not isinstance(args, dict):
            self._session_count(sid, "errors")
            return _err(
                rid, "bad_request",
                f"mutate needs action in {sorted(MUTATION_ACTIONS)} "
                "and an args object",
            )
        key = env.get("key")
        fresh, replay = self._begin_keyed(key)
        if not fresh:
            if replay is None:
                return _err(rid, "in_flight",
                            "first attempt still running",
                            retry_after=self.policy.retry_after)
            out = dict(replay)
            out["id"] = rid
            out["idempotent_replay"] = True
            return out
        try:
            # one mutation at a time: engine mutators read-modify-rebind
            # self.net, so two concurrent wire mutations could lose one
            with self._mutate_lock:
                getattr(self.engine, method)(**args)
            resp = _response(
                rid, ok=True, applied=action,
                durable_lsn=(None if self._store is None
                             else self._store.last_lsn),
            )
        except EngineClosed:
            resp = _err(rid, "closed", "server shutting down")
        except Exception as e:
            self._session_count(sid, "errors")
            resp = _err(rid, "engine_error", f"{type(e).__name__}: {e}")
        if key is not None:
            # COMMIT BEFORE THE RESPONSE IS WRITTEN: if the ack is lost
            # to a drop/torn write, the retry replays this record instead
            # of running the mutation a second time
            if resp.get("ok"):
                self.idempotency.commit(str(key), resp)
            else:
                self.idempotency.abort(str(key))
        return resp

    # -- stats ---------------------------------------------------------------

    @property
    def stats(self) -> dict:
        with self._lock:
            transport = dict(self._counters)
            sessions = {
                "active": len(self._sessions),
                "opened": self._sessions_opened,
                "by_session": {
                    str(k): dict(v) for k, v in self._sessions.items()
                },
            }
        return {
            "address": list(self.address),
            "transport": transport,
            "sessions": sessions,
            "admission": self.admission.stats,
            "idempotency": self.idempotency.stats,
            "engine": self.engine.stats,
            "faults": self._plan.stats if self._plan else None,
        }
