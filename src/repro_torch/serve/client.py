"""Retrying NDJSON client for the network serve frontend.

The client half of the resilience contract (serve/resilience.py):

* every call carries an **idempotency key** (seeded, unique per logical
  request, REUSED verbatim across retries of that request) — so the
  retry loop can resend mutations after a lost ack without ever running
  them twice: the server replays the committed response instead;
* transport failures (connection refused/reset, torn responses, stalled
  sockets) and retryable server verdicts (``shed`` / ``in_flight``)
  back off with capped exponential **full-jitter** delays
  (:class:`repro_torch.serve.resilience.RetryPolicy`), honoring the server's
  ``retry_after`` hint when it is larger;
* a per-call ``deadline_ms`` is both sent to the server (end-to-end
  propagation) and enforced locally: the client raises
  :class:`DeadlineExceeded` rather than sleep past the budget;
* non-retryable verdicts (``bad_request``, ``deadline``,
  ``engine_error``, ``closed``) raise :class:`ServeError` immediately —
  retrying a malformed or expired request is wasted load.

Fault sites (serve/faults.py): ``client.send`` (a ``drop`` here is a
connection lost before the server saw the request — the harness's
retry-must-not-duplicate case) and ``client.consume`` (a ``stall`` here
is the slow-consumer case: this client sits on its socket while the
threaded server keeps serving other sessions).
"""

from __future__ import annotations

import json
import random
import socket
import time

from .faults import ConnectionDropped
from .resilience import DeadlineExceeded, RetryPolicy, deadline_from_ms

__all__ = ["GraphServeClient", "ServeError", "Unavailable"]

_RETRYABLE_CODES = ("shed", "in_flight")


class ServeError(RuntimeError):
    """The server answered with a non-retryable error response."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code


class Unavailable(ServeError):
    """Retries exhausted without a settled response."""

    def __init__(self, message: str):
        super().__init__("unavailable", message)


class GraphServeClient:
    """One TCP session against a :class:`GraphServeFrontend`.

    >>> with GraphServeClient(host, port) as c:
    ...     c.query({"kind": "degree", "u": 12}, deadline_ms=250)
    ...     c.mutate("addedges", {"layer": "er", "src": [1], "dst": [2]})

    Thread-compatible, not thread-safe: use one client per thread (the
    server multiplexes sessions; sockets do not multiplex requests).
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        retry: RetryPolicy | None = None,
        default_deadline_ms: float | None = None,
        seed: int | None = None,
        fault_plan=None,
        io_timeout: float = 10.0,
        connect_timeout: float = 5.0,
    ):
        self.host, self.port = host, int(port)
        self.retry = retry or RetryPolicy()
        self.default_deadline_ms = default_deadline_ms
        self._rng = random.Random(seed)
        self._plan = fault_plan
        self._io_timeout = float(io_timeout)
        self._connect_timeout = float(connect_timeout)
        self._sock: socket.socket | None = None
        self._rfile = None
        self._next_id = 0
        self._key_prefix = f"c{self._rng.getrandbits(48):012x}"
        self.attempts = 0      # wire attempts, includes retries
        self.retries = 0
        self.reconnects = 0

    # -- connection management ----------------------------------------------

    def _connect(self):
        if self._sock is not None:
            return
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self._connect_timeout
        )
        self._sock.settimeout(self._io_timeout)
        # one request-response per exchange: without NODELAY, Nagle +
        # delayed ACK adds ~40ms to every call
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self.reconnects += 1

    def _drop_connection(self) -> None:
        # any failed exchange poisons the socket: an unread response
        # from a timed-out call would desync every later exchange
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._drop_connection()

    def __enter__(self) -> "GraphServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the retry loop ------------------------------------------------------

    def fresh_key(self, tag: str = "r") -> str:
        """A new idempotency key — unique per logical request, shared by
        every retry of it."""
        self._next_id += 1
        return f"{self._key_prefix}-{tag}{self._next_id}"

    def _exchange(self, env: dict, deadline: float | None) -> dict:
        """One wire attempt: send the envelope, read one response line."""
        if self._plan:
            self._plan.fire("client.send")  # drop = request never sent
        self._connect()
        data = (json.dumps(env) + "\n").encode()
        self._sock.sendall(data)
        if self._plan:
            self._plan.fire("client.consume")  # stall = slow consumer
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise DeadlineExceeded(f"{env.get('op')}: budget lapsed")
            self._sock.settimeout(min(self._io_timeout, left))
        line = self._rfile.readline()
        if deadline is not None:
            self._sock.settimeout(self._io_timeout)
        if not line or not line.endswith(b"\n"):
            # EOF or a torn (partial, unterminated) response record
            raise ConnectionResetError("connection closed mid-response")
        resp = json.loads(line)
        if not isinstance(resp, dict):
            raise ValueError("response is not a JSON object")
        if resp.get("id") != env["id"]:
            raise ConnectionResetError(
                f"response id {resp.get('id')!r} != request id "
                f"{env['id']!r} (desynced stream)"
            )
        return resp

    def _call(self, env: dict, deadline_ms=None) -> dict:
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = deadline_from_ms(deadline_ms)
        if deadline_ms is not None:
            env["deadline_ms"] = float(deadline_ms)
        last = "no attempt made"
        for attempt in range(self.retry.max_attempts):
            self.attempts += 1
            retry_after = None
            try:
                resp = self._exchange(env, deadline)
                if resp.get("ok"):
                    return resp
                code = resp.get("code", "engine_error")
                if code not in _RETRYABLE_CODES:
                    if code == "deadline":
                        raise DeadlineExceeded(resp.get("error", code))
                    raise ServeError(code, resp.get("error", "error"))
                last = f"[{code}] {resp.get('error', '')}"
                retry_after = resp.get("retry_after")
            except (OSError, ConnectionDropped, ValueError) as e:
                # OSError covers refused/reset/timeout; ConnectionDropped
                # is an injected client.send fault; ValueError is a
                # garbled response — all retryable, all poison the socket
                self._drop_connection()
                last = f"{type(e).__name__}: {e}"
            if attempt + 1 >= self.retry.max_attempts:
                break
            delay = self.retry.backoff(attempt, self._rng)
            if retry_after is not None:
                delay = max(delay, float(retry_after))
            if deadline is not None and (
                time.monotonic() + delay >= deadline
            ):
                raise DeadlineExceeded(
                    f"{env.get('op')}: budget lapses before next retry "
                    f"(last: {last})"
                )
            self.retries += 1
            time.sleep(delay)
        raise Unavailable(
            f"{env.get('op')} failed after {self.retry.max_attempts} "
            f"attempts (last: {last})"
        )

    def _envelope(self, op: str, **fields) -> dict:
        self._next_id += 1
        env = {"op": op, "id": self._next_id}
        env.update(fields)
        return env

    # -- public surface ------------------------------------------------------

    def query(
        self, request: dict, *, deadline_ms=None, key: str | None = None,
        full: bool = False,
    ):
        """Run one read query; returns the result value (or the full
        response envelope with ``full=True`` — ``cached`` / ``degraded``
        flags live there)."""
        env = self._envelope(
            "query", request=dict(request),
            key=key if key is not None else self.fresh_key("q"),
        )
        resp = self._call(env, deadline_ms)
        return resp if full else resp.get("result")

    def mutate(
        self, action: str, args: dict, *, deadline_ms=None,
        key: str | None = None,
    ) -> dict:
        """Apply one mutation exactly once (idempotency-keyed); returns
        the response envelope (``durable_lsn``, ``idempotent_replay``)."""
        env = self._envelope(
            "mutate", action=action, args=dict(args),
            key=key if key is not None else self.fresh_key("m"),
        )
        return self._call(env, deadline_ms)

    def ping(self, *, deadline_ms=None) -> bool:
        return bool(self._call(
            self._envelope("ping"), deadline_ms
        ).get("pong"))

    def healthz(self) -> dict:
        return self._call(self._envelope("healthz"))["health"]

    def readyz(self) -> dict:
        """Readiness document; does NOT raise when not ready."""
        env = self._envelope("readyz")
        deadline = deadline_from_ms(self.default_deadline_ms)
        try:
            resp = self._exchange(env, deadline)
        except (OSError, ConnectionDropped, ValueError) as e:
            self._drop_connection()
            return {"ready": False, "reasons": [f"unreachable: {e}"]}
        return resp.get("readiness", {"ready": False, "reasons": ["bad response"]})

    def stats(self) -> dict:
        return self._call(self._envelope("stats"))["stats"]
