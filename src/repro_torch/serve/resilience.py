"""Resilience layer for the network serve frontend.

Everything here is policy, not transport: the pieces that make a
request/response loop over a real network *safe* —

* **Deadlines** — every request carries one budget end-to-end. The wire
  field ``deadline_ms`` becomes an absolute ``time.monotonic()`` expiry
  at ingress; the engine's per-request ``timeout`` expires it in
  the queue, the engine's post-batch check expires it mid-dispatch, and
  the frontend re-checks before writing, so a client never receives a
  success for a request whose budget had already lapsed.
* **Retries** — :class:`RetryPolicy` computes capped exponential backoff
  with full jitter (decorrelated client herds). Retries are *safe*, not
  just bounded, because every request carries an idempotency key the
  server deduplicates (:class:`IdempotencyCache`): a retry of a mutation
  whose first attempt was acknowledged-but-the-ack-was-lost replays the
  stored response instead of mutating twice.
* **Admission control** — :class:`AdmissionController` implements the
  shed-vs-degrade matrix: under heavy-queue overload, ``khop`` degrades
  (its ``max_frontier`` is clamped to the policy's degraded budget and
  the response is flagged ``degraded: true`` — bit-identical to honestly
  running the truncated request), ``walkbatch`` sheds with a
  ``retry_after`` hint, and point queries keep serving until their own
  bounded queue rejects. Load never silently changes an answer: a
  degraded result says so.
* **Health** — :func:`health` (liveness: the process answers) and
  :func:`readiness` (fitness: pump thread alive, queues below the shed
  threshold, WAL store writable) back the ``/healthz`` / ``/readyz``
  endpoints, so an orchestrator can stop routing to a wedged server
  before clients feel it.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

__all__ = [
    "Admission",
    "AdmissionController",
    "AdmissionPolicy",
    "DeadlineExceeded",
    "IdempotencyCache",
    "RetryPolicy",
    "deadline_from_ms",
    "degraded_reference",
    "health",
    "readiness",
    "remaining_ms",
    "store_status",
]


class DeadlineExceeded(RuntimeError):
    """A request's end-to-end budget lapsed (client-raised form of the
    engine's ``DeadlineExceeded:`` error results)."""


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


def deadline_from_ms(deadline_ms, *, now: float | None = None) -> float | None:
    """Wire budget (milliseconds, relative) -> absolute monotonic expiry."""
    if deadline_ms is None:
        return None
    budget = float(deadline_ms)
    if budget <= 0:
        raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
    return (time.monotonic() if now is None else now) + budget / 1000.0


def remaining_ms(deadline: float | None, *, now: float | None = None):
    """Milliseconds left before ``deadline`` (None = no deadline)."""
    if deadline is None:
        return None
    return (deadline - (time.monotonic() if now is None else now)) * 1000.0


# ---------------------------------------------------------------------------
# Retry policy (client side)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter.

    ``backoff(attempt)`` for attempt 0, 1, 2, … draws uniformly from
    ``[base * 2^attempt * (1 - jitter), base * 2^attempt]``, capped at
    ``cap`` — full jitter (jitter=1.0 draws from [0, window]) keeps a
    herd of clients retrying a shed burst from re-arriving in phase.
    """

    max_attempts: int = 5
    base: float = 0.02
    cap: float = 1.0
    jitter: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff(self, attempt: int, rng: random.Random | None = None) -> float:
        window = min(self.base * (2.0 ** attempt), self.cap)
        r = rng.random() if rng is not None else random.random()
        return window * (1.0 - self.jitter * r)


# ---------------------------------------------------------------------------
# Idempotency (server side)
# ---------------------------------------------------------------------------


class IdempotencyCache:
    """Bounded LRU of idempotency key -> stored response record.

    ``begin(key)`` claims a key: the first caller gets ``(True, None)``
    and must later ``commit(key, response)``; a retry arriving after the
    commit gets ``(False, response)`` and replays it verbatim — the
    mutation it acknowledges ran exactly once. A retry arriving while
    the first attempt is *still in flight* gets ``(False, None)``:
    in-progress, retry later (the server answers ``retry_after`` rather
    than running the op twice concurrently).
    """

    _IN_FLIGHT = object()

    def __init__(self, capacity: int = 4096):
        self.capacity = max(int(capacity), 1)
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.replays = 0
        self.in_flight_hits = 0

    def begin(self, key: str):
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self._d[key] = self._IN_FLIGHT
                self._trim()
                return True, None
            self._d.move_to_end(key)
            if hit is self._IN_FLIGHT:
                self.in_flight_hits += 1
                return False, None
            self.replays += 1
            return False, hit

    def commit(self, key: str, response) -> None:
        with self._lock:
            self._d[key] = response
            self._d.move_to_end(key)
            self._trim()

    def abort(self, key: str) -> None:
        """First attempt failed before commit: release the claim so a
        retry can run the op (nothing happened server-side)."""
        with self._lock:
            if self._d.get(key) is self._IN_FLIGHT:
                del self._d[key]

    def _trim(self) -> None:
        # never evict an in-flight claim: dropping one would let a
        # concurrent retry run the same mutation a second time
        while len(self._d) > self.capacity:
            victim = next(
                (k for k, v in self._d.items() if v is not self._IN_FLIGHT),
                None,
            )
            if victim is None:
                return
            del self._d[victim]

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": len(self._d),
                "replays": self.replays,
                "in_flight_hits": self.in_flight_hits,
            }


# ---------------------------------------------------------------------------
# Admission control (shed vs degrade)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdmissionPolicy:
    """The shed-vs-degrade matrix, as numbers.

    ==============  ==========================  ===========================
    kind            under overload              rationale
    ==============  ==========================  ===========================
    point queries   keep serving                their queue is drained
                                                first every round; bounded
                                                queue rejects at its limit
    ``khop``        degrade: clamp
                    ``max_frontier`` to
                    ``degrade_max_frontier``,   a truncated neighborhood is
                    flag ``degraded: true``     a *correct* answer to the
                                                truncated request — flagged,
                                                bit-identical to running it
    ``walkbatch``   shed with ``retry_after``   a shorter walk answers a
                                                different question; better
                                                to say "later" than to lie
    ==============  ==========================  ===========================

    ``heavy_shed_depth`` is the heavy-queue depth at which the matrix
    engages (None = engage only at the queue's hard limit).
    """

    heavy_shed_depth: int | None = None
    degrade_khop: bool = True
    degrade_max_frontier: int = 32
    retry_after: float = 0.05


@dataclass(frozen=True)
class Admission:
    """One admission decision: ``action`` in {"serve", "degrade", "shed"};
    ``request`` is the (possibly rewritten) request to execute."""

    action: str
    request: dict
    retry_after: float | None = None
    reason: str | None = None


class AdmissionController:
    """Applies an :class:`AdmissionPolicy` against live engine depth."""

    def __init__(self, engine, policy: AdmissionPolicy | None = None):
        self.engine = engine
        self.policy = policy or AdmissionPolicy()
        self._lock = threading.Lock()
        self.shed = 0
        self.degraded = 0

    def _overloaded(self) -> bool:
        depth = self.engine.heavy_pending
        limit = self.engine.queue_limits[1]
        threshold = (
            limit if self.policy.heavy_shed_depth is None
            else min(self.policy.heavy_shed_depth, limit)
        )
        return depth >= threshold

    def admit(self, request: dict) -> Admission:
        from .graph_engine import HEAVY_KINDS

        kind = str(request.get("kind", ""))
        if kind not in HEAVY_KINDS or not self._overloaded():
            return Admission("serve", request)
        if kind == "khop" and self.policy.degrade_khop:
            mf = request.get("max_frontier")
            clamp = self.policy.degrade_max_frontier
            if mf is None or int(mf) > clamp:
                degraded = dict(request)
                degraded["max_frontier"] = clamp
                with self._lock:
                    self.degraded += 1
                return Admission(
                    "degrade", degraded,
                    reason=f"overload: max_frontier clamped to {clamp}",
                )
            return Admission("serve", request)  # already within budget
        with self._lock:
            self.shed += 1
        return Admission(
            "shed", request, retry_after=self.policy.retry_after,
            reason=f"overload: {kind} queue saturated",
        )

    def record_shed(self) -> None:
        """Count a queue-limit rejection (QueueFull) as a shed."""
        with self._lock:
            self.shed += 1

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"shed": self.shed, "degraded": self.degraded}


def degraded_reference(request: dict, policy: AdmissionPolicy) -> dict:
    """The truncated request a degraded response must be bit-identical
    to (the chaos suite's checkable degradation contract)."""
    adm = dict(request)
    mf = adm.get("max_frontier")
    clamp = policy.degrade_max_frontier
    if mf is None or int(mf) > clamp:
        adm["max_frontier"] = clamp
    return adm


# ---------------------------------------------------------------------------
# Health / readiness
# ---------------------------------------------------------------------------


def store_status(store) -> dict:
    """WAL-store health facts (defensive: never raises)."""
    if store is None:
        return {"present": False, "ok": True}
    out = {"present": True, "ok": True}
    try:
        out["last_lsn"] = store.last_lsn
        wal = getattr(store, "_wal", None)
        if wal is not None:
            closed = getattr(wal, "_f", object()) is None
            poisoned = bool(getattr(wal, "_poisoned", False))
            out["wal_closed"] = closed
            out["wal_poisoned"] = poisoned
            out["ok"] = not (closed or poisoned)
    except Exception as e:  # a store that can't even report is not ok
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def health(engine, store=None) -> dict:
    """Liveness: the serving process is up and can report state."""
    stats = engine.stats
    return {
        "ok": not engine.closed,
        "closed": engine.closed,
        "served": stats["served"],
        "pending_point": stats["pending_point"],
        "pending_heavy": stats["pending_heavy"],
        "pump_faults": stats["pump_faults"],
        "store": store_status(store),
    }


def readiness(
    engine, policy: AdmissionPolicy | None = None, store=None
) -> dict:
    """Fitness to take traffic: ready iff no reason says otherwise.

    Reasons: engine closed; the background pump was started but its
    thread died; the point queue is at its hard limit (even point
    queries are bouncing); the heavy queue is at/over the shed
    threshold (heavy traffic is being shed/degraded — drain first);
    the WAL store cannot accept mutations.
    """
    policy = policy or AdmissionPolicy()
    reasons: list[str] = []
    if engine.closed:
        reasons.append("engine closed")
    if engine.pump_started and not engine.pump_alive:
        reasons.append("pump thread dead")
    point, heavy = engine.point_pending, engine.heavy_pending
    point_limit, heavy_limit = engine.queue_limits
    if point >= point_limit:
        reasons.append(f"point queue full ({point}/{point_limit})")
    shed_depth = (
        heavy_limit if policy.heavy_shed_depth is None
        else min(policy.heavy_shed_depth, heavy_limit)
    )
    if heavy >= shed_depth:
        reasons.append(f"heavy queue shedding ({heavy}/{shed_depth})")
    st = store_status(store)
    if not st["ok"]:
        reasons.append("wal store unavailable")
    return {
        "ready": not reasons,
        "reasons": reasons,
        "pending_point": point,
        "pending_heavy": heavy,
        "store": st,
    }
