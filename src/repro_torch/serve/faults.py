"""Deterministic fault injection for the serve stack (chaos harness).

A resilient server is only as trustworthy as the failure modes it has
actually been driven through. This module is the injection half of the
chaos test suite: a seeded :class:`FaultPlan` maps **named sites** in the
serve stack to fault rules, and the frontend / engine / client consult
the plan at each site. With the same plan (same seed, same rules) a test
run replays the identical fault schedule every time — flaky-by-design
infrastructure tested deterministically.

Named sites (where the stack consults a plan):

======================  =====================================================
site                    consulted by
======================  =====================================================
``accept``              frontend, once per accepted connection (before any
                        byte is read) — a ``drop`` here is a connection
                        reset on connect
``read``                frontend, once per request line read off the wire
``write``               frontend, once per response about to be written; a
                        ``torn`` rule truncates the serialized response to
                        ``frac`` of its bytes and drops the connection — the
                        torn-write the client's retry path must survive
``reply.delay``         frontend, before writing a response (``delay`` =
                        response latency injection)
``engine.exec``         GraphServeEngine, before executing a coalesced
                        group (``error`` here = an engine exception that
                        must degrade to per-request error results)
``pump.batch_delay``    GraphServeEngine, after a group executes but before
                        results scatter (``delay`` here makes a request
                        expire *mid-batch* — the post-execution deadline
                        check's regression site)
``client.send``         client, before sending a request (``drop`` =
                        connection lost before the server saw the request)
``client.consume``      client, before reading a response (``stall`` = the
                        slow-consumer case: the server must stay live for
                        other sessions while this one sits on its socket)
======================  =====================================================

Fault kinds: ``drop`` (raise :class:`ConnectionDropped`), ``error``
(raise :class:`InjectedFault`), ``delay`` / ``stall`` (sleep
``spec.delay`` seconds), ``torn`` (no action here — the site truncates
its own write to ``spec.frac``; only write-like sites honor it).

Rules fire at explicit call indices (``at=(3, 7)``), on a stride
(``every=5``), or with seeded probability ``p`` — all per-site, all
deterministic for a given seed. ``times`` caps total fires so a plan can
model a transient burst that the system must *recover* from.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

__all__ = [
    "ConnectionDropped",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
]

_KINDS = ("drop", "error", "delay", "stall", "torn")


class InjectedFault(RuntimeError):
    """An injected engine/server exception (fault kind ``error``)."""


class ConnectionDropped(InjectedFault):
    """An injected connection drop (fault kind ``drop``)."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault rule at one site. Exactly one trigger should be set:
    ``at`` (explicit 0-based call indices), ``every`` (every Nth call,
    1-based stride), or ``p`` (per-call probability under the plan's
    seeded RNG). ``times`` bounds total fires (None = unbounded)."""

    kind: str
    at: tuple[int, ...] | None = None
    every: int | None = None
    p: float = 0.0
    times: int | None = None
    delay: float = 0.05     # seconds slept by delay / stall
    frac: float = 0.5       # fraction of bytes written by a torn write
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {_KINDS}"
            )
        if self.at is not None:
            object.__setattr__(self, "at", tuple(int(i) for i in self.at))
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")


def _as_spec(rule) -> FaultSpec:
    if isinstance(rule, FaultSpec):
        return rule
    if isinstance(rule, dict):
        return FaultSpec(**rule)
    raise TypeError(f"fault rule must be a FaultSpec or dict, got {rule!r}")


@dataclass
class FaultEvent:
    """One fired fault, for the plan's replayable log."""

    site: str
    call: int       # 0-based call index at the site
    kind: str


class FaultPlan:
    """Seeded site -> rule map; thread-safe, replay-deterministic.

    >>> plan = FaultPlan({"write": {"kind": "torn", "at": (2,)}}, seed=7)
    >>> plan.decide("write")        # calls 0,1 -> None; call 2 -> the spec

    ``decide(site)`` counts the call and returns the matching
    :class:`FaultSpec` when it fires (else None). ``fire(site)`` is
    ``decide`` plus the action for self-contained kinds: raises on
    ``drop``/``error``, sleeps on ``delay``/``stall``; ``torn`` is
    returned for the caller to truncate its own write. Sites not in the
    plan are free (no counting cost beyond a dict miss); a ``None`` plan
    never fires — callers guard with ``if plan:``.
    """

    def __init__(self, rules: dict | None = None, *, seed: int = 0):
        self.seed = int(seed)
        self.rules: dict[str, tuple[FaultSpec, ...]] = {}
        for site, rule in (rules or {}).items():
            specs = rule if isinstance(rule, (list, tuple)) else [rule]
            self.rules[str(site)] = tuple(_as_spec(r) for r in specs)
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._spec_fired: dict[int, int] = {}
        self._rng: dict[str, random.Random] = {}
        self.log: list[FaultEvent] = []

    def reset(self) -> None:
        """Rewind counters + RNGs so the same plan replays identically."""
        with self._lock:
            self._calls.clear()
            self._fired.clear()
            self._spec_fired.clear()
            self._rng.clear()
            self.log.clear()

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rng.get(site)
        if rng is None:
            # seed is (plan seed, site name): two sites never share a
            # stream, and the stream does not depend on rule order
            rng = self._rng[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def decide(self, site: str) -> FaultSpec | None:
        """Count one call at ``site``; return the spec that fires, if any."""
        specs = self.rules.get(site)
        if not specs:
            return None
        with self._lock:
            call = self._calls.get(site, 0)
            self._calls[site] = call + 1
            for spec in specs:
                fired = self._spec_fired.get(id(spec), 0)
                if spec.times is not None and fired >= spec.times:
                    continue
                hit = False
                if spec.at is not None:
                    hit = call in spec.at
                elif spec.every is not None:
                    hit = (call + 1) % spec.every == 0
                elif spec.p > 0.0:
                    # drawn even on no-hit calls so the stream position
                    # depends only on the call index (determinism)
                    hit = self._site_rng(site).random() < spec.p
                if hit:
                    self._spec_fired[id(spec)] = fired + 1
                    self._fired[site] = self._fired.get(site, 0) + 1
                    self.log.append(FaultEvent(site, call, spec.kind))
                    return spec
        return None

    def fire(self, site: str) -> FaultSpec | None:
        """``decide`` + act: raise / sleep for self-contained kinds.

        Returns the spec (``torn`` and everything else) so write sites
        can apply the byte truncation themselves.
        """
        spec = self.decide(site)
        if spec is None:
            return None
        if spec.kind == "drop":
            raise ConnectionDropped(f"{site}: {spec.message}")
        if spec.kind == "error":
            raise InjectedFault(f"{site}: {spec.message}")
        if spec.kind in ("delay", "stall"):
            time.sleep(spec.delay)
        return spec

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "calls": dict(self._calls),
                "fired": dict(self._fired),
                "total_fired": sum(self._fired.values()),
            }


@dataclass
class _NeverPlan:
    """Shared no-op stand-in (``plan or NEVER`` keeps call sites branchless)."""

    stats: dict = field(default_factory=lambda: {
        "calls": {}, "fired": {}, "total_fired": 0,
    })

    def decide(self, site: str) -> None:
        return None

    def fire(self, site: str) -> None:
        return None

    def __bool__(self) -> bool:
        return False


NEVER = _NeverPlan()
