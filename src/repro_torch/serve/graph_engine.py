"""Concurrent graph-query serving engine: micro-batching + result cache.

The paper's deployment model (§3.1, threadleR) is a resident in-memory
network answering streams of small queries from many clients. Executing
those one call at a time wastes the batched query engine: every request
pays its own host-side bucket planning and device launches. This module
is the serving layer over the degree-bucketed dispatch (core/dispatch.py)
and the batched traversal engine (core/traversal.py):

* **Micro-batching** — requests of the same kind and compatible static
  arguments (layer selection, ``k``, ``max_alters``, filter fingerprint)
  are coalesced from the queue into ONE batched dispatch; results scatter
  back per request id. Every supported query is row-independent under
  batching, so a coalesced result is bit-identical to the same request
  served alone (``run_request``).
* **Result cache** — an LRU keyed on ``(kind, layer selection,
  canonicalized args, filter fingerprint)`` with hit/miss/eviction stats.
  Mutations invalidate by SCOPE: every entry carries the set of layers
  its result was computed from (``layer:<name>``, or ``layers*`` for
  whole-network queries), and a mutation to layer L evicts only the
  entries touching L (``delete_layer``/``import_layer``/``add_edges``/
  ``delete_edges``; ``update_network`` still drops everything).
  ``set_attr`` evicts nothing: cache keys embed a content hash of the
  resolved filter mask, so entries computed under a pre-mutation mask
  become unreachable (and LRU-age out) rather than stale. Constructing
  the engine with ``scoped_invalidation=False`` drops everything on
  every mutation (the reference the property tests compare against).
  Cached values are host values (numpy arrays, Python scalars, records),
  never device tensors.
* **Durability** (``store=``) — mutations route through a
  ``core.snapshot.DurableStore``: the op is appended to a write-ahead
  log and fsync'd *before* the engine's network rebinds, and a WAL
  write failure rejects the mutation (fail closed) leaving the served
  network unchanged.
* **Graceful degradation** — per-request deadlines (``"timeout"``
  seconds per request, or ``default_timeout=``) expire queued requests
  into error results instead of serving arbitrarily stale answers; a
  fault anywhere in a pump round turns into per-request error results
  and the background pump thread survives to serve the next round. The
  engine never retries on another device: a CUDA error reaches the
  requests of its round as error results carrying its message.
* **Backpressure** — two bounded queues split request kinds by cost:
  point queries (``getedge``, ``alters``, ``degree``) and heavy traversal
  (``khop``, ``walkbatch``). Each pump round drains the point queue first
  and caps heavy work, so a flood of ``khop`` requests fills *its own*
  queue (``QueueFull`` for the flooder) while point queries keep flowing.

Request kinds (the trace-file / ``submit`` schema; scalars or id-lists):

    {"kind": "getedge",   "layer": L, "u": i, "v": j}
    {"kind": "alters",    "u": i [, "layers": [...]] [, "max_alters": m]}
    {"kind": "degree",    "u": i|[ids] [, "layers": [...]]}
    {"kind": "khop",      "sources": i|[ids], "k": h [, "max_frontier": f]
                          [, "layers": [...]]}
    {"kind": "walkbatch", "starts": i|[ids], "steps": n [, "walkers": w]
                          [, "seed": s] [, "layers": [...]]
                          [, "layer_weights": [...]]}

plus an optional ``"filter"``: a NodeSelection, a bool mask, or a spec
``{"attr": a, "op": eq|ne|lt|le|gt|ge|has [, "value": v]}`` resolved
against the network's attribute store (§3.1 register-analysis filters).

Thread-safety and the card: ``submit`` / ``result`` are safe from many
client threads, and ``submit`` does no device work. A filter it cannot
take from the engine's filter memo is checked on the host
(``Nodeset.check_select``), so a bad spec still fails at submit, and is
resolved at pop time by whoever pumps. ``start()`` runs the pump loop on
one background thread, which sets the network's device and alone
touches the card; it also loads the graph kernels' libraries on the
starting thread first. Single-threaded callers use ``serve()``, which
submits and pumps on the calling thread. While the background pump runs,
a mutation is handed to it: the pump applies it between two rounds and
the calling thread waits for the outcome, so no round is served during
the mutation's host time (seconds for a 10M-node layer). Without the
pump, a mutation runs on the thread that calls it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch

__all__ = [
    "GraphServeEngine",
    "QueryResult",
    "QueueFull",
    "EngineClosed",
    "POINT_KINDS",
    "HEAVY_KINDS",
    "REQUEST_KINDS",
    "run_request",
    "assert_results_equal",
    "canonical_request",
    "parse_trace",
    "load_trace",
]

# Canonicalization, fingerprinting, executors and the per-call reference
# path live in ``core/request.py``. The engine re-exports the serving
# names so that ``_EXECUTORS`` here is the same object tests wrap.
from repro_torch.core.request import (  # noqa: F401  (re-exported serving API)
    ALL_LAYERS_SCOPE,
    HEAVY_KINDS,
    POINT_KINDS,
    REQUEST_KINDS,
    _DEFAULT_MAX_ALTERS,
    _EXECUTORS,
    CanonicalRequest as _CanonRequest,
    QueryRequest,
    QueryResult,
    _pythonic,
    _spec_memo_key,
    assert_results_equal,
    canonical_request,
    run_request,
)

class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the request's cost class is saturated."""


class EngineClosed(RuntimeError):
    """The engine was ``close()``d: late submissions/mutations rejected."""


# ---------------------------------------------------------------------------
# LRU result cache
# ---------------------------------------------------------------------------


class _ResultCache:
    """LRU over canonical results with hit/miss/eviction/invalidation stats.

    Entries carry the scope-token set of the layers their result was
    computed from; ``invalidate(scopes=...)`` evicts only intersecting
    entries, while ``invalidate()`` drops everything.
    """

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 0)
        self._d: OrderedDict = OrderedDict()  # key -> (value, scopes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.scoped_invalidations = 0
        self.entries_invalidated = 0

    def get(self, key):
        if self.capacity == 0:
            self.misses += 1
            return None
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return hit[0]

    def put(self, key, value, scopes: frozenset = frozenset()) -> None:
        if self.capacity == 0:
            return
        self._d[key] = (value, scopes)
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def invalidate(self, scopes: frozenset | None = None) -> None:
        if scopes is None:
            self.entries_invalidated += len(self._d)
            self._d.clear()
            self.invalidations += 1
            return
        victims = [k for k, (_, deps) in self._d.items() if deps & scopes]
        for k in victims:
            del self._d[k]
        self.entries_invalidated += len(victims)
        self.scoped_invalidations += 1

    def __len__(self) -> int:
        return len(self._d)

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "entries": len(self._d),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "scoped_invalidations": self.scoped_invalidations,
            "entries_invalidated": self.entries_invalidated,
        }


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    rid: int
    creq: _CanonRequest
    raw: dict  # original request — re-canonicalized if the net mutates
    gen: int = 0  # generation the canonicalization ran against; -1 = the
    # filter is not resolved yet (the pump resolves it at pop time)
    deadline: float | None = None  # time.monotonic() expiry, None = never


@dataclass
class _Mutation:
    """A mutation handed to the background pump: ``apply()`` builds the
    new network, ``commit`` holds ``_commit_mutation``'s scope arguments;
    the caller waits on ``done`` and re-raises ``error``."""

    apply: Callable
    commit: dict
    done: threading.Event = field(default_factory=threading.Event)
    error: Exception | None = None


def _check_filter(net, spec) -> None:
    """Host-only validation of a request's filter: raises what resolving
    it would raise for a malformed spec, and touches no device buffer."""
    from repro_torch.core.nodeset import node_filter_mask

    if isinstance(spec, dict):
        net.nodeset.check_select(
            str(spec["attr"]), str(spec["op"]), spec.get("value")
        )
    else:
        node_filter_mask(spec, net.n_nodes)


class GraphServeEngine:
    """Resident network + bounded queues + micro-batcher + result cache.

    >>> eng = net.serve_session()
    >>> rid = eng.submit({"kind": "degree", "u": 7})
    >>> eng.pump()
    >>> eng.result(rid).value
    """

    def __init__(
        self,
        net=None,
        *,
        cache_size: int = 4096,
        queue_limit: int = 8192,
        heavy_queue_limit: int | None = None,
        max_heavy_per_round: int = 1024,
        result_limit: int = 65536,
        scoped_invalidation: bool = True,
        default_timeout: float | None = None,
        store=None,
        fault_plan=None,
        shards: int | None = None,
    ):
        if net is None:
            if store is None:
                raise ValueError("need a network (net=) or a durable "
                                 "store to serve from (store=)")
            net = store.net
        self.net = net
        if shards is not None and int(shards) < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self._n_shards = int(shards) if shards else None
        # shards > 1: executors dispatch against a ShardedNetwork view
        # (owner-routed point queries, per-shard k-hop expansion), built
        # here, before any pump starts, and rebuilt with every mutation
        self._sharded = self._shard(net)
        # mutations go WAL-first through the DurableStore when present:
        # a mutation the store could not make durable is rejected before
        # the served network rebinds (fail closed)
        self._store = store
        # False = every mutation drops the whole cache + filter memo
        self.scoped_invalidation = bool(scoped_invalidation)
        self.default_timeout = default_timeout
        self._cache = _ResultCache(cache_size)
        self._queue_limit = max(int(queue_limit), 1)
        self._heavy_limit = max(int(
            queue_limit if heavy_queue_limit is None else heavy_queue_limit
        ), 1)
        self._generation = 0
        self._max_heavy = max(int(max_heavy_per_round), 1)
        # Uncollected-result bound: a fire-and-forget client that submits
        # but never calls result() must not grow self._results without
        # limit — overflow drops the oldest-stored result (counted in
        # stats["results_dropped"]). Clamped so serve()'s incremental
        # collection (window result_limit/2 + one full round) always
        # fits: its own results can never be the ones dropped.
        self._result_limit = max(
            int(result_limit),
            2 * (self._queue_limit + self._heavy_limit),
        )
        self._results_dropped = 0
        # rids a serve() replay is committed to collecting: exempt from
        # the overflow trim so a concurrent fire-and-forget flood can
        # never drop (and deadlock) an in-progress replay's results
        self._claimed: set[int] = set()
        self._point: deque[_Pending] = deque()
        self._heavy: deque[_Pending] = deque()
        self._mutations: deque[_Mutation] = deque()  # for the pump to apply
        self._results: dict[int, QueryResult] = {}
        self._next_rid = 0
        self._served = 0
        self._batches: dict[str, int] = {k: 0 for k in REQUEST_KINDS}
        self._dispatched: dict[str, int] = {k: 0 for k in REQUEST_KINDS}
        self._rejected = 0
        self._coalesced_dupes = 0
        self._deadline_expired = 0
        self._pump_faults = 0
        self._filter_memo: dict = {}
        # host seconds spent inside pump rounds, rounds run, and seconds
        # the background pump waited for work (see ``round_stats``)
        self._rounds = 0
        self._round_s = 0.0
        self._pump_wait_s = 0.0
        # chaos-harness hook (serve/faults.py): sites "engine.exec"
        # (injected executor exception) and "pump.batch_delay" (delay
        # between execution and scatter — the post-batch deadline check's
        # regression site); None = no injection, zero hot-path cost
        self._fault_plan = fault_plan
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._done = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._closed = False

    # -- client surface ------------------------------------------------------

    def _canonical_at_submit(self, request: dict, net, gen: int):
        """Canonicalize on the caller's thread without device work ->
        (CanonicalRequest, generation). A filter the memo holds for this
        generation is taken from it; any other filter is checked on the
        host and left to the pump (generation -1), which resolves it at
        pop time against the network it pops under."""
        q = QueryRequest.from_any(request)
        if q.filter is None:
            return canonical_request(net, q), gen
        key = _spec_memo_key(q.filter)
        try:
            hit = self._filter_memo.get(key) if key is not None else None
        except TypeError:  # unhashable value in the spec
            hit = None
        if hit is not None and hit[0] == gen:
            # a private copy of the entry: the pump may clear or re-tag
            # the shared memo meanwhile, and a miss here would resolve
            # the filter on this thread
            return canonical_request(
                net, q, _filter_memo={key: hit}, _gen=gen
            ), gen
        creq = canonical_request(net, q.replace(filter=None))
        _check_filter(net, q.filter)
        return creq, -1

    def submit(
        self, request: dict, *,
        _count_rejection: bool = True, _claim: bool = False,
    ) -> int:
        """Enqueue one request; returns its id.

        Raises ``QueueFull`` when the request's cost class is saturated
        (bounded-queue backpressure) and ``ValueError`` / ``KeyError`` on
        malformed requests. ``rejected`` in :attr:`stats` counts the
        rejections the client saw; ``serve``'s internal retry loop opts
        out (``_count_rejection=False``) since it absorbs the raise.

        A per-request ``"timeout"`` (seconds, overriding the engine's
        ``default_timeout``) sets a deadline: a request still queued when
        it expires is answered with a ``DeadlineExceeded`` error result
        at the next pump round instead of a stale-by-seconds answer.

        Accepts either a request dict (the trace schema) or a typed
        ``QueryRequest``.
        """
        if isinstance(request, QueryRequest):
            request = request.to_dict()
        timeout = request.get("timeout", self.default_timeout)
        deadline = None
        if timeout is not None:
            timeout = float(timeout)
            if timeout <= 0:
                raise ValueError(f"timeout must be > 0, got {timeout}")
            deadline = time.monotonic() + timeout
        with self._lock:
            if self._closed:
                raise EngineClosed("engine is closed; no new submissions")
            gen, net = self._generation, self.net
        # canonicalization runs outside the lock; if a mutation lands in
        # between, the enqueued snapshot ``gen`` no longer matches and
        # pump() re-canonicalizes against the current network at pop time
        creq, gen = self._canonical_at_submit(request, net, gen)
        q, limit = (
            (self._point, self._queue_limit)
            if creq.kind in POINT_KINDS
            else (self._heavy, self._heavy_limit)
        )
        with self._lock:
            if self._closed:  # closed while we canonicalized
                raise EngineClosed("engine is closed; no new submissions")
            if len(q) >= limit:
                if _count_rejection:
                    self._rejected += 1
                raise QueueFull(
                    f"{creq.kind!r} queue at limit ({limit}); drain "
                    "with pump() or raise queue_limit"
                )
            rid = self._next_rid
            self._next_rid += 1
            if _claim:
                self._claimed.add(rid)
            q.append(_Pending(rid, creq, dict(request), gen, deadline))
            self._work.notify()
        return rid

    def result(
        self, rid: int, *, timeout: float | None = None
    ) -> QueryResult | None:
        """Pop a finished result; with the background pump running, blocks
        up to ``timeout`` for it (None = non-blocking when no thread)."""
        with self._lock:
            if self._thread is not None and timeout is not None:
                self._done.wait_for(
                    lambda: rid in self._results, timeout=timeout
                )
            return self._results.pop(rid, None)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._point) + len(self._heavy)

    # -- health surface (serve/resilience.py readiness checks) ---------------

    @property
    def point_pending(self) -> int:
        with self._lock:
            return len(self._point)

    @property
    def heavy_pending(self) -> int:
        with self._lock:
            return len(self._heavy)

    @property
    def queue_limits(self) -> tuple[int, int]:
        """(point queue limit, heavy queue limit)."""
        return self._queue_limit, self._heavy_limit

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pump_started(self) -> bool:
        return self._thread is not None

    @property
    def pump_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def pump_thread(self) -> threading.Thread | None:
        """The background pump thread, the one thread that touches the
        card while it runs: queries and mutations (None before
        ``start()``)."""
        return self._thread

    # -- micro-batching ------------------------------------------------------

    def pump(self) -> int:
        """One scheduling round: drain the point queue and up to
        ``max_heavy_per_round`` heavy requests, coalesce, dispatch,
        scatter. Returns the number of requests served.

        The round is guarded end to end: an exception anywhere in it
        (not just inside a group executor) becomes a ``pump fault``
        error result for every popped-but-unanswered request, so a
        fault can neither hang queued clients nor kill the background
        pump thread (``pump_faults`` in :attr:`stats` counts rounds
        that degraded this way).
        """
        with self._lock:
            popped = list(self._point)
            self._point.clear()
            for _ in range(min(self._max_heavy, len(self._heavy))):
                popped.append(self._heavy.popleft())
            net, generation = self.net, self._generation
            target = self._sharded if self._sharded is not None else net
        if not popped:
            return 0

        t0 = time.perf_counter()
        finished: list[QueryResult] = []
        try:
            self._pump_round(popped, net, generation, finished, target)
        except Exception as e:
            answered = {r.rid for r in finished}
            msg = f"pump fault: {type(e).__name__}: {e}"
            for p in popped:
                if p.rid not in answered:
                    finished.append(
                        QueryResult(p.rid, p.creq.kind, None, error=msg)
                    )
            with self._lock:
                self._pump_faults += 1

        with self._lock:
            self._rounds += 1
            self._round_s += time.perf_counter() - t0
            for r in finished:
                self._results[r.rid] = r
            # bound the store against fire-and-forget clients: drop the
            # oldest-stored results first (insertion-ordered dict),
            # skipping rids an in-progress serve() replay has claimed —
            # one scan per round, not one per drop
            excess = len(self._results) - self._result_limit
            if excess > 0:
                victims = []
                for k in self._results:
                    if k not in self._claimed:
                        victims.append(k)
                        if len(victims) == excess:
                            break
                for k in victims:
                    self._results.pop(k)
                self._results_dropped += len(victims)
            self._served += len(finished)
            self._done.notify_all()
        return len(finished)

    def _pump_round(
        self, popped: list[_Pending], net, generation: int,
        finished: list[QueryResult], target,
    ) -> None:
        """The fallible middle of a pump round; appends to ``finished``.
        Requests canonicalize against ``net``; executors dispatch against
        ``target``, the sharded view picked with ``net`` when sharding is
        on, else ``net``."""
        # deadline sweep first: a request that expired while queued gets
        # an error result, never a stale answer (checked once, at pop
        # time — an in-flight dispatch is never abandoned mid-compute)
        now = time.monotonic()
        batch: list[_Pending] = []
        expired = 0
        for p in popped:
            if p.deadline is not None and now >= p.deadline:
                finished.append(QueryResult(
                    p.rid, p.creq.kind, None,
                    error="DeadlineExceeded: request expired in queue",
                ))
                expired += 1
            else:
                batch.append(p)
        if expired:
            with self._lock:
                self._deadline_expired += expired

        # requests canonicalized against an older network, and requests
        # whose filter submit left unresolved, resolve here, at pop time
        # and outside the lock: filter specs bind to the popped network,
        # and a request this network can't satisfy becomes a per-request
        # error result
        live: list[_Pending] = []
        for p in batch:
            if p.gen == generation:
                live.append(p)
                continue
            try:
                p.creq = canonical_request(
                    net, p.raw,
                    _filter_memo=self._filter_memo, _gen=generation,
                )
                p.gen = generation
                live.append(p)
            except Exception as e:
                finished.append(QueryResult(
                    p.rid, p.creq.kind, None,
                    error=f"{type(e).__name__}: {e}",
                ))
        batch = live

        # cache pass + group the misses (dedup identical in-flight keys)
        jobs: dict[tuple, list[_Pending]] = {}
        with self._lock:
            for p in batch:
                hit = self._cache.get(p.creq.cache_key)
                if hit is not None:
                    finished.append(
                        QueryResult(p.rid, p.creq.kind, hit, cached=True)
                    )
                else:
                    jobs.setdefault(p.creq.cache_key, []).append(p)

        groups: dict[tuple, list[tuple[tuple, _CanonRequest]]] = {}
        for key, ps in jobs.items():
            groups.setdefault(ps[0].creq.group_key, []).append(
                (key, ps[0].creq)
            )
        for group_key, entries in groups.items():
            kind = group_key[0]
            creqs = [c for _, c in entries]
            try:
                if self._fault_plan:
                    self._fault_plan.fire("engine.exec")
                # the executors return host values: their copies off the
                # card synchronize, so the deadline re-check below sees
                # device time
                values = _EXECUTORS[kind](target, group_key, creqs)
                if self._fault_plan:  # chaos: stall between exec + scatter
                    self._fault_plan.fire("pump.batch_delay")
                errs = [None] * len(values)
            except Exception as e:  # surface per request, don't kill the pump
                values = [None] * len(entries)
                errs = [f"{type(e).__name__}: {e}"] * len(entries)
            # deadline re-check AFTER execution: a request that expired
            # while its batch was on the device must answer
            # DeadlineExceeded, not a stale-by-its-own-budget success.
            # The computed value is still cached below — it is a valid
            # result for the key; only THIS request's budget lapsed.
            done_at = time.monotonic()
            late = 0
            with self._lock:
                self._batches[kind] += 1
                self._dispatched[kind] += len(entries)
                # a mutation that landed mid-dispatch invalidated the
                # cache; this batch's results were computed against the
                # pre-mutation network and must not re-enter it
                cacheable = self._generation == generation
                for (key, creq), val, err in zip(entries, values, errs):
                    if err is None and cacheable:
                        self._cache.put(key, val, creq.scopes)
                    # duplicates coalesced into this job share the result
                    # without recomputation — flagged cached like LRU hits
                    # (a failed dispatch shared nothing: plain error records)
                    for i, p in enumerate(jobs[key]):
                        if (err is None and p.deadline is not None
                                and done_at >= p.deadline):
                            late += 1
                            finished.append(QueryResult(
                                p.rid, kind, None,
                                error="DeadlineExceeded: request expired "
                                      "during dispatch",
                            ))
                            continue
                        shared = i > 0 and err is None
                        if shared:
                            self._coalesced_dupes += 1
                        finished.append(
                            QueryResult(p.rid, kind, val, cached=shared,
                                        error=err)
                        )
                self._deadline_expired += late

    def serve(self, requests: Iterable[dict]) -> list[QueryResult]:
        """Submit a request stream and pump until every result is in;
        results return in request order. Queue saturation triggers an
        inline pump — or, with the background pump running, a wait for
        it to drain; a malformed request becomes a per-request error
        result instead of aborting the replay."""
        rids: list[int] = []
        collected: dict[int, QueryResult] = {}
        threaded = self._thread is not None
        next_i = 0  # oldest rid index not yet known-collected

        def drain(max_outstanding: int) -> None:
            # collect oldest-first until at most max_outstanding of our
            # rids remain in the store — keeps this replay's footprint
            # bounded by the collection window, not the trace length
            nonlocal next_i
            with self._lock:
                while len(rids) - len(collected) > max_outstanding:
                    while rids[next_i] in collected:
                        next_i += 1  # malformed-request records land in
                        # `collected` directly, out of pointer order
                    r = rids[next_i]
                    if threaded:
                        self._done.wait_for(lambda: r in self._results)
                    elif r not in self._results:
                        break  # not served yet; a later pump round is
                    collected[r] = self._results.pop(r)
                    self._claimed.discard(r)

        window = max(self._result_limit // 2, 1)
        try:
            self._serve_loop(requests, rids, collected, drain, window,
                             threaded)
            drain(0)
            return [collected[r] for r in rids]
        finally:
            with self._lock:  # an aborted replay must not pin the store
                self._claimed.difference_update(rids)

    def _serve_loop(
        self, requests, rids, collected, drain, window, threaded,
    ) -> None:
        for req in requests:
            while True:
                try:
                    rids.append(self.submit(
                        req, _count_rejection=False, _claim=True,
                    ))
                    break
                except QueueFull:
                    if threaded:
                        # the background pump owns dispatch: wait for a
                        # round to drain queue space instead of pumping
                        # from this thread
                        with self._lock:
                            self._done.wait(timeout=0.05)
                    else:
                        self.pump()
                        drain(window)
                except (ValueError, KeyError, TypeError, AttributeError) as e:
                    # produced synchronously: goes straight to collected,
                    # never through the bounded result store
                    with self._lock:
                        rid = self._next_rid
                        self._next_rid += 1
                        self._served += 1
                    kind = str(req.get("kind", "")) if isinstance(
                        req, dict
                    ) else str(getattr(req, "kind", ""))
                    collected[rid] = QueryResult(
                        rid, kind, None,
                        error=f"{type(e).__name__}: {e}",
                    )
                    rids.append(rid)
                    break
            if threaded:
                drain(window)
        if not threaded:
            while self.pending:
                self.pump()
        # caller's drain(0) collects the tail — with the background pump,
        # it waits out batches in flight (pending can read 0 meanwhile)

    # -- background pump -----------------------------------------------------

    def start(self) -> "GraphServeEngine":
        """Run the pump loop on a daemon thread, the one thread that
        runs queries and applies mutations. On a CUDA network the graph
        kernels' libraries load here first, and the thread takes the
        network's device."""
        if self._closed:
            raise EngineClosed("engine is closed; cannot start the pump")
        if self._thread is not None:
            return self
        device = None
        if self.net.device.type == "cuda":
            from repro_torch.kernels import build

            for name in build.GRAPH_SOURCES:
                build.library(name)
            device = self.net.device.index
            if device is None:
                device = torch.cuda.current_device()
        self._stopping = False

        def loop():
            if device is not None:
                torch.cuda.set_device(device)
            while True:
                with self._lock:
                    t0 = time.perf_counter()
                    self._work.wait_for(
                        lambda: self._stopping or self._mutations
                        or self._point or self._heavy
                    )
                    self._pump_wait_s += time.perf_counter() - t0
                    mutations = list(self._mutations)
                    self._mutations.clear()
                    if self._stopping and not (
                        mutations or self._point or self._heavy
                    ):
                        return
                for m in mutations:  # between rounds, in arrival order
                    try:
                        self._commit_mutation(m.apply(), **m.commit)
                    except Exception as e:
                        m.error = e
                    m.done.set()
                try:
                    self.pump()
                except Exception:
                    # pump() degrades faults to per-request error results
                    # itself; this is the last-ditch guard so the thread
                    # survives and the still-queued requests are retried
                    # next round
                    with self._lock:
                        self._pump_faults += 1

        self._thread = threading.Thread(
            target=loop, name="graph-serve-pump", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the background pump (draining first); the engine stays
        open — ``start()`` again to resume. ``close()`` is terminal."""
        if self._thread is None:
            return
        with self._lock:
            self._stopping = True
            self._work.notify_all()
        self._thread.join()
        self._thread = None

    def close(self) -> None:
        """Terminal shutdown: reject new submissions with
        :class:`EngineClosed`, drain + answer everything already queued
        (nothing silently lost), and join the background pump thread.
        Idempotent; ``result()`` keeps working for already-served rids.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True  # submit() rejects from here on
        if self._thread is not None:
            self.stop()  # the pump loop drains both queues before exiting
        else:
            while self.pending:
                self.pump()
        with self._lock:
            self._done.notify_all()

    def __enter__(self) -> "GraphServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- mutating ops (scoped invalidation; WAL-first when durable) ----------

    def _ensure_open(self) -> None:
        if self._closed:
            raise EngineClosed("engine is closed; no new mutations")

    def _mutate(self, apply: Callable, **commit):
        """Apply one mutation: ``apply()`` builds the new network, which
        ``_commit_mutation(**commit)`` rebinds. While the background pump
        runs, the pump applies it between rounds and this call waits for
        it, so no other thread touches the card; otherwise it runs here.
        Returns the served network; raises what ``apply`` raised."""
        self._ensure_open()
        with self._lock:
            handoff = (self._thread is not None and not self._stopping
                       and self._thread is not threading.current_thread())
            if handoff:
                m = _Mutation(apply, commit)
                self._mutations.append(m)
                self._work.notify()
        if not handoff:
            self._commit_mutation(apply(), **commit)
            return self.net
        m.done.wait()
        if m.error is not None:
            raise m.error
        return self.net

    def _commit_mutation(
        self, net, *, layer_scopes: frozenset | None = None,
        attr: str | None = None, everything: bool = False,
    ) -> None:
        """Rebind the network and invalidate exactly what the op touched.

        Bumping the generation lazily re-canonicalizes queued requests at
        pop time (``pump``), so a filter spec resolved at submit time
        never executes with a pre-mutation mask, and a queued request the
        new network can't satisfy (e.g. its layer was deleted) turns into
        a per-request error result when dispatched. In-flight batches
        deliver results computed against the network they were popped
        under but never re-enter the cache — ``pump`` checks the
        generation before ``put``.

        With ``scoped_invalidation`` (the default), only cache entries
        whose layer-scope set intersects ``layer_scopes`` are evicted;
        ``set_attr`` evicts none. The filter memo keeps every mask whose
        attribute the op did not touch (masks read only the attribute
        store): a layer mutation invalidates none of them and
        ``set_attr`` exactly its own attribute's entries; survivors are
        re-tagged to the new generation, with their device copies.
        """
        # the sharded view is rebuilt before the rebind, on this thread
        # (the pump, while it runs), and rebinds with ``net`` under the
        # lock ``pump`` picks both under, so no round pairs the new network
        # with a stale view; an overlay-only mutation re-slices only the
        # overlays (``reshard_deltas``), never the base CSRs
        sharded = self._shard(net, self._sharded)
        with self._lock:
            self.net = net
            self._sharded = sharded
            self._generation += 1
            gen = self._generation
            if everything or not self.scoped_invalidation:
                self._cache.invalidate()
                self._filter_memo.clear()
                return
            if layer_scopes:
                self._cache.invalidate(scopes=layer_scopes)
            if attr is not None:
                for key in [k for k in self._filter_memo if k[1] == attr]:
                    del self._filter_memo[key]
            for key, entry in list(self._filter_memo.items()):
                self._filter_memo[key] = (gen,) + entry[1:]

    def _shard(self, net, previous=None):
        """The sharded view of ``net`` when ``shards > 1``, else None:
        ``previous`` re-sliced by ``reshard_deltas`` when only overlays
        changed, else a fresh ``shard_network``."""
        if not self._n_shards or self._n_shards < 2:
            return None
        from repro_torch.core import sharded

        view = None if previous is None else sharded.reshard_deltas(previous, net)
        return view if view is not None else sharded.shard_network(net, self._n_shards)

    @staticmethod
    def _layer_mutation_scopes(name: str) -> frozenset:
        # a layer mutation hits entries naming that layer AND every
        # whole-network (layers=None) entry
        return frozenset((f"layer:{name}", ALL_LAYERS_SCOPE))

    def update_network(self, net) -> None:
        """Rebind the resident network; every cached result is dropped
        (an arbitrary replacement can change anything). With a durable
        store, the replacement is checkpointed as a snapshot covering
        the current WAL position before the engine rebinds."""

        def apply():
            if self._store is not None:
                self._store.replace(net)
            return net

        self._mutate(apply, everything=True)

    def set_attr(self, name: str, nodes, values, kind: str | None = None):
        from repro_torch.core import api

        name = str(name)

        def apply():
            if self._store is None:
                return api.setnodeattr(self.net, name, nodes, values,
                                       kind=kind)
            from repro_torch.core.wal import make_set_attr_op

            pinned = kind
            if pinned is None:
                # pin the kind at log time so replay cannot re-infer
                # differently against a partially-recovered store
                ns = self.net.nodeset
                pinned = (ns.attrs.column(name).kind
                          if name in ns.attrs.names
                          else api._infer_kind(values))
            return self._store.apply(
                make_set_attr_op(name, nodes, values, kind=pinned)
            )

        return self._mutate(apply, attr=name)

    def delete_layer(self, name: str):
        from repro_torch.core import api

        name = str(name)

        def apply():
            if self._store is None:
                return api.deletelayer(self.net, name)
            from repro_torch.core.wal import make_delete_layer_op

            return self._store.apply(make_delete_layer_op(name))

        return self._mutate(
            apply, layer_scopes=self._layer_mutation_scopes(name)
        )

    def import_layer(self, name: str, file: str, **kw):
        from repro_torch.core import api

        name = str(name)

        def apply():
            if self._store is None:
                return api.importlayer(self.net, name, file, **kw)
            # the WAL record inlines the parsed edge list: recovery must
            # not depend on the imported file still existing unchanged
            return self._store.apply(
                _import_layer_op_from_file(self.net, name, file, **kw)
            )

        return self._mutate(
            apply, layer_scopes=self._layer_mutation_scopes(name)
        )

    def add_edges(self, layer: str, src, dst, values=None):
        from repro_torch.core import api

        layer = str(layer)

        def apply():
            if self._store is None:
                return api.addedges(self.net, layer, src, dst, values=values)
            from repro_torch.core.wal import make_add_edges_op

            return self._store.apply(
                make_add_edges_op(layer, src, dst, values)
            )

        return self._mutate(
            apply, layer_scopes=self._layer_mutation_scopes(layer)
        )

    def delete_edges(self, layer: str, src, dst):
        from repro_torch.core import api

        layer = str(layer)

        def apply():
            if self._store is None:
                return api.deleteedges(self.net, layer, src, dst)
            from repro_torch.core.wal import make_delete_edges_op

            return self._store.apply(make_delete_edges_op(layer, src, dst))

        return self._mutate(
            apply, layer_scopes=self._layer_mutation_scopes(layer)
        )

    # -- stats ---------------------------------------------------------------

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "served": self._served,
                "rejected": self._rejected,
                "coalesced_dupes": self._coalesced_dupes,
                "pending_point": len(self._point),
                "pending_heavy": len(self._heavy),
                "uncollected": len(self._results),
                "results_dropped": self._results_dropped,
                "deadline_expired": self._deadline_expired,
                "pump_faults": self._pump_faults,
                "batches": dict(self._batches),
                "dispatched": dict(self._dispatched),
                "shards": self._n_shards or 1,
                "cache": self._cache.stats(),
                "durable_lsn": (
                    None if self._store is None else self._store.last_lsn
                ),
            }

    @property
    def round_stats(self) -> dict:
        """Host time of the pump: rounds run, seconds spent inside them
        (dispatch included) and seconds the background pump waited for
        work."""
        with self._lock:
            return {"rounds": self._rounds, "round_s": self._round_s,
                    "pump_wait_s": self._pump_wait_s}


def _import_layer_op_from_file(net, name: str, file: str, **kw) -> dict:
    """Parse an import-layer TSV into a self-contained WAL op.

    Goes through ``import_layer_tsv`` (same validation/defaulting as the
    non-durable path) and then re-extracts the built layer's logical
    edge list, so the logged op replays to a bit-identical layer without
    the source file.
    """
    from repro_torch.core.io import import_layer_tsv
    from repro_torch.core.layers import LayerTwoMode, _one_mode_logical_edges
    from repro_torch.core.overlay import eff_coo
    from repro_torch.core.wal import make_import_layer_op

    layer = import_layer_tsv(file, net.n_nodes, device=net.device, **kw)
    if isinstance(layer, LayerTwoMode):
        rows, cols, _ = eff_coo(layer.memb, layer.memb_ov)
        return make_import_layer_op(
            name, rows, cols, mode=2, n_hyperedges=layer.n_hyperedges
        )
    src, dst, vals = _one_mode_logical_edges(layer)
    return make_import_layer_op(
        name, src, dst, mode=1, directed=layer.directed, values=vals
    )


# ---------------------------------------------------------------------------
# Trace files (the threadleR client format)
# ---------------------------------------------------------------------------


def parse_trace(text: str, *, path: str = "<trace>") -> list[dict]:
    """Parse a request trace: one JSON object per line; ``#`` comments and
    blank lines are skipped. See the module docstring for the schema.

    A final line without a newline terminator is still a record. If that
    unterminated tail is NOT complete JSON it is a record torn mid-write,
    and the parse raises ``core.io.TruncatedFileError`` rather than the
    generic bad-JSON ``ValueError`` a mid-file corruption gets.
    """
    import json

    lines = text.splitlines()
    unterminated_last = bool(text) and not text.endswith(("\n", "\r"))
    out = []
    for ln, line in enumerate(lines, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            if ln == len(lines) and unterminated_last:
                from repro_torch.core.io import TruncatedFileError

                raise TruncatedFileError(
                    path, ln,
                    "final trace line has no newline terminator and is "
                    "not complete JSON (record torn mid-write)",
                ) from None
            raise ValueError(f"trace line {ln}: bad JSON ({e})") from None
        if not isinstance(req, dict):
            raise ValueError(f"trace line {ln}: expected an object")
        out.append(req)
    return out


def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        return parse_trace(f.read(), path=str(path))
