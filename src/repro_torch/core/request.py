"""QueryRequest — the query-description currency.

The wire/trace schema maps 1:1 onto the fields:

    {"kind": "getedge",   "layer": L, "u": i, "v": j}
    {"kind": "alters",    "u": i [, "layers": [...]] [, "max_alters": m]}
    {"kind": "degree",    "u": i|[ids] [, "layers": [...]]}
    {"kind": "khop",      "sources": [ids], "k": k [, "layers": [...]]
                          [, "max_frontier": f]}
    {"kind": "walkbatch", "starts": i|[ids], "steps": n [, "walkers": w]
                          [, "seed": s] [, "layers": [...]]
                          [, "layer_weights": [...]]}

plus an optional ``"filter"``: a NodeSelection, a bool mask, or a spec
``{"attr": a, "op": eq|ne|lt|le|gt|ge|has [, "value": v]}`` resolved
against the network's attribute store, and an optional ``"timeout"``.
A ``walkbatch`` draws from ``core/prng.py``'s ``key(seed)``, so its paths
equal the JAX package's for the same request.

:func:`run_query` executes one request; :func:`run_queries` a batch,
grouped so requests sharing kind, static arguments and filter run as one
batched dispatch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

from .nodeset import node_filter_mask

__all__ = [
    "QueryRequest",
    "CanonicalRequest",
    "canonical_request",
    "run_query",
    "run_queries",
    "merge_filter_kwargs",
    "POINT_KINDS",
    "HEAVY_KINDS",
    "REQUEST_KINDS",
]

POINT_KINDS = ("getedge", "alters", "degree")
HEAVY_KINDS = ("khop", "walkbatch")
REQUEST_KINDS = POINT_KINDS + HEAVY_KINDS

_DEFAULT_MAX_ALTERS = 4096


def merge_filter_kwargs(filter, node_filter, *, stacklevel: int = 3):
    """Collapse the legacy ``node_filter=`` kwarg into ``filter=``
    (DeprecationWarning; passing both is an error)."""
    if node_filter is None:
        return filter
    warnings.warn(
        "node_filter= is deprecated; use filter= (the unified kwarg "
        "accepted everywhere a QueryRequest is built)",
        DeprecationWarning,
        stacklevel=stacklevel,
    )
    if filter is not None:
        raise ValueError("pass filter= or node_filter=, not both")
    return node_filter


@dataclass(frozen=True)
class QueryRequest:
    """One typed query description (the trace/wire schema, as fields).

    Only the fields a kind uses are set; the rest stay ``None``.
    Converts losslessly to/from the wire dict form.
    """

    kind: str
    layer: str | None = None            # getedge
    layers: Any = None                  # layer-name selection (None = all)
    u: Any = None                       # getedge / alters / degree
    v: Any = None                       # getedge
    sources: Any = None                 # khop
    k: int | None = None                # khop
    max_frontier: int | None = None     # khop
    max_alters: int | None = None       # alters
    starts: Any = None                  # walkbatch
    steps: int | None = None            # walkbatch
    walkers: int | None = None          # walkbatch
    seed: int | None = None             # walkbatch
    layer_weights: Any = None           # walkbatch
    filter: Any = None                  # NodeSelection | bool mask | spec
    timeout: float | None = None        # seconds (serve deadline budget)

    @classmethod
    def from_dict(cls, d: dict) -> "QueryRequest":
        """Wire/trace dict -> QueryRequest. Unknown keys are ignored; the
        legacy ``node_filter`` key maps onto ``filter``."""
        if not isinstance(d, dict):
            raise TypeError(
                f"request must be a dict or QueryRequest, got {type(d).__name__}"
            )
        kw = {k: d[k] for k in d if k in _FIELD_NAMES and k != "kind"}
        if "node_filter" in d:
            kw["filter"] = merge_filter_kwargs(
                kw.get("filter"), d["node_filter"], stacklevel=3
            )
        return cls(kind=str(d.get("kind", "")), **kw)

    @classmethod
    def from_any(cls, req) -> "QueryRequest":
        return req if isinstance(req, cls) else cls.from_dict(req)

    @classmethod
    def getedge(cls, layer, u, v, *, filter=None, timeout=None):
        return cls(kind="getedge", layer=str(layer), u=u, v=v,
                   filter=filter, timeout=timeout)

    @classmethod
    def alters(cls, u, *, layers=None, max_alters=None, filter=None,
               timeout=None):
        return cls(kind="alters", u=u, layers=layers,
                   max_alters=max_alters, filter=filter, timeout=timeout)

    @classmethod
    def degree(cls, u, *, layers=None, filter=None, timeout=None):
        return cls(kind="degree", u=u, layers=layers, filter=filter,
                   timeout=timeout)

    @classmethod
    def khop(cls, sources, k, *, layers=None, max_frontier=None,
             filter=None, timeout=None):
        return cls(kind="khop", sources=sources, k=k, layers=layers,
                   max_frontier=max_frontier, filter=filter,
                   timeout=timeout)

    @classmethod
    def walkbatch(cls, starts, steps, *, walkers=None, seed=None,
                  layers=None, layer_weights=None, filter=None,
                  timeout=None):
        return cls(kind="walkbatch", starts=starts, steps=steps,
                   walkers=walkers, seed=seed, layers=layers,
                   layer_weights=layer_weights, filter=filter,
                   timeout=timeout)

    def to_dict(self) -> dict:
        """QueryRequest -> the wire/trace dict (``None`` fields omitted)."""
        out = {"kind": self.kind}
        for f in dataclasses.fields(self):
            if f.name == "kind":
                continue
            val = getattr(self, f.name)
            if val is not None:
                out[f.name] = val
        return out


_FIELD_NAMES = frozenset(f.name for f in dataclasses.fields(QueryRequest))


# ---------------------------------------------------------------------------
# Request canonicalization
# ---------------------------------------------------------------------------


def _canon_ids(x, *, what: str) -> tuple[int, ...]:
    """Scalar id or id-list -> tuple of ints (the canonical batch form)."""
    if isinstance(x, (list, tuple, np.ndarray)):
        ids = tuple(int(i) for i in np.asarray(x).reshape(-1))
        if not ids:
            raise ValueError(f"{what} must not be empty")
        return ids
    return (int(x),)


def _canon_layers(net, layers) -> tuple[str, ...] | None:
    if layers is None:
        return None
    names = tuple(
        str(n) for n in (layers if isinstance(layers, (list, tuple)) else [layers])
    )
    for n in names:
        net.layer(n)  # raises KeyError on unknown layers
    return names


def _filter_fingerprint(mask: np.ndarray | None) -> str | None:
    """Stable content hash of a filter mask (group/cache-key component)."""
    if mask is None:
        return None
    return hashlib.blake2b(mask.tobytes(), digest_size=16).hexdigest()


def _resolve_filter(net, spec, memo: dict | None = None):
    """Filter spec -> (host bool mask | None, fingerprint | None).

    Resolving walks the attribute store or copies the mask and hashes
    O(n_nodes) bytes; ``memo`` (one per :func:`run_queries` batch, keyed
    by the spec object's identity) makes a batch that shares one filter
    object pay for that once.
    """
    if spec is None:
        return None, None
    if memo is not None and id(spec) in memo:
        return memo[id(spec)][1:]
    if isinstance(spec, dict):
        mask = net.nodeset.select(
            str(spec["attr"]), str(spec["op"]), spec.get("value")
        ).mask
    else:
        nf = node_filter_mask(spec, net.n_nodes)
        if hasattr(nf, "detach"):
            nf = nf.detach().cpu().numpy()
        mask = np.asarray(nf, dtype=bool)
    fp = _filter_fingerprint(mask)
    if memo is not None:
        memo[id(spec)] = (spec, mask, fp)  # pins spec: its id stays unique
    return mask, fp


@dataclass(frozen=True)
class CanonicalRequest:
    """A request after canonicalization: hashable keys + dispatch args."""

    kind: str
    group_key: tuple        # static args shared by a coalescible batch
    cache_key: tuple        # group_key + per-request args
    ids: tuple[int, ...]    # the batchable id payload
    ids2: tuple[int, ...]   # second id payload (getedge v), else ()
    mask: np.ndarray | None = field(compare=False, hash=False, default=None)


def _need(val, name: str):
    if val is None:
        raise KeyError(name)
    return val


def canonical_request(net, req, *, _filter_memo: dict | None = None
                      ) -> CanonicalRequest:
    """Validate + canonicalize one request (dict or QueryRequest).

    Raises ``ValueError`` / ``KeyError`` on malformed requests.
    """
    q = QueryRequest.from_any(req)
    kind = str(q.kind)
    if kind not in REQUEST_KINDS:
        raise ValueError(
            f"unknown request kind {kind!r}; have {REQUEST_KINDS}"
        )
    mask, fp = _resolve_filter(net, q.filter, _filter_memo)

    if kind == "getedge":
        layer = str(_need(q.layer, "layer"))
        net.layer(layer)
        u, v = (int(_need(q.u, "u")),), (int(_need(q.v, "v")),)
        gk = (kind, layer, fp)
        return CanonicalRequest(kind, gk, gk + (u, v), u, v, mask)

    if kind == "alters":
        layers = _canon_layers(net, q.layers)
        m = _DEFAULT_MAX_ALTERS if q.max_alters is None else int(q.max_alters)
        if m < 1:
            raise ValueError(f"max_alters must be >= 1, got {m}")
        u = (int(_need(q.u, "u")),)
        gk = (kind, layers, m, fp)
        return CanonicalRequest(kind, gk, gk + (u,), u, (), mask)

    if kind == "degree":
        layers = _canon_layers(net, q.layers)
        u = _canon_ids(_need(q.u, "u"), what="u")
        gk = (kind, layers, fp)
        return CanonicalRequest(kind, gk, gk + (u,), u, (), mask)

    if kind == "khop":
        layers = _canon_layers(net, q.layers)
        k = int(_need(q.k, "k"))
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        mf = None if q.max_frontier is None else int(q.max_frontier)
        src = _canon_ids(_need(q.sources, "sources"), what="sources")
        gk = (kind, layers, k, mf, fp)
        return CanonicalRequest(kind, gk, gk + (src,), src, (), mask)

    # walkbatch: the draws couple rows across a batch, so each distinct
    # request is its own dispatch group
    layers = _canon_layers(net, q.layers)
    steps = int(_need(q.steps, "steps"))
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    walkers = 1 if q.walkers is None else int(q.walkers)
    seed = 0 if q.seed is None else int(q.seed)
    weights = q.layer_weights
    weights = (
        None if weights is None
        else tuple(float(w) for w in np.atleast_1d(weights))
    )
    starts = _canon_ids(_need(q.starts, "starts"), what="starts")
    gk = (kind, layers, steps, walkers, seed, weights, fp, starts)
    return CanonicalRequest(kind, gk, gk, starts, (), mask)


# ---------------------------------------------------------------------------
# Batched group executors (one device dispatch per coalesced group)
# ---------------------------------------------------------------------------


def _exec_getedge(net, group_key, creqs):
    _, layer_name, _ = group_key
    u = np.asarray([c.ids[0] for c in creqs], np.int32)
    v = np.asarray([c.ids2[0] for c in creqs], np.int32)
    vals = net.edge_value(layer_name, u, v, node_filter=creqs[0].mask)
    vals = vals.cpu().numpy()
    return [float(vals[i]) for i in range(len(creqs))]


def _exec_alters(net, group_key, creqs):
    _, layers, max_alters, _ = group_key
    u = np.asarray([c.ids[0] for c in creqs], np.int32)
    vals, mask = net.node_alters(
        u, max_alters, layers, node_filter=creqs[0].mask
    )
    vals, mask = vals.cpu().numpy(), mask.cpu().numpy()
    return [vals[i][mask[i]] for i in range(len(creqs))]


def _exec_degree(net, group_key, creqs):
    _, layers, _ = group_key
    flat = [i for c in creqs for i in c.ids]
    out = net.degree(
        np.asarray(flat, np.int32), layers, node_filter=creqs[0].mask
    ).cpu().numpy()
    res, lo = [], 0
    for c in creqs:
        hi = lo + len(c.ids)
        res.append(int(out[lo]) if len(c.ids) == 1 else out[lo:hi].astype(int))
        lo = hi
    return res


def _exec_khop(net, group_key, creqs):
    from .traversal import khop_records

    _, layers, k, mf, _ = group_key
    flat = [s for c in creqs for s in c.ids]
    nodes, mask, hops = net.khop(
        np.asarray(flat, np.int32), k, max_frontier=mf,
        layer_names=layers, node_filter=creqs[0].mask,
    )
    records = khop_records(flat, nodes, mask, hops)
    res, lo = [], 0
    for c in creqs:
        hi = lo + len(c.ids)
        res.append(records[lo:hi])
        lo = hi
    return res


def _exec_walkbatch(net, group_key, creqs):
    from . import prng
    from .traversal import random_walk_batch

    _, layers, steps, walkers, seed, weights, _, starts = group_key
    paths = random_walk_batch(
        net, np.asarray(starts, np.int32), steps, prng.key(seed),
        walkers_per_start=walkers, layer_names=layers,
        layer_weights=weights, node_filter=creqs[0].mask,
    )
    return [paths.cpu().numpy()] * len(creqs)


_EXECUTORS = {
    "getedge": _exec_getedge,
    "alters": _exec_alters,
    "degree": _exec_degree,
    "khop": _exec_khop,
    "walkbatch": _exec_walkbatch,
}


def run_query(net, req):
    """Execute ONE request with no queue, no coalescing, no cache."""
    c = canonical_request(net, req)
    return _EXECUTORS[c.kind](net, c.group_key, [c])[0]


def run_queries(net, reqs: Iterable) -> list:
    """Execute a request batch; requests sharing a dispatch group key
    (kind + static args + filter fingerprint) run as ONE batched
    dispatch. Results return in request order."""
    memo: dict = {}
    creqs = [canonical_request(net, r, _filter_memo=memo) for r in reqs]
    out: list = [None] * len(creqs)
    groups: dict[tuple, list[int]] = {}
    for i, c in enumerate(creqs):
        groups.setdefault(c.group_key, []).append(i)
    for gk, idxs in groups.items():
        vals = _EXECUTORS[gk[0]](net, gk, [creqs[i] for i in idxs])
        for i, v in zip(idxs, vals):
            out[i] = v
    return out
