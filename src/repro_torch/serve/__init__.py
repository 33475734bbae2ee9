"""repro_torch.serve — the graph-query serving engine (threadleR's server
side) on the PyTorch port.

``serve/`` serves *graph queries* from a resident Network (micro-batching
+ result cache + backpressure — see graph_engine.py). The network-facing
pieces layer on top: ``frontend.py`` (NDJSON/TCP transport + HTTP health
probes), ``client.py`` (retrying client), ``resilience.py`` (deadlines,
idempotency, admission control, health), ``faults.py`` (the deterministic
chaos harness). The LM prefill/decode engine is
``repro_torch.models.lm_serve``.
"""

from repro_torch.core.request import QueryRequest

from .client import GraphServeClient, ServeError, Unavailable
from .faults import ConnectionDropped, FaultPlan, FaultSpec, InjectedFault
from .frontend import GraphServeFrontend
from .graph_engine import (
    GraphServeEngine,
    EngineClosed,
    QueryResult,
    QueueFull,
    HEAVY_KINDS,
    POINT_KINDS,
    REQUEST_KINDS,
    assert_results_equal,
    canonical_request,
    load_trace,
    parse_trace,
    run_request,
)
from .resilience import (
    AdmissionController,
    AdmissionPolicy,
    DeadlineExceeded,
    IdempotencyCache,
    RetryPolicy,
    deadline_from_ms,
    degraded_reference,
    health,
    readiness,
)

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "ConnectionDropped",
    "DeadlineExceeded",
    "EngineClosed",
    "FaultPlan",
    "FaultSpec",
    "GraphServeClient",
    "GraphServeEngine",
    "GraphServeFrontend",
    "IdempotencyCache",
    "InjectedFault",
    "QueryRequest",
    "QueryResult",
    "QueueFull",
    "RetryPolicy",
    "ServeError",
    "Unavailable",
    "HEAVY_KINDS",
    "POINT_KINDS",
    "REQUEST_KINDS",
    "assert_results_equal",
    "canonical_request",
    "deadline_from_ms",
    "degraded_reference",
    "health",
    "load_trace",
    "parse_trace",
    "readiness",
    "run_request",
]
