"""Geo-serving subsystem: millions-of-users inference traffic priced on
the same fabric as training (the north-star "serves heavy traffic from
millions of users" workload).

Pieces:

* :mod:`repro.serving.traffic` — seeded open-loop request generation:
  per-DC user populations, rotating diurnal curves, heavy-tailed token
  counts; deterministic traces.
* :mod:`repro.serving.router` — session/KV-cache affinity with
  SLA-probe-driven cross-DC failover; migrations carry a concrete WAN
  byte cost.
* :mod:`repro.serving.engine` — flows + phases for each step, appended
  to the training schedule so :func:`~repro.core.congestion.
  simulate_schedule` co-schedules both through one max-min allocator;
  per-request latency read back from the per-flow timeline.
* :mod:`repro.serving.requests` — trace request -> real model batch
  (shared frontend logic with ``repro.launch.serve``).

Declared via :class:`~repro.scenario.spec.ServingSpec` on a
:class:`~repro.scenario.spec.Scenario`; scenarios without one keep the
runner's historical costing path byte-for-byte.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``); ``request_batch`` is the port's torch version.

from ..serving.engine import (
    MIGRATION_PHASE,
    SERVING_BASE_QPN,
    SERVING_PHASE,
    ServingEngine,
    ServingPlan,
    ServingStepStats,
)
from ..serving.requests import request_batch
from ..serving.router import FabricHealth, Route, SessionRouter
from ..serving.traffic import (
    Request,
    diurnal_factor,
    generate_trace,
    resolve_populations,
)

__all__ = [
    "FabricHealth",
    "MIGRATION_PHASE",
    "Request",
    "Route",
    "SERVING_BASE_QPN",
    "SERVING_PHASE",
    "ServingEngine",
    "ServingPlan",
    "ServingStepStats",
    "SessionRouter",
    "diurnal_factor",
    "generate_trace",
    "request_batch",
    "resolve_populations",
]
