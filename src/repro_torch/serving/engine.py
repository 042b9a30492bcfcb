"""The serving engine: turns a step's request trace into concrete fabric
flows and reads per-request latencies back out of the congestion
simulator's per-flow timeline.

Co-scheduling is structural, not additive: the engine emits its flows as
extra dependency-free :class:`~repro.core.schedule.Phase`\\ s appended to
the step's training schedule, so :func:`~repro.core.congestion.
simulate_schedule` runs training collectives and serving transfers as
concurrent flow classes through the *same* weighted max-min allocator.
A training AllReduce burst steals spine-WAN capacity from in-flight
request handoffs (inflating serving p99), and heavy serving load slows
the AllReduce — both directions fall out of the allocator, nothing is
hand-priced.

What a request's flow models: the prefill -> decode-host KV handoff
(``tokens * kv_bytes_per_token`` bytes) from the home DC's ingress
leader to the user's pinned decode host — intra-DC for home-served
sessions, spine-WAN for the ``remote_fraction`` class and for failed-over
sessions.  Migration flows (``session_tokens * kv_bytes_per_token``
leader-to-leader) ride a second phase.  Latency per request is the
simulator's ``completion - start`` for its flow; requests with no wire
cost (single-host DCs) count as 0 ms.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..core.flows import Flow, open_loop_flows
from ..core.schedule import Phase
from ..scenario.spec import ServingSpec
from ..serving.router import FabricHealth, Route, SessionRouter
from ..serving.traffic import Request, generate_trace

__all__ = [
    "MIGRATION_PHASE",
    "SERVING_BASE_QPN",
    "SERVING_PHASE",
    "ServingEngine",
    "ServingPlan",
    "ServingStepStats",
]

#: Phase names the engine appends to each step's schedule.
SERVING_PHASE = "serving_rq"
MIGRATION_PHASE = "serving_kv"
#: QPN plane for serving flows, disjoint from the collectives' 0x11.
SERVING_BASE_QPN = 0x5E0000
#: flow_id offset separating migration QPNs from request QPNs.
_MIGRATION_FLOW_BASE = 1_000_000


@dataclass(frozen=True)
class ServingStepStats:
    """One step's serving rollup, the serving-side sibling of the
    runner's per-step :class:`~repro.core.geo.SyncCost` record."""

    step: int
    requests: int
    dropped: int
    tokens: int
    remote_requests: int
    migrated_sessions: int
    migration_bytes: int
    slo_misses: int
    p50_ms: float
    p99_ms: float
    latencies_ms: Tuple[float, ...] = ()

    @property
    def slo_miss_frac(self) -> float:
        if self.requests == 0:
            return 0.0
        return self.slo_misses / self.requests

    def to_dict(self) -> Dict[str, object]:
        return {
            "step": self.step,
            "requests": self.requests,
            "dropped": self.dropped,
            "tokens": self.tokens,
            "remote_requests": self.remote_requests,
            "migrated_sessions": self.migrated_sessions,
            "migration_bytes": self.migration_bytes,
            "slo_misses": self.slo_misses,
            "slo_miss_frac": self.slo_miss_frac,
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
        }


@dataclass(frozen=True)
class ServingPlan:
    """One step's serving flows, pre-simulation.  ``placements`` holds
    ``(request, route, has_flow)`` in emission order — exactly the order
    the request flows occupy the :data:`SERVING_PHASE` slice of the
    report's per-flow arrays."""

    step: int
    phases: Tuple[Phase, ...]
    placements: Tuple[Tuple[Request, Route, bool], ...]
    dropped: int
    remote_requests: int
    migrated_sessions: int
    migration_bytes: int


@dataclass
class ServingEngine:
    """Per-scenario serving state: the precomputed trace, the sticky
    session router, and the accumulated per-step stats."""

    spec: ServingSpec
    num_dcs: int
    num_steps: int
    port_scheme: str = "qp_aware"
    trace: Tuple[Tuple[Request, ...], ...] = field(init=False)
    router: SessionRouter = field(init=False)
    kv_bytes_per_token: int = field(init=False)
    session_kv_bytes: int = field(init=False)
    stats: List[ServingStepStats] = field(init=False, default_factory=list)
    _mig_seq: int = field(init=False, default=0)

    def __post_init__(self):
        self.trace = generate_trace(self.spec, self.num_dcs, self.num_steps)
        self.router = SessionRouter(self.spec, self.num_dcs)
        self.kv_bytes_per_token = self.spec.resolve_kv_bytes_per_token()
        self.session_kv_bytes = self.kv_bytes_per_token * self.spec.session_tokens

    def plan_step(self, step: int, geo, health: FabricHealth) -> ServingPlan:
        """Route this step's requests and synthesize their flows.

        A failover sweep runs first: every tracked session sitting on a
        now-unhealthy placement is re-homed (and pays its migration
        bytes) before this step's requests route."""
        leaders = geo.pod_leaders()
        rq_flows: List[Flow] = []
        mig_flows: List[Flow] = []
        placements: List[Tuple[Request, Route, bool]] = []
        dropped = remote = migrated = 0
        migration_bytes = 0

        for _home, _user, _old, route in self.router.rehome_all(health):
            migrated += 1
            if route.kv_source is not None and self.session_kv_bytes > 0:
                migration_bytes += self.session_kv_bytes
                self._mig_seq += 1
                mig_flows += open_loop_flows(
                    leaders[route.kv_source - 1],
                    leaders[route.serving_dc - 1],
                    _MIGRATION_FLOW_BASE + self._mig_seq,
                    self.session_kv_bytes,
                    scheme=self.port_scheme,
                    base_qpn=SERVING_BASE_QPN,
                )

        for req in self.trace[step]:
            route = self.router.route(req.home_dc, req.user, health)
            if route is None:
                dropped += 1
                continue
            serving_dc = route.serving_dc
            # ingress: traffic enters where the user is — unless their
            # whole DC is down, in which case they reconnect at the
            # failover DC directly.
            ingress_dc = req.home_dc if health.dc_ok(req.home_dc) else serving_dc
            if serving_dc != req.home_dc:
                remote += 1
            if route.migrated:
                migrated += 1
                if route.kv_source is not None and self.session_kv_bytes > 0:
                    migration_bytes += self.session_kv_bytes
                    self._mig_seq += 1
                    mig_flows += open_loop_flows(
                        leaders[route.kv_source - 1],
                        leaders[serving_dc - 1],
                        _MIGRATION_FLOW_BASE + self._mig_seq,
                        self.session_kv_bytes,
                        scheme=self.port_scheme,
                        base_qpn=SERVING_BASE_QPN,
                    )

            ingress = leaders[ingress_dc - 1]
            hosts = geo.workers(serving_dc)
            nbytes = req.tokens * self.kv_bytes_per_token
            if ingress_dc == serving_dc:
                # home-served: ingress leader -> the user's decode host
                if len(hosts) > 1 and nbytes > 0:
                    dst = hosts[1 + req.user % (len(hosts) - 1)]
                    rq_flows += open_loop_flows(
                        ingress, dst, req.rid, nbytes,
                        scheme=self.port_scheme, base_qpn=SERVING_BASE_QPN,
                    )
                    placements.append((req, route, True))
                else:
                    placements.append((req, route, False))
            else:
                # cross-DC: the KV handoff rides the spine WAN
                dst = hosts[req.user % len(hosts)]
                if nbytes > 0:
                    rq_flows += open_loop_flows(
                        ingress, dst, req.rid, nbytes,
                        scheme=self.port_scheme, base_qpn=SERVING_BASE_QPN,
                    )
                    placements.append((req, route, True))
                else:
                    placements.append((req, route, False))

        phases: List[Phase] = []
        if rq_flows:
            phases.append(Phase(SERVING_PHASE, flows=tuple(rq_flows)))
        if mig_flows:
            phases.append(Phase(MIGRATION_PHASE, flows=tuple(mig_flows)))
        return ServingPlan(
            step=step,
            phases=tuple(phases),
            placements=tuple(placements),
            dropped=dropped,
            remote_requests=remote,
            migrated_sessions=migrated,
            migration_bytes=migration_bytes,
        )

    def finish_step(self, plan: ServingPlan, report=None) -> ServingStepStats:
        """Read per-request latencies out of the simulated report and
        roll up this step's stats."""
        import numpy as np

        latencies: List[float] = []
        if report is not None and any(p.name == SERVING_PHASE for p in plan.phases):
            timing = report.phase(SERVING_PHASE)
            # one flow per placed request with has_flow, in emission order
            idx = timing.flow_lo
            for _req, _route, has_flow in plan.placements:
                if has_flow:
                    lat = (
                        float(report.completion_s[idx])
                        - float(report.flow_start_s[idx])
                    ) * 1e3
                    latencies.append(lat)
                    idx += 1
                else:
                    latencies.append(0.0)
        else:
            latencies = [0.0] * len(plan.placements)

        requests = len(plan.placements) + plan.dropped
        tokens = sum(req.tokens for req, _r, _h in plan.placements)
        arr = np.asarray(latencies, dtype=float)
        p50 = float(np.percentile(arr, 50)) if len(arr) else 0.0
        p99 = float(np.percentile(arr, 99)) if len(arr) else 0.0
        slo_misses = int((arr > self.spec.slo_ms).sum()) + plan.dropped
        stats = ServingStepStats(
            step=plan.step,
            requests=requests,
            dropped=plan.dropped,
            tokens=tokens,
            remote_requests=plan.remote_requests,
            migrated_sessions=plan.migrated_sessions,
            migration_bytes=plan.migration_bytes,
            slo_misses=slo_misses,
            p50_ms=p50,
            p99_ms=p99,
            latencies_ms=tuple(latencies),
        )
        self.stats.append(stats)
        return stats
