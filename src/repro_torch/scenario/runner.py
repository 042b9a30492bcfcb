"""Execute a declarative :class:`~repro.scenario.spec.Scenario`.

``run_scenario`` builds the emulated deployment from the spec, replays the
event script step by step (link flaps through the BFD/BGP failure
detector — which drives the fabric's incremental re-convergence and the
EVPN incremental resync — tenant churn through the tenancy manager,
straggler injection into the compute term), costs every training step with
the spec's :class:`~repro.core.geo.SyncOptions`, and returns a
:class:`ScenarioResult`:

* a per-step timeline (modeled seconds, WAN sync seconds, straggler
  factor, the events that fired);
* rollups of the three observability records the substrate already emits —
  :class:`~repro.core.geo.SyncCost` (a deterministic jitter-free
  representative), :class:`~repro.core.bfd.RecoveryTimeline` per failure,
  :class:`~repro.core.evpn.EvpnResyncStats` per control-plane resync;
* ``metrics()`` — the flat deterministic observables the CI baseline gate
  (``benchmarks/compare.py``) consumes — and ``to_dict()`` — the full
  JSON-serializable record.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.bfd import RecoveryTimeline
from ..core.evpn import EvpnResyncStats
from ..core.fabric import RerouteStats, UnreachableError
from ..core.geo import GeoFabric, SyncCost
from ..core.schedule import build_schedule, with_compute_overlap
from ..core.slaprobe import ProbeState, ProbeTransition, SlaProbeBank
from ..scenario.spec import DegradationPolicy, Scenario, ScenarioEvent

__all__ = [
    "PodRecovery",
    "ScenarioResult",
    "StepRecord",
    "apply_event",
    "run_scenario",
]


@dataclass(frozen=True)
class StepRecord:
    """One emulated training step of a scenario."""

    step: int
    seconds: float  # modeled wall time of the step (compute + exposed sync)
    sync_seconds: float  # the step's WAN sync term (amortized)
    compute_seconds: float  # compute term after straggler scaling
    straggler_factor: float
    events: Tuple[str, ...] = ()  # kinds of the events that fired this step
    strategy: str = ""  # schedule actually costed (policy may have switched it)
    degraded: bool = False  # was a DegradationPolicy adaptation active?
    downtime_seconds: float = 0.0  # pod-loss detect/restore/remesh paid this step

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["events"] = list(self.events)
        return d


@dataclass(frozen=True)
class PodRecovery:
    """One priced pod-loss episode: heartbeat detection -> checkpoint
    restore -> elastic remesh, as the runner executed it."""

    pod: int
    failed_at_step: int
    detected_at_step: int
    plan: object  # repro.runtime.failure.RecoveryPlan
    mesh: object  # repro.runtime.elastic.MeshPlan

    def to_dict(self) -> Dict[str, object]:
        return {
            "pod": self.pod,
            "failed_at_step": self.failed_at_step,
            "detected_at_step": self.detected_at_step,
            "detection_s": float(self.plan.detection_s),
            "restore_s": float(self.plan.restore_s),
            "remesh_s": float(self.plan.remesh_s),
            "lost_steps": int(self.plan.lost_steps),
            "lost_work_s": float(self.plan.lost_work_s),
            "total_downtime_s": float(self.plan.total_downtime_s),
            "total_cost_s": float(self.plan.total_cost_s),
            "mesh": self.mesh.to_dict(),
        }


def _sync_cost_dict(c: SyncCost) -> Dict[str, object]:
    return {
        "strategy": c.strategy,
        "wan_seconds": float(c.wan_seconds),
        "amortized_seconds": float(c.amortized_seconds),
        "wan_bytes": int(c.wan_bytes),
        "sync_every": int(c.sync_every),
        "bottleneck_link": None if c.bottleneck_link is None else list(c.bottleneck_link),
        "bottleneck_bytes": int(c.bottleneck_bytes),
        "bottleneck_utilization": float(c.bottleneck_utilization),
        "load_factor": float(c.load.load_factor),
        "phases": [
            {
                "name": p.name,
                "start_s": float(p.start_s),
                "end_s": float(p.end_s),
                "wan_bytes": int(p.wan_bytes),
            }
            for p in c.phases
        ],
    }


def _recovery_dict(t: RecoveryTimeline) -> Dict[str, object]:
    return {
        "mechanism": t.mechanism,
        "recovery_ms": float(t.recovery_ms),
        "detect_ms": float(t.detected_at_ms - t.failure_at_ms),
    }


def _resync_dict(s: EvpnResyncStats) -> Dict[str, object]:
    return {
        "link": list(s.link),
        "action": s.action,
        "patched": s.patched,
        "rebuilt": s.rebuilt,
        "retained": s.retained,
        "vtep_touched_frac": float(s.vtep_touched_frac),
    }


@dataclass
class ScenarioResult:
    """Everything one scenario run produced.

    ``geo`` is the live emulated deployment (post-events) so thin bench
    wrappers can keep probing it; it is deliberately absent from
    ``to_dict()``.
    """

    scenario: Scenario
    steps: List[StepRecord]
    sync: Optional[SyncCost]  # jitter-free representative sync cost
    recoveries: List[RecoveryTimeline] = field(default_factory=list)
    reroutes: List[RerouteStats] = field(default_factory=list)
    evpn_resyncs: List[EvpnResyncStats] = field(default_factory=list)
    geo: Optional[GeoFabric] = None
    probe_transitions: List[ProbeTransition] = field(default_factory=list)
    pod_recoveries: List[PodRecovery] = field(default_factory=list)
    #: (at_step, pod) per pod_fail event, recorded by apply_event so the
    #: trainer's replay sees them too; the runner's heartbeat loop prices them
    pod_failures: List[Tuple[int, int]] = field(default_factory=list)
    #: per-step ServingStepStats when the scenario carries a ServingSpec
    serving_steps: List = field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        return float(sum(s.seconds for s in self.steps))

    @property
    def mean_step_seconds(self) -> float:
        return self.total_seconds / len(self.steps) if self.steps else 0.0

    @property
    def evpn_mean_touched_frac(self) -> float:
        if not self.evpn_resyncs:
            return 0.0
        return float(
            sum(s.vtep_touched_frac for s in self.evpn_resyncs)
            / len(self.evpn_resyncs)
        )

    def metrics(self) -> Dict[str, float]:
        """Deterministic gated observables for ``benchmarks/compare.py``.

        Only seeded model outputs belong here (the compare-gate contract
        of ``benchmarks/common.py``); wall-clock never does.  Keys follow
        the direction-by-suffix convention (``*_seconds``/``*_frac`` lower
        is better, etc.).
        """
        out: Dict[str, float] = {}
        if self.steps:
            out["total_step_seconds"] = self.total_seconds
            out["mean_step_seconds"] = self.mean_step_seconds
        if self.sync is not None:
            out["sync_wan_seconds"] = float(self.sync.wan_seconds)
            out["sync_wan_bytes"] = float(self.sync.wan_bytes)
        if self.recoveries:
            out["mean_recovery_ms"] = float(
                sum(t.recovery_ms for t in self.recoveries) / len(self.recoveries)
            )
        if self.evpn_resyncs:
            out["evpn_mean_touched_frac"] = self.evpn_mean_touched_frac
        if self.probe_transitions:
            out["probe_trip_count"] = float(
                sum(1 for t in self.probe_transitions if t.state == ProbeState.DEGRADED)
            )
            trips = [
                t.at_ms for t in self.probe_transitions
                if t.state == ProbeState.DEGRADED
            ]
            if trips:
                out["probe_first_trip_ms"] = float(min(trips))
        if self.pod_recoveries:
            out["pod_lost_work_seconds"] = float(
                sum(r.plan.lost_work_s for r in self.pod_recoveries)
            )
            out["pod_downtime_seconds"] = float(
                sum(r.plan.total_downtime_s for r in self.pod_recoveries)
            )
            out["pod_total_cost_seconds"] = float(
                sum(r.plan.total_cost_s for r in self.pod_recoveries)
            )
        if self.serving_steps:
            import numpy as np

            requests = sum(s.requests for s in self.serving_steps)
            out["serving_requests"] = float(requests)
            lat = [l for s in self.serving_steps for l in s.latencies_ms]
            if lat:
                out["serving_p50_ms"] = float(np.percentile(lat, 50))
                out["serving_p99_ms"] = float(np.percentile(lat, 99))
            misses = sum(s.slo_misses for s in self.serving_steps)
            out["serving_slo_miss_frac"] = (
                float(misses) / requests if requests else 0.0
            )
            out["serving_migrated_sessions"] = float(
                sum(s.migrated_sessions for s in self.serving_steps)
            )
            out["serving_migration_bytes"] = float(
                sum(s.migration_bytes for s in self.serving_steps)
            )
        return out

    def to_dict(self) -> Dict[str, object]:
        return {
            "scenario": self.scenario.to_dict(),
            "steps": [s.to_dict() for s in self.steps],
            "sync": None if self.sync is None else _sync_cost_dict(self.sync),
            "recoveries": [_recovery_dict(t) for t in self.recoveries],
            "evpn_resyncs": [_resync_dict(s) for s in self.evpn_resyncs],
            "probe_transitions": [t.to_dict() for t in self.probe_transitions],
            "pod_recoveries": [r.to_dict() for r in self.pod_recoveries],
            "serving_steps": [s.to_dict() for s in self.serving_steps],
            "metrics": self.metrics(),
            "total_seconds": self.total_seconds,
        }


def _switch_links(geo: GeoFabric, node: str, *, down: bool) -> List[Tuple[str, str]]:
    """Links incident to ``node``, filtered by current state, sorted."""
    links = [
        tuple(sorted(l))
        for l in geo.fabric.all_links()
        if node in l and geo.fabric.link_up(*l) != down
    ]
    if not links and not any(node in l for l in geo.fabric.all_links()):
        raise ValueError(f"no links incident to node {node!r}")
    return sorted(links)


def _srlg_links(
    geo: GeoFabric, pairs: Tuple[Tuple[int, int], ...], *, down: bool
) -> List[Tuple[str, str]]:
    """WAN links of the SRLG's member DC pairs, filtered by state, sorted."""
    members = set(pairs)
    return sorted(
        tuple(sorted(l))
        for l in geo.fabric.wan_links
        if geo.fabric.wan_pair(*l) in members and geo.fabric.link_up(*l) != down
    )


def _apply_group_failure(
    geo: GeoFabric,
    result: ScenarioResult,
    links: List[Tuple[str, str]],
    *,
    mechanism: str,
    label: str,
) -> None:
    timeline, reroutes, resyncs = geo.detector.fail_group(
        links, mechanism=mechanism, label=label
    )
    result.recoveries.append(timeline)
    result.reroutes.extend(reroutes)
    result.evpn_resyncs.extend(resyncs)


def apply_event(
    event: ScenarioEvent,
    geo: GeoFabric,
    result: ScenarioResult,
    straggler: Dict[int, float],
) -> None:
    """Apply one :class:`ScenarioEvent` to a live deployment.

    Rollups (recovery timelines, reroute stats, EVPN resyncs) accumulate
    on ``result``; straggler multipliers accumulate per step index in
    ``straggler``.  Shared by :func:`run_scenario` and the scenario-driven
    :class:`repro.runtime.trainer.GeoTrainer`, so both replay an event
    script with identical semantics.
    """
    if event.kind == "fail_link":
        timeline = geo.detector.fail_and_recover(
            tuple(event.link), mechanism=event.mechanism
        )
        result.recoveries.append(timeline)
        if timeline.reroute is not None:
            result.reroutes.append(timeline.reroute)
        if timeline.evpn_resync is not None:
            result.evpn_resyncs.append(timeline.evpn_resync)
    elif event.kind == "restore_link":
        stats = geo.detector.restore(tuple(event.link))
        result.reroutes.append(stats)
        if geo.evpn.last_resync is not None:
            result.evpn_resyncs.append(geo.evpn.last_resync)
    elif event.kind == "tenant_attach":
        if event.tenant not in geo.tenancy.tenants:
            if event.vni is None:
                raise ValueError(
                    f"tenant_attach for new tenant {event.tenant!r} needs a vni"
                )
            geo.tenancy.create_tenant(event.tenant, vni=event.vni)
        geo.tenancy.attach(event.tenant, event.host)
    elif event.kind == "tenant_detach":
        geo.tenancy.detach(event.tenant, event.host)
    elif event.kind == "straggler":
        for s in range(event.at_step, event.at_step + event.duration_steps):
            straggler[s] = straggler.get(s, 1.0) * event.slowdown
    elif event.kind == "degrade_link":
        geo.netem.degrade_link(
            *event.link,
            bandwidth_fraction=event.bandwidth_fraction,
            extra_delay_ms=event.extra_delay_ms,
            extra_loss=event.extra_loss,
        )
    elif event.kind == "degrade_pair":
        geo.netem.degrade_pair(
            *event.pair,
            bandwidth_fraction=event.bandwidth_fraction,
            extra_delay_ms=event.extra_delay_ms,
            extra_loss=event.extra_loss,
        )
    elif event.kind == "restore_degradation":
        if event.link is not None:
            geo.netem.restore_link_profile(*event.link)
        else:
            geo.netem.restore_pair(*event.pair)
    elif event.kind == "fail_switch":
        links = _switch_links(geo, event.node, down=False)
        if links:
            _apply_group_failure(
                geo, result, links,
                mechanism=event.mechanism,
                label=f"switch {event.node} down",
            )
    elif event.kind == "restore_switch":
        down = _switch_links(geo, event.node, down=True)
        result.reroutes.extend(geo.detector.restore_group(down))
    elif event.kind == "fiber_cut":
        pairs = result.scenario.topology.srlg_pairs(event.srlg)
        links = _srlg_links(geo, pairs, down=False)
        if links:
            _apply_group_failure(
                geo, result, links,
                mechanism=event.mechanism,
                label=f"SRLG {event.srlg} cut ({len(pairs)} DC pairs)",
            )
    elif event.kind == "fiber_restore":
        pairs = result.scenario.topology.srlg_pairs(event.srlg)
        down = _srlg_links(geo, pairs, down=True)
        result.reroutes.extend(geo.detector.restore_group(down))
    elif event.kind == "pod_fail":
        if event.pod > geo.num_pods:
            raise ValueError(
                f"pod_fail pod {event.pod} outside pods 1..{geo.num_pods}"
            )
        result.pod_failures.append((event.at_step, int(event.pod)))
    else:  # pragma: no cover - spec validation rejects unknown kinds
        raise ValueError(f"unknown event kind {event.kind!r}")


def _wan_window_s(phases, fallback_s: float) -> float:
    """Span of the schedule's WAN-carrying phases (the comm observation
    window an SLA probe rates bytes against) — excludes a grafted compute
    head, so overlapped and pure-sync steps measure consistently."""
    spans = [(p.start_s, p.end_s) for p in phases if p.wan_bytes > 0]
    if not spans:
        return float(fallback_s)
    return max(e for _, e in spans) - min(s for s, _ in spans)


def _pair_rates(
    geo: GeoFabric, phases, fallback_s: float
) -> Dict[Tuple[int, int], float]:
    """Observed per-DC-pair WAN rate (Gbit/s) of the last costed schedule,
    from the fabric's routed byte counters and the comm window."""
    window = _wan_window_s(phases, fallback_s)
    if window <= 0.0:
        return {}
    pair_bytes: Dict[Tuple[int, int], int] = {}
    for (u, v), b in geo.fabric.link_bytes.items():
        if b and geo.fabric.is_wan_link(u, v):
            pair = geo.fabric.wan_pair(u, v)
            pair_bytes[pair] = pair_bytes.get(pair, 0) + b
    return {p: b * 8.0 / (window * 1e9) for p, b in pair_bytes.items()}


def _pair_rtt_ms(geo: GeoFabric, pair: Tuple[int, int]) -> float:
    """Jitter-free leader RTT of a DC pair; inf when partitioned."""
    leaders = geo.pod_leaders()
    try:
        return geo.netem.base_rtt_ms(leaders[pair[0] - 1], leaders[pair[1] - 1])
    except UnreachableError:
        return math.inf


def _fabric_health(geo: GeoFabric, probes: Optional[SlaProbeBank], dead_pods):
    """The serving router's per-step view of the fabric.

    A pair is bad when it is partitioned, when its SLA probe is tripped
    (scenarios with a :class:`DegradationPolicy` — detection with
    hysteresis, the realistic signal), or — probe-less — when ``Netem``
    currently degrades it (ground truth, reaction without detection lag).
    """
    from ..serving.router import FabricHealth

    alive = frozenset(
        p for p in range(1, geo.num_pods + 1) if p not in dead_pods
    )
    rtt: Dict[Tuple[int, int], float] = {}
    bad: set = set()
    for a in range(1, geo.num_pods + 1):
        for b in range(a + 1, geo.num_pods + 1):
            r = _pair_rtt_ms(geo, (a, b))
            rtt[(a, b)] = r
            if r == math.inf:
                bad.add((a, b))
    if probes is not None:
        bad.update(probes.tripped())
    else:
        bad.update(geo.netem.degraded_pairs)
    return FabricHealth(alive=alive, bad_pairs=frozenset(bad), rtt_ms=rtt)


def _serving_step(
    engine,
    geo: GeoFabric,
    step: int,
    *,
    training_active: bool,
    strategy,
    grad_bytes: int,
    compute: float,
    policy: Optional[DegradationPolicy],
    options,
    overlap_fraction: float,
    degraded: bool,
    dead_pods,
    probes: Optional[SlaProbeBank],
    baseline_rates: Dict[Tuple[int, int], float],
):
    """Cost one step with serving co-load: route the step's requests,
    append their flows as dependency-free phases to the (possibly
    policy-adapted) training schedule, and run both through
    :func:`~repro.core.congestion.simulate_schedule` — one max-min
    allocation prices the contention in both directions.

    Always the event-driven simulator (serving latency needs the per-flow
    timeline), always jitter-free (determinism is the serving contract).
    Returns ``(seconds, sync_seconds, strategy_name)`` for the training
    record, or ``None`` on serving-only steps.
    """
    from ..core.congestion import simulate_schedule
    from ..core.schedule import CollectiveSchedule

    health = _fabric_health(geo, probes, dead_pods)
    plan = engine.plan_step(step, geo, health)

    training_phases: Tuple = ()
    sync_every = 1
    strategy_name = ""
    eff_opts = options
    name = "serving"
    if training_active:
        eff_strategy, eff_grad = strategy, grad_bytes
        if degraded and policy is not None:
            if policy.fallback_strategy is not None and isinstance(strategy, str):
                eff_strategy = policy.fallback_strategy
            if policy.degraded_sync_every is not None:
                eff_opts = dataclasses.replace(
                    eff_opts, sync_every=policy.degraded_sync_every
                )
            if policy.int8_wan:
                eff_grad = max(int(grad_bytes * eff_opts.int8_ratio), 1)
        if isinstance(eff_strategy, str):
            schedule = build_schedule(
                eff_strategy,
                geo.strategy_context(tuple(sorted(dead_pods))),
                eff_grad,
                sync_every=eff_opts.sync_every,
                int8_ratio=eff_opts.int8_ratio,
            )
        else:
            schedule = eff_strategy
        strategy_name = schedule.name
        if compute > 0:
            schedule = with_compute_overlap(schedule, compute, overlap_fraction)
        training_phases = schedule.phases
        sync_every = max(schedule.sync_every, 1)
        name = f"{schedule.name}+serving"

    all_phases = tuple(training_phases) + plan.phases
    report = None
    if all_phases:
        combined = CollectiveSchedule(name, all_phases, sync_every=sync_every)
        report = simulate_schedule(
            geo.fabric,
            geo.netem,
            combined,
            check_reachability=geo.tenancy.reachable,
            ecmp_weighted=eff_opts.ecmp_weighted,
        )
    engine.finish_step(plan, report)

    if probes is not None and report is not None:
        rates = _pair_rates(geo, report.phase_timings, report.seconds)
        probe_now_ms = step * 1000.0  # one emulated second per step
        for pair in probes.pairs:
            probes.observe(
                pair,
                probe_now_ms,
                rate_gbps=rates.get(pair, baseline_rates.get(pair, 0.0)),
                rtt_ms=_pair_rtt_ms(geo, pair),
            )
    if not training_active:
        return None
    train_names = {p.name for p in training_phases}
    train_end = 0.0
    if report is not None:
        train_end = max(
            (p.end_s for p in report.phase_timings if p.name in train_names),
            default=0.0,
        )
    if compute > 0:
        exposed = max(train_end - compute, 0.0)
        sync_seconds = exposed / sync_every
        seconds = compute + sync_seconds
    else:
        sync_seconds = train_end / sync_every
        seconds = sync_seconds
    return seconds, sync_seconds, strategy_name


def run_scenario(
    scenario: Scenario, *, geo: Optional[GeoFabric] = None
) -> ScenarioResult:
    """Execute ``scenario`` and return its :class:`ScenarioResult`.

    ``geo`` overrides the topology build (reuse a warm fabric across a
    sweep — the spec's topology must describe it).  Steps run in order;
    each step first fires its events, then costs the training step under
    the (possibly changed) fabric state.  With ``compute_seconds > 0`` the
    step is :meth:`GeoFabric.step_time` (compute overlap as DAG
    structure, straggler factor applied to the compute term); otherwise
    it is the amortized sync cost alone.  The representative ``sync``
    rollup is costed jitter-free *before* any event fires, so it is a
    deterministic healthy-fabric baseline regardless of the event script.

    With a :class:`~repro.scenario.spec.DegradationPolicy` on the spec,
    the runner additionally closes the gray-failure loop: per-DC-pair
    :class:`~repro.core.slaprobe.SlaProbe`\\ s calibrate against the
    healthy representative, observe each step's achieved WAN rate and
    leader RTT, and — once tripped — the policy's graceful degradation
    (strategy fallback / raised sync period / int8 WAN compression)
    applies from the next step until the probes recover.  ``pod_fail``
    events drive the HeartbeatMonitor -> checkpoint-restore ->
    ``plan_remesh`` chain: detection is priced into the step timeline
    (``StepRecord.downtime_seconds``) and subsequent steps cost the
    surviving-pod schedule; per-episode :class:`PodRecovery` records land
    in the result.

    With a :class:`~repro.scenario.spec.ServingSpec` on the spec, every
    step additionally runs the geo-serving co-load: the
    :class:`~repro.serving.engine.ServingEngine` routes that step's
    deterministic request trace (sticky sessions, probe/degradation-driven
    failover) and its flows join the training schedule inside one
    event-driven max-min simulation — per-step
    :class:`~repro.serving.engine.ServingStepStats` land on
    ``result.serving_steps``.  Serving steps are always costed by the
    event-driven simulator and jitter-free; scenarios without a
    ``ServingSpec`` keep the historical costing path bit-for-bit.
    """
    geo = geo if geo is not None else scenario.topology.build()
    workload = scenario.workload
    grad_bytes = workload.resolve_grad_bytes()
    strategy = workload.strategy
    policy = scenario.policy
    result = ScenarioResult(scenario=scenario, steps=[], sync=None, geo=geo)

    # serving co-load: lazy import so scenarios without a ServingSpec never
    # pay for (or depend on) the serving subsystem
    engine = None
    if scenario.serving is not None:
        from ..serving.engine import ServingEngine

        engine = ServingEngine(
            scenario.serving,
            num_dcs=geo.num_pods,
            num_steps=scenario.num_steps,
            port_scheme=geo.port_scheme,
        )

    baseline_rates: Dict[Tuple[int, int], float] = {}
    if strategy is not None:
        result.sync = geo.sync_cost(
            strategy,
            grad_bytes,
            options=dataclasses.replace(scenario.options, jitter=False),
        )
        if policy is not None:
            baseline_rates = _pair_rates(
                geo, result.sync.phases, result.sync.wan_seconds
            )

    # gray-failure probes: one per WAN DC pair, calibrated on the healthy
    # representative (pairs the schedule never touches calibrate at rate 0,
    # which disables their rate floor but keeps the RTT ceiling live)
    probes: Optional[SlaProbeBank] = None
    if policy is not None and strategy is not None and geo.num_pods > 1:
        probes = SlaProbeBank(
            rate_floor_frac=policy.rate_floor_frac,
            rtt_ceiling_frac=policy.rtt_ceiling_frac,
            trip_after=policy.trip_after,
            recover_after=policy.recover_after,
        )
        for a in range(1, geo.num_pods + 1):
            for b in range(a + 1, geo.num_pods + 1):
                probes.calibrate(
                    (a, b),
                    rate_gbps=baseline_rates.get((a, b), 0.0),
                    rtt_ms=_pair_rtt_ms(geo, (a, b)),
                )
        result.probe_transitions = probes.transitions

    # pod-loss chain: a real HeartbeatMonitor on a step-indexed simulated
    # clock (one heartbeat interval per step), priced via plan_recovery +
    # the elastic coordinator's remesh plan.  Lazy import: repro.runtime
    # pulls in jax, which control-plane-only sweeps must not pay for.
    pricing = policy if policy is not None else DegradationPolicy()
    monitor = coordinator = None
    pod_names: List[str] = []
    if any(e.kind == "pod_fail" for e in scenario.events):
        from ..runtime.elastic import ElasticCoordinator
        from ..runtime.failure import HeartbeatMonitor

        pod_names = [f"pod{i}" for i in range(1, geo.num_pods + 1)]
        monitor = HeartbeatMonitor(
            pod_names,
            interval_ms=pricing.heartbeat_interval_ms,
            detect_mult=pricing.heartbeat_detect_mult,
            start_ms=0.0,
        )
        coordinator = ElasticCoordinator(
            pod_names, data=len(geo.workers(pod=1)), model=1
        )
    step_time_ref = workload.compute_seconds + (
        result.sync.amortized_seconds if result.sync is not None else 0.0
    )

    by_step: Dict[int, List[ScenarioEvent]] = {}
    for e in scenario.events:
        by_step.setdefault(e.at_step, []).append(e)
    straggler: Dict[int, float] = {}
    silenced: Dict[int, int] = {}  # pod -> step its heartbeats stopped
    dead_pods: set = set()

    # while no event has touched the fabric and the options are already
    # jitter-free, every pure-sync step costs exactly the representative
    # rollup — skip the duplicate congestion solve
    fabric_pristine = True
    reusable = result.sync is not None and not scenario.options.jitter

    for step in range(scenario.num_steps):
        fired = by_step.get(step, ())
        for event in fired:
            apply_event(event, geo, result, straggler)
            fabric_pristine = fabric_pristine and event.kind == "straggler"
            if event.kind == "pod_fail":
                silenced.setdefault(int(event.pod), step)
        downtime_s = 0.0
        if monitor is not None:
            now_ms = step * pricing.heartbeat_interval_ms
            for idx, name in enumerate(pod_names, 1):
                if idx not in silenced:
                    monitor.heartbeat(name, now_ms)
            for name in monitor.poll(now_ms):
                idx = int(name[len("pod"):])
                dead_pods.add(idx)
                from ..runtime.failure import plan_recovery

                mesh = coordinator.on_pod_lost(name, step)
                # rollback anchor: the last checkpoint *before* the pod
                # died — nothing taken after the death is globally valid
                failed_at = silenced.get(idx, step)
                plan = plan_recovery(
                    step=step,
                    last_checkpoint_step=(failed_at // pricing.checkpoint_every)
                    * pricing.checkpoint_every,
                    step_time_s=step_time_ref,
                    detect_time_ms=monitor.detect_time_ms(),
                    checkpoint_bytes=float(grad_bytes),
                    restore_bandwidth_gbps=pricing.restore_bandwidth_gbps,
                    remesh_s=pricing.remesh_s,
                )
                result.pod_recoveries.append(
                    PodRecovery(
                        pod=idx,
                        failed_at_step=failed_at,
                        detected_at_step=step,
                        plan=plan,
                        mesh=mesh,
                    )
                )
                downtime_s += plan.total_downtime_s
        training_active = strategy is not None and step < workload.steps
        if engine is None and not training_active:
            continue  # event-only tail (or control-plane-only scenario)
        factor = straggler.get(step, 1.0)
        compute = workload.compute_seconds * factor if training_active else 0.0
        degraded = probes is not None and probes.any_degraded
        if engine is not None:
            served = _serving_step(
                engine,
                geo,
                step,
                training_active=training_active,
                strategy=strategy,
                grad_bytes=grad_bytes,
                compute=compute,
                policy=policy,
                options=scenario.options,
                overlap_fraction=workload.overlap_fraction,
                degraded=degraded,
                dead_pods=dead_pods,
                probes=probes,
                baseline_rates=baseline_rates,
            )
            if served is None:
                continue  # serving-only step: stats on result.serving_steps
            seconds, sync_seconds, strategy_name = served
        elif policy is None and not dead_pods:
            # the historical costing path, untouched (bit-identical
            # timelines for every pre-existing scenario)
            strategy_name = (
                strategy if isinstance(strategy, str) else strategy.name
            )
            if workload.compute_seconds > 0:
                seconds = geo.step_time(
                    strategy,
                    grad_bytes,
                    compute,
                    overlap_fraction=workload.overlap_fraction,
                    options=scenario.options,
                )
                sync_seconds = max(seconds - compute, 0.0)
            else:
                cost = (
                    result.sync
                    if reusable and fabric_pristine
                    else geo.sync_cost(strategy, grad_bytes, options=scenario.options)
                )
                sync_seconds = cost.amortized_seconds
                seconds = sync_seconds
        else:
            # resilience path: cost the (possibly adapted) schedule over
            # the surviving pods, then feed the probes what it observed
            eff_strategy, eff_grad, eff_opts = strategy, grad_bytes, scenario.options
            if degraded and policy is not None:
                if policy.fallback_strategy is not None and isinstance(strategy, str):
                    eff_strategy = policy.fallback_strategy
                if policy.degraded_sync_every is not None:
                    eff_opts = dataclasses.replace(
                        eff_opts, sync_every=policy.degraded_sync_every
                    )
                if policy.int8_wan:
                    eff_grad = max(int(grad_bytes * eff_opts.int8_ratio), 1)
            if isinstance(eff_strategy, str):
                schedule = build_schedule(
                    eff_strategy,
                    geo.strategy_context(tuple(sorted(dead_pods))),
                    eff_grad,
                    sync_every=eff_opts.sync_every,
                    int8_ratio=eff_opts.int8_ratio,
                )
            else:
                schedule = eff_strategy
            strategy_name = schedule.name
            if workload.compute_seconds > 0:
                overlapped = with_compute_overlap(
                    schedule, compute, workload.overlap_fraction
                )
                cost = geo.sync_cost(overlapped, options=eff_opts)
                exposed = max(cost.wan_seconds - compute, 0.0)
                sync_seconds = exposed / cost.sync_every
                seconds = compute + sync_seconds
            else:
                cost = geo.sync_cost(schedule, options=eff_opts)
                sync_seconds = cost.amortized_seconds
                seconds = sync_seconds
            if probes is not None:
                rates = _pair_rates(geo, cost.phases, cost.wan_seconds)
                probe_now_ms = step * 1000.0  # one emulated second per step
                for pair in probes.pairs:
                    probes.observe(
                        pair,
                        probe_now_ms,
                        rate_gbps=rates.get(pair, baseline_rates.get(pair, 0.0)),
                        rtt_ms=_pair_rtt_ms(geo, pair),
                    )
        result.steps.append(
            StepRecord(
                step=step,
                seconds=float(seconds) + float(downtime_s),
                sync_seconds=float(sync_seconds),
                compute_seconds=float(compute),
                straggler_factor=float(factor),
                events=tuple(e.kind for e in fired),
                strategy=strategy_name,
                degraded=bool(degraded),
                downtime_seconds=float(downtime_s),
            )
        )
    if engine is not None:
        result.serving_steps = list(engine.stats)
    return result
