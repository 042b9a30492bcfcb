"""Named scenario library: the paper's §5 studies as one-line specs.

Every named entry is a factory returning a ready-to-run
:class:`~repro.scenario.spec.Scenario`; factories take keyword overrides
so sweeps are spec edits, not new scripts:

* ``fig14_allreduce`` / ``fig14_ps`` — the Fig. 14 AllReduce-vs-PS
  geo-training study (DistilGPT2 gradient volumes, contended WAN);
* ``compute_overlap`` — the compute/communication overlap sweep (one
  fraction per scenario) under the event-driven congestion model;
* ``rs_then_ag`` / ``rs_ag_overlap`` — serial vs pipelined ring schedules
  on shared WAN bottlenecks (the schedule-overlap gate's pair);
* ``bfd_flap_storm`` — the 8-DC BFD-cadence flap storm (§5.3 at scale):
  deterministic fail/restore script over the scaled topology, recovery
  timelines + EVPN resync stats in the result;
* ``multi_tenant_churn`` — tenant attach/detach churn on the paper's
  Fig. 1 fabric plus a leaf-isolation episode, surfacing
  :class:`~repro.core.evpn.EvpnResyncStats` (§5.4 beyond Table 1);
* ``ecmp_collision`` — the §5.2 collision study costed end-to-end: same
  workload under ``baseline`` vs ``qp_aware`` port allocation with the
  ECMP-weighted congestion model.

The shared topology/workload constants the benchmarks used to copy-paste
(`SCALED8`, the storm event scripts, the Fig. 14 gradient volumes) live
here so ``benchmarks/bench_*.py`` and ``examples/`` are thin wrappers.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..core.fabric import Fabric, FabricConfig
from ..core.geo import SyncOptions
from ..scenario.spec import (
    DegradationPolicy,
    Scenario,
    ScenarioEvent,
    ServingSpec,
    TopologySpec,
    WorkloadSpec,
)

__all__ = [
    "AR_GRAD_BYTES",
    "CALIBRATED_COMPUTE_S",
    "DISTILGPT2_KV_BYTES_PER_TOKEN",
    "PS_GRAD_BYTES",
    "SCALED8",
    "STORM_GRAD_BYTES",
    "evpn_storm_events",
    "get_scenario",
    "register_scenario",
    "scenario_names",
    "storm_events",
]

#: DistilGPT2 fp32 gradient volume (paper: ~312 MB with DDP).
AR_GRAD_BYTES = 312_000_000
#: PS per-batch volume (paper: ~459 MB: fp32 grads + momentum-carrying pulls).
PS_GRAD_BYTES = 459_000_000
#: Per-batch gradient-computation floor calibrated to Fig. 14 (see
#: ``benchmarks/bench_training.py`` for the derivation).
CALIBRATED_COMPUTE_S = 2.2

#: 8-DC scaled fabric for the flap storm: 32 spines, 32 leaves, 64 hosts,
#: 28 DC pairs x 16 spine-pair WAN links = 448 WAN links.
SCALED8 = FabricConfig(
    num_dcs=8,
    spines_per_dc=4,
    leaves_per_dc=4,
    hosts_per_leaf=tuple(tuple(2 for _ in range(4)) for _ in range(8)),
)

STORM_GRAD_BYTES = 16_000_001


def storm_events(fabric: Fabric) -> List[Tuple[str, Tuple[str, str]]]:
    """Deterministic BFD-cadence flap schedule: isolated WAN flaps spread
    over the DC pairs, one correlated burst (3 of d1s1's 4 links toward
    DC2), and a leaf-spine flap; a few links stay down at the end."""
    wan = sorted(tuple(sorted(l)) for l in fabric.wan_links)
    events: List[Tuple[str, Tuple[str, str]]] = []
    for k in range(8):
        link = wan[(k * 53) % len(wan)]
        events.append(("fail", link))
        events.append(("restore", link))
    burst = [l for l in wan if l[0] == "d1s1" and l[1].startswith("d2s")]
    for link in burst[:3]:
        events.append(("fail", link))
    for link in burst[:2]:
        events.append(("restore", link))
    events.append(("fail", ("d3l2", "d3s1")))
    return events


def evpn_storm_events(fabric: Fabric) -> List[Tuple[str, Tuple[str, str]]]:
    """The data-plane storm plus a leaf-isolation episode: d5l1 loses all
    four uplinks one BFD flap at a time (only the fourth partitions the
    BGP session graph), then gets them back — the only event class whose
    EVPN blast radius is non-empty."""
    events = list(storm_events(fabric))
    uplinks = [("d5l1", f"d5s{j}") for j in range(1, 5)]
    events += [("fail", link) for link in uplinks]
    events += [("restore", link) for link in uplinks]
    return events


# -- registry -----------------------------------------------------------------

ScenarioFactory = Callable[..., Scenario]

_LIBRARY: Dict[str, ScenarioFactory] = {}


def register_scenario(
    name: str, factory: Optional[ScenarioFactory] = None, *, overwrite: bool = False
):
    """Register a scenario factory under ``name`` (usable as a decorator).

    Factories are called as ``factory(**overrides)`` and must return a
    :class:`Scenario`.  Re-registering raises unless ``overwrite=True``.
    """

    def _register(f: ScenarioFactory) -> ScenarioFactory:
        if not overwrite and name in _LIBRARY:
            raise ValueError(f"scenario {name!r} already registered")
        _LIBRARY[name] = f
        return f

    return _register if factory is None else _register(factory)


def get_scenario(name: str, **overrides) -> Scenario:
    """Build the named scenario, forwarding keyword overrides."""
    try:
        factory = _LIBRARY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {scenario_names()}"
        ) from None
    return factory(**overrides)


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(_LIBRARY))


# -- the paper's §5 studies ---------------------------------------------------


def _fig14_scenario(name: str, strategy: str, grad_bytes: int, **kw) -> Scenario:
    opts = kw.pop("options", SyncOptions(jitter=False, congestion=True))
    return Scenario(
        name=name,
        topology=TopologySpec(num_pods=2, workers_per_pod=2, num_channels=4, seed=14),
        workload=WorkloadSpec(strategy=strategy, grad_bytes=grad_bytes, **kw),
        options=opts,
        description=(
            "Fig. 14 geo-training study: DistilGPT2 gradients over the "
            "emulated 800 Mbit/s / 22 ms WAN, contended congestion model."
        ),
    )


@register_scenario("fig14_allreduce")
def fig14_allreduce(**kw) -> Scenario:
    return _fig14_scenario("fig14_allreduce", "allreduce", AR_GRAD_BYTES, **kw)


@register_scenario("fig14_ps")
def fig14_ps(**kw) -> Scenario:
    return _fig14_scenario("fig14_ps", "ps", PS_GRAD_BYTES, **kw)


@register_scenario("compute_overlap")
def compute_overlap(overlap_fraction: float = 0.5, **kw) -> Scenario:
    """One point of the compute/communication overlap sweep (ROADMAP):
    flat AllReduce grafted with the calibrated compute phase, costed by
    the event-driven simulator."""
    return Scenario(
        name=f"compute_overlap_f{int(overlap_fraction * 100):02d}",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, num_channels=4, seed=14),
        workload=WorkloadSpec(
            strategy="allreduce",
            grad_bytes=AR_GRAD_BYTES,
            compute_seconds=kw.pop("compute_seconds", CALIBRATED_COMPUTE_S),
            overlap_fraction=overlap_fraction,
        ),
        options=kw.pop("options", SyncOptions(jitter=False, congestion=True)),
        description=(
            "Compute/communication overlap as DAG structure: communication "
            "may start once the non-overlappable head of backprop is done."
        ),
    )


def _ring_schedule_scenario(name: str, strategy: str, **kw) -> Scenario:
    return Scenario(
        name=name,
        topology=TopologySpec(num_pods=2, workers_per_pod=2, num_channels=4, seed=3),
        workload=WorkloadSpec(
            strategy=strategy, grad_bytes=kw.pop("grad_bytes", AR_GRAD_BYTES)
        ),
        options=kw.pop("options", SyncOptions(jitter=False, congestion=True)),
        description=(
            "Ring reduce-scatter/all-gather on shared WAN bottlenecks: "
            "pipelined overlap lands strictly between max(RS, AG) and "
            "serial RS -> AG."
        ),
    )


@register_scenario("rs_then_ag")
def rs_then_ag(**kw) -> Scenario:
    return _ring_schedule_scenario("rs_then_ag", "rs_then_ag", **kw)


@register_scenario("rs_ag_overlap")
def rs_ag_overlap(**kw) -> Scenario:
    return _ring_schedule_scenario("rs_ag_overlap", "rs_ag_overlap", **kw)


@register_scenario("bfd_flap_storm")
def bfd_flap_storm(mechanism: str = "bfd", **kw) -> Scenario:
    """The §5.3 storm as a scenario: the deterministic flap script over
    the 8-DC scaled topology, one BFD event per step, with a hierarchical
    leader sync riding through it.  ``ScenarioResult.recoveries`` /
    ``evpn_resyncs`` carry the per-flap rollups."""
    events = tuple(
        ScenarioEvent(
            kind="fail_link" if action == "fail" else "restore_link",
            at_step=i,
            link=link,
            mechanism=mechanism,
        )
        for i, (action, link) in enumerate(storm_events(Fabric(SCALED8)))
    )
    return Scenario(
        name="bfd_flap_storm",
        topology=TopologySpec(fabric=SCALED8, num_channels=4, seed=5),
        workload=WorkloadSpec(
            strategy="hier",
            grad_bytes=kw.pop("grad_bytes", STORM_GRAD_BYTES),
            steps=len(events),
        ),
        options=kw.pop("options", SyncOptions(jitter=False)),
        events=events,
        description=(
            "8-DC BFD-cadence flap storm: isolated WAN flaps, a correlated "
            "burst, and a leaf-spine flap, with leader sync costed every "
            "step of the storm."
        ),
    )


@register_scenario("multi_tenant_churn")
def multi_tenant_churn(**kw) -> Scenario:
    """Tenant attach/detach churn on the paper's Fig. 1 fabric plus a
    leaf-isolation episode (d1l3 loses both uplinks, then recovers).

    The workload is the hierarchical leader sync (leaders d1h1/d2h1 stay
    attached throughout), so every churn step re-costs sync under the
    current control-plane state; detach/attach churn exercises Type-2
    withdrawal/re-advertisement, and the isolation episode is the one
    event class with a non-empty EVPN resync blast radius."""
    churn_hosts = ("d1h2", "d2h2", "d1h4", "d2h3")
    events: List[ScenarioEvent] = []
    step = 1
    for host in churn_hosts:  # detach/re-attach each host, one per step
        events.append(
            ScenarioEvent(kind="tenant_detach", at_step=step, tenant="training", host=host)
        )
        events.append(
            ScenarioEvent(kind="tenant_attach", at_step=step + 1, tenant="training", host=host)
        )
        step += 2
    # leaf-isolation episode: d1l3 (hosts d1h5) loses both uplinks
    for j, action in ((1, "fail_link"), (2, "fail_link"), (1, "restore_link"), (2, "restore_link")):
        events.append(
            ScenarioEvent(kind=action, at_step=step, link=("d1l3", f"d1s{j}"))
        )
        step += 1
    return Scenario(
        name="multi_tenant_churn",
        topology=TopologySpec(fabric=FabricConfig(), num_channels=4, seed=1),
        workload=WorkloadSpec(
            strategy="hier",
            grad_bytes=kw.pop("grad_bytes", 64_000_000),
            steps=step + 1,
        ),
        options=kw.pop("options", SyncOptions(jitter=False)),
        events=tuple(events),
        description=(
            "Multi-tenant churn (§5.4 beyond Table 1): per-step tenant "
            "detach/attach plus a leaf-isolation flap sequence; "
            "EvpnResyncStats rollups surface the control-plane blast radius."
        ),
    )


@register_scenario("wan_brownout")
def wan_brownout(
    policy: Optional[DegradationPolicy] = DegradationPolicy(
        degraded_sync_every=8, int8_wan=True
    ),
    bandwidth_fraction: float = 0.25,
    **kw,
) -> Scenario:
    """Gray-failure brownout: one DC pair silently loses 4x bandwidth
    mid-run (no link goes down — BFD stays UP throughout), then recovers.

    With the default :class:`~repro.scenario.spec.DegradationPolicy` the
    SLA probes trip after two breaching steps and the runner gracefully
    degrades (sync every 8 steps, int8 WAN compression) until the probes
    recover; ``policy=None`` rides the brownout at full cost — the
    ``bench_resilience.py`` brownout gate prices the difference."""
    events = (
        ScenarioEvent(
            kind="degrade_pair",
            at_step=4,
            pair=(1, 2),
            bandwidth_fraction=bandwidth_fraction,
        ),
        ScenarioEvent(kind="restore_degradation", at_step=12, pair=(1, 2)),
    )
    return Scenario(
        name="wan_brownout",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, num_channels=4, seed=7),
        workload=WorkloadSpec(
            strategy="hier",
            grad_bytes=kw.pop("grad_bytes", AR_GRAD_BYTES),
            steps=16,
        ),
        options=kw.pop("options", SyncOptions(jitter=False)),
        events=events,
        policy=policy,
        description=(
            "WAN brownout on pair (1,2): bandwidth quietly drops to a "
            "fraction while BFD sessions stay UP; SLA probes trip with "
            "hysteresis and the degradation policy falls back gracefully."
        ),
    )


#: distilgpt2-82m decode-cache bytes per context token
#: (= ``model_kv_bytes("distilgpt2-82m")``, pinned so control-plane-only
#: runs never import jax).
DISTILGPT2_KV_BYTES_PER_TOKEN = 18_432


@register_scenario("serving_under_flap")
def serving_under_flap(
    policy: Optional[DegradationPolicy] = DegradationPolicy(),
    serving: Optional[ServingSpec] = None,
    **kw,
) -> Scenario:
    """Geo-serving through a WAN brownout + BFD flap: 400k users across
    two DCs, half of DC-crossing sessions steadily served remote, while a
    hierarchical leader sync trains underneath on the same spine WAN.

    The event arc: pair (1,2) browns out at step 4 (bandwidth to 20%,
    +30 ms), a spine WAN link BFD-flaps at step 5/6, and the brownout
    lifts at step 10.  With the default detection-only policy the SLA
    probes trip after the second breaching observation, the session
    router's failover sweep re-homes every remote session (paying
    leader-to-leader KV migration bytes), serving p99 collapses back
    under the SLO, and once the probes recover the remote class resumes —
    goodput-under-flap, priced end to end.  ``bench_serving.py`` gates
    the whole arc."""
    if serving is None:
        serving = ServingSpec(
            users=400_000,
            requests_per_user_step=2e-5,
            remote_fraction=0.5,
            mean_tokens=128,
            session_tokens=1024,
            kv_bytes_per_token=DISTILGPT2_KV_BYTES_PER_TOKEN,
            slo_ms=400.0,
            seed=23,
        )
    events = (
        ScenarioEvent(
            kind="degrade_pair",
            at_step=4,
            pair=(1, 2),
            bandwidth_fraction=0.2,
            extra_delay_ms=30.0,
        ),
        ScenarioEvent(kind="fail_link", at_step=5, link=("d1s1", "d2s1")),
        ScenarioEvent(kind="restore_link", at_step=6, link=("d1s1", "d2s1")),
        ScenarioEvent(kind="restore_degradation", at_step=10, pair=(1, 2)),
    )
    return Scenario(
        name="serving_under_flap",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, num_channels=4, seed=19),
        workload=WorkloadSpec(
            strategy="hier",
            grad_bytes=kw.pop("grad_bytes", AR_GRAD_BYTES),
            steps=14,
        ),
        options=kw.pop("options", SyncOptions(jitter=False)),
        events=events,
        policy=policy,
        serving=serving,
        description=(
            "Inference co-load through a gray-failure arc: brownout + BFD "
            "flap trip the SLA probes, the affinity router fails user "
            "sessions over (KV migration priced on the WAN), p99 recovers."
        ),
    )


@register_scenario("srlg_fiber_cut")
def srlg_fiber_cut(**kw) -> Scenario:
    """SRLG fiber cut on a 4-DC fabric: the DC pairs (1,2) and (3,4)
    share one conduit (``subsea-1``), so a single backhoe fails every WAN
    link of both pairs *atomically* — one shared BFD detection window, one
    withdrawal/best-path/FIB pipeline, per-link incremental reroute + EVPN
    resync in deterministic order.  Leader-ring traffic between the cut
    pairs transits the surviving DCs until the fiber is respliced.  The
    resulting routing state is pinned byte-for-byte equal to sequential
    per-link failure by the ``bench_resilience.py`` SRLG gate."""
    events = (
        ScenarioEvent(kind="fiber_cut", at_step=2, srlg="subsea-1"),
        ScenarioEvent(kind="fiber_restore", at_step=5, srlg="subsea-1"),
    )
    return Scenario(
        name="srlg_fiber_cut",
        topology=TopologySpec(
            num_pods=4,
            workers_per_pod=2,
            num_channels=4,
            seed=9,
            srlgs=(("subsea-1", ((1, 2), (3, 4))),),
        ),
        workload=WorkloadSpec(
            strategy="hier",
            grad_bytes=kw.pop("grad_bytes", 64_000_000),
            steps=8,
        ),
        options=kw.pop("options", SyncOptions(jitter=False)),
        events=events,
        policy=kw.pop("policy", None),
        description=(
            "Shared-risk-link-group cut: pairs (1,2) and (3,4) fail "
            "together in one detection window; sync reroutes through the "
            "surviving DCs until fiber_restore."
        ),
    )


@register_scenario("pod_loss_recovery")
def pod_loss_recovery(
    policy: Optional[DegradationPolicy] = DegradationPolicy(),
    **kw,
) -> Scenario:
    """Whole-pod loss priced end to end: pod 2 stops heartbeating at step
    6, the HeartbeatMonitor declares it dead ~3 intervals later, and the
    runner prices the recovery — roll back to the last checkpoint *before*
    the death, restore over the WAN, re-mesh onto the survivor — into the
    step timeline (``StepRecord.downtime_seconds``) and the
    :class:`~repro.scenario.runner.PodRecovery` record.  Subsequent steps
    cost the survivor-only schedule (single-DC: WAN sync disabled)."""
    events = (ScenarioEvent(kind="pod_fail", at_step=6, pod=2),)
    return Scenario(
        name="pod_loss_recovery",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, num_channels=4, seed=11),
        workload=WorkloadSpec(
            strategy="hier",
            grad_bytes=kw.pop("grad_bytes", AR_GRAD_BYTES),
            steps=12,
        ),
        options=kw.pop("options", SyncOptions(jitter=False)),
        events=events,
        policy=policy,
        description=(
            "Pod-loss economics: lost work = steps since the last "
            "pre-failure checkpoint, plus detection + checkpoint restore "
            "+ elastic remesh downtime."
        ),
    )


@register_scenario("ecmp_collision")
def ecmp_collision(port_scheme: str = "baseline", **kw) -> Scenario:
    """The §5.2 collision study costed end-to-end: the same ring AllReduce
    under ``baseline`` vs ``qp_aware`` source-port allocation, with the
    ECMP-weighted congestion model turning recorded hash-slot collisions
    into completion-time inflation.  At the default 4 channels (the
    paper's sensitive regime) Algorithm 1 must cost visibly less."""
    return Scenario(
        name=f"ecmp_collision_{port_scheme}",
        topology=TopologySpec(
            num_pods=2,
            workers_per_pod=2,
            num_channels=kw.pop("num_channels", 4),
            port_scheme=port_scheme,
            seed=2,
        ),
        workload=WorkloadSpec(
            strategy="allreduce", grad_bytes=kw.pop("grad_bytes", 64_000_000)
        ),
        options=kw.pop(
            "options",
            SyncOptions(jitter=False, congestion=True, ecmp_weighted=True),
        ),
        description=(
            "ECMP hash-collision study: identical workload, two port "
            "allocators; weighted max-min prices the collisions each "
            "scheme leaves."
        ),
    )
