"""GeoFabric — the facade joining the emulated WAN fabric to JAX training.

A :class:`GeoFabric` owns one :class:`~repro.core.fabric.Fabric` (+ EVPN +
netem) configured for ``num_pods`` data centers and exposes the quantities
the training runtime and benchmarks need:

* per-sync-strategy communication time for a gradient of ``B`` bytes —
  any name in the :func:`repro.core.schedule.register_strategy` registry
  (the paper's ``allreduce`` | ``ps`` | ``hier`` | ``hier_int8`` |
  ``local_sgd`` plus the phased/overlapped schedules) or a
  :class:`~repro.core.schedule.CollectiveSchedule` built directly —
  obtained by synthesizing the QP flows per phase, routing them through
  the emulated fabric, and costing the phase DAG with the fluid timing
  model or the event-driven congestion simulator — i.e. the Fig. 14
  pipeline, generalized to phased schedules;
* RTT and failover numbers for the runtime's failure handling;
* the WAN roofline term for multi-pod dry-runs (bytes / DCI bandwidth).

The per-host mapping: each emulated host stands for one data-center DCI
endpoint (in a real pod, the reduction result of the pod's ICI fabric), so
"worker" below = one pod's egress aggregate, matching how hierarchical
collectives concentrate WAN traffic on pod leaders.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .bfd import FailureDetector, RecoveryTimeline
from .congestion import PhaseTiming
from .evpn import EvpnControlPlane
from .fabric import Fabric, FabricConfig
from .metrics import LoadFactorResult, load_factor
from .schedule import (
    CollectiveSchedule,
    StrategyContext,
    build_schedule,
    with_compute_overlap,
)
from .tenancy import TenancyManager
from .wan import (
    Netem,
    NetemProfile,
    PAPER_LAN,
    PAPER_WAN,
    TransferResult,
    WanTimingModel,
    ping_rtt,
)


@dataclass(frozen=True)
class SyncOptions:
    """Consolidated costing knobs for :meth:`GeoFabric.sync_cost` /
    :meth:`GeoFabric.step_time`.

    One value object instead of five orthogonal kwargs threaded through
    every benchmark and example — the :mod:`repro.scenario` spec carries
    it verbatim.  Defaults are exactly the historical keyword defaults,
    and the keyword path stays available: ``sync_cost(s, B, jitter=False)``
    and ``sync_cost(s, B, options=SyncOptions(jitter=False))`` are pinned
    bit-for-bit identical (including the jitter RNG stream, which is
    sampled at the same point either way).

    ``sync_every``/``int8_ratio`` parameterize the strategy *builder*
    (local-SGD amortization, int8 WAN compression); ``jitter``/
    ``congestion``/``ecmp_weighted`` select the costing model.
    """

    sync_every: int = 8
    int8_ratio: float = 0.25
    jitter: bool = True
    congestion: bool = False
    ecmp_weighted: bool = False

    def __post_init__(self):
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if not 0.0 < self.int8_ratio <= 1.0:
            raise ValueError("int8_ratio must be in (0, 1]")

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "SyncOptions":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(
                f"unknown SyncOptions key(s) {unknown}; valid: {sorted(fields)}"
            )
        return cls(**d)

    @classmethod
    def merge(cls, options: Optional["SyncOptions"], kwargs: Dict[str, object]) -> "SyncOptions":
        """Resolve the ``options=`` / legacy-keyword dual API.

        Exactly one of the two may be used per call; mixing them raises
        (silent precedence would make ``sync_cost(o, jitter=False)`` a
        footgun), and unknown keywords raise ``TypeError`` just as the old
        explicit signature did.
        """
        if not kwargs:
            return options if options is not None else cls()
        if options is not None:
            raise TypeError(
                f"pass options=SyncOptions(...) or legacy keywords, not both "
                f"(got options and {sorted(kwargs)})"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kwargs) - fields
        if unknown:
            raise TypeError(f"unknown sync option(s): {sorted(unknown)}")
        return cls(**kwargs)


@dataclass
class SyncCost:
    strategy: str
    wan_seconds: float
    wan_bytes: int
    bottleneck_link: Optional[Tuple[str, str]]
    load: LoadFactorResult
    sync_every: int = 1  # local_sgd amortization
    bottleneck_bytes: int = 0
    bottleneck_utilization: float = 0.0
    phases: Tuple[PhaseTiming, ...] = ()

    @property
    def amortized_seconds(self) -> float:
        return self.wan_seconds / self.sync_every


class GeoFabric:
    """Emulated geo-distributed deployment for ``num_pods`` data centers."""

    def __init__(
        self,
        num_pods: int = 2,
        workers_per_pod: int = 2,
        *,
        wan: NetemProfile = PAPER_WAN,
        lan: NetemProfile = PAPER_LAN,
        wan_pairs: Optional[Dict[Tuple[int, int], NetemProfile]] = None,
        num_channels: int = 4,
        port_scheme: str = "qp_aware",
        seed: int = 0,
        config: Optional[FabricConfig] = None,
        default_tenant: Optional[str] = "training",
    ):
        if config is not None:
            # raw-topology override (scaled scenario studies): num_pods /
            # workers_per_pod are derived from the config, not the defaults
            self.config = config
            num_pods = config.num_dcs
        else:
            hosts_per_leaf = tuple(
                tuple(
                    workers_per_pod // 3 + (1 if i < workers_per_pod % 3 else 0)
                    for i in range(3)
                )
                for _ in range(num_pods)
            )
            self.config = FabricConfig(num_dcs=num_pods, hosts_per_leaf=hosts_per_leaf)
        self.fabric = Fabric(self.config)
        self.evpn = EvpnControlPlane(self.fabric)
        self.tenancy = TenancyManager(self.fabric, self.evpn)
        self.netem = Netem(
            self.fabric, wan=wan, lan=lan, seed=seed, wan_pairs=wan_pairs
        )
        self.timing = WanTimingModel(self.netem)
        self.detector = FailureDetector(self.fabric, self.evpn)
        self.num_pods = num_pods
        self.num_channels = num_channels
        self.port_scheme = port_scheme
        # attach every host to the training tenant by default; tenancy
        # scenarios pass default_tenant=None and lay out their own VNIs
        if default_tenant is not None:
            self.tenancy.create_tenant(default_tenant, vni=100)
            for name in sorted(self.fabric.hosts):
                self.tenancy.attach(default_tenant, name)

    # -- host roles ----------------------------------------------------------

    def workers(self, pod: Optional[int] = None) -> List[str]:
        names = sorted(self.fabric.hosts)
        if pod is None:
            return names
        return [n for n in names if self.fabric.hosts[n].dc == pod]

    def pod_leaders(self) -> List[str]:
        """First host of each DC acts as the WAN/DCI endpoint."""
        return [self.workers(pod)[0] for pod in range(1, self.num_pods + 1)]

    # -- paper metrics -------------------------------------------------------

    def rtt_ms(self, count: int = 32) -> np.ndarray:
        leaders = self.pod_leaders()
        if len(leaders) < 2:
            return np.zeros(count)
        return ping_rtt(self.netem, leaders[0], leaders[1], count=count)

    def failover(self, *, mechanism: str = "bfd", **kw) -> RecoveryTimeline:
        wan_link = sorted(self.fabric.wan_links[0])
        return self.detector.fail_and_recover((wan_link[0], wan_link[1]), mechanism=mechanism, **kw)

    # -- sync-strategy costing (Fig. 14 pipeline + beyond-paper schedules) ---

    def strategy_context(self, exclude_pods: Tuple[int, ...] = ()) -> StrategyContext:
        """Topology facts for :mod:`repro.core.schedule` strategy builders.

        ``exclude_pods`` drops dead pods from the context (post-remesh
        graceful degradation: survivors keep synchronizing among
        themselves); excluding every pod raises.
        """
        dead = set(exclude_pods)
        pods = [p for p in range(1, self.num_pods + 1) if p not in dead]
        if not pods:
            raise ValueError("cannot exclude every pod from the strategy context")
        return StrategyContext(
            pod_workers=tuple(tuple(self.workers(pod)) for pod in pods),
            num_channels=self.num_channels,
            port_scheme=self.port_scheme,
        )

    def build_schedule(
        self,
        strategy: Union[str, CollectiveSchedule],
        grad_bytes: int = 0,
        *,
        options: Optional[SyncOptions] = None,
        **kwargs,
    ) -> CollectiveSchedule:
        """Resolve ``strategy`` to a :class:`CollectiveSchedule`.

        A string is looked up in the :func:`repro.core.schedule.register_strategy`
        registry and built against this fabric's topology; a schedule
        object passes through untouched.  Builder knobs come from
        ``options`` (a :class:`SyncOptions`) or the legacy ``sync_every``/
        ``int8_ratio`` keywords.
        """
        opts = SyncOptions.merge(options, kwargs)
        if isinstance(strategy, CollectiveSchedule):
            return strategy
        if grad_bytes <= 0:
            raise ValueError(
                f"strategy {strategy!r} needs grad_bytes > 0, got {grad_bytes}"
            )
        return build_schedule(
            strategy,
            self.strategy_context(),
            grad_bytes,
            sync_every=opts.sync_every,
            int8_ratio=opts.int8_ratio,
        )

    def sync_cost(
        self,
        strategy: Union[str, CollectiveSchedule],
        grad_bytes: int = 0,
        *,
        options: Optional[SyncOptions] = None,
        **kwargs,
    ) -> SyncCost:
        """Cost one gradient synchronization under ``strategy``.

        ``strategy`` is either a registered strategy name (the paper's
        ``allreduce`` | ``ps`` | ``hier`` | ``hier_int8`` | ``local_sgd``
        plus the phased schedules — ``rs_ag_overlap``, ``rs_then_ag``,
        ``ps_phased``, ``alltoall``, ``hier_alltoall``, and anything added
        via :func:`repro.core.schedule.register_strategy`) or a
        :class:`CollectiveSchedule` built directly.  The schedule's phase
        DAG is costed end-to-end; ``SyncCost.phases`` carries the
        per-phase timeline.

        Costing knobs travel in ``options`` (one :class:`SyncOptions`
        value, the declarative-scenario path) or as the legacy keywords
        ``sync_every`` / ``int8_ratio`` / ``jitter`` / ``congestion`` /
        ``ecmp_weighted`` — the two spellings are pinned bit-for-bit
        identical, including the jitter RNG stream; mixing them raises.

        ``congestion=False`` (default) applies the fluid estimate per
        phase — each phase finishes with its most-loaded link, phases
        compose along the DAG critical path (identical to the historical
        single-flow-set costing for the paper strategies).
        ``congestion=True`` runs the event-driven time-varying max-min
        model (:meth:`~repro.core.wan.WanTimingModel.contended_schedule_time`):
        flows enter as their phase's dependencies complete, fair shares are
        re-solved at every arrival/completion, and per-flow path
        propagation is already included (so no separate RTT term).

        ``ecmp_weighted=True`` (congestion branch only) solves *weighted*
        max-min fair shares: the router's recorded hash-slot occupancy
        down-weights hash-collided flows
        (:func:`repro.core.congestion.ecmp_flow_weights`; for multi-phase
        schedules the derivation is restricted to concurrently-active
        phases — :func:`repro.core.congestion.concurrent_ecmp_flow_weights`),
        and the returned ``bottleneck_utilization`` reflects the weighted
        allocation.  The default keeps the unweighted model (bit-identical
        to the historical congestion branch).
        """
        opts = SyncOptions.merge(options, kwargs)
        schedule = self.build_schedule(strategy, grad_bytes, options=opts)
        jit = float(self.netem.rng.uniform(0, 2.0)) if opts.jitter else 0.0
        if opts.congestion:
            report = self.timing.contended_schedule_time(
                schedule,
                check_reachability=self.tenancy.reachable,
                ecmp_weighted=opts.ecmp_weighted,
            )
            link_bytes = dict(self.fabric.link_bytes)
            seconds = report.seconds + jit / 1e3
            bottleneck = report.bottleneck_link
            bottleneck_bytes = report.bottleneck_bytes
            bottleneck_util = report.bottleneck_utilization
            phase_costs = report.phase_timings
        else:
            seconds, phase_costs, result = self._fluid_schedule_cost(schedule, jit)
            link_bytes = dict(self.fabric.link_bytes)
            bottleneck = result.bottleneck_link
            bottleneck_bytes = result.bottleneck_bytes
            cap = (
                self.netem.profile(*bottleneck).effective_bandwidth_gbps
                if bottleneck is not None
                else 0.0
            )
            busy = bottleneck_bytes * 8.0 / (cap * 1e9) if cap > 0 else 0.0
            bottleneck_util = busy / seconds if seconds > 0 else 0.0
        wan_bytes = sum(
            b for (u, v), b in link_bytes.items() if self.fabric.is_wan_link(u, v)
        )
        return SyncCost(
            strategy=schedule.name,
            wan_seconds=seconds,
            wan_bytes=wan_bytes,
            bottleneck_link=bottleneck,
            load=load_factor({k: v for k, v in link_bytes.items()}),
            sync_every=schedule.sync_every,
            bottleneck_bytes=bottleneck_bytes,
            bottleneck_utilization=bottleneck_util,
            phases=phase_costs,
        )

    def _fluid_schedule_cost(
        self, schedule: CollectiveSchedule, jit_ms: float
    ) -> Tuple[float, Tuple[PhaseTiming, ...], TransferResult]:
        """Fluid (uncontended) costing of a schedule's phase DAG.

        Each flow phase is routed through the vectorized batched engine
        (byte-identical to the sequential walk, ~25x faster at scaled
        topologies) and costed as ``most-loaded-link seconds``, plus the
        leader WAN RTT for phases whose flows actually cross the WAN;
        phase ends compose along the DAG (dependencies' ends + start
        offset, and at least ``compute_seconds`` long).  The jitter sample
        and the bottleneck-link attribution over the aggregate counters
        match the historical single-phase behavior exactly.
        """
        rtt_ms = (
            self.netem.base_rtt_ms(self.pod_leaders()[0], self.pod_leaders()[-1])
            if self.num_pods > 1
            else 0.0
        )
        self.fabric.reset_counters()
        end: Dict[str, float] = {}
        phase_costs = []
        flow_lo = 0
        for phase in schedule.phases:  # topological order
            inc = self.fabric.route_flows_batched(
                phase.flows, check_reachability=self.tenancy.reachable
            )
            start = max((end[d] for d in phase.deps), default=0.0)
            start += phase.start_offset_s
            wan_inc = sum(
                b for (u, v), b in inc.items() if self.fabric.is_wan_link(u, v)
            )
            duration = 0.0
            if phase.flows:
                # LAN-only phases (e.g. hier_alltoall dispatch) don't pay
                # the inter-DC RTT
                duration = self.timing.transfer_time(
                    inc, rtt_ms=rtt_ms if wan_inc else 0.0
                ).seconds
            duration = max(duration, phase.compute_seconds)
            end[phase.name] = start + duration
            phase_costs.append(
                PhaseTiming(
                    name=phase.name,
                    start_s=start,
                    end_s=end[phase.name],
                    flow_lo=flow_lo,
                    flow_hi=flow_lo + len(phase.flows),
                    wan_bytes=wan_inc,
                    compute_seconds=phase.compute_seconds,
                )
            )
            flow_lo += len(phase.flows)
        seconds = max(end.values()) + jit_ms / 1e3
        # bottleneck attribution over the schedule-aggregate counters
        result = self.timing.transfer_time(dict(self.fabric.link_bytes))
        return seconds, tuple(phase_costs), result

    def step_time(
        self,
        strategy: Union[str, CollectiveSchedule],
        grad_bytes: int,
        compute_seconds: float,
        *,
        overlap_fraction: float = 0.0,
        options: Optional[SyncOptions] = None,
        **kwargs,
    ) -> float:
        """Per-step wall time with compute/communication overlap as DAG
        structure.

        The strategy's schedule is composed with a ``compute_seconds``
        phase (:func:`repro.core.schedule.with_compute_overlap`):
        communication may begin once the non-overlappable head of compute
        — ``(1 - overlap_fraction) * compute_seconds`` — has elapsed, and
        the step ends when both finish.  Unlike the old scalar
        ``(1 - overlap) * comm`` discount, communication can never be
        overlapped below its bandwidth floor: with full overlap the step
        costs ``max(compute, comm)``, not ``compute``.  The comm time left
        exposed beyond compute is amortized by the schedule's
        ``sync_every`` (local-SGD-style strategies).

        Knobs travel in ``options`` (:class:`SyncOptions`) or the legacy
        keywords, exactly as :meth:`sync_cost`.
        """
        opts = SyncOptions.merge(options, kwargs)
        schedule = self.build_schedule(strategy, grad_bytes, options=opts)
        overlapped = with_compute_overlap(
            schedule, compute_seconds, overlap_fraction
        )
        cost = self.sync_cost(overlapped, options=opts)
        exposed = max(cost.wan_seconds - compute_seconds, 0.0)
        return compute_seconds + exposed / cost.sync_every

    # -- roofline hook --------------------------------------------------------

    def wan_roofline_seconds(self, cross_pod_bytes_per_chip: float, chips_per_pod: int) -> float:
        """WAN term for the multi-pod roofline: the pod's aggregate cross-pod
        bytes squeezed through the DC-pair's WAN links.

        Each WAN link contributes the bandwidth its *resolved* profile
        grants (``netem.profile(u, v)`` — per-pair overrides included), not
        the class default; the uniform case keeps the historical
        ``bandwidth * n_links`` product bit-for-bit.
        """
        total_bytes = cross_pod_bytes_per_chip * chips_per_pod
        link_gbps = [
            self.netem.profile(*sorted(link)).effective_bandwidth_gbps
            for link in self.fabric.wan_links
        ]
        if not link_gbps:
            link_gbps = [self.netem.wan.effective_bandwidth_gbps]
        if all(g == link_gbps[0] for g in link_gbps):
            # uniform profiles: the historical product, bit-for-bit
            aggregate_bytes_s = link_gbps[0] * 1e9 / 8.0 * len(link_gbps)
        else:
            aggregate_bytes_s = sum(g * 1e9 / 8.0 for g in link_gbps)
        return total_bytes / aggregate_bytes_s
