"""CollectiveSchedule: phased, overlappable synchronization schedules.

The paper's Fig. 14 costing treats one synchronization as a single static
flow set, but real geo-training schedules are *phased*: reduce-scatter
overlapping all-gather, PS push then pull, MoE dispatch/combine, compute
overlapping WAN transfer (arXiv 2605.19169 argues fiber-latency/overlap
modeling is exactly where multi-DC training wins or loses; arXiv
2407.12819 shows MoE all-to-all stresses the WAN in yet another phase
structure).  This module makes the schedule a first-class value:

* :class:`Phase` — one named step of a schedule: a flow set (synthesized
  by :mod:`repro.core.flows`), the names of phases it depends on, an
  optional start offset past its dependencies, and an optional compute
  duration (a flowless compute phase models overlap-with-backprop);
* :class:`CollectiveSchedule` — a validated DAG of phases plus the
  ``sync_every`` amortization factor (local-SGD-style schedules run once
  every N steps);
* a **strategy registry** (:func:`register_strategy` /
  :func:`get_strategy`) replacing the closed ``if/elif`` that used to
  live in ``GeoFabric.sync_cost``: every paper strategy is a registered
  builder, and new overlapped schedules (``rs_ag_overlap``,
  ``hier_alltoall``, ...) plug in without touching the costing engine;
* :func:`with_compute_overlap` — graft a compute phase onto any schedule
  so overlap is a DAG property, not a scalar ``overlap_fraction`` hack.

Builders receive a :class:`StrategyContext` (the topology facts a
schedule needs: worker rosters per pod, channel count, port scheme) so
this module stays independent of :class:`repro.core.geo.GeoFabric`; the
costing itself — fluid critical path or the event-driven time-varying
max-min simulator — lives in :mod:`repro.core.geo` and
:func:`repro.core.congestion.simulate_schedule`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .flows import (
    Flow,
    all_gather_flows,
    all_to_all_flows,
    hierarchical_all_to_all_flows,
    hierarchical_flows,
    parameter_server_flows,
    reduce_scatter_flows,
    ring_allreduce_flows,
)

#: The paper's Fig. 14 strategy set (kept for back-compat; the registry
#: below is the extensible superset).
SYNC_STRATEGIES = ("allreduce", "ps", "hier", "hier_int8", "local_sgd")


@dataclass(frozen=True)
class Phase:
    """One step of a :class:`CollectiveSchedule`.

    A phase *starts* once every phase named in ``deps`` has completed,
    plus ``start_offset_s``; it *completes* when all its flows have
    finished (transfer + path propagation) and ``compute_seconds`` have
    elapsed since its start.  A flowless phase with ``compute_seconds``
    models computation; a phase with both models compute that must finish
    before dependents start even if its flows drain early.
    """

    name: str
    flows: Tuple[Flow, ...] = ()
    deps: Tuple[str, ...] = ()
    start_offset_s: float = 0.0
    compute_seconds: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "flows", tuple(self.flows))
        object.__setattr__(self, "deps", tuple(self.deps))
        if not self.name:
            raise ValueError("phase name must be non-empty")
        if self.start_offset_s < 0 or self.compute_seconds < 0:
            raise ValueError(
                f"phase {self.name!r}: offsets/durations must be >= 0"
            )


@dataclass(frozen=True)
class CollectiveSchedule:
    """A validated DAG of :class:`Phase`\\ s.

    ``phases`` are stored in a topological order (validation rejects
    duplicate names, unknown dependencies, and cycles), so consumers can
    fold over them front-to-back.  ``sync_every`` is the amortization
    factor the strategy implies (``local_sgd`` syncs once every N steps).
    """

    name: str
    phases: Tuple[Phase, ...]
    sync_every: int = 1

    def __post_init__(self):
        object.__setattr__(self, "phases", tuple(self.phases))
        if not self.phases:
            raise ValueError(f"schedule {self.name!r} has no phases")
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        names = [p.name for p in self.phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate phase names in {self.name!r}: {names}")
        object.__setattr__(self, "phases", self._topo_sorted())

    def _topo_sorted(self) -> Tuple[Phase, ...]:
        by_name = {p.name: p for p in self.phases}
        for p in self.phases:
            for d in p.deps:
                if d not in by_name:
                    raise ValueError(
                        f"phase {p.name!r} depends on unknown phase {d!r}"
                    )
        done: Dict[str, Phase] = {}
        visiting: set = set()

        def visit(p: Phase) -> None:
            if p.name in done:
                return
            if p.name in visiting:
                raise ValueError(
                    f"dependency cycle through phase {p.name!r} in {self.name!r}"
                )
            visiting.add(p.name)
            for d in p.deps:
                visit(by_name[d])
            visiting.discard(p.name)
            done[p.name] = p

        for p in self.phases:
            visit(p)
        return tuple(done.values())

    # -- conveniences --------------------------------------------------------

    @property
    def phase_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.phases)

    def phase(self, name: str) -> Phase:
        for p in self.phases:
            if p.name == name:
                return p
        raise KeyError(f"no phase {name!r} in schedule {self.name!r}")

    def all_flows(self) -> List[Flow]:
        """Every flow of every phase, in topological phase order."""
        return [f for p in self.phases for f in p.flows]

    def flow_slices(self) -> List[Tuple[int, int]]:
        """Per-phase ``(lo, hi)`` index ranges into :meth:`all_flows`.

        The epoch bookkeeping contract with the event-driven simulator
        (:func:`repro.core.congestion.simulate_schedule`): phase ``i``'s
        flows occupy the contiguous global-flow-id block
        ``flow_slices()[i]``, in the schedule's topological phase order.
        The simulator's per-flow report arrays, its allocator's CSR row
        blocks, and :class:`~repro.core.congestion.PhaseTiming`'s
        ``flow_lo:flow_hi`` all index by this layout.
        """
        slices: List[Tuple[int, int]] = []
        lo = 0
        for p in self.phases:
            slices.append((lo, lo + len(p.flows)))
            lo += len(p.flows)
        return slices

    def concurrency_matrix(self) -> "np.ndarray":
        """(P, P) bool: may phases i and j ever be in flight together?

        Two phases can only coexist when neither is a DAG ancestor of the
        other — a dependency (direct or transitive) serializes them, so
        their flows never contend and must not count as ECMP hash-slot
        colliders against each other
        (:func:`repro.core.congestion.concurrent_ecmp_flow_weights`).
        The diagonal is True (a phase always overlaps itself).
        """
        import numpy as np  # local: schedule stays numpy-free otherwise

        n = len(self.phases)
        idx = {p.name: i for i, p in enumerate(self.phases)}
        anc = np.zeros((n, n), dtype=bool)  # anc[i, j]: i is an ancestor of j
        for j, p in enumerate(self.phases):  # topological order
            for d in p.deps:
                i = idx[d]
                anc[i, j] = True
                anc[:, j] |= anc[:, i]
        conc = ~(anc | anc.T)
        np.fill_diagonal(conc, True)
        return conc

    @property
    def is_single_phase(self) -> bool:
        """True when the schedule is one flow phase starting at t=0 — the
        shape whose contended cost is exactly the static
        :func:`repro.core.congestion.congestion_report`."""
        return (
            len(self.phases) == 1
            and not self.phases[0].deps
            and self.phases[0].start_offset_s == 0.0
            and self.phases[0].compute_seconds == 0.0
        )

    @classmethod
    def single(
        cls, name: str, flows: Sequence[Flow], *, sync_every: int = 1
    ) -> "CollectiveSchedule":
        """One flow set, all at t=0 — today's static costing as a schedule."""
        return cls(name, (Phase(name, tuple(flows)),), sync_every=sync_every)

    @classmethod
    def serial(
        cls,
        name: str,
        named_flow_sets: Sequence[Tuple[str, Sequence[Flow]]],
        *,
        sync_every: int = 1,
    ) -> "CollectiveSchedule":
        """Chain flow sets back-to-back (each phase depends on the previous)."""
        phases: List[Phase] = []
        for pname, flows in named_flow_sets:
            deps = (phases[-1].name,) if phases else ()
            phases.append(Phase(pname, tuple(flows), deps=deps))
        return cls(name, tuple(phases), sync_every=sync_every)


def with_compute_overlap(
    schedule: CollectiveSchedule,
    compute_seconds: float,
    overlap_fraction: float = 1.0,
    *,
    compute_name: str = "compute",
) -> CollectiveSchedule:
    """Overlap ``schedule`` with a compute phase, as DAG structure.

    Adds a flowless ``compute_seconds`` phase starting at t=0 and delays
    every root phase of the communication schedule by the non-overlappable
    head of compute, ``(1 - overlap_fraction) * compute_seconds`` (e.g. the
    backward pass must produce gradients before their sync can start).
    With ``overlap_fraction=0`` the result degenerates to compute followed
    by the untouched schedule; with 1.0 comm and compute run fully
    concurrently and the makespan is what the congestion engine says it is
    — communication can no longer be "overlapped away" below its bandwidth
    floor, unlike the old scalar ``(1 - overlap) * comm`` estimate.
    """
    if not 0.0 <= overlap_fraction <= 1.0:
        raise ValueError(f"overlap_fraction must be in [0, 1], got {overlap_fraction}")
    if compute_seconds < 0:
        raise ValueError("compute_seconds must be >= 0")
    if any(p.name == compute_name for p in schedule.phases):
        raise ValueError(f"schedule already has a phase named {compute_name!r}")
    head = (1.0 - overlap_fraction) * compute_seconds
    phases: List[Phase] = [Phase(compute_name, compute_seconds=compute_seconds)]
    for p in schedule.phases:
        if not p.deps:
            p = replace(p, start_offset_s=p.start_offset_s + head)
        phases.append(p)
    return CollectiveSchedule(
        f"{schedule.name}+compute", tuple(phases), sync_every=schedule.sync_every
    )


# -- strategy registry --------------------------------------------------------


@dataclass(frozen=True)
class StrategyContext:
    """Topology facts a strategy builder needs, decoupled from GeoFabric.

    ``pod_workers`` lists every pod's workers (first member = pod leader,
    the DCI endpoint); ``num_channels``/``port_scheme`` parameterize the
    QP flow synthesis exactly as ``GeoFabric.sync_cost`` always has.
    """

    pod_workers: Tuple[Tuple[str, ...], ...]
    num_channels: int = 4
    port_scheme: str = "qp_aware"

    @property
    def workers(self) -> Tuple[str, ...]:
        return tuple(w for pod in self.pod_workers for w in pod)

    @property
    def pod_leaders(self) -> Tuple[str, ...]:
        return tuple(pod[0] for pod in self.pod_workers if pod)

    @property
    def n_local(self) -> int:
        """Workers in the first pod (the hierarchical-shard divisor)."""
        return max(len(self.pod_workers[0]) if self.pod_workers else 0, 1)

    @property
    def flow_kw(self) -> Dict[str, object]:
        return {"num_channels": self.num_channels, "scheme": self.port_scheme}


#: builder(ctx, grad_bytes, **kw) -> CollectiveSchedule
StrategyBuilder = Callable[..., CollectiveSchedule]

_REGISTRY: Dict[str, StrategyBuilder] = {}


def register_strategy(
    name: str, builder: Optional[StrategyBuilder] = None, *, overwrite: bool = False
):
    """Register a schedule builder under ``name`` (usable as a decorator).

    Builders are called as ``builder(ctx, grad_bytes, **kw)`` with a
    :class:`StrategyContext` and should accept (and may ignore) the keyword
    knobs ``sync_every`` and ``int8_ratio`` that ``GeoFabric.sync_cost``
    forwards.  Re-registering an existing name raises unless
    ``overwrite=True``, so typos don't silently shadow paper strategies.
    """

    def _register(b: StrategyBuilder) -> StrategyBuilder:
        if not overwrite and name in _REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        _REGISTRY[name] = b
        return b

    return _register if builder is None else _register(builder)


def get_strategy(name: str) -> StrategyBuilder:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: {strategy_names()}"
        ) from None


def strategy_names() -> Tuple[str, ...]:
    """All registered strategy names, paper strategies first."""
    extras = tuple(sorted(n for n in _REGISTRY if n not in SYNC_STRATEGIES))
    return tuple(n for n in SYNC_STRATEGIES if n in _REGISTRY) + extras


def build_schedule(
    strategy: str, ctx: StrategyContext, grad_bytes: int, **kw
) -> CollectiveSchedule:
    """Look up ``strategy`` in the registry and build its schedule."""
    return get_strategy(strategy)(ctx, grad_bytes, **kw)


# -- builders: the paper's Fig. 14 strategies (single-phase, back-compat) ----


@register_strategy("allreduce")
def _allreduce(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Flat ring over all workers in all DCs (paper M2)."""
    return CollectiveSchedule.single(
        "allreduce", ring_allreduce_flows(list(ctx.workers), grad_bytes, **ctx.flow_kw)
    )


@register_strategy("ps")
def _ps(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Central server in DC1, concurrent push+pull (paper M1)."""
    workers = list(ctx.workers)
    return CollectiveSchedule.single(
        "ps",
        parameter_server_flows(workers[0], workers[1:], grad_bytes, **ctx.flow_kw),
    )


def _hier_schedule(
    name: str, ctx: StrategyContext, grad_bytes: int, *, scale: float = 1.0,
    sync_every: int = 1,
) -> CollectiveSchedule:
    shard = int((grad_bytes // ctx.n_local) * scale)
    return CollectiveSchedule.single(
        name,
        hierarchical_flows(list(ctx.pod_leaders), shard, **ctx.flow_kw),
        sync_every=sync_every,
    )


@register_strategy("hier")
def _hier(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Intra-pod reduce-scatter (LAN, free at WAN granularity) + leader ring."""
    return _hier_schedule("hier", ctx, grad_bytes)


@register_strategy("hier_int8")
def _hier_int8(
    ctx: StrategyContext, grad_bytes: int, *, int8_ratio: float = 0.25, **_
) -> CollectiveSchedule:
    """``hier`` with the WAN payload int8-compressed (+ per-block scales)."""
    return _hier_schedule("hier_int8", ctx, grad_bytes, scale=int8_ratio)


@register_strategy("local_sgd")
def _local_sgd(
    ctx: StrategyContext, grad_bytes: int, *, sync_every: int = 8, **_
) -> CollectiveSchedule:
    """``hier`` executed once every ``sync_every`` steps (DiLoCo-style)."""
    return _hier_schedule("local_sgd", ctx, grad_bytes, sync_every=sync_every)


# -- builders: phased / overlapped schedules (beyond Fig. 14) ----------------


@register_strategy("ps_phased")
def _ps_phased(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """PS as two dependent phases: all pushes complete before any pull.

    The barrier semantics of a synchronous PS round — the server cannot
    serve updated weights until every push has landed — versus the ``ps``
    strategy's optimistic fully-concurrent flow set.
    """
    workers = list(ctx.workers)
    kw = dict(ctx.flow_kw)
    return CollectiveSchedule.serial(
        "ps_phased",
        (
            ("push", parameter_server_flows(
                workers[0], workers[1:], grad_bytes, direction="push", **kw)),
            ("pull", parameter_server_flows(
                workers[0], workers[1:], grad_bytes, direction="pull", **kw)),
        ),
    )


def _rs_ag_phases(ctx: StrategyContext, grad_bytes: int) -> Tuple[Tuple[Flow, ...], Tuple[Flow, ...]]:
    workers = list(ctx.workers)
    rs = tuple(reduce_scatter_flows(workers, grad_bytes, **ctx.flow_kw))
    ag = tuple(all_gather_flows(workers, grad_bytes, **ctx.flow_kw))
    return rs, ag


@register_strategy("rs_then_ag")
def _rs_then_ag(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Unpipelined ring: the all-gather waits for the full reduce-scatter."""
    rs, ag = _rs_ag_phases(ctx, grad_bytes)
    return CollectiveSchedule.serial("rs_then_ag", (("rs", rs), ("ag", ag)))


@register_strategy("rs_ag_overlap")
def _rs_ag_overlap(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Pipelined ring: reduce-scatter and all-gather traffic in flight together.

    The fluid-granularity model of NCCL's chunked ring pipeline: per-chunk
    the all-gather step chases the reduce-scatter step around the ring, so
    at any instant both phases' traffic (on disjoint QP connection groups —
    see :func:`repro.core.flows.all_gather_flows`) contends for the same
    links.  On shared bottlenecks this lands strictly between
    ``max(RS, AG)`` (they do contend) and serial RS -> AG (imbalanced
    per-link byte loads no longer stack, and only one terminal propagation
    delay is paid) — the ``bench_schedule.py`` gate.
    """
    rs, ag = _rs_ag_phases(ctx, grad_bytes)
    return CollectiveSchedule(
        "rs_ag_overlap", (Phase("rs", rs), Phase("ag", ag))
    )


@register_strategy("alltoall")
def _alltoall(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Flat MoE all-to-all among every worker (arXiv 2407.12819's stressor)."""
    return CollectiveSchedule.single(
        "alltoall", all_to_all_flows(list(ctx.workers), grad_bytes, **ctx.flow_kw)
    )


@register_strategy("hier_alltoall")
def _hier_alltoall(ctx: StrategyContext, grad_bytes: int, **_) -> CollectiveSchedule:
    """Two-phase MoE all-to-all: intra-DC dispatch, leader-only WAN combine."""
    pods = [list(p) for p in ctx.pod_workers]
    kw = dict(ctx.flow_kw)
    return CollectiveSchedule.serial(
        "hier_alltoall",
        (
            ("dispatch", hierarchical_all_to_all_flows(
                pods, grad_bytes, phase="dispatch", **kw)),
            ("combine", hierarchical_all_to_all_flows(
                pods, grad_bytes, phase="combine", **kw)),
        ),
    )
