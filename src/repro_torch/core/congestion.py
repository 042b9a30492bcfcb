"""Vectorized flow-level congestion model (paper §5.5 / Fig. 14).

The paper observes that during geo-distributed training the spine WAN
links saturate at an *effective* ~800 Mbit/s (§5.5) and that per-collective
batch times (Fig. 14) are set by how flows share those bottlenecks — not by
the fabric's ideal bisection bandwidth.  :class:`~repro.core.wan.WanTimingModel`'s
original fluid estimate divides each link's aggregate bytes by its capacity,
which is exact only when every flow on the bottleneck starts and ends
together.  This module refines that into a *flow-level* model:

* :func:`build_link_load_matrix` — turn the per-flow directed-link paths
  recorded by :meth:`repro.core.fabric.Fabric.route_flows_with_paths` into a
  factorized flow x link incidence (CSR-style membership arrays) annotated
  with per-link netem capacity and propagation;
* :func:`max_min_rates` — progressive-filling max-min fair allocation
  ("I've Got 99 Problems But FLOPS Ain't One", arXiv:2407.12819, argues WAN
  bottleneck share is the quantity that determines geo step time): every
  round all unfrozen flows rise together until the tightest link saturates,
  freezing its flows at the current level; each round is pure NumPy
  (``bincount`` / boolean masks) over the membership arrays, so 10k+ flows
  allocate in a handful of array ops per bottleneck level.  With a
  ``weights`` vector the filling is *weighted*: flow ``f`` rises at
  ``weights[f]`` times the common level, so its share of any saturated
  link is proportional to its weight (uniform weights reproduce the
  unweighted allocator byte-for-byte);
* :func:`ecmp_flow_weights` — ECMP-awareness for the weighted allocator
  (paper §4, §5.5): :meth:`repro.core.fabric.Fabric.route_flows_with_paths`
  records each traversal's hash-slot occupancy (how many flows of the
  batch hashed into the same :data:`repro.core.fabric.ECMP_HASH_BUCKETS`
  bucket of the same member link); flows sharing a slot are one scheduling
  entity to the switch pipeline, so a flow colliding with ``k - 1`` others
  at its worst hop carries weight ``1 / k`` — the hash-skew contention the
  paper's queue-pair-aware port allocation exists to avoid, now expressed
  as allocation weights instead of being invisible to the fair-share
  model;
* :func:`congestion_report` — per-flow completion time
  (``bytes / fair rate`` + propagation along the recorded path, the Corning
  fiber-latency argument of arXiv:2605.19169) and per-link throughput /
  utilization, including the paper's effective-WAN-throughput observable:
  a saturated spine WAN link carries exactly its ~800 Mbit/s capacity
  no matter how many flows contend for it.

* :func:`simulate_schedule` — the event-driven *time-varying* extension:
  a :class:`repro.core.schedule.CollectiveSchedule` DAG is replayed as a
  fluid simulation in which phases start when their dependencies complete,
  the max-min allocation is re-solved (over the active flows' CSR
  membership rows) at every flow arrival/completion event, and the
  :class:`ScheduleReport` carries per-phase/per-flow timelines.  A
  single-phase schedule reproduces :func:`congestion_report` exactly.

The event loop's per-epoch allocation is **component-decomposed and
incremental** (ISSUE 9): the active flow x link membership graph is
partitioned into connected components (flows coupled only transitively
through shared directed links), every component is water-filled with its
*own* level accumulator (:func:`_multi_max_min_rates`), and across
events the default :class:`_IncrementalAllocator` re-solves only the
components whose active-flow sets an arrival/completion actually changed
— warm-starting everyone else from the previous epoch's rates, which are
bit-for-bit what a from-scratch solve would recompute for them.
``simulate_schedule(..., incremental=False)`` forces the from-scratch
oracle (:class:`_FullEpochAllocator`); the two are gated byte-identical,
the same discipline as ``Fabric._reconverge`` and
``EvpnControlPlane.resync_incremental`` before them (see
``docs/ARCHITECTURE.md``).

Wired into :meth:`repro.core.wan.WanTimingModel.contended_transfer_time`
/ :meth:`~repro.core.wan.WanTimingModel.contended_schedule_time` (and from
there ``GeoFabric.sync_cost(congestion=True)``) so Fig. 14-style
per-collective timings reflect contention rather than ideal bisection.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fabric import Fabric, FlowPaths, Link

#: Relative tolerance for deciding a link saturated at this filling level.
_SATURATION_RTOL = 1e-9


@dataclass(frozen=True)
class LinkLoadMatrix:
    """Factorized flow x link incidence with per-link netem attributes.

    Row ``r`` says flow ``mem_flow[r]`` traverses link ``mem_link[r]``
    (an index into ``links``).  ``delay_ms`` is the one-way propagation of
    a single traversal — two netem qdisc passes, as in
    :meth:`repro.core.wan.Netem.one_way_delay_ms` (jitter-free).

    ``slot_occ`` (row-aligned) carries the recorded ECMP hash-slot
    occupancy of each traversal when the paths were recorded by the
    batched router (ones when unavailable); ``slot_key`` the slot
    *identity* of each ECMP traversal (-1 for non-ECMP hops), letting
    occupancy be recounted over flow subsets — see
    :class:`repro.core.fabric.FlowPaths`.
    """

    mem_flow: np.ndarray  # (R,) int64
    mem_link: np.ndarray  # (R,) int64 indices into ``links``
    links: Tuple[Link, ...]
    capacity_gbps: np.ndarray  # (L,) float64
    delay_ms: np.ndarray  # (L,) float64, per single traversal (2 passes)
    is_wan: np.ndarray  # (L,) bool
    num_flows: int
    hops_per_flow: np.ndarray  # (F,) int64 links traversed per flow
    slot_occ: Optional[np.ndarray] = None  # (R,) int64 hash-slot occupancy
    slot_key: Optional[np.ndarray] = None  # (R,) int64 slot identity, -1 = none

    @property
    def max_slot_occ(self) -> np.ndarray:
        """Per-link worst hash-slot occupancy — the observed ECMP hash
        imbalance (1 everywhere when no collision was recorded)."""
        out = np.ones(len(self.links), dtype=np.int64)
        if self.slot_occ is not None and self.mem_link.size:
            np.maximum.at(out, self.mem_link, self.slot_occ)
        return out


def build_link_load_matrix(
    fabric: Fabric, netem, paths: FlowPaths
) -> LinkLoadMatrix:
    """Factorize recorded flow paths into a :class:`LinkLoadMatrix`.

    ``netem`` is a :class:`repro.core.wan.Netem` (typed loosely to keep the
    module import-cycle-free); capacity and delay come from its per-link
    profiles, exactly as the ideal fluid model uses them.
    """
    nflows = paths.num_flows
    n = len(paths.nodes)
    keys = paths.link_u * n + paths.link_v
    uniq, mem_link = np.unique(keys, return_inverse=True)
    links = tuple(
        (paths.nodes[int(k) // n], paths.nodes[int(k) % n]) for k in uniq
    )
    capacity = np.empty(len(links))
    delay = np.empty(len(links))
    is_wan = np.zeros(len(links), dtype=bool)
    for i, (u, v) in enumerate(links):
        prof = netem.profile(u, v)
        capacity[i] = prof.effective_bandwidth_gbps
        delay[i] = 2.0 * prof.delay_ms  # netem qdisc on both interfaces
        is_wan[i] = fabric.is_wan_link(u, v)
    hops = np.diff(paths.ptr)
    mem_flow = np.repeat(np.arange(nflows, dtype=np.int64), hops)
    return LinkLoadMatrix(
        mem_flow=mem_flow,
        mem_link=mem_link.astype(np.int64),
        links=links,
        capacity_gbps=capacity,
        delay_ms=delay,
        is_wan=is_wan,
        num_flows=nflows,
        hops_per_flow=hops.astype(np.int64),
        slot_occ=paths.slot_occ,
        slot_key=paths.slot_key,
    )


def ecmp_flow_weights(paths) -> np.ndarray:
    """Per-flow allocation weights from observed ECMP hash imbalance.

    ``paths`` is a :class:`repro.core.fabric.FlowPaths` (or a
    :class:`LinkLoadMatrix` built from one).  A flow whose worst traversal
    shares its hash slot with ``k - 1`` other flows weighs ``1 / k``:
    same-slot flows are one entity to the switch's hash pipeline, so they
    split one slot's service among themselves wherever bandwidth gets
    scarce.  Flows that never collide weigh 1.0, and a batch with no
    collisions yields the uniform vector — whose weighted allocation is
    byte-identical to the unweighted one.
    """
    if isinstance(paths, LinkLoadMatrix):
        nflows, occ, mem_flow = paths.num_flows, paths.slot_occ, paths.mem_flow
    else:
        nflows = paths.num_flows
        occ = paths.slot_occ
        mem_flow = np.repeat(
            np.arange(nflows, dtype=np.int64), np.diff(paths.ptr)
        )
    worst = np.ones(nflows)
    if occ is not None and mem_flow.size:
        np.maximum.at(worst, mem_flow, occ.astype(np.float64))
    return 1.0 / worst


def concurrent_ecmp_flow_weights(
    matrix: LinkLoadMatrix,
    flow_phase: np.ndarray,
    concurrent: np.ndarray,
    live: Optional[np.ndarray] = None,
) -> np.ndarray:
    """:func:`ecmp_flow_weights` restricted to concurrently-active phases.

    The whole-batch derivation counts every flow of a routed schedule as a
    potential slot collider, which over-penalizes phases that never
    overlap: two serial phases re-using the same 5-tuples land in the same
    hash slots, yet their flows are never in flight together and the
    switch pipeline never queues them behind one another.  Here occupancy
    is recounted from the recorded slot *identities* (``matrix.slot_key``)
    with a phase filter: flow ``f`` of phase ``p`` counts a same-slot flow
    ``g`` of phase ``q`` iff ``concurrent[p, q]`` (a
    :meth:`repro.core.schedule.CollectiveSchedule.concurrency_matrix` —
    True iff neither phase is a DAG ancestor of the other).

    ``flow_phase`` maps each flow id to its phase index; ``live`` masks
    flows that actually transmit bytes (zero-byte chunk flows occupy no
    slot, the routing-time convention).  A single-phase schedule (or an
    all-True matrix) reproduces :func:`ecmp_flow_weights` for live flows.
    """
    nflows = matrix.num_flows
    worst = np.ones(nflows)
    keys = matrix.slot_key
    if keys is None or matrix.mem_flow.size == 0:
        return worst
    flow_phase = np.asarray(flow_phase, dtype=np.int64)
    if flow_phase.shape != (nflows,):
        raise ValueError(f"flow_phase shape {flow_phase.shape} != ({nflows},)")
    conc = np.asarray(concurrent, dtype=bool)
    live = (
        np.ones(nflows, dtype=bool)
        if live is None
        else np.asarray(live, dtype=bool)
    )
    valid = keys >= 0
    rows_f = matrix.mem_flow[valid]
    rows_p = flow_phase[rows_f]
    if rows_f.size == 0:
        return worst
    uniq, inv = np.unique(keys[valid], return_inverse=True)
    counts = np.zeros((uniq.size, conc.shape[0]))
    lr = live[rows_f]
    np.add.at(counts, (inv[lr], rows_p[lr]), 1.0)
    # occupancy seen by a row of phase p in slot s: live same-slot flows
    # of every phase that may run concurrently with p (including itself)
    occ = np.maximum((counts @ conc.T)[inv, rows_p], 1.0)
    np.maximum.at(worst, rows_f, occ)
    return 1.0 / worst


def max_min_rates(
    matrix: LinkLoadMatrix, weights: Optional[np.ndarray] = None
) -> np.ndarray:
    """Max-min fair per-flow rates (Gbit/s) by vectorized water-filling.

    Progressive filling: all unfrozen flows increase at the same rate; the
    link minimizing ``residual capacity / unfrozen flow count`` saturates
    first and freezes its flows at the current level.  Terminates in at
    most ``len(links)`` rounds (>=1 link saturates per round); each round
    is O(active memberships) in NumPy with frozen rows compacted away.

    With ``weights`` (one positive weight per flow, e.g.
    :func:`ecmp_flow_weights`) the filling is weighted: flow ``f`` rises
    at ``weights[f] * level`` and a saturated link's capacity splits
    proportionally to the weights of the flows crossing it.  ``None`` (and
    the all-ones vector, byte-for-byte) is the classic unweighted
    allocation.
    """
    return _max_min_rates_arrays(
        matrix.mem_flow,
        matrix.mem_link,
        matrix.capacity_gbps,
        matrix.num_flows,
        len(matrix.links),
        weights,
    )


def _check_weights(weights: Optional[np.ndarray], nflows: int) -> None:
    if weights is None:
        return
    if weights.shape != (nflows,):
        raise ValueError(
            f"weights shape {weights.shape} != ({nflows},) flows"
        )
    if not np.all(weights > 0):
        raise ValueError("allocation weights must be strictly positive")


def _max_min_rates_arrays(
    mem_f: np.ndarray,
    mem_l: np.ndarray,
    capacity_gbps: np.ndarray,
    nflows: int,
    nlinks: int,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """:func:`max_min_rates` over raw membership arrays.

    **The weighted max-min definition.**  An allocation is (weighted)
    max-min fair when no flow's rate can be raised without lowering the
    rate of another flow whose *normalized* rate (``rate / weight``) is
    already no larger.  Progressive filling computes exactly that fixed
    point: every unfrozen flow ``f`` rises at ``weights[f] * level`` for
    one common scalar ``level``; when a link's residual capacity hits
    zero it *saturates* and freezes every flow crossing it at the current
    level; the loop repeats on the survivors.  Each round the binding
    link is the one minimizing ``residual / (sum of unfrozen member
    weights)``, so a round costs a ``bincount`` + a min over links, and
    the whole solve is ``O(bottleneck levels x active memberships)`` in
    pure NumPy.  ``weights=None`` (or all-ones, byte-for-byte) is the
    classic unweighted allocation.

    **The CSR membership layout.**  ``mem_f``/``mem_l`` are the
    row-aligned halves of a flow x link incidence in coordinate form: row
    ``r`` says flow ``mem_f[r]`` traverses link ``mem_l[r]``.  Rows are
    laid out flow-major in ascending flow order (the
    :func:`build_link_load_matrix` construction:
    ``mem_flow = repeat(arange(F), hops_per_flow)``), so flow ``f``'s
    rows are the contiguous slice ``row_ptr[f]:row_ptr[f+1]`` with
    ``row_ptr = cumsum(hops_per_flow)`` — the property the incremental
    event-loop allocator uses to gather any flow subset's rows in one
    vectorized ragged gather.  ``mem_f``/``mem_l`` may be any subset of a
    matrix's rows (the event-driven simulator passes only the rows of
    currently-active flows); flows with no rows get rate 0.  ``weights``
    is always indexed by global flow id, so a rows subset composes with
    it unchanged.  Summation order matters for bit-identity: NumPy's
    ``bincount`` accumulates in row order, so any two solvers that feed a
    link the same rows in the same ascending order produce bitwise-equal
    per-link sums — the invariant the incremental/full equivalence gate
    rests on.

    This single-level solver is the *static* allocator
    (:func:`congestion_report` and the single-phase fast path).  The
    event loop instead uses the component-decomposed
    :func:`_multi_max_min_rates`: one shared scalar level couples every
    component's float rounding (each round's step is the min over *all*
    links), whereas per-component levels make disjoint subproblems price
    independently — the property that lets an incremental solver reuse
    untouched components' rates bit-for-bit.  The two differ only in
    float rounding (same fixed point, different summation partitions).
    """
    rate = np.zeros(nflows)
    if nflows == 0 or mem_f.size == 0:
        return rate
    _check_weights(weights, nflows)
    resid = capacity_gbps.astype(np.float64).copy()
    level = 0.0
    for _ in range(nlinks + 1):
        if mem_f.size == 0:
            break
        if weights is None:
            n_l = np.bincount(mem_l, minlength=nlinks)
        else:
            n_l = np.bincount(mem_l, weights=weights[mem_f], minlength=nlinks)
        has = n_l > 0
        share = np.full(nlinks, np.inf)
        share[has] = np.maximum(resid[has], 0.0) / n_l[has]
        step = float(share.min())
        if not np.isfinite(step):
            break
        level += step
        resid -= step * n_l
        saturated = has & (share <= step * (1.0 + _SATURATION_RTOL))
        newly = np.unique(mem_f[saturated[mem_l]])
        rate[newly] = level if weights is None else level * weights[newly]
        keep = ~np.isin(mem_f, newly)
        mem_f, mem_l = mem_f[keep], mem_l[keep]
    if mem_f.size:  # numerical stragglers: freeze at the final level
        last = np.unique(mem_f)
        rate[last] = level if weights is None else level * weights[last]
    return rate


# -- component-decomposed epoch allocation (incremental event loop) ----------


def _label_components(
    mem_f: np.ndarray, mem_l: np.ndarray, nflows: int, nlinks: int
) -> Tuple[np.ndarray, int]:
    """Connected components of the flow x link membership rows.

    Two flows are in the same component when they are coupled through a
    chain of shared *directed* links — exactly the transitive "affected
    frontier" of the incremental allocator: a rate change can only ever
    propagate along shared links, so components are the unit of re-solve.
    Labels spread by min-label propagation (scatter-min flow -> link ->
    flow until a fixed point, ``O(diameter)`` vectorized passes).

    Returns ``(comp, ncomp)`` where ``comp`` is a full ``(nflows,)``
    array of compact component ids in ``[0, ncomp)`` (``-1`` for flows
    with no rows present).  Compact ids are ordered by each component's
    minimum flow id, so the labeling is a pure function of the row set.
    """
    comp = np.full(nflows, -1, dtype=np.int64)
    if mem_f.size == 0:
        return comp, 0
    sentinel = np.iinfo(np.int64).max
    flow_lab = np.full(nflows, sentinel, dtype=np.int64)
    present = np.unique(mem_f)
    flow_lab[present] = present
    link_lab = np.full(nlinks, sentinel, dtype=np.int64)
    while True:
        np.minimum.at(link_lab, mem_l, flow_lab[mem_f])
        prev = flow_lab[present].copy()
        np.minimum.at(flow_lab, mem_f, link_lab[mem_l])
        if np.array_equal(flow_lab[present], prev):
            break
    uniq, inv = np.unique(flow_lab[present], return_inverse=True)
    comp[present] = inv
    return comp, int(uniq.size)


def _multi_max_min_rates(
    mem_f: np.ndarray,
    mem_l: np.ndarray,
    capacity_gbps: np.ndarray,
    nflows: int,
    nlinks: int,
    comp_f: np.ndarray,
    ncomp: int,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-component weighted max-min over membership rows (the epoch solver).

    Runs :func:`_max_min_rates_arrays`'s progressive filling on every
    connected component *simultaneously*, each with its own level
    accumulator: per round, each component's unfrozen flows rise by that
    component's own min share (a segment-min over its links), its links'
    residuals drop by exactly that step, and its newly saturated links
    freeze their flows at the component level.  Because every operation
    is elementwise per link / per component, a component's float
    trajectory is *independent of which other components are present in
    the call* — solving the full active set and solving any union of
    whole components give bitwise-identical rates for those components.

    That locality is the whole correctness argument for the incremental
    event loop (the "frontier re-freeze" argument): an arrival/completion
    changes the active-flow sets of the links on the affected flows'
    paths only; components not sharing any of those links keep an
    identical row multiset, and since this solver is a pure function of a
    component's rows (in ascending row order — ``bincount`` sums in row
    order), their previous epoch's rates ARE this epoch's from-scratch
    answer, bit for bit.  Only the dirtied components (changed links plus
    everything transitively attached — after re-labeling, since removals
    can split a component and arrivals can merge several) need re-solving.

    ``comp_f``/``ncomp`` come from :func:`_label_components` on the same
    rows.  Flows with no rows get rate 0.
    """
    rate = np.zeros(nflows)
    if nflows == 0 or mem_f.size == 0:
        return rate
    _check_weights(weights, nflows)
    resid = capacity_gbps.astype(np.float64).copy()
    level = np.zeros(ncomp)
    # link -> component (consistent across a component's rows by definition;
    # links never change component within one solve)
    comp_l = np.full(nlinks, -1, dtype=np.int64)
    comp_l[mem_l] = comp_f[mem_f]
    for _ in range(nlinks + 1):
        if mem_f.size == 0:
            break
        if weights is None:
            n_l = np.bincount(mem_l, minlength=nlinks)
        else:
            n_l = np.bincount(mem_l, weights=weights[mem_f], minlength=nlinks)
        has = np.nonzero(n_l > 0)[0]
        if has.size == 0:
            break
        share = np.full(nlinks, np.inf)
        share[has] = np.maximum(resid[has], 0.0) / n_l[has]
        step_c = np.full(ncomp, np.inf)
        np.minimum.at(step_c, comp_l[has], share[has])
        act = np.isfinite(step_c)
        if not act.any():
            break
        level[act] += step_c[act]
        step_l = np.zeros(nlinks)
        step_l[has] = step_c[comp_l[has]]
        resid -= step_l * n_l
        saturated = np.zeros(nlinks, dtype=bool)
        saturated[has] = share[has] <= step_l[has] * (1.0 + _SATURATION_RTOL)
        newly = np.unique(mem_f[saturated[mem_l]])
        if newly.size:
            lv = level[comp_f[newly]]
            rate[newly] = lv if weights is None else lv * weights[newly]
            keep = ~np.isin(mem_f, newly)
            mem_f, mem_l = mem_f[keep], mem_l[keep]
    if mem_f.size:  # numerical stragglers: freeze at the component level
        last = np.unique(mem_f)
        lv = level[comp_f[last]]
        rate[last] = lv if weights is None else lv * weights[last]
    return rate


class _FullEpochAllocator:
    """From-scratch per-epoch oracle: relabel + re-solve every component.

    The reference implementation the incremental allocator is gated
    byte-identical against (``simulate_schedule(..., incremental=False)``
    and the ``bench_scenarios.py`` SCALED64 speedup gate's slow side):
    each epoch it recomputes the component partition of the full active
    row set and water-fills all components with
    :func:`_multi_max_min_rates`, ``O(active memberships)`` per event
    with no state carried across epochs.
    """

    def __init__(self, matrix: LinkLoadMatrix, weights: Optional[np.ndarray]):
        self._mem_f = matrix.mem_flow
        self._mem_l = matrix.mem_link
        self._caps = matrix.capacity_gbps
        self._nflows = matrix.num_flows
        self._nlinks = len(matrix.links)
        self._weights = weights
        self.rates = np.zeros(self._nflows)
        self.peak = np.zeros(self._nlinks)

    def update(
        self, active: np.ndarray, added: np.ndarray, removed: np.ndarray
    ) -> None:
        rows = active[self._mem_f]
        rf, rl = self._mem_f[rows], self._mem_l[rows]
        comp_f, ncomp = _label_components(rf, rl, self._nflows, self._nlinks)
        self.rates = _multi_max_min_rates(
            rf, rl, self._caps, self._nflows, self._nlinks, comp_f, ncomp,
            self._weights,
        )
        thr = np.bincount(rl, weights=self.rates[rf], minlength=self._nlinks)
        np.maximum(self.peak, thr, out=self.peak)


class _IncrementalAllocator:
    """Warm-started epoch allocator: re-freeze only the affected frontier.

    Maintains across allocation epochs: the component id of every active
    flow and link, each component's member list, every flow's solved
    rate, and every link's summed throughput.  On an event batch
    (``added`` flows entering at a phase start / ``removed`` flows whose
    transfers drained):

    1. the *dirty* component set = the components of every removed flow
       plus every component owning a link that an added flow's path
       touches — exactly the links whose active-flow sets changed, plus
       everything transitively attached through shared links;
    2. dirty members and arrivals are re-labeled from scratch
       (:func:`_label_components` on their rows only — removals can split
       a component, arrivals can merge several);
    3. :func:`_multi_max_min_rates` re-solves just those rows; everyone
       else keeps the previous epoch's rates, which are bitwise what a
       full re-solve would return for them (see the locality argument on
       :func:`_multi_max_min_rates`);
    4. per-link throughput / the running peak are patched on the dirtied
       links only (a clean link's stored sum was computed from the same
       rows and rates a recomputation would use).

    Per event this costs ``O(dirty memberships + nflows)`` instead of the
    oracle's ``O(levels x active memberships)`` — on workloads whose DC
    pairs are independent (the common geo case: per-pair WAN paths share
    no directed link) an event re-solves one pair's flows instead of
    100k.  Gated byte-identical to :class:`_FullEpochAllocator` in
    ``tests/test_incremental_maxmin.py`` (random DAGs) and
    ``benchmarks/bench_scenarios.py`` (library scenarios + SCALED64).
    """

    def __init__(self, matrix: LinkLoadMatrix, weights: Optional[np.ndarray]):
        self._mem_f = matrix.mem_flow
        self._mem_l = matrix.mem_link
        self._caps = matrix.capacity_gbps
        self._nflows = matrix.num_flows
        self._nlinks = len(matrix.links)
        self._weights = weights
        self._hops = matrix.hops_per_flow
        self._row_ptr = np.zeros(self._nflows + 1, dtype=np.int64)
        np.cumsum(self._hops, out=self._row_ptr[1:])
        self._comp_of_flow = np.full(self._nflows, -1, dtype=np.int64)
        self._link_comp = np.full(self._nlinks, -1, dtype=np.int64)
        self._members: Dict[int, np.ndarray] = {}
        self._next_label = 0
        self._thr = np.zeros(self._nlinks)
        self.rates = np.zeros(self._nflows)
        self.peak = np.zeros(self._nlinks)

    def _rows_of(self, flows: np.ndarray) -> np.ndarray:
        """Row indices of ``flows`` (ascending flow ids -> ascending rows)."""
        counts = self._hops[flows]
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64)
        starts = np.repeat(self._row_ptr[flows], counts)
        ends = np.cumsum(counts)
        offsets = np.arange(total, dtype=np.int64) - np.repeat(
            ends - counts, counts
        )
        return starts + offsets

    def update(
        self, active: np.ndarray, added: np.ndarray, removed: np.ndarray
    ) -> None:
        dirty: List[int] = []
        if removed.size:
            dirty.extend(
                int(c) for c in np.unique(self._comp_of_flow[removed])
            )
            self._comp_of_flow[removed] = -1
            self.rates[removed] = 0.0
        if added.size:
            added = np.unique(added)  # sorted, for the ragged row gather
            touched = self._link_comp[self._mem_l[self._rows_of(added)]]
            touched = np.unique(touched[touched >= 0])
            dirty.extend(int(c) for c in touched if int(c) not in dirty)
        stale_members = [self._members.pop(c) for c in dirty if c in self._members]
        parts = stale_members + ([added] if added.size else [])
        if not parts:
            return
        cand = np.unique(np.concatenate(parts))
        if removed.size:
            affected = cand[~np.isin(cand, removed)]
        else:
            affected = cand
        # links whose active-flow sets changed: everything on the paths of
        # the re-solved + departed flows.  Reset, then repatch below.
        reset = affected if not removed.size else np.unique(
            np.concatenate([affected, np.asarray(removed, dtype=np.int64)])
        )
        old_links = np.unique(self._mem_l[self._rows_of(reset)])
        self._link_comp[old_links] = -1
        self._thr[old_links] = 0.0
        if affected.size:
            rows = self._rows_of(affected)
            rf, rl = self._mem_f[rows], self._mem_l[rows]
            comp_f, ncomp = _label_components(
                rf, rl, self._nflows, self._nlinks
            )
            rates = _multi_max_min_rates(
                rf, rl, self._caps, self._nflows, self._nlinks, comp_f, ncomp,
                self._weights,
            )
            self.rates[affected] = rates[affected]
            self._comp_of_flow[affected] = comp_f[affected] + self._next_label
            order = np.argsort(comp_f[affected], kind="stable")
            grouped = affected[order]
            labels = comp_f[affected][order]
            bounds = np.nonzero(np.diff(labels))[0] + 1
            for cid, grp in zip(
                labels[np.concatenate([[0], bounds])] if labels.size else (),
                np.split(grouped, bounds),
            ):
                self._members[int(cid) + self._next_label] = grp
            self._next_label += ncomp
            self._link_comp[rl] = self._comp_of_flow[rf]
            thr = np.bincount(rl, weights=self.rates[rf], minlength=self._nlinks)
            self._thr[old_links] = thr[old_links]
        self.peak[old_links] = np.maximum(
            self.peak[old_links], self._thr[old_links]
        )


def _propagation_ms(matrix: LinkLoadMatrix) -> np.ndarray:
    """One-way path propagation per flow: per-link netem delays (two qdisc
    passes each, already folded into ``delay_ms``) + per-transit-switch
    forwarding latency."""
    from .wan import SWITCH_FORWARDING_MS  # local: wan imports this module

    prop = np.zeros(matrix.num_flows)
    np.add.at(prop, matrix.mem_flow, matrix.delay_ms[matrix.mem_link])
    prop += np.maximum(matrix.hops_per_flow - 1, 0) * SWITCH_FORWARDING_MS
    return prop


@dataclass(frozen=True)
class CongestionReport:
    """Per-flow rates/completions and per-link throughput under contention.

    ``weights`` records the allocation weights the rates were solved under
    (``None`` = unweighted); ``max_slot_occ`` the per-link worst observed
    ECMP hash-slot occupancy (``None`` when paths carried no occupancy).
    """

    rates_gbps: np.ndarray  # (F,) max-min fair allocation
    completion_s: np.ndarray  # (F,) transfer + propagation
    propagation_ms: np.ndarray  # (F,) one-way path propagation
    links: Tuple[Link, ...]
    capacity_gbps: np.ndarray  # (L,)
    throughput_gbps: np.ndarray  # (L,) sum of allocated rates on the link
    is_wan: np.ndarray  # (L,) bool
    weights: Optional[np.ndarray] = None  # (F,) allocation weights
    max_slot_occ: Optional[np.ndarray] = None  # (L,) worst hash-slot occupancy

    @property
    def seconds(self) -> float:
        """Completion time of the whole flow set (slowest flow)."""
        return float(self.completion_s.max()) if self.completion_s.size else 0.0

    @property
    def utilization(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(
                self.capacity_gbps > 0, self.throughput_gbps / self.capacity_gbps, 0.0
            )
        return out

    @property
    def bottleneck_link(self) -> Optional[Link]:
        if not self.links:
            return None
        return self.links[int(np.argmax(self.utilization))]

    @property
    def effective_wan_gbps(self) -> float:
        """Peak per-link WAN throughput — the paper's §5.5 observable
        (~0.8 Gbit/s on a contended spine WAN link)."""
        if not bool(self.is_wan.any()):
            return 0.0
        return float(self.throughput_gbps[self.is_wan].max())


def congestion_report(
    matrix: LinkLoadMatrix,
    nbytes: Sequence[int],
    weights: Optional[np.ndarray] = None,
) -> CongestionReport:
    """Allocate rates and estimate per-flow completion + propagation.

    ``completion = bytes * 8 / rate + one-way propagation`` where the
    propagation sums the recorded path's per-link netem delays (two qdisc
    passes each) plus per-transit-switch forwarding latency — the same
    terms :func:`repro.core.wan.ping_rtt` samples, minus jitter.

    Zero-byte flows do not occupy capacity: they complete after their
    propagation alone and are excluded from the water-filling, exactly as
    the event-driven simulator drains them for free — the two allocators
    share one convention (a zero-byte chunk is an artifact of exact
    ``split_bytes`` chunking, not a bandwidth consumer).

    ``weights`` (e.g. :func:`ecmp_flow_weights`) selects the weighted
    allocation; ``None`` is the classic unweighted model.

    This is the repo's *static* allocator: one allocation epoch, every
    live flow present from t=0 to its own completion, solved by the
    single-level :func:`_max_min_rates_arrays` water-filling.  It is the
    exact model behind ``sync_cost``-style single-collective pricing and
    the single-phase fast path of :func:`simulate_schedule` — those
    numbers are pinned bit-for-bit across PRs, which is why this function
    deliberately does NOT share the event loop's component-decomposed
    solver (:func:`_multi_max_min_rates`): the two reach the same
    weighted max-min fixed point but partition their float summations
    differently (one global level accumulator vs one per component), and
    repartitioning would move the pinned values by ulps.  Anything that
    needs rates *changing over time* — phases arriving, flows draining —
    belongs in :func:`simulate_schedule` instead.
    """
    nb = np.asarray(list(nbytes), dtype=np.float64)
    if nb.size != matrix.num_flows:
        raise ValueError(
            f"{nb.size} byte counts for {matrix.num_flows} recorded paths"
        )
    live = nb[matrix.mem_flow] > 0
    rate = _max_min_rates_arrays(
        matrix.mem_flow[live],
        matrix.mem_link[live],
        matrix.capacity_gbps,
        matrix.num_flows,
        len(matrix.links),
        weights,
    )
    prop = _propagation_ms(matrix)
    with np.errstate(divide="ignore", invalid="ignore"):
        transfer = np.where(nb > 0, nb * 8.0 / (rate * 1e9), 0.0)
    throughput = np.bincount(
        matrix.mem_link, weights=rate[matrix.mem_flow], minlength=len(matrix.links)
    )
    return CongestionReport(
        rates_gbps=rate,
        completion_s=transfer + prop / 1e3,
        propagation_ms=prop,
        links=matrix.links,
        capacity_gbps=matrix.capacity_gbps,
        throughput_gbps=throughput,
        is_wan=matrix.is_wan,
        weights=weights,
        max_slot_occ=(
            matrix.max_slot_occ if matrix.slot_occ is not None else None
        ),
    )


def route_and_analyze(
    fabric: Fabric,
    netem,
    flows: Sequence,
    *,
    check_reachability=None,
    reset_counters: bool = True,
    ecmp_weighted: bool = False,
) -> Tuple[Dict[Link, int], CongestionReport]:
    """Route ``flows`` with path recording and run the congestion model.

    Returns the batch's link byte counters (same contract as
    :func:`repro.core.flows.route_flows_batched`, including the optional
    counter reset) alongside the :class:`CongestionReport`.

    ``ecmp_weighted=True`` derives :func:`ecmp_flow_weights` from the
    recorded hash-slot occupancy and solves the weighted allocation;
    the default keeps the classic unweighted model.
    """
    flows = list(flows)  # consumed twice: routing, then per-flow byte counts
    if reset_counters:
        fabric.reset_counters()
    link_bytes, paths = fabric.route_flows_with_paths(
        flows, check_reachability=check_reachability
    )
    matrix = build_link_load_matrix(fabric, netem, paths)
    weights = ecmp_flow_weights(matrix) if ecmp_weighted else None
    report = congestion_report(matrix, [f.nbytes for f in flows], weights)
    return link_bytes, report


# -- event-driven time-varying simulation (CollectiveSchedule costing) -------

#: Drains within this relative window of the earliest one are processed as a
#: single event (merges the +/-1-byte stragglers of exact ``split_bytes``
#: chunking, which would otherwise each trigger a nanosecond-apart re-solve).
_DRAIN_GROUP_RTOL = 1e-8

#: Default allocator for :func:`simulate_schedule`'s event loop.  ``True``
#: selects the warm-started :class:`_IncrementalAllocator`; ``False`` the
#: from-scratch :class:`_FullEpochAllocator` oracle.  Flip it (or pass
#: ``simulate_schedule(..., incremental=...)``) to A/B the two — they are
#: gated byte-identical, so everything downstream must be unchanged.
INCREMENTAL_EVENT_LOOP = True


def _event_budget(nflows: int, nphases: int) -> int:
    """Max events :func:`_simulate_events` may process before declaring the
    simulator stuck.  Every flow contributes at most one arrival and one
    drain, every phase one start and one completion; the 4x headroom covers
    drain-group fragmentation.  Separate (and monkeypatchable) so the guard
    itself can be regression-tested without building a pathological
    schedule."""
    return 4 * (nflows + nphases) + 64


@dataclass(frozen=True)
class PhaseTiming:
    """When one :class:`repro.core.schedule.Phase` ran in a simulation.

    ``flow_lo:flow_hi`` slices the report's per-flow arrays (flows are laid
    out in the schedule's topological phase order).
    """

    name: str
    start_s: float
    end_s: float
    flow_lo: int
    flow_hi: int
    wan_bytes: int
    compute_seconds: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclass(frozen=True)
class ScheduleReport:
    """Per-phase/per-flow timelines of a simulated :class:`CollectiveSchedule`.

    The schedule-level counterpart of :class:`CongestionReport`: a
    single-phase schedule's report reproduces it exactly (same ``seconds``,
    completions, and peak link throughput), while multi-phase schedules add
    the time dimension — phase start/end, per-flow start/drain/completion,
    and each link's *peak* concurrent throughput across allocation epochs
    (the §5.5 effective-WAN observable generalized to time-varying load).
    """

    schedule_name: str
    phase_timings: Tuple[PhaseTiming, ...]
    flow_start_s: np.ndarray  # (F,) phase-start time of each flow
    flow_drain_s: np.ndarray  # (F,) transfer finished (capacity released)
    completion_s: np.ndarray  # (F,) drain + one-way path propagation
    propagation_ms: np.ndarray  # (F,)
    flow_bytes: np.ndarray  # (F,)
    links: Tuple[Link, ...]
    capacity_gbps: np.ndarray  # (L,)
    link_total_bytes: np.ndarray  # (L,) bytes carried over the whole schedule
    peak_throughput_gbps: np.ndarray  # (L,) max concurrent allocation
    is_wan: np.ndarray  # (L,) bool
    weights: Optional[np.ndarray] = None  # (F,) allocation weights
    max_slot_occ: Optional[np.ndarray] = None  # (L,) worst hash-slot occupancy

    @property
    def seconds(self) -> float:
        """Makespan: completion of the last phase (flows + compute tails)."""
        if not self.phase_timings:
            return 0.0
        return float(max(p.end_s for p in self.phase_timings))

    @property
    def busy_seconds(self) -> np.ndarray:
        """Per-link serial drain time (``bytes * 8 / capacity``) — how long
        the link would need carrying its whole schedule load alone."""
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(
                self.capacity_gbps > 0,
                self.link_total_bytes * 8.0 / (self.capacity_gbps * 1e9),
                0.0,
            )

    @property
    def utilization(self) -> np.ndarray:
        """Time-averaged utilization over the schedule makespan."""
        total = self.seconds
        if total <= 0:
            return np.zeros(len(self.links))
        return self.busy_seconds / total

    @property
    def bottleneck_link(self) -> Optional[Link]:
        if not self.links:
            return None
        return self.links[int(np.argmax(self.busy_seconds))]

    @property
    def bottleneck_bytes(self) -> int:
        if not self.links:
            return 0
        return int(self.link_total_bytes[int(np.argmax(self.busy_seconds))])

    @property
    def bottleneck_utilization(self) -> float:
        if not self.links:
            return 0.0
        return float(self.utilization[int(np.argmax(self.busy_seconds))])

    @property
    def effective_wan_gbps(self) -> float:
        """Peak per-link WAN throughput across the schedule (§5.5)."""
        if not bool(self.is_wan.any()):
            return 0.0
        return float(self.peak_throughput_gbps[self.is_wan].max())

    def phase(self, name: str) -> PhaseTiming:
        for p in self.phase_timings:
            if p.name == name:
                return p
        raise KeyError(f"no phase {name!r} in schedule {self.schedule_name!r}")


def _phase_wan_bytes(
    matrix: LinkLoadMatrix, nb: np.ndarray, lo: int, hi: int
) -> int:
    """Bytes the phase's flows place on WAN links (per-traversal, matching
    the ``link_bytes`` WAN accounting of ``GeoFabric.sync_cost``)."""
    rows = (
        (matrix.mem_flow >= lo)
        & (matrix.mem_flow < hi)
        & matrix.is_wan[matrix.mem_link]
    )
    return int(nb[matrix.mem_flow[rows]].sum())


def simulate_schedule(
    fabric: Fabric,
    netem,
    schedule,
    *,
    check_reachability=None,
    reset_counters: bool = True,
    ecmp_weighted: bool = False,
    incremental: Optional[bool] = None,
) -> ScheduleReport:
    """Event-driven time-varying max-min simulation of a phased schedule.

    ``schedule`` is a :class:`repro.core.schedule.CollectiveSchedule`.  All
    phases' flows are routed in one batch (counters accumulate the whole
    schedule, same contract as :func:`route_and_analyze`); the simulation
    then replays the DAG as a fluid model:

    * a phase starts when its dependencies complete (+ its start offset);
      its flows join the active set;
    * the max-min fair allocation is re-solved — vectorized over the CSR
      membership rows of the *active* flows only — at every flow
      arrival/completion event, so flows arriving or leaving mid-collective
      reshape everyone's fair share (the time-varying congestion the static
      :func:`congestion_report` cannot express);
    * a flow drains when its bytes are transferred at the evolving rates
      and completes one path-propagation later; a phase completes when all
      its flows have completed and its ``compute_seconds`` have elapsed.

    A single-phase schedule takes a fast path through the static
    :func:`congestion_report` — with one allocation epoch the two models
    coincide, and the shortcut keeps the equivalence *exact* (bit-for-bit
    the ``wan_seconds`` the pre-schedule ``sync_cost`` returned) rather
    than within float tolerance of the event loop.

    ``ecmp_weighted=True`` solves every allocation epoch as a *weighted*
    max-min: single-phase schedules use the whole-batch
    :func:`ecmp_flow_weights`; multi-phase schedules use
    :func:`concurrent_ecmp_flow_weights`, which counts a hash-slot
    collision only between phases the DAG allows in flight together —
    serialized phases re-using the same slots are not down-weighted
    against each other.

    ``incremental`` selects the multi-phase epoch allocator:
    ``True`` -> :class:`_IncrementalAllocator` (warm-started, the default),
    ``False`` -> :class:`_FullEpochAllocator` (from-scratch oracle),
    ``None`` -> the module flag :data:`INCREMENTAL_EVENT_LOOP`.  The two are
    byte-identical by construction (see :func:`_multi_max_min_rates`), so
    this knob only trades wall-clock, never results.
    """
    phases = schedule.phases
    flows = schedule.all_flows()
    slices = schedule.flow_slices()
    if reset_counters:
        fabric.reset_counters()
    _, paths = fabric.route_flows_with_paths(
        flows, check_reachability=check_reachability
    )
    matrix = build_link_load_matrix(fabric, netem, paths)
    nb = np.asarray([f.nbytes for f in flows], dtype=np.float64)
    weights = None
    if ecmp_weighted:
        if schedule.is_single_phase:
            weights = ecmp_flow_weights(matrix)
        else:
            # multi-phase: hash collisions only matter between phases that
            # can actually be in flight together — serialized phases
            # re-using the same slots must not down-weight each other
            flow_phase = np.empty(len(flows), dtype=np.int64)
            for i, (plo, phi) in enumerate(slices):
                flow_phase[plo:phi] = i
            weights = concurrent_ecmp_flow_weights(
                matrix, flow_phase, schedule.concurrency_matrix(), live=nb > 0
            )
    nlinks = len(matrix.links)
    link_total = np.bincount(
        matrix.mem_link, weights=nb[matrix.mem_flow], minlength=nlinks
    )

    if schedule.is_single_phase:
        rep = congestion_report(matrix, nb, weights)
        drain = rep.completion_s - rep.propagation_ms / 1e3
        timing = PhaseTiming(
            name=phases[0].name,
            start_s=0.0,
            end_s=rep.seconds,
            flow_lo=0,
            flow_hi=len(flows),
            wan_bytes=_phase_wan_bytes(matrix, nb, 0, len(flows)),
        )
        return ScheduleReport(
            schedule_name=schedule.name,
            phase_timings=(timing,),
            flow_start_s=np.zeros(len(flows)),
            flow_drain_s=drain,
            completion_s=rep.completion_s,
            propagation_ms=rep.propagation_ms,
            flow_bytes=nb,
            links=matrix.links,
            capacity_gbps=matrix.capacity_gbps,
            link_total_bytes=link_total,
            peak_throughput_gbps=rep.throughput_gbps,
            is_wan=matrix.is_wan,
            weights=weights,
            max_slot_occ=rep.max_slot_occ,
        )

    if incremental is None:
        incremental = INCREMENTAL_EVENT_LOOP
    return _simulate_events(
        schedule, matrix, nb, slices, link_total, weights,
        incremental=incremental,
    )


def _simulate_events(
    schedule,
    matrix: LinkLoadMatrix,
    nb: np.ndarray,
    slices: List[Tuple[int, int]],
    link_total: np.ndarray,
    weights: Optional[np.ndarray] = None,
    incremental: bool = True,
) -> ScheduleReport:
    import heapq

    phases = schedule.phases
    nphases = len(phases)
    nflows = int(nb.size)
    prop_ms = _propagation_ms(matrix)
    name_to_idx = {p.name: i for i, p in enumerate(phases)}
    dependents: List[List[int]] = [[] for _ in range(nphases)]
    pending = np.zeros(nphases, dtype=np.int64)
    for i, p in enumerate(phases):
        pending[i] = len(p.deps)
        for d in p.deps:
            dependents[name_to_idx[d]].append(i)

    remaining = nb * 8.0  # bits still to transfer
    active = np.zeros(nflows, dtype=bool)
    flow_phase = np.empty(nflows, dtype=np.int64)
    for i, (plo, phi) in enumerate(slices):
        flow_phase[plo:phi] = i
    undrained = np.asarray([hi - lo for lo, hi in slices], dtype=np.int64)
    flow_start = np.zeros(nflows)
    flow_drain = np.zeros(nflows)
    flow_complete = np.zeros(nflows)
    phase_start = np.zeros(nphases)
    phase_end = np.zeros(nphases)
    alloc_cls = _IncrementalAllocator if incremental else _FullEpochAllocator
    alloc = alloc_cls(matrix, weights)
    rates = alloc.rates
    # flows that joined/left the active set since the last allocation epoch —
    # handed to the allocator as one batch at the next stale re-solve
    pend_add: List[np.ndarray] = []
    pend_rm: List[np.ndarray] = []
    _empty = np.empty(0, dtype=np.int64)

    _START, _COMPLETE = 0, 1
    heap: List[Tuple[float, int, int, int]] = []
    seq = 0
    for i, p in enumerate(phases):
        if not p.deps:
            heapq.heappush(heap, (p.start_offset_s, seq, _START, i))
            seq += 1

    def finish_phase(i: int, t: float) -> float:
        """Completion time of phase i once its last flow has drained."""
        plo, phi = slices[i]
        end = phase_start[i] + phases[i].compute_seconds
        if phi > plo:
            end = max(end, float(flow_complete[plo:phi].max()))
        return max(end, t)

    t = 0.0
    stale = True
    guard = 0
    max_events = _event_budget(nflows, nphases)
    while heap or bool(active.any()):
        guard += 1
        if guard > max_events:
            raise RuntimeError(
                f"schedule {schedule.name!r}: event budget exceeded "
                f"({max_events}) — simulator stuck"
            )
        act_idx = np.nonzero(active)[0]
        if stale and act_idx.size:
            added = np.concatenate(pend_add) if pend_add else _empty
            removed = np.concatenate(pend_rm) if pend_rm else _empty
            pend_add.clear()
            pend_rm.clear()
            alloc.update(active, added, removed)
            rates = alloc.rates
            stale = False
        if act_idx.size:
            with np.errstate(divide="ignore", invalid="ignore"):
                ttd = remaining[act_idx] / (rates[act_idx] * 1e9)
            t_drain = float(ttd.min())
        else:
            ttd = None
            t_drain = np.inf
        t_heap = heap[0][0] if heap else np.inf
        if not np.isfinite(t_drain) and not heap:
            raise RuntimeError(
                f"schedule {schedule.name!r}: active flows can make no "
                "progress (zero-capacity path?)"
            )
        if t_heap <= t + t_drain:
            # advance to the heap event; in-flight transfers progress
            dt = max(t_heap - t, 0.0)
            if act_idx.size and dt > 0:
                remaining[act_idx] -= rates[act_idx] * 1e9 * dt
            t = t_heap
            while heap and heap[0][0] <= t:
                _, _, kind, i = heapq.heappop(heap)
                plo, phi = slices[i]
                if kind == _START:
                    phase_start[i] = t
                    flow_start[plo:phi] = t
                    zero = plo + np.nonzero(nb[plo:phi] <= 0)[0]
                    if zero.size:
                        flow_drain[zero] = t
                        flow_complete[zero] = t + prop_ms[zero] / 1e3
                        undrained[i] -= zero.size
                    live = plo + np.nonzero(nb[plo:phi] > 0)[0]
                    if live.size:
                        active[live] = True
                        pend_add.append(live)
                        stale = True
                    if undrained[i] == 0:
                        heapq.heappush(
                            heap, (finish_phase(i, t), seq, _COMPLETE, i)
                        )
                        seq += 1
                else:  # _COMPLETE
                    phase_end[i] = t
                    for q in dependents[i]:
                        pending[q] -= 1
                        if pending[q] == 0:
                            start = (
                                max(phase_end[name_to_idx[d]] for d in phases[q].deps)
                                + phases[q].start_offset_s
                            )
                            heapq.heappush(heap, (start, seq, _START, q))
                            seq += 1
            continue
        # advance to the next drain group
        group = act_idx[ttd <= t_drain * (1.0 + _DRAIN_GROUP_RTOL) + 1e-15]
        remaining[act_idx] -= rates[act_idx] * 1e9 * t_drain
        t += t_drain
        remaining[group] = 0.0
        active[group] = False
        flow_drain[group] = t
        flow_complete[group] = t + prop_ms[group] / 1e3
        pend_rm.append(group)
        stale = True
        undrained -= np.bincount(flow_phase[group], minlength=nphases)
        for i in np.unique(flow_phase[group]).tolist():
            if undrained[i] == 0:
                heapq.heappush(heap, (finish_phase(i, t), seq, _COMPLETE, i))
                seq += 1

    timings = tuple(
        PhaseTiming(
            name=p.name,
            start_s=float(phase_start[i]),
            end_s=float(phase_end[i]),
            flow_lo=slices[i][0],
            flow_hi=slices[i][1],
            wan_bytes=_phase_wan_bytes(matrix, nb, *slices[i]),
            compute_seconds=p.compute_seconds,
        )
        for i, p in enumerate(phases)
    )
    return ScheduleReport(
        schedule_name=schedule.name,
        phase_timings=timings,
        flow_start_s=flow_start,
        flow_drain_s=flow_drain,
        completion_s=flow_complete,
        propagation_ms=prop_ms,
        flow_bytes=nb,
        links=matrix.links,
        capacity_gbps=matrix.capacity_gbps,
        link_total_bytes=link_total,
        peak_throughput_gbps=alloc.peak,
        is_wan=matrix.is_wan,
        weights=weights,
        max_slot_occ=(
            matrix.max_slot_occ if matrix.slot_occ is not None else None
        ),
    )
