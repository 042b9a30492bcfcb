"""Collective operation -> queue-pair flow synthesis (paper §3.3, §5.5).

NCCL-style collectives chunk a tensor across ``num_channels`` independent
queue pairs per peer connection ("a 4 GB gradient using four channels is
divided into four 1 GB chunks, where each chunk is assigned to a separate
QP" — §3.3).  This module turns a logical collective among fabric hosts
into the concrete set of (src, dst, bytes, QP) flows the fabric routes.

Patterns (each emits the same :class:`Flow` records, so the QP-aware vs.
baseline port-allocation comparison runs unchanged across all of them):

* :func:`ring_allreduce_flows` — bidirectional ring; each worker ships
  ``2*(N-1)/N * B`` bytes to its ring successor across the whole op;
* :func:`reduce_scatter_flows` / :func:`all_gather_flows` — the two ring
  phases individually (``(N-1)/N * B`` per worker each), for schedules
  that overlap them with compute;
* :func:`parameter_server_flows` — push (worker->PS, B bytes each) and pull
  (PS->worker, B bytes each);
* :func:`all_to_all_flows` — MoE expert-parallel dispatch/combine
  (``B/N`` from every worker to every other worker), the pattern that
  stresses WAN fabrics very differently from rings (arXiv 2407.12819);
* :func:`pipeline_p2p_flows` — GeoPipe-style stage-to-stage activation
  traffic between pipeline stages (arXiv 2510.12064);
* :func:`hierarchical_flows` — the beyond-paper geo schedule: only the
  1/N_local shard crosses the WAN between DC leaders;
* :func:`hierarchical_all_to_all_flows` — two-phase MoE all-to-all
  (intra-DC dispatch to the pod leader, leader-only WAN combine), built
  for the :mod:`repro.core.schedule` phased scheduler.

Per-pattern byte totals are exact: remainders from integer division are
spread one byte at a time over the first channels (see
:func:`split_bytes`), never silently dropped.

Routing: :func:`route_flows` walks the fabric per flow (reference);
:func:`route_flows_batched` drives
:meth:`repro.core.fabric.Fabric.route_flows_batched`, the vectorized
engine, and produces byte-identical link counters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

from .fabric import Fabric, FlowPaths, Link
from .ports import QueuePair, allocate_ports


@dataclass(frozen=True)
class Flow:
    src: str
    dst: str
    nbytes: int
    qp: QueuePair
    src_port: int


def split_bytes(total: int, parts: int) -> List[int]:
    """Split ``total`` bytes into ``parts`` near-equal chunks, exactly.

    The first ``total % parts`` chunks carry one extra byte, so
    ``sum(split_bytes(B, n)) == B`` always — no silent truncation.
    """
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    base, rem = divmod(int(total), parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def _qps_for_pair(
    pair_id: int,
    num_channels: int,
    scheme: str,
    k_bins: int,
    base_qpn: int,
    qp_stride: int,
) -> List[Tuple[QueuePair, int]]:
    qps = [
        QueuePair(index=i, number=(base_qpn + pair_id * 131 + i * qp_stride) & 0xFFFFFFFF)
        for i in range(num_channels)
    ]
    ports = allocate_ports(qps, scheme=scheme, k=k_bins)
    return list(zip(qps, ports))


def _pair_flows(
    src: str,
    dst: str,
    pair_id: int,
    total_bytes: int,
    num_channels: int,
    scheme: str,
    k_bins: int,
    base_qpn: int,
    qp_stride: int,
) -> List[Flow]:
    """One peer connection: ``total_bytes`` striped exactly over channels."""
    chunks = split_bytes(total_bytes, num_channels)
    return [
        Flow(src=src, dst=dst, nbytes=chunk, qp=qp, src_port=port)
        for chunk, (qp, port) in zip(
            chunks, _qps_for_pair(pair_id, num_channels, scheme, k_bins, base_qpn, qp_stride)
        )
    ]


def open_loop_flows(
    src: str,
    dst: str,
    flow_id: int,
    nbytes: int,
    *,
    num_channels: int = 1,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x5E0000,
    qp_stride: int = 1,
) -> List[Flow]:
    """One open-loop transfer (a serving request's KV handoff or a session
    migration): ``nbytes`` from ``src`` to ``dst`` as its own peer
    connection.

    ``flow_id`` plays the role the collectives' ``pair_id`` plays — it
    seeds the QPN so every request hashes independently under ECMP.  The
    ``base_qpn`` default puts serving QPs in a plane disjoint from the
    collectives' ``0x11`` so co-scheduled traffic never collides on a
    queue pair number.
    """
    if nbytes <= 0:
        return []
    return _pair_flows(
        src, dst, int(flow_id), int(nbytes), num_channels, scheme, k_bins,
        base_qpn, qp_stride,
    )


def ring_allreduce_flows(
    workers: Sequence[str],
    total_bytes: int,
    *,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """Ring all-reduce: reduce-scatter + all-gather = 2*(N-1)/N * B per hop."""
    n = len(workers)
    if n < 2:
        return []
    per_link_bytes = (2 * (n - 1) * int(total_bytes)) // n
    flows: List[Flow] = []
    for i, src in enumerate(workers):
        dst = workers[(i + 1) % n]
        flows += _pair_flows(
            src, dst, i, per_link_bytes, num_channels, scheme, k_bins, base_qpn, qp_stride
        )
    return flows


def reduce_scatter_flows(
    workers: Sequence[str],
    total_bytes: int,
    *,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """Ring reduce-scatter: each worker ships (N-1)/N * B to its successor."""
    n = len(workers)
    if n < 2:
        return []
    per_link_bytes = ((n - 1) * int(total_bytes)) // n
    flows: List[Flow] = []
    for i, src in enumerate(workers):
        dst = workers[(i + 1) % n]
        flows += _pair_flows(
            src, dst, i, per_link_bytes, num_channels, scheme, k_bins, base_qpn, qp_stride
        )
    return flows


def all_gather_flows(
    workers: Sequence[str],
    total_bytes: int,
    *,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """Ring all-gather: same wire volume as reduce-scatter, distinct QPs.

    ``base_qpn`` is offset past the entire QP-number span a same-sized
    reduce-scatter would use (pair ids stride by 131, channels by
    ``qp_stride``), so a reduce-scatter + all-gather pair composed by a
    scheduler uses disjoint connection groups (as NCCL does) at any
    worker count.
    """
    rs_span = 131 * len(workers) + num_channels * max(qp_stride, 1)
    return reduce_scatter_flows(
        workers,
        total_bytes,
        num_channels=num_channels,
        scheme=scheme,
        k_bins=k_bins,
        base_qpn=base_qpn + rs_span,
        qp_stride=qp_stride,
    )


def parameter_server_flows(
    server: str,
    workers: Sequence[str],
    grad_bytes: int,
    *,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
    direction: str = "both",
) -> List[Flow]:
    """PS push+pull: every worker sends B to the server and receives B back.

    ``direction`` selects the ``"push"`` (worker -> server) or ``"pull"``
    (server -> worker) half individually so a phased scheduler can compose
    push-then-pull as two dependent phases; ``"both"`` (default) emits the
    full concurrent set with identical QPs/ports either way.
    """
    if direction not in ("both", "push", "pull"):
        raise ValueError(f"direction must be both|push|pull, got {direction!r}")
    flows: List[Flow] = []
    for wi, worker in enumerate(workers):
        if direction in ("both", "push"):
            flows += _pair_flows(
                worker, server, wi, grad_bytes, num_channels, scheme, k_bins,
                base_qpn, qp_stride,
            )
        if direction in ("both", "pull"):
            flows += _pair_flows(
                server, worker, 1000 + wi, grad_bytes, num_channels, scheme, k_bins,
                base_qpn, qp_stride,
            )
    return flows


def all_to_all_flows(
    workers: Sequence[str],
    total_bytes: int,
    *,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """MoE expert-parallel all-to-all: B/N from every worker to every peer.

    Models the dispatch (or combine) phase of expert parallelism — e.g. the
    shipped ``mixtral_8x22b`` / ``arctic_480b`` configs — where each worker
    scatters an equal token shard to every other worker.  N*(N-1) peer
    connections x ``num_channels`` QPs; per-connection bytes are
    ``split_bytes(B, N)[j]`` so the total dispatched per worker is exactly
    ``B`` minus the self-shard (which never hits the wire).
    """
    n = len(workers)
    if n < 2:
        return []
    shards = split_bytes(int(total_bytes), n)
    flows: List[Flow] = []
    for i, src in enumerate(workers):
        for j, dst in enumerate(workers):
            if i == j:
                continue
            flows += _pair_flows(
                src, dst, i * n + j, shards[j], num_channels, scheme, k_bins,
                base_qpn, qp_stride,
            )
    return flows


def pipeline_p2p_flows(
    stages: Sequence[Union[str, Sequence[str]]],
    activation_bytes: int,
    *,
    num_microbatches: int = 1,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """GeoPipe-style pipeline-parallel point-to-point stage traffic.

    ``stages`` is an ordered list of pipeline stages, each either one host
    or a list of hosts (tensor-parallel ranks within the stage).  Each rank
    of stage ``s`` streams ``activation_bytes * num_microbatches`` to the
    same-index rank of stage ``s+1`` (ranks pair round-robin when stage
    widths differ) — the WAN-crossing activation/gradient traffic of
    pipeline parallelism across DCs (arXiv 2510.12064).
    """
    norm: List[List[str]] = [
        [st] if isinstance(st, str) else list(st) for st in stages
    ]
    if any(not st for st in norm):
        raise ValueError("every pipeline stage needs at least one host")
    if len(norm) < 2:
        return []
    per_rank = int(activation_bytes) * int(num_microbatches)
    flows: List[Flow] = []
    pair_id = 0
    for s in range(len(norm) - 1):
        cur, nxt = norm[s], norm[s + 1]
        width = max(len(cur), len(nxt))
        for r in range(width):
            src = cur[r % len(cur)]
            dst = nxt[r % len(nxt)]
            flows += _pair_flows(
                src, dst, pair_id, per_rank, num_channels, scheme, k_bins,
                base_qpn, qp_stride,
            )
            pair_id += 1
    return flows


def hierarchical_all_to_all_flows(
    pods: Sequence[Sequence[str]],
    total_bytes: int,
    *,
    phase: str = "both",
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """Hierarchical MoE all-to-all: intra-DC dispatch + leader-only WAN combine.

    ``pods`` is one worker list per DC (first member is the pod leader).
    Each worker holds ``total_bytes`` of expert-bound tokens split uniformly
    across pods (:func:`split_bytes`, so totals are exact); the flat
    all-to-all would push every worker's remote shard straight across the
    WAN.  The hierarchical schedule instead runs two phases:

    * ``"dispatch"`` — every non-leader worker forwards its remote-destined
      bytes (``total_bytes`` minus its own pod's shard) to the pod leader
      over the local fabric;
    * ``"combine"`` — leaders exchange the pod-aggregated shards
      (``n_local * shard`` per destination pod) as a leader-only all-to-all,
      the only traffic that crosses the WAN.

    ``phase`` selects one half for a phased scheduler (QP numbering is
    stable across selections, so dispatch/combine flows built separately are
    identical to the matching halves of ``"both"``); the per-pod WAN volume
    is ``n_local * (P-1)/P * B`` concentrated on the leader, versus the flat
    all-to-all's identical volume spread over ``n_local`` distinct
    host-level WAN paths — same bytes, fewer contending WAN flows.
    """
    if phase not in ("both", "dispatch", "combine"):
        raise ValueError(f"phase must be both|dispatch|combine, got {phase!r}")
    norm: List[List[str]] = [list(p) for p in pods]
    if any(not p for p in norm):
        raise ValueError("every pod needs at least one worker")
    n_pods = len(norm)
    if n_pods < 2:
        return []
    shards = split_bytes(int(total_bytes), n_pods)
    flows: List[Flow] = []
    pair_id = 0
    for p, members in enumerate(norm):
        leader = members[0]
        remote_bytes = int(total_bytes) - shards[p]
        for worker in members[1:]:
            if phase in ("both", "dispatch"):
                flows += _pair_flows(
                    worker, leader, pair_id, remote_bytes, num_channels, scheme,
                    k_bins, base_qpn, qp_stride,
                )
            pair_id += 1  # advances regardless of phase: stable QP identity
    pair_id = 100_000  # combine pair ids disjoint from any dispatch count
    for p, members in enumerate(norm):
        for q in range(n_pods):
            if p == q:
                continue
            if phase in ("both", "combine"):
                flows += _pair_flows(
                    members[0], norm[q][0], pair_id, len(members) * shards[q],
                    num_channels, scheme, k_bins, base_qpn, qp_stride,
                )
            pair_id += 1
    return flows


def hierarchical_flows(
    dc_leaders: Sequence[str],
    shard_bytes: int,
    *,
    num_channels: int = 4,
    scheme: str = "qp_aware",
    k_bins: int = 4,
    base_qpn: int = 0x11,
    qp_stride: int = 1,
) -> List[Flow]:
    """Cross-DC leader ring over the WAN carrying only the local shard.

    Models the geo-hierarchical schedule: intra-DC reduce-scatter happens on
    the (fast) local fabric; only ``shard_bytes = B / n_local`` per leader
    crosses the WAN, as a ring among DC leaders.
    """
    return ring_allreduce_flows(
        dc_leaders,
        shard_bytes,
        num_channels=num_channels,
        scheme=scheme,
        k_bins=k_bins,
        base_qpn=base_qpn,
        qp_stride=qp_stride,
    )


def route_flows(
    fabric: Fabric,
    flows: Sequence[Flow],
    *,
    check_reachability=None,
) -> Dict[Link, int]:
    """Route every flow through the fabric; returns the link byte counters.

    Reference per-flow path — byte-identical to
    :func:`route_flows_batched`, which should be preferred for anything
    beyond Fig. 1 scale.
    """
    fabric.reset_counters()
    for flow in flows:
        fabric.send(
            flow.src,
            flow.dst,
            flow.nbytes,
            src_port=flow.src_port,
            check_reachability=check_reachability,
        )
    return dict(fabric.link_bytes)


def route_flows_batched(
    fabric: Fabric,
    flows: Sequence[Flow],
    *,
    check_reachability=None,
) -> Dict[Link, int]:
    """Vectorized counterpart of :func:`route_flows` (same contract).

    Resets the fabric counters, then routes the whole batch through
    :meth:`Fabric.route_flows_batched`.  Unlike the sequential path, an
    unreachable flow raises *before* any counter is touched.
    """
    fabric.reset_counters()
    return fabric.route_flows_batched(flows, check_reachability=check_reachability)


def route_flows_with_paths(
    fabric: Fabric,
    flows: Sequence[Flow],
    *,
    check_reachability=None,
) -> Tuple[Dict[Link, int], FlowPaths]:
    """:func:`route_flows_batched` plus per-flow path recording.

    Same reset-and-route contract; additionally returns the CSR
    :class:`repro.core.fabric.FlowPaths` consumed by the flow-level
    congestion model (:mod:`repro.core.congestion`).
    """
    fabric.reset_counters()
    return fabric.route_flows_with_paths(flows, check_reachability=check_reachability)
