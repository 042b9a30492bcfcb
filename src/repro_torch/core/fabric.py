"""Emulated multi-data-center spine-leaf fabric (ScaleAcross §4).

Pure-Python, byte-accurate (not packet-accurate) model of the topology in
Fig. 1 of the paper: ``num_dcs`` data centers, each a spine-leaf Clos
(``spines_per_dc`` × ``leaves_per_dc``), hosts attached to leaves, and
full-bipartite spine↔spine WAN links between data centers.

Responsibilities:

* underlay graph + equal-cost shortest-path routing with per-hop ECMP
  (5-tuple CRC hash, per-switch seed — the paper's commodity pipeline);
* VXLAN data plane: host frames are encapsulated at the ingress leaf (VTEP),
  routed leaf→leaf through the underlay, decapsulated at the egress leaf —
  reachability is governed by the EVPN control plane (``evpn.py``);
* per-directed-link byte counters, from which the load factor (Eq. 12) and
  path-distribution skew (Eqs. 3–11) are computed.

Two routing engines share the same hash semantics:

* :meth:`Fabric.send` / :meth:`Fabric.route_flow` — per-flow hop-by-hop
  Python walk (reference path, fine for the paper's 9-host Fig. 1 scale);
* :meth:`Fabric.route_flows_batched` — the production-scale engine: the
  BFS DAGs from ``_distances_to`` are compiled into per-destination
  integer next-hop tables, and the per-switch-seeded CRC-32 hash is
  vectorized over all flows at once via CRC linearity
  (``crc32(key, seed) == crc32(key, 0) ^ crc32(0^len, seed) ^
  crc32(0^len, 0)``), so one ``zlib.crc32`` per flow plus NumPy
  XOR/mod/gather replaces per-hop dict lookups and ``sorted()`` calls.
  Byte-identical to the sequential walk (asserted in
  ``tests/test_flows_batched.py``) and >=10x faster on >=10k-flow
  workloads (``benchmarks/bench_collectives.py``).

Incremental failover re-convergence (paper §5.3, Fig. 9 at scale): a link
flap does **not** flush the routing state wholesale.  While compiling
``_distances_to(dst)`` the fabric records a reverse *link -> destination*
dependency index: a destination depends on a live link iff the link lies
on its BFS shortest-path DAG (``|dist[u] - dist[v]| == 1``), and on a
down link iff restoring it would shorten a distance or add an equal-cost
choice.  ``fail_link``/``restore_link`` consult that index and touch only
the dependent destinations — and when the flap provably leaves every BFS
distance unchanged (the far endpoint keeps another equal-cost next hop),
the cached next-hop table is patched *in place* (one row) instead of being
rebuilt.  The interned pair registry, template CRCs and per-switch
seed-XOR columns are never invalidated, so ``route_flows_batched`` stays
warm across BFD-cadence flap storms (``benchmarks/bench_failover.py``
gates >=10x re-convergence speedup vs. full invalidation, byte-identical
counters as the check).

:meth:`Fabric.route_flows_with_paths` additionally records every flow's
directed-link path (CSR :class:`FlowPaths`) — the input to the
flow-level congestion model in :mod:`repro.core.congestion`.

Node naming follows the paper: ``d{i}s{j}`` spines, ``d{i}l{j}`` leaves,
``d{i}h{j}`` hosts (1-based, e.g. ``d1l1`` = leaf 1 of DC 1).
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

Link = Tuple[str, str]  # directed (u, v)


@dataclass(frozen=True)
class FiveTuple:
    """Packet 5-tuple as hashed by commodity ECMP pipelines."""

    src_ip: str
    dst_ip: str
    src_port: int
    dst_port: int
    proto: int = 17  # UDP (RoCEv2 / VXLAN)

    def key_bytes(self) -> bytes:
        return f"{self.src_ip}|{self.dst_ip}|{self.src_port}|{self.dst_port}|{self.proto}".encode()


def ecmp_hash(tup: FiveTuple, seed: int, num_choices: int) -> int:
    """CRC-32 5-tuple hash with a per-switch seed, modulo the fan-out.

    Commodity switches hash the same fields but mix in a chip-specific seed
    so consecutive hops do not make perfectly correlated decisions; we model
    that with the seed argument.
    """
    h = zlib.crc32(tup.key_bytes(), seed & 0xFFFFFFFF)
    return h % num_choices


# VXLAN outer UDP destination port (RFC 7348) and RoCEv2 destination port.
VXLAN_DST_PORT = 4789
ROCE_DST_PORT = 4791

#: ECMP member-table bucket space per (switch, destination) group.  Commodity
#: ASICs resolve the 5-tuple hash into a small per-group member table (tens to
#: a few hundred buckets) before mapping buckets onto egress members; two
#: flows whose hashes land in the same bucket are indistinguishable to the
#: pipeline — they always pick the same member and share its scheduling slot.
#: ``route_flows_with_paths`` records that slot occupancy per traversal, the
#: observable the weighted congestion model derives allocation weights from.
ECMP_HASH_BUCKETS = 64

@lru_cache(maxsize=64)
def _digit_gamma(tail: int) -> "np.ndarray":
    """CRC-32 contribution of decimal digit ``d`` placed ``tail`` bytes
    before the end of a message.

    CRC-32 is linear over GF(2), so flipping one byte changes the checksum
    by a value that depends only on the byte's XOR delta and its distance
    from the end: ``crc32(msg_with_d) == crc32(msg_with_'0') ^ gamma[d]``
    (digit chars are ``0x30 + d``, so the delta is ``d`` itself).  This is
    what lets the batched router evaluate the five-tuple hash for every
    flow without calling ``zlib.crc32`` per flow.
    """
    zeros = b"\x00" * tail
    base = zlib.crc32(b"\x00" + zeros)
    return np.array(
        [zlib.crc32(bytes((d,)) + zeros) ^ base for d in range(10)],
        dtype=np.uint32,
    )


@lru_cache(maxsize=16)
def _gamma_block(suffix_len: int) -> "np.ndarray":
    """(5, 10) digit-gamma table for a 5-digit port followed by a suffix."""
    return np.stack([_digit_gamma(suffix_len + (4 - k)) for k in range(5)])


def vxlan_outer_tuple(inner: FiveTuple, src_vtep_ip: str, dst_vtep_ip: str) -> FiveTuple:
    """Outer header built by the ingress VTEP.

    Per RFC 7348 the VTEP derives the outer UDP source port from a hash of
    the inner frame so that inner-flow entropy survives encapsulation; the
    inner RoCEv2 source port therefore still steers ECMP in the underlay.
    """
    entropy = zlib.crc32(inner.key_bytes()) & 0x3FFF
    return FiveTuple(
        src_ip=src_vtep_ip,
        dst_ip=dst_vtep_ip,
        src_port=0xC000 + entropy,
        dst_port=VXLAN_DST_PORT,
    )


@dataclass(frozen=True)
class FabricConfig:
    """Topology knobs.  Defaults mirror the paper's Fig. 1."""

    num_dcs: int = 2
    spines_per_dc: int = 2
    leaves_per_dc: int = 3
    # hosts per leaf, per DC; paper: DC1 = 5 hosts, DC2 = 4 hosts over 3 leaves.
    hosts_per_leaf: Tuple[Tuple[int, ...], ...] = ((2, 2, 1), (2, 2, 0))
    link_gbps: float = 10.0
    wan_gbps: float = 0.8  # paper measured ~800 Mbit/s effective on spine WAN links
    #: ECMP member-table bucket space per (switch, destination) group — the
    #: per-switch realism knob for hash-slot collision modeling (see
    #: :data:`ECMP_HASH_BUCKETS`, the default matching commodity ASICs).
    #: Smaller values model cheaper pipelines with denser hash collisions.
    ecmp_hash_buckets: int = ECMP_HASH_BUCKETS

    def validate(self) -> None:
        if len(self.hosts_per_leaf) != self.num_dcs:
            raise ValueError("hosts_per_leaf must have one tuple per DC")
        for dc, per_leaf in enumerate(self.hosts_per_leaf):
            if len(per_leaf) != self.leaves_per_dc:
                raise ValueError(f"DC{dc + 1}: expected {self.leaves_per_dc} leaf host counts")
        if self.ecmp_hash_buckets < 1:
            raise ValueError("ecmp_hash_buckets must be >= 1")


@dataclass
class Host:
    name: str
    dc: int  # 1-based
    leaf: str
    ip: str
    mac: str
    vni: Optional[int] = None


@dataclass(frozen=True)
class RerouteStats:
    """What one ``fail_link``/``restore_link`` did to the routing state.

    ``patched``  — compiled next-hop tables repaired in place (one row);
    ``rebuilt``  — cached destinations evicted for a full BFS rebuild;
    ``retained`` — cached destinations left untouched (unaffected by the
    flap, or affected but carrying no compiled table to edit).

    ``affected_dsts`` names the destinations that were patched or evicted —
    the data plane's blast radius, emitted so observability layers (the
    failover benchmark's storm accounting, recovery-timeline reporting)
    don't re-derive it from the dependency index.  The EVPN control plane
    piggybacks on the *stats object itself*
    (:meth:`repro.core.evpn.EvpnControlPlane.resync_incremental` consumes
    ``link``/``action``): BGP flood reachability is a session-graph
    property, so the control plane diffs session-graph components rather
    than underlay routing destinations.
    """

    link: Tuple[str, str]
    action: str  # "fail" | "restore"
    patched: int
    rebuilt: int
    retained: int
    affected_dsts: Tuple[str, ...] = ()

    @property
    def touched(self) -> int:
        return self.patched + self.rebuilt


@dataclass(frozen=True)
class FlowPaths:
    """Per-flow directed-link paths in CSR form (``route_flows_with_paths``).

    Flow ``i`` traverses the directed links
    ``(link_u[k], link_v[k]) for k in range(ptr[i], ptr[i + 1])`` in hop
    order, as integer node ids decodable through ``nodes``.  This is the
    flow x link incidence the congestion model's max-min allocation
    consumes without any per-flow Python loop.

    ``slot_occ`` (row-aligned with ``link_u``/``link_v``) is the ECMP
    hash-slot occupancy of each traversal: how many flows of the batch
    hashed into the same bucket of the same member link at that decision
    point (bucket space per (switch, destination) group =
    ``FabricConfig.ecmp_hash_buckets``, default
    :data:`ECMP_HASH_BUCKETS`; occupancy is 1 for non-ECMP hops such as
    host attachments or single-choice forwarding).  Values > 1 are
    observed hash collisions — the imbalance the weighted congestion
    model (:func:`repro.core.congestion.ecmp_flow_weights`) turns into
    per-flow allocation weights.

    ``slot_key`` (row-aligned) is the *identity* of the hash slot each
    ECMP traversal landed in — one integer per (destination group,
    member link, bucket), ``-1`` for non-ECMP hops.  Two rows share a
    slot key iff their flows are indistinguishable to that switch's hash
    pipeline, which is what lets consumers recount occupancy over an
    arbitrary flow subset (e.g. only the concurrently-active phases of a
    schedule — :func:`repro.core.congestion.concurrent_ecmp_flow_weights`)
    without re-routing.
    """

    link_u: "np.ndarray"  # (R,) int64 node ids
    link_v: "np.ndarray"  # (R,) int64 node ids
    ptr: "np.ndarray"  # (F + 1,) int64 CSR offsets
    nodes: Tuple[str, ...]  # node id -> name
    slot_occ: Optional["np.ndarray"] = None  # (R,) int64 hash-slot occupancy
    slot_key: Optional["np.ndarray"] = None  # (R,) int64 slot identity, -1 = none

    @property
    def num_flows(self) -> int:
        return len(self.ptr) - 1

    def flow_links(self, i: int) -> List[Link]:
        lo, hi = int(self.ptr[i]), int(self.ptr[i + 1])
        return [
            (self.nodes[int(u)], self.nodes[int(v)])
            for u, v in zip(self.link_u[lo:hi], self.link_v[lo:hi])
        ]


class Fabric:
    """The emulated underlay + VXLAN data plane."""

    def __init__(self, config: FabricConfig | None = None):
        self.config = config or FabricConfig()
        self.config.validate()
        self._adj: Dict[str, List[str]] = defaultdict(list)
        self._links: set[FrozenSet[str]] = set()
        self._down_links: set[FrozenSet[str]] = set()
        self.link_bytes: Dict[Link, int] = defaultdict(int)
        self.hosts: Dict[str, Host] = {}
        self.leaves: List[str] = []
        self.spines: List[str] = []
        self.wan_links: List[FrozenSet[str]] = []
        self._node_dc: Dict[str, int] = {}
        self._switch_seed: Dict[str, int] = {}
        self._dist_cache: Dict[str, Dict[str, int]] = {}
        # incremental re-convergence: reverse link -> destination dependency
        # index (built while compiling _distances_to) plus the forward map
        # used to unregister a destination when its entry is evicted.
        self._link_deps: Dict[FrozenSet[str], set] = {}
        self._dst_dep_links: Dict[str, List[FrozenSet[str]]] = {}
        self.last_reroute: Optional[RerouteStats] = None
        # batched-engine state: node<->id maps, per-destination next-hop
        # tables, and per-key-length CRC seed columns (see route_flows_batched)
        self._wan_link_set: set[FrozenSet[str]] = set()
        self._nh_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._zcol_cache: Dict[int, np.ndarray] = {}
        # interned (src, dst, dst_port) host pairs: node ids, template CRCs
        # and egress-leaf group — immutable after _build, so never evicted.
        self._pair_cache: Dict[Tuple[str, str, int], int] = {}
        self._pair_rows: List[Tuple] = []
        self._pair_cols: Optional[Dict[str, np.ndarray]] = None
        self._leaf_gid: Dict[str, int] = {}
        self._gid_leaf: List[str] = []
        self._build()

    # -- construction -------------------------------------------------------

    def _add_link(self, u: str, v: str) -> None:
        key = frozenset((u, v))
        if key in self._links:
            return
        self._links.add(key)
        self._adj[u].append(v)
        self._adj[v].append(u)

    def _build(self) -> None:
        cfg = self.config
        for dc in range(1, cfg.num_dcs + 1):
            spines = [f"d{dc}s{j}" for j in range(1, cfg.spines_per_dc + 1)]
            leaves = [f"d{dc}l{j}" for j in range(1, cfg.leaves_per_dc + 1)]
            self.spines.extend(spines)
            self.leaves.extend(leaves)
            for sw in spines + leaves:
                self._node_dc[sw] = dc
            for leaf in leaves:
                for spine in spines:  # full bipartite leaf-spine Clos
                    self._add_link(leaf, spine)
            host_idx = 1
            for li, leaf in enumerate(leaves):
                for _ in range(cfg.hosts_per_leaf[dc - 1][li]):
                    name = f"d{dc}h{host_idx}"
                    host = Host(
                        name=name,
                        dc=dc,
                        leaf=leaf,
                        ip=f"192.168.{dc}.{host_idx}",
                        mac=f"aa:bb:{dc:02x}:{dc:02x}:{host_idx:02x}:{host_idx:02x}",
                    )
                    self.hosts[name] = host
                    self._node_dc[name] = dc
                    self._add_link(leaf, name)
                    host_idx += 1
        # WAN: full bipartite spine<->spine between DC pairs (paper: each spine
        # has one link to every spine of the remote DC -> 4 WAN links for 2 DCs).
        for dc_a in range(1, cfg.num_dcs + 1):
            for dc_b in range(dc_a + 1, cfg.num_dcs + 1):
                for ja in range(1, cfg.spines_per_dc + 1):
                    for jb in range(1, cfg.spines_per_dc + 1):
                        u, v = f"d{dc_a}s{ja}", f"d{dc_b}s{jb}"
                        self._add_link(u, v)
                        self.wan_links.append(frozenset((u, v)))
        for i, node in enumerate(sorted(self._adj)):
            self._switch_seed[node] = zlib.crc32(node.encode()) ^ (i * 0x9E3779B9)
        self._wan_link_set = set(self.wan_links)
        # lexicographic ids: sorting id arrays == sorting node names, so the
        # batched tables inherit next_hops()' stable ECMP choice order.
        self._node_order: List[str] = sorted(self._adj)
        self._node_id: Dict[str, int] = {n: i for i, n in enumerate(self._node_order)}
        self._seed_arr = np.array(
            [self._switch_seed[n] & 0xFFFFFFFF for n in self._node_order],
            dtype=np.uint32,
        )
        # Routing-loop guard derived from the topology instead of a magic
        # constant: an ECMP walk strictly decreases the BFS distance toward
        # the destination every hop, and that distance is bounded by the
        # switch-graph diameter — which under an arbitrary failure set is at
        # most the switch count (a shortest path never revisits a switch).
        # Anything longer is a genuine loop, at 8-DC scale included.
        self._hop_limit = len(self.spines) + len(self.leaves) + 2

    # -- link state ---------------------------------------------------------

    def all_links(self) -> List[FrozenSet[str]]:
        return sorted(self._links, key=sorted)

    def is_wan_link(self, u: str, v: str) -> bool:
        return frozenset((u, v)) in self._wan_link_set

    def node_dc(self, name: str) -> int:
        """1-based data center of a switch or host."""
        return self._node_dc[name]

    def wan_pair(self, u: str, v: str) -> Tuple[int, int]:
        """Normalized (lo, hi) DC pair a WAN link spans."""
        a, b = self._node_dc[u], self._node_dc[v]
        return (a, b) if a <= b else (b, a)

    def link_up(self, u: str, v: str) -> bool:
        return frozenset((u, v)) not in self._down_links

    def fail_link(self, u: str, v: str) -> RerouteStats:
        """Take a link down, re-converging only the dependent destinations."""
        key = frozenset((u, v))
        if key not in self._links:
            raise KeyError(f"no such link {u}<->{v}")
        if key in self._down_links:  # already down: nothing can change
            stats = RerouteStats((u, v), "fail", 0, 0, len(self._dist_cache))
            self.last_reroute = stats
            return stats
        self._down_links.add(key)
        return self._reconverge(key, (u, v), "fail")

    def restore_link(self, u: str, v: str) -> RerouteStats:
        """Bring a link back up, re-converging only the dependent destinations.

        Unlike the original full-invalidation path, an unknown link raises
        ``KeyError`` (symmetrically with :meth:`fail_link`) instead of being
        silently discarded.
        """
        key = frozenset((u, v))
        if key not in self._links:
            raise KeyError(f"no such link {u}<->{v}")
        if key not in self._down_links:  # already up: nothing can change
            stats = RerouteStats((u, v), "restore", 0, 0, len(self._dist_cache))
            self.last_reroute = stats
            return stats
        self._down_links.discard(key)
        return self._reconverge(key, (u, v), "restore")

    def flush_routing_state(self) -> None:
        """Full invalidation: drop every cached distance map, next-hop table
        and dependency record (the pre-incremental behavior; the failover
        benchmark uses it as the re-convergence baseline).  The interned
        pair registry and CRC/seed state survive — they are topology-only.
        """
        self._dist_cache.clear()
        self._nh_cache.clear()
        self._link_deps.clear()
        self._dst_dep_links.clear()

    def compile_routes(self, dsts: Iterable[str]) -> None:
        """Eagerly (re)build the per-destination routing tables.

        After a flap this materializes any lazily evicted rebuilds, so
        benchmarks can measure re-convergence separately from routing.
        """
        for dst in dsts:
            self._next_hop_table(dst)

    # -- incremental re-convergence -----------------------------------------

    def _index_deps(self, dst: str, dist: Dict[str, int]) -> None:
        """Register ``dst`` in the reverse link->destination index.

        Sensitivity is a pure function of the cached distance map:

        * a *live* link matters iff it is a DAG edge
          (``|dist[u] - dist[v]| == 1``) — failing anything else can change
          neither a distance nor an equal-cost choice set;
        * a *down* link matters iff restoring it would reconnect an
          unreachable endpoint or create a shorter/equal-cost path
          (``dist[u] != dist[v]`` or exactly one endpoint reachable).

        In-place row patches never change distances, so registrations stay
        exact across patches and only need rebuilding on eviction.
        """
        self._unindex(dst)
        deps: List[FrozenSet[str]] = []
        down = self._down_links
        hosts = self.hosts
        for key in self._links:
            u, v = tuple(key)
            if (u in hosts and u != dst) or (v in hosts and v != dst):
                # host attachment links never carry transit traffic, so they
                # cannot affect tables toward any other destination — without
                # this, a single host-NIC flap would degenerate to full
                # invalidation (every reachable host sits one BFS level past
                # its leaf, which looks like a DAG edge).
                continue
            du, dv = dist.get(u), dist.get(v)
            if key in down:
                sensitive = (du is None) != (dv is None) or (
                    du is not None and dv is not None and du != dv
                )
            else:
                sensitive = du is not None and dv is not None and abs(du - dv) == 1
            if sensitive:
                self._link_deps.setdefault(key, set()).add(dst)
                deps.append(key)
        self._dst_dep_links[dst] = deps

    def _unindex(self, dst: str) -> None:
        for key in self._dst_dep_links.pop(dst, ()):
            bucket = self._link_deps.get(key)
            if bucket is not None:
                bucket.discard(dst)

    def _evict(self, dst: str) -> None:
        self._dist_cache.pop(dst, None)
        self._nh_cache.pop(dst, None)
        self._unindex(dst)

    def _patch_row(self, dst: str, node: str) -> bool:
        """Recompute one node's row of the cached next-hop table in place.

        Returns True iff a compiled table existed and was actually edited."""
        cached = self._nh_cache.get(dst)
        if cached is None:
            return False  # distances unchanged and no table compiled yet
        nh, counts = cached
        i = self._node_id[node]
        if node in self.hosts and node != dst:
            row: List[int] = []  # hosts never forward
        else:
            row = [self._node_id[c] for c in self.next_hops(node, dst)]
        if len(row) > nh.shape[1]:  # restore added a choice beyond the width
            pad = np.full((nh.shape[0], len(row) - nh.shape[1]), -1, dtype=np.int64)
            nh = np.hstack([nh, pad])
        nh[i, :] = -1
        if row:
            nh[i, : len(row)] = row
        counts[i] = len(row)
        self._nh_cache[dst] = (nh, counts)
        return True

    def _reconverge(
        self, key: FrozenSet[str], link: Tuple[str, str], action: str
    ) -> RerouteStats:
        """Patch or evict exactly the destinations that depend on ``key``.

        For each dependent destination the cached distances decide the
        cheap case: if the flapped link connects adjacent BFS levels and
        the far endpoint still has (fail) / merely gains (restore) an
        equal-cost choice, no distance anywhere can change — only the far
        endpoint's ECMP choice row, which is rewritten in place.  Anything
        else (lost last next hop, reconnection, shortcut) evicts that one
        destination for a lazy BFS rebuild.  Every other cached
        destination — and the pair/CRC/seed state — is untouched.
        """
        cached_before = len(self._dist_cache)
        affected = sorted(self._link_deps.get(key, ()))
        patched = rebuilt = 0
        touched_dsts: List[str] = []
        for dst in affected:
            dist = self._dist_cache.get(dst)
            if dist is None:  # stale index entry; nothing cached to fix
                self._evict(dst)
                continue
            u, v = link
            du, dv = dist.get(u), dist.get(v)
            if du is not None and dv is not None and abs(du - dv) == 1:
                far = u if du > dv else v
                if action == "restore" or any(
                    dist.get(nb) == dist[far] - 1 for nb in self.neighbors(far)
                ):
                    # distances provably unchanged: the flap only edits the
                    # far endpoint's equal-cost choice set.  A destination
                    # with a cached distance map but no compiled table needs
                    # no edit at all and stays in the retained count.
                    if self._patch_row(dst, far):
                        patched += 1
                        touched_dsts.append(dst)
                    continue
            self._evict(dst)
            rebuilt += 1
            touched_dsts.append(dst)
        stats = RerouteStats(
            link, action, patched, rebuilt, cached_before - patched - rebuilt,
            affected_dsts=tuple(touched_dsts),
        )
        self.last_reroute = stats
        return stats

    def neighbors(self, node: str) -> List[str]:
        return [v for v in self._adj[node] if self.link_up(node, v)]

    # -- routing ------------------------------------------------------------

    def _distances_to(self, dst: str) -> Dict[str, int]:
        """BFS hop distances toward dst over live links (hosts non-transit)."""
        cached = self._dist_cache.get(dst)
        if cached is not None:
            return cached
        dist = {dst: 0}
        frontier = [dst]
        while frontier:
            nxt: List[str] = []
            for node in frontier:
                # hosts never forward traffic for others
                if node in self.hosts and node != dst:
                    continue
                for nb in self.neighbors(node):
                    if nb not in dist:
                        dist[nb] = dist[node] + 1
                        nxt.append(nb)
            frontier = nxt
        self._dist_cache[dst] = dist
        self._index_deps(dst, dist)
        return dist

    def next_hops(self, node: str, dst: str) -> List[str]:
        """Equal-cost next hops from ``node`` toward ``dst`` (sorted, stable)."""
        dist = self._distances_to(dst)
        if node not in dist:
            return []
        return sorted(
            nb for nb in self.neighbors(node) if dist.get(nb, 1 << 30) == dist[node] - 1
        )

    def route_flow(self, tup: FiveTuple, src: str, dst: str) -> List[str]:
        """Hop-by-hop ECMP walk; returns the node path (src..dst)."""
        path = [src]
        node = src
        hops = 0
        while node != dst:
            choices = self.next_hops(node, dst)
            if not choices:
                raise RuntimeError(f"no route {src}->{dst} at {node} (link failures?)")
            pick = choices[ecmp_hash(tup, self._switch_seed[node], len(choices))]
            path.append(pick)
            node = pick
            hops += 1
            if hops > self._hop_limit:
                raise RuntimeError("routing loop detected")
        return path

    # -- batched routing engine ---------------------------------------------

    def _next_hop_table(self, dst: str) -> Tuple[np.ndarray, np.ndarray]:
        """Per-destination ECMP table: (nh[node, choice], count[node]).

        Row ``i`` holds the ids of node i's equal-cost next hops toward
        ``dst`` in the exact order :meth:`next_hops` yields them (sorted by
        name == sorted by id), padded with -1.  Cached until a link fails
        or is restored.
        """
        cached = self._nh_cache.get(dst)
        if cached is not None:
            return cached
        n = len(self._node_order)
        counts = np.zeros(n, dtype=np.int64)
        rows: List[List[int]] = [[] for _ in range(n)]
        for i, node in enumerate(self._node_order):
            if node in self.hosts and node != dst:
                continue  # hosts never forward; their rows stay empty
            choices = self.next_hops(node, dst)
            rows[i] = [self._node_id[c] for c in choices]
            counts[i] = len(choices)
        width = max(1, int(counts.max()))
        nh = np.full((n, width), -1, dtype=np.int64)
        for i, row in enumerate(rows):
            if row:
                nh[i, : len(row)] = row
        self._nh_cache[dst] = (nh, counts)
        return nh, counts

    def _seed_xor_column(self, key_len: int) -> np.ndarray:
        """CRC seed-mixing column: Z[i] for key length L such that
        ``crc32(key, seed_i) == crc32(key, 0) ^ Z[i]`` (CRC-32 is linear
        over GF(2), so the seed's contribution depends only on len(key))."""
        col = self._zcol_cache.get(key_len)
        if col is None:
            zeros = b"\x00" * key_len
            base = zlib.crc32(zeros)
            col = np.array(
                [zlib.crc32(zeros, int(s)) ^ base for s in self._seed_arr],
                dtype=np.uint32,
            )
            self._zcol_cache[key_len] = col
        return col

    def _register_pair(self, src_name: str, dst_name: str, dst_port: int) -> int:
        """Intern a (src, dst, dst_port) host pair for the batched router.

        Stores node ids plus the CRC-32 of the inner/outer key *templates*
        (port digits zeroed): with the digit-gamma tables, the hash of any
        concrete port then falls out of pure XOR arithmetic.
        """
        nid = self._node_id
        src = self.hosts[src_name]
        dst = self.hosts[dst_name]
        if src.leaf == dst.leaf:
            row = (nid[src_name], nid[src.leaf], nid[dst_name], nid[dst.leaf],
                   True, 0, 0, 0, -1, src_name, dst_name)
        else:
            gid = self._leaf_gid.get(dst.leaf)
            if gid is None:
                gid = len(self._gid_leaf)
                self._leaf_gid[dst.leaf] = gid
                self._gid_leaf.append(dst.leaf)
            inner_t = f"{src.ip}|{dst.ip}|00000|{dst_port}|17".encode()
            outer_t = (
                f"{self.vtep_ip(src.leaf)}|{self.vtep_ip(dst.leaf)}"
                f"|00000|{VXLAN_DST_PORT}|17"
            ).encode()
            row = (nid[src_name], nid[src.leaf], nid[dst_name], nid[dst.leaf],
                   False, zlib.crc32(inner_t), zlib.crc32(outer_t), len(outer_t),
                   gid, src_name, dst_name)
        self._pair_rows.append(row)
        idx = len(self._pair_rows) - 1
        self._pair_cache[(src_name, dst_name, dst_port)] = idx
        self._pair_cols = None
        return idx

    def _pair_columns(self) -> Dict[str, np.ndarray]:
        """Column arrays over the interned pair registry (rebuilt on growth)."""
        cols = self._pair_cols
        if cols is None:
            rows = self._pair_rows
            cols = {
                "src_host": np.array([r[0] for r in rows], dtype=np.int64),
                "src_leaf": np.array([r[1] for r in rows], dtype=np.int64),
                "dst_host": np.array([r[2] for r in rows], dtype=np.int64),
                "dst_leaf": np.array([r[3] for r in rows], dtype=np.int64),
                "same_leaf": np.array([r[4] for r in rows], dtype=bool),
                "cti": np.array([r[5] for r in rows], dtype=np.uint32),
                "cto": np.array([r[6] for r in rows], dtype=np.uint32),
                "outer_len": np.array([r[7] for r in rows], dtype=np.int64),
                "gid": np.array([r[8] for r in rows], dtype=np.int64),
            }
            self._pair_cols = cols
        return cols

    def _walk_group(
        self,
        counters: np.ndarray,
        touched: np.ndarray,
        dst_leaf: str,
        c0: np.ndarray,
        lens: np.ndarray,
        cur: np.ndarray,
        nb: np.ndarray,
        dst_hosts: np.ndarray,
        flow_ids: Optional[np.ndarray] = None,
        rec: Optional[List] = None,
    ) -> None:
        """Advance every flow bound for ``dst_leaf`` one hop per NumPy step."""
        nh, cnt = self._next_hop_table(dst_leaf)
        nbuckets = self.config.ecmp_hash_buckets
        uniq_lens = np.unique(lens)
        zmat = np.stack([self._seed_xor_column(int(L)) for L in uniq_lens])
        len_slot = np.searchsorted(uniq_lens, lens)
        dst_id = self._node_id[dst_leaf]
        active = np.nonzero(cur != dst_id)[0]
        # per-hop ECMP fragments of this group: (flow_ids, seq, ci, pick,
        # bucket, fan, live) — buckets feed the hash-slot occupancy computed
        # once the whole group has walked (collisions span hops: two flows
        # meeting at the same switch at different depths still share the
        # bucket).
        grec: List[Tuple] = []
        for _hop in range(self._hop_limit):
            if active.size == 0:
                break
            ci = cur[active]
            fan = cnt[ci]
            if np.any(fan == 0):
                bad = self._node_order[int(ci[np.argmax(fan == 0)])]
                raise RuntimeError(f"no route ->{dst_leaf} at {bad} (link failures?)")
            h = c0[active] ^ zmat[len_slot[active], ci]
            pick = nh[ci, h.astype(np.int64) % fan]
            np.add.at(counters, (ci, pick), nb[active])
            touched[ci, pick] = True
            if rec is not None:
                bucket = (h % np.uint32(nbuckets)).astype(np.int64)
                grec.append(
                    (flow_ids[active], _hop + 1, ci, pick, bucket, fan,
                     nb[active] > 0)
                )
            cur[active] = pick
            active = active[pick != dst_id]
        else:
            raise RuntimeError("routing loop detected")
        if rec is not None and grec:
            # hash-slot occupancy over the whole group: flows sharing the
            # same (switch, member link, bucket) occupy one scheduling slot.
            # Zero-byte chunk flows transmit nothing, so they occupy no
            # slot (same convention as the congestion allocators, which
            # drain them for free); fan-1 forwarding involves no hash
            # decision, so its occupancy stays 1 no matter how many flows
            # cross the link.
            n = len(self._node_order)
            ug = np.concatenate([g[2] for g in grec])
            vg = np.concatenate([g[3] for g in grec])
            bg = np.concatenate([g[4] for g in grec])
            fg = np.concatenate([g[5] for g in grec])
            live = np.concatenate([g[6] for g in grec])
            key = (ug * n + vg) * nbuckets + bg
            _, inv = np.unique(key, return_inverse=True)
            live_counts = np.bincount(inv, weights=live.astype(np.int64))
            occ = np.where(fg > 1, np.maximum(live_counts[inv], 1), 1).astype(
                np.int64
            )
            # slot identity: member tables are per (switch, destination
            # group), so fold the group's egress leaf in; -1 marks fan-1
            # forwarding, which involves no hash decision and thus no slot.
            skey = np.where(
                fg > 1, key + np.int64(dst_id) * (n * n * nbuckets), np.int64(-1)
            )
            lo = 0
            for ids, seq, ci, pick, _, _, _ in grec:
                rec.append(
                    (ids, seq, ci, pick, occ[lo : lo + ids.size],
                     skey[lo : lo + ids.size])
                )
                lo += ids.size
        egress = np.full(dst_hosts.size, dst_id)
        np.add.at(counters, (egress, dst_hosts), nb)
        touched[egress, dst_hosts] = True
        if rec is not None:
            rec.append((flow_ids, self._hop_limit + 2, egress, dst_hosts, None, None))

    def route_flows_batched(
        self,
        flows: Iterable,
        *,
        dst_port: int = ROCE_DST_PORT,
        check_reachability=None,
    ) -> Dict[Link, int]:
        """Route many host-to-host flows at once; updates ``link_bytes``.

        ``flows`` is any iterable of records with ``src``, ``dst``,
        ``nbytes`` and ``src_port`` attributes (e.g.
        :class:`repro.core.flows.Flow`).  Byte-identical to calling
        :meth:`send` per flow, but everything beyond a thin interning loop
        runs in NumPy:

        * the five-tuple CRC is evaluated from per-pair key-template CRCs
          plus per-digit gamma tables (CRC-32 is GF(2)-linear), so steady
          state needs zero ``zlib.crc32`` calls per flow;
        * the per-switch hash seed folds in via the same linearity
          (``_seed_xor_column``);
        * flows group by egress leaf and advance one hop per vectorized
          step through the precomputed next-hop tables;
        * byte counters accumulate via ``np.add.at`` into a dense
          node x node matrix merged back into ``link_bytes`` at the end.

        Returns the link byte increments contributed by this batch.  Unlike
        the sequential path, an unreachable flow raises before any counter
        is touched.
        """
        out, _ = self._route_batch(flows, dst_port, check_reachability, False)
        return out

    def route_flows_with_paths(
        self,
        flows: Iterable,
        *,
        dst_port: int = ROCE_DST_PORT,
        check_reachability=None,
    ) -> Tuple[Dict[Link, int], FlowPaths]:
        """:meth:`route_flows_batched` plus per-flow path recording.

        Returns ``(link byte increments, FlowPaths)``; the paths feed the
        flow-level congestion model (:mod:`repro.core.congestion`), which
        needs to know *which* flows share a link, not just the aggregate
        bytes.  Counter semantics are identical to the plain batched call.
        """
        out, paths = self._route_batch(flows, dst_port, check_reachability, True)
        assert paths is not None
        return out, paths

    def _route_batch(
        self,
        flows: Iterable,
        dst_port: int,
        check_reachability,
        collect_paths: bool,
    ) -> Tuple[Dict[Link, int], Optional[FlowPaths]]:
        pair_cache = self._pair_cache
        register = self._register_pair
        pidx_l: List[int] = []
        ports_l: List[int] = []
        nb_l: List[int] = []
        for flow in flows:
            if check_reachability is not None and not check_reachability(
                flow.src, flow.dst
            ):
                raise UnreachableError(
                    f"{flow.dst} unreachable from {flow.src} (VNI isolation)"
                )
            idx = pair_cache.get((flow.src, flow.dst, dst_port))
            if idx is None:
                idx = register(flow.src, flow.dst, dst_port)
            pidx_l.append(idx)
            ports_l.append(flow.src_port)
            nb_l.append(flow.nbytes)
        empty = np.empty(0, dtype=np.int64)
        if not pidx_l:
            paths = (
                FlowPaths(empty, empty, np.zeros(1, dtype=np.int64),
                          tuple(self._node_order), empty, empty)
                if collect_paths else None
            )
            return {}, paths
        n = len(self._node_order)
        counters = np.zeros((n, n), dtype=np.int64)
        # links traversed, independent of byte count: send() records a
        # counter entry even for zero-byte frames, and byte-identical
        # includes those zero-valued keys.
        touched = np.zeros((n, n), dtype=bool)
        cols = self._pair_columns()
        pidx = np.asarray(pidx_l, dtype=np.int64)
        ports = np.asarray(ports_l, dtype=np.int64)
        nb = np.asarray(nb_l, dtype=np.int64)

        # per-flow (flow id, hop seq, u, v, slot occupancy, slot key)
        # fragments for FlowPaths assembly (occupancy None = non-ECMP hop,
        # occupancy 1, key -1)
        rec: Optional[List] = [] if collect_paths else None
        nflows = pidx.size
        np.add.at(counters, (cols["src_host"][pidx], cols["src_leaf"][pidx]), nb)
        touched[cols["src_host"][pidx], cols["src_leaf"][pidx]] = True
        if rec is not None:
            rec.append(
                (
                    np.arange(nflows),
                    0,
                    cols["src_host"][pidx],
                    cols["src_leaf"][pidx],
                    None,
                    None,
                )
            )
        same = cols["same_leaf"][pidx]
        si = np.nonzero(same)[0]
        if si.size:  # same-leaf local bridging: leaf -> dst host, no underlay
            sp = pidx[si]
            np.add.at(counters, (cols["dst_leaf"][sp], cols["dst_host"][sp]), nb[si])
            touched[cols["dst_leaf"][sp], cols["dst_host"][sp]] = True
            if rec is not None:
                rec.append(
                    (si, 1, cols["dst_leaf"][sp], cols["dst_host"][sp], None, None)
                )
        ri = np.nonzero(~same)[0]
        if ri.size:
            rp = pidx[ri]
            rports = ports[ri]
            c0 = np.empty(ri.size, dtype=np.uint32)
            five = (rports >= 10000) & (rports <= 99999)
            v = np.nonzero(five)[0]
            if v.size:
                # inner key hash -> 14-bit entropy -> outer VXLAN source
                # port (0xC000 + entropy, always 5 digits) -> outer key
                # hash, all via template CRCs + digit gammas.
                g_in = _gamma_block(len(f"|{dst_port}|17"))
                g_out = _gamma_block(len(f"|{VXLAN_DST_PORT}|17"))
                pv = rports[v]
                inner = cols["cti"][rp[v]].copy()
                for k in range(5):
                    inner ^= g_in[k][(pv // 10 ** (4 - k)) % 10]
                op = (inner & np.uint32(0x3FFF)).astype(np.int64) + 0xC000
                outer = cols["cto"][rp[v]].copy()
                for k in range(5):
                    outer ^= g_out[k][(op // 10 ** (4 - k)) % 10]
                c0[v] = outer
            for i in np.nonzero(~five)[0].tolist():
                # rare: source port outside the 5-digit range; take the
                # reference string path for these flows only.
                row = self._pair_rows[int(rp[i])]
                src, dsth = self.hosts[row[9]], self.hosts[row[10]]
                outer_tup = vxlan_outer_tuple(
                    FiveTuple(src.ip, dsth.ip, int(rports[i]), dst_port),
                    self.vtep_ip(src.leaf),
                    self.vtep_ip(dsth.leaf),
                )
                c0[i] = zlib.crc32(outer_tup.key_bytes())
            gids = cols["gid"][rp]
            lens = cols["outer_len"][rp]
            cur = cols["src_leaf"][rp]
            dst_hosts = cols["dst_host"][rp]
            rnb = nb[ri]
            for g in np.unique(gids).tolist():
                m = np.nonzero(gids == g)[0]
                self._walk_group(
                    counters, touched, self._gid_leaf[g],
                    c0[m], lens[m], cur[m], rnb[m], dst_hosts[m],
                    flow_ids=ri[m] if rec is not None else None, rec=rec,
                )

        out: Dict[Link, int] = {}
        us, vs = np.nonzero(touched)
        order = self._node_order
        for u, v in zip(us.tolist(), vs.tolist()):
            b = int(counters[u, v])
            out[(order[u], order[v])] = b
            self.link_bytes[(order[u], order[v])] += b
        paths: Optional[FlowPaths] = None
        if rec is not None:
            fl = np.concatenate([np.asarray(r[0], dtype=np.int64) for r in rec])
            seq = np.concatenate(
                [np.full(len(r[0]), r[1], dtype=np.int64) for r in rec]
            )
            lu = np.concatenate([np.asarray(r[2], dtype=np.int64) for r in rec])
            lv = np.concatenate([np.asarray(r[3], dtype=np.int64) for r in rec])
            occ = np.concatenate(
                [
                    np.asarray(r[4], dtype=np.int64)
                    if r[4] is not None
                    else np.ones(len(r[0]), dtype=np.int64)
                    for r in rec
                ]
            )
            skey = np.concatenate(
                [
                    np.asarray(r[5], dtype=np.int64)
                    if r[5] is not None
                    else np.full(len(r[0]), -1, dtype=np.int64)
                    for r in rec
                ]
            )
            sort = np.lexsort((seq, fl))  # group by flow, hop order within
            ptr = np.zeros(nflows + 1, dtype=np.int64)
            np.cumsum(np.bincount(fl, minlength=nflows), out=ptr[1:])
            paths = FlowPaths(
                lu[sort], lv[sort], ptr, tuple(order), occ[sort], skey[sort]
            )
        return out, paths

    # -- data plane ---------------------------------------------------------

    def vtep_ip(self, leaf: str) -> str:
        # loopback VTEP addressing mirrors the paper (1.1.10.1 style);
        # split on the 'l' separator of d{dc}l{idx} rather than slicing at
        # fixed offsets so multi-digit DC ids (SCALED64) parse too
        dc_s, idx_s = leaf[1:].split("l", 1)
        dc, idx = int(dc_s), int(idx_s)
        return f"{dc}.{dc}.10.{idx}"

    def send(
        self,
        src_host: str,
        dst_host: str,
        nbytes: int,
        src_port: int,
        dst_port: int = ROCE_DST_PORT,
        *,
        check_reachability=None,
    ) -> List[str]:
        """Send ``nbytes`` from host to host; updates link byte counters.

        ``check_reachability`` is an optional callable (src, dst) -> bool
        supplied by the EVPN/tenancy layer; when it returns False the frame
        is dropped at the ingress VTEP (destination host unreachable).
        Returns the underlay node path taken.
        """
        src, dst = self.hosts[src_host], self.hosts[dst_host]
        if check_reachability is not None and not check_reachability(src_host, dst_host):
            raise UnreachableError(f"{dst_host} unreachable from {src_host} (VNI isolation)")
        inner = FiveTuple(src.ip, dst.ip, src_port, dst_port)
        self._count(src_host, src.leaf, nbytes)
        if src.leaf == dst.leaf:
            self._count(dst.leaf, dst_host, nbytes)
            return [src_host, src.leaf, dst_host]
        outer = vxlan_outer_tuple(inner, self.vtep_ip(src.leaf), self.vtep_ip(dst.leaf))
        path = self.route_flow(outer, src.leaf, dst.leaf)
        for u, v in zip(path, path[1:]):
            self._count(u, v, nbytes)
        self._count(dst.leaf, dst_host, nbytes)
        return [src_host] + path + [dst_host]

    def _count(self, u: str, v: str, nbytes: int) -> None:
        self.link_bytes[(u, v)] += nbytes

    def reset_counters(self) -> None:
        self.link_bytes.clear()

    # -- observability ------------------------------------------------------

    def uplink_bytes(self, node: str, toward: str = "spine") -> Dict[Link, int]:
        """Byte counters on a node's egress links toward spines or WAN."""
        out: Dict[Link, int] = {}
        for (u, v), b in self.link_bytes.items():
            if u != node:
                continue
            if toward == "spine" and v in self.spines and not self.is_wan_link(u, v):
                out[(u, v)] = b
            elif toward == "wan" and self.is_wan_link(u, v):
                out[(u, v)] = b
        return out

    def rtt_path(self, src_host: str, dst_host: str) -> List[Tuple[str, str, bool]]:
        """One representative forward path as (u, v, is_wan) link triples."""
        src, dst = self.hosts[src_host], self.hosts[dst_host]
        links: List[Tuple[str, str, bool]] = [(src_host, src.leaf, False)]
        if src.leaf != dst.leaf:
            tup = FiveTuple(src.ip, dst.ip, 49192, ROCE_DST_PORT)
            outer = vxlan_outer_tuple(tup, self.vtep_ip(src.leaf), self.vtep_ip(dst.leaf))
            path = self.route_flow(outer, src.leaf, dst.leaf)
            links += [(u, v, self.is_wan_link(u, v)) for u, v in zip(path, path[1:])]
        links.append((dst.leaf, dst_host, False))
        return links


class UnreachableError(RuntimeError):
    """Destination host unreachable (missing EVPN route or VNI mismatch)."""
