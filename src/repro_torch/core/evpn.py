"""MP-BGP EVPN control plane for the emulated VXLAN fabric (paper §3.2, §4.2).

Models the route types the paper exercises:

* **Type-3 IMET** (Inclusive Multicast Ethernet Tag) — a VTEP advertises
  (VTEP-IP, VNI) membership; builds per-VNI flood lists and enables remote
  VTEP discovery.
* **Type-2 MAC/IP** — a leaf that learns a host (via ARP snooping in the
  paper) advertises (MAC, IP, VNI, VTEP-IP); builds the overlay forwarding
  tables that make cross-DC hosts mutually reachable.

Routes carry Route Distinguishers and Route Targets; import policy is
RT-based, which is what enforces multi-tenancy at the control-plane level.
Propagation follows the paper's BGP session graph: leaves peer with their
local spines (route reflectors), spines of different DCs peer over the WAN.
Withdrawal (on BFD-detected failure) removes routes and flood-list entries.

Incremental resync (the control-plane twin of the data plane's incremental
re-convergence, "I've Got 99 Problems But FLOPS Ain't One"-style
control-plane cost accounting): a BFD flap used to trigger
:meth:`EvpnControlPlane.resync` — flush every speaker's RIB and re-flood
the whole route log.  :meth:`EvpnControlPlane.resync_incremental`
piggybacks on the fabric's :class:`~repro.core.fabric.RerouteStats`
instead: a single-link flap can only move routes whose *origin VTEP's
flood reachability crossed that link*, so the control plane diffs the BGP
session graph's connected components before/after the flap and edits
exactly the speakers whose membership relative to an origin changed —
surfacing ``patched`` / ``rebuilt`` / ``retained`` counts symmetrically
with the data plane.  The resulting session state is byte-identical to a
full resync (gated in ``benchmarks/bench_failover.py``), while the
typical non-partitioning flap touches zero VTEPs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .fabric import Fabric, RerouteStats


@dataclass(frozen=True)
class RouteType3:
    """IMET route: VTEP membership in a VNI."""

    rd: str
    vni: int
    vtep_ip: str
    origin_leaf: str

    @property
    def rt(self) -> str:
        return f"target:65000:{self.vni}"


@dataclass(frozen=True)
class RouteType2:
    """MAC/IP advertisement route."""

    rd: str
    vni: int
    mac: str
    ip: str
    vtep_ip: str
    origin_leaf: str

    @property
    def rt(self) -> str:
        return f"target:65000:{self.vni}"


@dataclass(frozen=True)
class EvpnResyncStats:
    """What one incremental EVPN resync did to control-plane state.

    The control-plane mirror of :class:`repro.core.fabric.RerouteStats`:

    ``patched``  — spine (route-reflector) RIBs edited in place;
    ``rebuilt``  — leaf VTEPs whose RIB changed, forcing their derived
    MAC/IP/flood tables to be re-imported;
    ``retained`` — speakers whose sessions and RIBs were left untouched.

    ``origins_recomputed`` counts the origin VTEPs whose flood
    reachability had to be re-derived (0 for the common flap that
    partitions nothing).
    """

    link: Tuple[str, str]
    action: str  # "fail" | "restore"
    patched: int
    rebuilt: int
    retained: int
    origins_recomputed: int = 0
    total_vteps: int = 0

    @property
    def touched(self) -> int:
        return self.patched + self.rebuilt

    @property
    def total_speakers(self) -> int:
        return self.patched + self.rebuilt + self.retained

    @property
    def vtep_touched_frac(self) -> float:
        """Fraction of leaf VTEPs whose tables had to be rebuilt."""
        if self.total_vteps <= 0:
            return 0.0
        return self.rebuilt / self.total_vteps


@dataclass
class BgpSpeaker:
    name: str
    asn: int
    router_id: str
    is_route_reflector: bool = False
    peers: List[str] = field(default_factory=list)
    rib: Set[object] = field(default_factory=set)


class EvpnControlPlane:
    """BGP session graph + route propagation over a :class:`Fabric`."""

    def __init__(self, fabric: Fabric):
        self.fabric = fabric
        self.speakers: Dict[str, BgpSpeaker] = {}
        # per-leaf derived state
        self.mac_table: Dict[str, Dict[Tuple[int, str], str]] = {}  # leaf -> (vni, mac) -> vtep
        self.ip_table: Dict[str, Dict[Tuple[int, str], str]] = {}  # leaf -> (vni, ip) -> vtep
        self.flood_list: Dict[str, Dict[int, Set[str]]] = {}  # leaf -> vni -> vtep set
        self.local_vnis: Dict[str, Set[int]] = {}  # leaf -> VNIs configured
        self._route_log: List[object] = []
        self.last_resync: Optional[EvpnResyncStats] = None
        self._build_sessions()

    # -- session graph -------------------------------------------------------

    def _build_sessions(self) -> None:
        for i, node in enumerate(sorted(self.fabric.spines + self.fabric.leaves)):
            dc = int(node[1])
            self.speakers[node] = BgpSpeaker(
                name=node,
                asn=65000 + dc,
                router_id=f"10.{dc}.0.{i + 1}",
                is_route_reflector=node in self.fabric.spines,
            )
        for leaf in self.fabric.leaves:
            self.mac_table[leaf] = {}
            self.ip_table[leaf] = {}
            self.flood_list[leaf] = {}
            self.local_vnis[leaf] = set()
            dc = leaf[:2]
            for spine in self.fabric.spines:
                if spine.startswith(dc):
                    self._peer(leaf, spine)
        # inter-DC spine peering over WAN links
        for link in self.fabric.wan_links:
            u, v = sorted(link)
            self._peer(u, v)

    def _peer(self, a: str, b: str) -> None:
        if b not in self.speakers[a].peers:
            self.speakers[a].peers.append(b)
        if a not in self.speakers[b].peers:
            self.speakers[b].peers.append(a)

    def session_up(self, a: str, b: str) -> bool:
        """A BGP session is up iff the underlay link is up."""
        return self.fabric.link_up(a, b)

    # -- advertisement -------------------------------------------------------

    def configure_vni(self, leaf: str, vni: int) -> RouteType3:
        """Configure a VNI on a leaf VTEP -> originate a Type-3 IMET route."""
        self.local_vnis[leaf].add(vni)
        self.flood_list[leaf].setdefault(vni, set())
        route = RouteType3(
            rd=f"{self.speakers[leaf].router_id}:{vni}",
            vni=vni,
            vtep_ip=self.fabric.vtep_ip(leaf),
            origin_leaf=leaf,
        )
        self._propagate(route)
        return route

    def learn_host(self, host_name: str, vni: int) -> RouteType2:
        """Leaf snoops the host's ARP -> originate a Type-2 MAC/IP route."""
        host = self.fabric.hosts[host_name]
        leaf = host.leaf
        if vni not in self.local_vnis.get(leaf, set()):
            self.configure_vni(leaf, vni)
        host.vni = vni
        route = RouteType2(
            rd=f"{self.speakers[leaf].router_id}:{vni}",
            vni=vni,
            mac=host.mac,
            ip=host.ip,
            vtep_ip=self.fabric.vtep_ip(leaf),
            origin_leaf=leaf,
        )
        self._propagate(route)
        return route

    def _propagate(self, route: object) -> None:
        """Flood through the BGP session graph (RR semantics collapsed to a
        loop-free flood over live sessions), then run import policy."""
        self._route_log.append(route)
        origin = route.origin_leaf  # type: ignore[attr-defined]
        seen = {origin}
        frontier = [origin]
        self.speakers[origin].rib.add(route)
        while frontier:
            nxt: List[str] = []
            for node in frontier:
                for peer in self.speakers[node].peers:
                    if peer in seen or not self.session_up(node, peer):
                        continue
                    seen.add(peer)
                    self.speakers[peer].rib.add(route)
                    nxt.append(peer)
            frontier = nxt
        self._reimport()

    def _reimport(self, leaves: Optional[Iterable[str]] = None) -> None:
        """Rebuild leaf tables from RIBs with RT import filtering.

        ``leaves`` restricts the rebuild to the given VTEPs (the
        incremental resync passes exactly the leaves whose RIB changed);
        ``None`` rebuilds every leaf, the full-resync behavior.
        """
        for leaf in self.fabric.leaves if leaves is None else leaves:
            mac: Dict[Tuple[int, str], str] = {}
            ip: Dict[Tuple[int, str], str] = {}
            flood: Dict[int, Set[str]] = {v: set() for v in self.local_vnis[leaf]}
            my_vteps = self.fabric.vtep_ip(leaf)
            for route in self.speakers[leaf].rib:
                vni = route.vni  # type: ignore[attr-defined]
                if vni not in self.local_vnis[leaf]:
                    continue  # RT import policy: only locally configured VNIs
                if isinstance(route, RouteType3) and route.vtep_ip != my_vteps:
                    flood[vni].add(route.vtep_ip)
                elif isinstance(route, RouteType2):
                    mac[(vni, route.mac)] = route.vtep_ip
                    ip[(vni, route.ip)] = route.vtep_ip
            self.mac_table[leaf] = mac
            self.ip_table[leaf] = ip
            self.flood_list[leaf] = flood

    # -- withdrawal ----------------------------------------------------------

    def withdraw_host(self, host_name: str) -> None:
        """Withdraw one host's Type-2 MAC/IP routes (tenant detach churn).

        The withdrawn routes also leave the route log, so neither a full
        :meth:`resync` nor :meth:`resync_incremental` can resurrect them;
        the host's VNI binding is cleared, making it unreachable until the
        next :meth:`learn_host`.
        """
        host = self.fabric.hosts[host_name]

        def _is_host_route(r: object) -> bool:
            return (
                isinstance(r, RouteType2)
                and r.mac == host.mac
                and r.ip == host.ip
            )

        for sp in self.speakers.values():
            sp.rib = {r for r in sp.rib if not _is_host_route(r)}
        self._route_log = [r for r in self._route_log if not _is_host_route(r)]
        host.vni = None
        self._reimport()

    def withdraw_leaf(self, leaf: str) -> None:
        """Withdraw every route originated by ``leaf`` (e.g. leaf isolated).

        The withdrawn routes also leave the route log, so neither a full
        :meth:`resync` nor :meth:`resync_incremental` can resurrect them.
        """
        for sp in self.speakers.values():
            sp.rib = {r for r in sp.rib if getattr(r, "origin_leaf", None) != leaf}
        self._route_log = [
            r for r in self._route_log if getattr(r, "origin_leaf", None) != leaf
        ]
        self._reimport()

    def resync(self) -> None:
        """Re-flood every logged route (after topology repair)."""
        routes, self._route_log = self._route_log, []
        for sp in self.speakers.values():
            sp.rib.clear()
        for r in routes:
            self._propagate(r)

    # -- incremental resync ---------------------------------------------------

    def _session_live(
        self,
        a: str,
        b: str,
        override: Optional[Tuple[FrozenSet[str], bool]] = None,
    ) -> bool:
        if override is not None and frozenset((a, b)) == override[0]:
            return override[1]
        return self.session_up(a, b)

    def _components(
        self, override: Optional[Tuple[FrozenSet[str], bool]] = None
    ) -> Dict[str, int]:
        """Connected components of the live BGP session graph.

        ``override`` forces one link's session state, letting the
        incremental resync reconstruct the pre-flap graph without
        replaying history (a :class:`~repro.core.fabric.RerouteStats`
        describes exactly one link transition).
        """
        comp: Dict[str, int] = {}
        cid = 0
        for s in self.speakers:
            if s in comp:
                continue
            cid += 1
            comp[s] = cid
            stack = [s]
            while stack:
                node = stack.pop()
                for peer in self.speakers[node].peers:
                    if peer not in comp and self._session_live(
                        node, peer, override
                    ):
                        comp[peer] = cid
                        stack.append(peer)
        return comp

    def resync_incremental(self, reroute: RerouteStats) -> EvpnResyncStats:
        """Resync only the VTEPs whose route reachability crossed a flap.

        Piggybacks on the data plane's :class:`~repro.core.fabric.RerouteStats`
        (the fabric has already applied the flap): a route's placement —
        RIB ``s`` holds origin ``o``'s routes iff ``s`` can be flooded
        from ``o`` over live sessions — can only change for speakers whose
        session-graph component relative to ``o`` changed across the flap.
        The common case (multihomed leaf/spine fabrics survive single-link
        flaps connected) diffs to the empty set and the whole control
        plane is ``retained``; a genuine partition withdraws/re-floods
        exactly the affected origins' routes at exactly the affected
        speakers, and only those leaves re-import their MAC/IP/flood
        tables.  Byte-identical to :meth:`resync` provided every flap is
        synced through here (or :meth:`resync` re-baselines).

        Host-attachment flaps and links that carry no BGP session diff to
        the empty set automatically.
        """
        u, v = reroute.link
        key = frozenset((u, v))
        after = self._components()
        # pre-flap graph: this link forced to its pre-transition state
        before = self._components(override=(key, reroute.action == "fail"))
        edited: Set[str] = set()
        recomputed = 0
        if before != after:
            by_origin: Dict[str, List[object]] = {}
            for r in self._route_log:
                origin = getattr(r, "origin_leaf", None)
                if origin is not None:
                    by_origin.setdefault(origin, []).append(r)
            for origin, routes in sorted(by_origin.items()):
                if origin not in self.speakers:
                    continue
                ob, oa = before[origin], after[origin]
                moved = [
                    s
                    for s in self.speakers
                    if (before[s] == ob) != (after[s] == oa)
                ]
                if not moved:
                    continue
                recomputed += 1
                rset = set(routes)
                for s in moved:
                    sp = self.speakers[s]
                    if after[s] == oa:  # gained reachability from origin
                        if not rset <= sp.rib:
                            sp.rib |= rset
                            edited.add(s)
                    else:  # lost reachability: withdraw origin's routes
                        kept = {
                            r
                            for r in sp.rib
                            if getattr(r, "origin_leaf", None) != origin
                        }
                        if len(kept) != len(sp.rib):
                            sp.rib = kept
                            edited.add(s)
        leaf_set = set(self.fabric.leaves)
        edited_leaves = sorted(edited & leaf_set)
        if edited_leaves:
            self._reimport(edited_leaves)
        stats = EvpnResyncStats(
            link=(u, v),
            action=reroute.action,
            patched=len(edited) - len(edited_leaves),
            rebuilt=len(edited_leaves),
            retained=len(self.speakers) - len(edited),
            origins_recomputed=recomputed,
            total_vteps=len(self.fabric.leaves),
        )
        self.last_resync = stats
        return stats

    # -- queries -------------------------------------------------------------

    def reachable(self, src_host: str, dst_host: str) -> bool:
        """Overlay reachability: same VNI + Type-2 route present at ingress."""
        src = self.fabric.hosts[src_host]
        dst = self.fabric.hosts[dst_host]
        if src.vni is None or dst.vni is None or src.vni != dst.vni:
            return False
        entry = self.ip_table.get(src.leaf, {}).get((src.vni, dst.ip))
        if src.leaf == dst.leaf:
            return True  # local bridging
        return entry == self.fabric.vtep_ip(dst.leaf)

    def route_count(self, node: str) -> Dict[str, int]:
        rib = self.speakers[node].rib
        return {
            "type2": sum(isinstance(r, RouteType2) for r in rib),
            "type3": sum(isinstance(r, RouteType3) for r in rib),
        }
