"""Session/KV-cache affinity routing with cross-DC failover.

Sessions are sticky: a user's KV cache lives in one DC, and re-homing it
costs ``session_tokens * kv_bytes_per_token`` over the WAN — the router
only pays that when it must.  A deterministic per-user hash steadily
serves ``remote_fraction`` of each DC's users cross-DC (capacity
spillover; the traffic class a WAN brownout actually hurts), and
failover re-homes a session when its serving DC dies or its home<->serving
pair goes bad — as reported by the scenario's SLA probes when a
:class:`~repro.scenario.spec.DegradationPolicy` is active, else straight
from ``Netem``'s degraded-pair set.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

from ..scenario.spec import ServingSpec

__all__ = ["FabricHealth", "Route", "SessionRouter"]

_INF = float("inf")


@dataclass(frozen=True)
class FabricHealth:
    """One step's routing view of the fabric: which DCs are alive, which
    DC pairs are degraded/tripped, and leader RTTs (``inf`` = partitioned)."""

    alive: FrozenSet[int]
    bad_pairs: FrozenSet[Tuple[int, int]]
    rtt_ms: Mapping[Tuple[int, int], float]

    def dc_ok(self, dc: int) -> bool:
        return dc in self.alive

    def pair_ok(self, a: int, b: int) -> bool:
        if a == b:
            return True
        pair = (a, b) if a < b else (b, a)
        return pair not in self.bad_pairs and self.rtt(a, b) != _INF

    def rtt(self, a: int, b: int) -> float:
        if a == b:
            return 0.0
        pair = (a, b) if a < b else (b, a)
        return float(self.rtt_ms.get(pair, _INF))

    def reachable(self, a: int, b: int) -> bool:
        return a == b or self.rtt(a, b) != _INF


@dataclass(frozen=True)
class Route:
    """Where one request is served.  ``migrated`` marks a session re-home
    this step; ``kv_source`` is the DC the session's KV is pulled from
    (None: fresh placement, or the cache died with its DC / behind a
    partition and must be recomputed — bytes saved, latency SLO lost)."""

    serving_dc: int
    migrated: bool = False
    kv_source: Optional[int] = None


@dataclass
class SessionRouter:
    spec: ServingSpec
    num_dcs: int
    #: (home_dc, user) -> DC currently holding the session's KV
    _serving: Dict[Tuple[int, int], int] = field(default_factory=dict)

    def _wants_remote(self, home: int, user: int) -> bool:
        """Deterministic per-user coin for the steady cross-DC class."""
        if self.spec.remote_fraction <= 0.0 or self.num_dcs < 2:
            return False
        h = ((user + 1) * 2654435761 + home * 97) & 0xFFFFFFFF
        return h / 2**32 < self.spec.remote_fraction

    def _preferred_remote(self, home: int, health: FabricHealth) -> Optional[int]:
        """Lowest-RTT healthy remote DC with a healthy pair to home."""
        best: Optional[int] = None
        best_rtt = _INF
        for dc in range(1, self.num_dcs + 1):
            if dc == home or not health.dc_ok(dc) or not health.pair_ok(home, dc):
                continue
            rtt = health.rtt(home, dc)
            if rtt < best_rtt:
                best, best_rtt = dc, rtt
        return best

    def _target(self, home: int, user: int, health: FabricHealth) -> Optional[int]:
        """Where this session *should* live right now."""
        if health.dc_ok(home):
            if self._wants_remote(home, user):
                remote = self._preferred_remote(home, health)
                if remote is not None:
                    return remote
            return home
        # home DC is down: nearest alive DC takes the user
        best: Optional[int] = None
        best_rtt = _INF
        for dc in sorted(health.alive):
            rtt = health.rtt(home, dc)
            if rtt < best_rtt:
                best, best_rtt = dc, rtt
        return best

    def rehome_all(self, health: FabricHealth):
        """The step-boundary failover sweep: re-home *every* tracked
        session whose placement is unhealthy (a live session suffers a
        brownout whether or not it issues a request this step).

        Returns ``[(home, user, old_dc, Route)]`` in sorted session order
        (deterministic).  Sessions with nowhere to go are dropped from
        the table (their users re-place on next contact)."""
        if not self.spec.failover:
            return []
        moves = []
        for key in sorted(self._serving):
            home, user = key
            cur = self._serving[key]
            unhealthy = not health.dc_ok(cur) or (
                health.dc_ok(home) and cur != home and not health.pair_ok(home, cur)
            )
            if not unhealthy:
                continue
            new = self._target(home, user, health)
            if new is None:
                del self._serving[key]
                continue
            if new == cur:
                continue
            kv_source = (
                cur if health.dc_ok(cur) and health.reachable(cur, new) else None
            )
            self._serving[key] = new
            moves.append(
                (home, user, cur,
                 Route(serving_dc=new, migrated=True, kv_source=kv_source))
            )
        return moves

    def route(self, home: int, user: int, health: FabricHealth) -> Optional[Route]:
        """Resolve one request; mutates session state.  None = dropped
        (no alive DC can take it)."""
        key = (home, user)
        cur = self._serving.get(key)
        if cur is None:
            target = self._target(home, user, health)
            if target is None:
                return None
            self._serving[key] = target
            return Route(serving_dc=target)

        unhealthy = not health.dc_ok(cur) or (
            health.dc_ok(home) and cur != home and not health.pair_ok(home, cur)
        )
        if not unhealthy or not self.spec.failover:
            return Route(serving_dc=cur)

        new = self._target(home, user, health)
        if new is None:
            del self._serving[key]
            return None
        if new == cur:
            return Route(serving_dc=cur)
        kv_source = cur if health.dc_ok(cur) and health.reachable(cur, new) else None
        self._serving[key] = new
        return Route(serving_dc=new, migrated=True, kv_source=kv_source)
