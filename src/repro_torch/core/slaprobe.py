"""Gray-failure detection: SLA probes over per-pair rate/RTT observations.

BFD (:mod:`repro.core.bfd`) answers "is the link *up*?" — its keepalives
are a few bytes every 10 ms, so a bandwidth brownout, a loss spike, or
latency inflation sails straight through it: the session stays UP while
the WAN silently eats the training budget.  This module is the sibling
state machine for the *gray* regime, with the same simulated-clock
discipline as :class:`~repro.core.bfd.BfdSession`:

* :class:`SlaProbe` — threshold-with-hysteresis over an observed
  per-DC-pair transfer rate and RTT: ``trip_after`` consecutive breaching
  observations trip the probe to DEGRADED, ``recover_after`` consecutive
  healthy ones recover it — a single noisy sample moves nothing in either
  direction.

* :class:`SlaProbeBank` — one probe per monitored DC pair, calibrated
  against a healthy-fabric baseline (thresholds are *fractions* of the
  calibrated rate/RTT, so one knob set covers asymmetric per-pair WANs),
  recording every state transition as a :class:`ProbeTransition`.

The scenario runner feeds the bank from the congestion reports of each
step's costed schedule (per-pair achieved WAN rate) plus the jitter-free
leader RTT, and a :class:`~repro.scenario.spec.DegradationPolicy` reacts
to trips — see :func:`repro.scenario.runner.run_scenario`.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ProbeState",
    "ProbeTransition",
    "SlaProbe",
    "SlaProbeBank",
]


class ProbeState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"


@dataclass(frozen=True)
class ProbeTransition:
    """One probe state change: which pair, when, to what, on which sample."""

    pair: Tuple[int, int]
    at_ms: float
    state: ProbeState
    rate_gbps: float
    rtt_ms: float

    def to_dict(self) -> Dict[str, object]:
        return {
            "pair": list(self.pair),
            "at_ms": float(self.at_ms),
            "state": self.state.value,
            "rate_gbps": float(self.rate_gbps),
            "rtt_ms": float(self.rtt_ms),
        }


@dataclass
class SlaProbe:
    """Threshold-with-hysteresis gray-failure detector for one DC pair.

    An observation *breaches* when the rate falls below ``rate_floor_gbps``
    (0 disables the rate check — e.g. a pair that carries no baseline
    traffic) or the RTT exceeds ``rtt_ceiling_ms`` (``inf`` disables it).
    ``trip_after`` consecutive breaches trip HEALTHY -> DEGRADED;
    ``recover_after`` consecutive clean observations recover it.  The
    simulated clock must advance monotonically, exactly like
    :class:`~repro.core.bfd.BfdSession`.
    """

    pair: Tuple[int, int]
    rate_floor_gbps: float = 0.0
    rtt_ceiling_ms: float = math.inf
    trip_after: int = 2
    recover_after: int = 2
    state: ProbeState = ProbeState.HEALTHY
    bad_streak: int = 0
    good_streak: int = 0
    last_observed_ms: float = -math.inf
    last_rate_gbps: float = math.nan
    last_rtt_ms: float = math.nan

    def __post_init__(self):
        if self.trip_after < 1:
            raise ValueError("trip_after must be >= 1")
        if self.recover_after < 1:
            raise ValueError("recover_after must be >= 1")
        if self.rate_floor_gbps < 0.0:
            raise ValueError("rate_floor_gbps must be >= 0")

    def breaches(self, *, rate_gbps: float, rtt_ms: float) -> bool:
        return rate_gbps < self.rate_floor_gbps or rtt_ms > self.rtt_ceiling_ms

    def observe(self, now_ms: float, *, rate_gbps: float, rtt_ms: float) -> ProbeState:
        """Feed one measurement; returns the (possibly new) state."""
        if now_ms < self.last_observed_ms:
            raise ValueError(
                f"probe clock moved backwards ({now_ms} < {self.last_observed_ms})"
            )
        self.last_observed_ms = now_ms
        self.last_rate_gbps = rate_gbps
        self.last_rtt_ms = rtt_ms
        if self.breaches(rate_gbps=rate_gbps, rtt_ms=rtt_ms):
            self.bad_streak += 1
            self.good_streak = 0
            if self.state == ProbeState.HEALTHY and self.bad_streak >= self.trip_after:
                self.state = ProbeState.DEGRADED
        else:
            self.good_streak += 1
            self.bad_streak = 0
            if self.state == ProbeState.DEGRADED and self.good_streak >= self.recover_after:
                self.state = ProbeState.HEALTHY
        return self.state


@dataclass
class SlaProbeBank:
    """One :class:`SlaProbe` per monitored DC pair, relative thresholds.

    :meth:`calibrate` fixes a pair's healthy baseline ``(rate, rtt)`` and
    instantiates its probe with absolute thresholds
    ``rate_floor_frac * rate`` / ``rtt_ceiling_frac * rtt``; a pair
    observed before calibration self-calibrates on its first sample (the
    probe learns steady state, then watches for deviation).  Every state
    change lands in ``transitions``.
    """

    rate_floor_frac: float = 0.5
    rtt_ceiling_frac: float = 2.0
    trip_after: int = 2
    recover_after: int = 2
    probes: Dict[Tuple[int, int], SlaProbe] = field(default_factory=dict)
    baselines: Dict[Tuple[int, int], Tuple[float, float]] = field(default_factory=dict)
    transitions: List[ProbeTransition] = field(default_factory=list)

    def __post_init__(self):
        if not 0.0 <= self.rate_floor_frac <= 1.0:
            raise ValueError("rate_floor_frac must be in [0, 1]")
        if self.rtt_ceiling_frac < 1.0:
            raise ValueError("rtt_ceiling_frac must be >= 1")

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(sorted(self.probes))

    def calibrate(
        self, pair: Tuple[int, int], *, rate_gbps: float, rtt_ms: float
    ) -> SlaProbe:
        pair = tuple(pair)
        if pair in self.probes:
            raise ValueError(f"pair {pair} already calibrated")
        self.baselines[pair] = (float(rate_gbps), float(rtt_ms))
        probe = SlaProbe(
            pair=pair,
            rate_floor_gbps=self.rate_floor_frac * rate_gbps,
            rtt_ceiling_ms=(
                self.rtt_ceiling_frac * rtt_ms if rtt_ms > 0 else math.inf
            ),
            trip_after=self.trip_after,
            recover_after=self.recover_after,
        )
        self.probes[pair] = probe
        return probe

    def observe(
        self, pair: Tuple[int, int], now_ms: float, *, rate_gbps: float, rtt_ms: float
    ) -> ProbeState:
        pair = tuple(pair)
        probe = self.probes.get(pair)
        if probe is None:
            probe = self.calibrate(pair, rate_gbps=rate_gbps, rtt_ms=rtt_ms)
        before = probe.state
        after = probe.observe(now_ms, rate_gbps=rate_gbps, rtt_ms=rtt_ms)
        if after != before:
            self.transitions.append(
                ProbeTransition(
                    pair=pair,
                    at_ms=now_ms,
                    state=after,
                    rate_gbps=rate_gbps,
                    rtt_ms=rtt_ms,
                )
            )
        return after

    def tripped(self) -> Tuple[Tuple[int, int], ...]:
        """DC pairs currently DEGRADED, sorted."""
        return tuple(
            p for p in self.pairs if self.probes[p].state == ProbeState.DEGRADED
        )

    @property
    def any_degraded(self) -> bool:
        return any(p.state == ProbeState.DEGRADED for p in self.probes.values())

    def probe(self, pair: Tuple[int, int]) -> Optional[SlaProbe]:
        return self.probes.get(tuple(pair))
