"""WAN link emulation (netem semantics) and deterministic transfer timing.

The paper injects a fixed 5 ms delay + 1 ms jitter per inter-DC link with
ContainerLab's ``netem`` and measures ~22 ms host-to-host RTT (Fig. 8) and
~800 Mbit/s effective spine-link throughput during training (§5.5).  This
module reproduces both:

* :class:`Netem` — per-link profile resolution (``profile(u, v)``): link-class
  delay/jitter/bandwidth/loss defaults, overridable per DC pair
  (``wan_pairs`` — the asymmetric-WAN axis) and per individual link;
* :func:`ping_rtt` — RTT samples along a fabric path (Fig. 8);
* :class:`WanTimingModel` — deterministic per-collective transfer times used
  by the Fig. 14 reproduction and by the geo-runtime's step-time estimator:
  ``time = bytes_on_bottleneck / bw + propagation + jitter`` — plus
  :meth:`WanTimingModel.contended_transfer_time`, which replaces the ideal
  aggregate-bytes fluid estimate with the flow-level max-min congestion
  model of :mod:`repro.core.congestion` (paper §5.5's ~800 Mbit/s
  effective spine throughput emerges from it rather than being assumed),
  and :meth:`WanTimingModel.contended_schedule_time`, its event-driven
  generalization to phased :class:`repro.core.schedule.CollectiveSchedule`
  DAGs with time-varying flow sets.

All randomness flows through a seeded ``numpy`` Generator: runs are
bit-reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .fabric import Fabric, Link


@dataclass(frozen=True)
class NetemProfile:
    """netem parameters for one link class.

    As in the paper's ContainerLab setup, ``netem`` qdiscs sit on *both*
    interfaces of a link, so one link traversal pays the delay (and samples
    the jitter) twice — this is what turns the paper's "5 ms per link" into
    the observed ~22 ms host-to-host RTT across a single WAN link (Fig. 8).
    """

    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    bandwidth_gbps: float = 10.0
    loss: float = 0.0

    @property
    def effective_bandwidth_gbps(self) -> float:
        """Goodput after loss-induced retransmission: ``bw * (1 - loss)``.

        The fluid/congestion models consume this, not the raw line rate, so
        a loss spike injected by a gray-failure event shows up as a
        bandwidth brownout without a packet-level model.  ``loss=0`` keeps
        the historical value bit-for-bit (``bw * 1.0``).
        """
        return self.bandwidth_gbps * (1.0 - self.loss)


def degraded_profile(
    base: NetemProfile,
    *,
    bandwidth_fraction: float = 1.0,
    extra_delay_ms: float = 0.0,
    extra_loss: float = 0.0,
) -> NetemProfile:
    """``base`` under a gray failure: a bandwidth brownout, latency
    inflation, and/or a loss spike — always derived from the pristine
    profile, so re-degrading replaces rather than compounds."""
    if not 0.0 < bandwidth_fraction <= 1.0:
        raise ValueError(
            f"bandwidth_fraction must be in (0, 1], got {bandwidth_fraction}"
        )
    if extra_delay_ms < 0.0:
        raise ValueError("extra_delay_ms must be >= 0")
    if not 0.0 <= extra_loss < 1.0:
        raise ValueError("extra_loss must be in [0, 1)")
    return NetemProfile(
        delay_ms=base.delay_ms + extra_delay_ms,
        jitter_ms=base.jitter_ms,
        bandwidth_gbps=base.bandwidth_gbps * bandwidth_fraction,
        loss=min(base.loss + extra_loss, 0.999),
    )


#: Paper defaults: WAN links get 5 ms +/- 1 ms per interface; LAN links are
#: effectively free at ping granularity; the *effective* WAN throughput
#: observed during training was ~800 Mbit/s (§5.5).
PAPER_WAN = NetemProfile(delay_ms=5.0, jitter_ms=1.0, bandwidth_gbps=0.8)
PAPER_LAN = NetemProfile(delay_ms=0.02, jitter_ms=0.005, bandwidth_gbps=10.0)
#: A modern DCI profile for the TPU-scale what-if studies (EXPERIMENTS §Perf):
#: dedicated 9 GB/s/direction per DC pair, ~10 ms one-way.
TPU_DCI = NetemProfile(delay_ms=10.0, jitter_ms=0.5, bandwidth_gbps=72.0)

#: Store-and-forward + pipeline latency per transit switch (FRR software
#: forwarding in the emulation; sub-ms, calibrated against Fig. 8).
SWITCH_FORWARDING_MS = 0.25

#: Per-DC-pair WAN profile overrides, keyed by (dc_i, dc_j) with i < j after
#: normalization: real geo deployments are asymmetric (per-pair fiber RTT is
#: the axis Papavasileiou et al. sweep), so one ``wan`` class profile is only
#: the *default*, not the whole map.
WanPairMap = Dict[Tuple[int, int], NetemProfile]


def normalize_wan_pairs(
    wan_pairs: Optional[WanPairMap], num_dcs: Optional[int] = None
) -> Dict[Tuple[int, int], NetemProfile]:
    """Validate and key-normalize a per-DC-pair profile map.

    Keys are unordered DC pairs — ``(2, 1)`` and ``(1, 2)`` name the same
    fiber bundle — stored as ``(lo, hi)``.  Self-pairs, duplicate keys
    (after normalization), and pairs outside ``1..num_dcs`` (when known)
    raise; an empty/None map normalizes to ``{}``, the symmetric default.
    """
    out: Dict[Tuple[int, int], NetemProfile] = {}
    for key, prof in (wan_pairs or {}).items():
        i, j = int(key[0]), int(key[1])
        if i == j:
            raise ValueError(f"wan_pairs key {key!r} is not a DC *pair*")
        lo, hi = (i, j) if i < j else (j, i)
        if lo < 1 or (num_dcs is not None and hi > num_dcs):
            raise ValueError(
                f"wan_pairs key {key!r} outside DCs 1..{num_dcs}"
            )
        if (lo, hi) in out:
            raise ValueError(
                f"wan_pairs keys {key!r} and {(lo, hi)!r} name the same pair"
            )
        if not isinstance(prof, NetemProfile):
            raise TypeError(f"wan_pairs[{key!r}] must be a NetemProfile")
        out[(lo, hi)] = prof
    return out


class Netem:
    """Per-link profile resolution over a :class:`Fabric`.

    :meth:`profile` is the single source of truth every consumer (fluid
    timing, congestion matrix, RTT sampling, roofline) resolves link
    parameters through.  Resolution order:

    1. an explicit per-link override (:meth:`override_link`);
    2. for WAN links, the per-DC-pair map ``wan_pairs`` — the asymmetric-WAN
       axis (one profile per inter-DC fiber bundle);
    3. the link-class defaults ``wan`` / ``lan``.

    With no overrides this is exactly the historical two-class behavior —
    byte-identical, including the jitter RNG stream, which is untouched by
    the resolution layer.
    """

    def __init__(
        self,
        fabric: Fabric,
        wan: NetemProfile = PAPER_WAN,
        lan: NetemProfile = PAPER_LAN,
        seed: int = 0,
        *,
        wan_pairs: Optional[WanPairMap] = None,
        link_overrides: Optional[Dict[Tuple[str, str], NetemProfile]] = None,
    ):
        self.fabric = fabric
        self.wan = wan
        self.lan = lan
        self.rng = np.random.default_rng(seed)
        self.wan_pairs = normalize_wan_pairs(wan_pairs, fabric.config.num_dcs)
        self._link_overrides: Dict[frozenset, NetemProfile] = {}
        # gray-failure bookkeeping: what each degraded link/pair resolved to
        # *before* its first degradation, so restore is exact and repeated
        # degradations compose on the pristine base, never on each other
        self._degraded_links: Dict[frozenset, Tuple[Optional[NetemProfile], NetemProfile]] = {}
        self._degraded_pairs: Dict[Tuple[int, int], Optional[NetemProfile]] = {}
        for (u, v), prof in (link_overrides or {}).items():
            self.override_link(u, v, prof)

    def override_link(self, u: str, v: str, profile: NetemProfile) -> None:
        """Pin one specific link (either endpoint order) to ``profile``."""
        if not isinstance(profile, NetemProfile):
            raise TypeError("link override must be a NetemProfile")
        self._link_overrides[frozenset((u, v))] = profile

    def profile(self, u: str, v: str) -> NetemProfile:
        if self._link_overrides:
            override = self._link_overrides.get(frozenset((u, v)))
            if override is not None:
                return override
        if self.fabric.is_wan_link(u, v):
            if self.wan_pairs:
                pair = self.wan_pairs.get(self.fabric.wan_pair(u, v))
                if pair is not None:
                    return pair
            return self.wan
        return self.lan

    # -- gray-failure injection ----------------------------------------------

    def _resolve_base(self, u: str, v: str) -> NetemProfile:
        """Profile resolution ignoring any per-link override (the class/pair
        layers only) — the pristine base a link degradation derives from."""
        if self.fabric.is_wan_link(u, v):
            if self.wan_pairs:
                pair = self.wan_pairs.get(self.fabric.wan_pair(u, v))
                if pair is not None:
                    return pair
            return self.wan
        return self.lan

    def degrade_link(
        self,
        u: str,
        v: str,
        *,
        bandwidth_fraction: float = 1.0,
        extra_delay_ms: float = 0.0,
        extra_loss: float = 0.0,
    ) -> NetemProfile:
        """Brownout one link: install a degraded per-link override.

        The base is whatever the link resolved to before its *first*
        degradation (a manual :meth:`override_link`, the pair map, or the
        class default) — re-degrading an already-degraded link replaces the
        degradation relative to that base instead of compounding.
        :meth:`restore_link_profile` undoes it exactly.
        """
        key = frozenset((u, v))
        if key in self._degraded_links:
            base = self._degraded_links[key][1]
        else:
            saved = self._link_overrides.get(key)
            base = saved if saved is not None else self._resolve_base(u, v)
            self._degraded_links[key] = (saved, base)
        prof = degraded_profile(
            base,
            bandwidth_fraction=bandwidth_fraction,
            extra_delay_ms=extra_delay_ms,
            extra_loss=extra_loss,
        )
        self._link_overrides[key] = prof
        return prof

    def restore_link_profile(self, u: str, v: str) -> None:
        """Undo :meth:`degrade_link` exactly (pre-degradation override or
        class/pair resolution, whichever held before)."""
        key = frozenset((u, v))
        if key not in self._degraded_links:
            raise ValueError(f"link {u}<->{v} is not degraded")
        saved, _ = self._degraded_links.pop(key)
        if saved is None:
            self._link_overrides.pop(key, None)
        else:
            self._link_overrides[key] = saved

    def degrade_pair(
        self,
        i: int,
        j: int,
        *,
        bandwidth_fraction: float = 1.0,
        extra_delay_ms: float = 0.0,
        extra_loss: float = 0.0,
    ) -> NetemProfile:
        """Brownout every link of one inter-DC fiber bundle: install a
        degraded ``wan_pairs`` entry for DC pair ``(i, j)``.

        Per-link overrides still win (resolution order unchanged); the base
        is the pair's pristine entry or the ``wan`` class default, and
        re-degrading replaces rather than compounds — same contract as
        :meth:`degrade_link`.
        """
        a, b = int(i), int(j)
        if a == b:
            raise ValueError(f"({i}, {j}) is not a DC *pair*")
        lo, hi = (a, b) if a < b else (b, a)
        num_dcs = self.fabric.config.num_dcs
        if lo < 1 or hi > num_dcs:
            raise ValueError(f"DC pair ({lo}, {hi}) outside DCs 1..{num_dcs}")
        pair = (lo, hi)
        if pair not in self._degraded_pairs:
            self._degraded_pairs[pair] = self.wan_pairs.get(pair)
        base = self._degraded_pairs[pair]
        if base is None:
            base = self.wan
        prof = degraded_profile(
            base,
            bandwidth_fraction=bandwidth_fraction,
            extra_delay_ms=extra_delay_ms,
            extra_loss=extra_loss,
        )
        self.wan_pairs[pair] = prof
        return prof

    def restore_pair(self, i: int, j: int) -> None:
        """Undo :meth:`degrade_pair` exactly."""
        a, b = int(i), int(j)
        pair = (a, b) if a < b else (b, a)
        if pair not in self._degraded_pairs:
            raise ValueError(f"DC pair {pair} is not degraded")
        original = self._degraded_pairs.pop(pair)
        if original is None:
            self.wan_pairs.pop(pair, None)
        else:
            self.wan_pairs[pair] = original

    @property
    def degraded_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """Currently degraded DC pairs, sorted."""
        return tuple(sorted(self._degraded_pairs))

    @property
    def degraded_links(self) -> Tuple[Tuple[str, str], ...]:
        """Currently degraded individual links, sorted."""
        return tuple(sorted(tuple(sorted(k)) for k in self._degraded_links))

    def one_way_delay_ms(self, path_links: Sequence[Tuple[str, str, bool]]) -> float:
        """One jittered one-way delay sample along (u, v, is_wan) links.

        Each link contributes two netem qdisc passes (one per interface),
        each transit switch contributes forwarding latency.
        """
        total = 0.0
        for u, v, _ in path_links:
            p = self.profile(u, v)
            for _interface in range(2):
                jitter = self.rng.uniform(-p.jitter_ms, p.jitter_ms) if p.jitter_ms else 0.0
                total += max(p.delay_ms + jitter, 0.0)
        n_switches = max(len(path_links) - 1, 0)
        total += n_switches * SWITCH_FORWARDING_MS
        return total

    def base_rtt_ms(self, src_host: str, dst_host: str) -> float:
        """Jitter-free RTT (per-interface delays + forwarding, both ways)."""
        links = self.fabric.rtt_path(src_host, dst_host)
        one_way = 2.0 * sum(self.profile(u, v).delay_ms for u, v, _ in links)
        one_way += max(len(links) - 1, 0) * SWITCH_FORWARDING_MS
        return 2.0 * one_way


def ping_rtt(
    netem: Netem, src_host: str, dst_host: str, count: int = 100
) -> np.ndarray:
    """RTT samples (ms), the Fig. 8 experiment."""
    links = netem.fabric.rtt_path(src_host, dst_host)
    out = np.empty(count)
    for i in range(count):
        out[i] = netem.one_way_delay_ms(links) + netem.one_way_delay_ms(links)
    return out


@dataclass
class TransferResult:
    seconds: float
    bottleneck_link: Optional[Link]
    bottleneck_bytes: int
    per_link_seconds: Dict[Link, float] = field(default_factory=dict)


class WanTimingModel:
    """Deterministic completion-time model for a set of concurrent flows.

    Each flow is routed through the fabric (updating byte counters); the
    completion time of the whole set is driven by the most-loaded link:
    ``max_l bytes(l)/bw(l) + 2*propagation + jitter_sample``.  This is the
    standard fluid approximation; it is what lets the Fig. 14 reproduction
    produce per-batch times without packet-level simulation.
    """

    def __init__(self, netem: Netem):
        self.netem = netem
        self.fabric = netem.fabric

    def transfer_time(
        self,
        flow_bytes: Dict[Link, int],
        rtt_ms: float = 0.0,
        jitter_sample_ms: float = 0.0,
    ) -> TransferResult:
        per_link: Dict[Link, float] = {}
        worst: Tuple[float, Optional[Link], int] = (0.0, None, 0)
        for (u, v), nbytes in flow_bytes.items():
            bw = self.netem.profile(u, v).effective_bandwidth_gbps
            secs = nbytes * 8.0 / (bw * 1e9)
            per_link[(u, v)] = secs
            if secs > worst[0]:
                worst = (secs, (u, v), nbytes)
        total = worst[0] + (rtt_ms + jitter_sample_ms) / 1e3
        return TransferResult(
            seconds=total,
            bottleneck_link=worst[1],
            bottleneck_bytes=worst[2],
            per_link_seconds=per_link,
        )

    def contended_transfer_time(
        self,
        flows: Sequence,
        *,
        check_reachability=None,
        reset_counters: bool = True,
        ecmp_weighted: bool = False,
    ):
        """Flow-level contended timing for a set of concurrent flows.

        Routes ``flows`` through the fabric with per-flow path recording
        (resetting counters first by default, like
        :func:`repro.core.flows.route_flows_batched`), then applies the
        max-min congestion model: each flow finishes at
        ``bytes / fair_share + path propagation``, so a collective's time
        is its slowest contended flow, not the ideal aggregate-bytes
        estimate of :meth:`transfer_time`.  Returns the
        :class:`repro.core.congestion.CongestionReport` (``.seconds`` is
        the completion time; propagation is already included per flow).

        ``ecmp_weighted=True`` weights the fair shares by the observed
        ECMP hash-slot occupancy
        (:func:`repro.core.congestion.ecmp_flow_weights`).
        """
        from .congestion import route_and_analyze  # congestion imports wan

        _, report = route_and_analyze(
            self.fabric,
            self.netem,
            flows,
            check_reachability=check_reachability,
            reset_counters=reset_counters,
            ecmp_weighted=ecmp_weighted,
        )
        return report

    def contended_schedule_time(
        self,
        schedule,
        *,
        check_reachability=None,
        reset_counters: bool = True,
        ecmp_weighted: bool = False,
        incremental=None,
    ):
        """Contended timing for a phased :class:`CollectiveSchedule`.

        Routes every phase's flows (one batch, counters accumulate the
        whole schedule) and runs the event-driven time-varying max-min
        simulation of :func:`repro.core.congestion.simulate_schedule`:
        phases enter the active set as their dependencies complete, the
        fair-share allocation is re-solved at every arrival/completion
        event, and the returned
        :class:`repro.core.congestion.ScheduleReport` carries per-phase
        and per-flow timelines (``.seconds`` is the makespan).  For a
        single-phase schedule this is exactly
        :meth:`contended_transfer_time` on its flow set.

        ``incremental`` passes through to the simulator's epoch-allocator
        choice (warm-started vs from-scratch oracle — byte-identical, see
        ``simulate_schedule``); ``None`` defers to the module default.
        """
        from .congestion import simulate_schedule  # congestion imports wan

        return simulate_schedule(
            self.fabric,
            self.netem,
            schedule,
            check_reachability=check_reachability,
            reset_counters=reset_counters,
            ecmp_weighted=ecmp_weighted,
            incremental=incremental,
        )
