"""Declarative experiment specs: one value object from topology to metrics.

The paper's contribution is a *reproducible emulation framework* (§4-§5),
but ad-hoc studies fragment fast: every benchmark and example used to
hand-roll its own ``FabricConfig`` + netem + workload + failure-script
builder.  This module makes the whole experiment a single declarative
:class:`Scenario`:

* :class:`TopologySpec` — the emulated deployment: pod/worker counts (or a
  raw :class:`~repro.core.fabric.FabricConfig` override for scaled
  studies), WAN/LAN :class:`~repro.core.wan.NetemProfile`\\ s, QP channel
  count and port scheme, RNG seed;
* :class:`WorkloadSpec` — what trains: a registered strategy name (or a
  :class:`~repro.core.schedule.CollectiveSchedule` built directly),
  gradient bytes (or a ``repro.configs`` model name to derive them from),
  per-step compute and the compute/communication overlap fraction, and how
  many steps to emulate;
* :class:`~repro.core.geo.SyncOptions` — the costing knobs
  (``sync_every`` / ``int8_ratio`` / ``jitter`` / ``congestion`` /
  ``ecmp_weighted``), consolidated from ``GeoFabric.sync_cost``'s historic
  keyword sprawl;
* :class:`ScenarioEvent` — timed control-plane/data-plane events: link
  flaps (BFD- or BGP-detected), tenant attach/detach churn, straggler
  injection.

A :class:`Scenario` round-trips through JSON
(``Scenario.from_dict(s.to_dict()) == s``) so studies are serializable,
diffable artifacts; :func:`repro.scenario.runner.run_scenario` executes one
and returns a :class:`~repro.scenario.runner.ScenarioResult`.
"""
# Port: relative imports (``repro.*`` -> ``..*``); model_grad_bytes / model_kv_bytes size the port's trees on the meta device.

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

from ..core.fabric import FabricConfig
from ..core.geo import GeoFabric, SyncOptions
from ..core.schedule import CollectiveSchedule
from ..core.wan import NetemProfile, PAPER_LAN, PAPER_WAN, normalize_wan_pairs

__all__ = [
    "DegradationPolicy",
    "Scenario",
    "ScenarioEvent",
    "ServingSpec",
    "SyncOptions",
    "TopologySpec",
    "WorkloadSpec",
    "model_grad_bytes",
    "model_kv_bytes",
]


def _reject_unknown_keys(cls, d: Dict[str, object]) -> None:
    """Clear error for unknown keys in a spec dict (sweep-override typos
    used to die as a bare ``TypeError`` from ``cls(**d)``)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} key(s) {unknown}; valid: {sorted(fields)}"
        )


def _profile_dict(p: NetemProfile) -> Dict[str, float]:
    return dataclasses.asdict(p)


def _fabric_dict(c: FabricConfig) -> Dict[str, object]:
    d = dataclasses.asdict(c)
    d["hosts_per_leaf"] = [list(t) for t in c.hosts_per_leaf]
    return d


def _fabric_from_dict(d: Dict[str, object]) -> FabricConfig:
    d = dict(d)
    d["hosts_per_leaf"] = tuple(tuple(t) for t in d["hosts_per_leaf"])
    return FabricConfig(**d)


@dataclass(frozen=True)
class TopologySpec:
    """The emulated deployment a scenario runs on.

    ``num_pods``/``workers_per_pod`` build the standard
    :class:`~repro.core.geo.GeoFabric` shape; ``fabric`` overrides it with
    a raw :class:`~repro.core.fabric.FabricConfig` (the 8-DC storm and the
    paper's asymmetric Fig. 1 topology need exact host layouts).
    ``wan_pairs`` assigns one :class:`NetemProfile` per inter-DC fiber
    bundle — ``{(1, 3): NetemProfile(delay_ms=28.0, ...)}`` — resolved by
    :meth:`Netem.profile <repro.core.wan.Netem.profile>` ahead of the
    ``wan`` class default (a dict or pre-normalized entry tuple is
    accepted; it is canonicalized so spec equality and the JSON round-trip
    hold).  ``default_tenant=False`` skips the all-hosts training tenant
    so tenancy scenarios can lay out their own VNIs via events.

    ``srlgs`` declares *shared-risk link groups*: named sets of DC pairs
    whose WAN links ride the same physical conduit (the sovereignty-driven
    shared-fiber reality), so one ``fiber_cut`` event fails them together —
    ``{"coastal": [(1, 2), (1, 3)]}`` (a dict or the canonicalized entry
    tuple; pairs are normalized ``(lo, hi)`` and validated against
    ``num_dcs`` exactly like ``wan_pairs`` keys).
    """

    num_pods: int = 2
    workers_per_pod: int = 2
    wan: NetemProfile = PAPER_WAN
    lan: NetemProfile = PAPER_LAN
    num_channels: int = 4
    port_scheme: str = "qp_aware"
    seed: int = 0
    fabric: Optional[FabricConfig] = None
    default_tenant: bool = True
    wan_pairs: Tuple[Tuple[Tuple[int, int], NetemProfile], ...] = ()
    srlgs: Tuple[Tuple[str, Tuple[Tuple[int, int], ...]], ...] = ()

    def __post_init__(self):
        normalized = normalize_wan_pairs(dict(self.wan_pairs or ()), self.num_dcs)
        object.__setattr__(
            self, "wan_pairs", tuple(sorted(normalized.items()))
        )
        object.__setattr__(self, "srlgs", self._normalize_srlgs(self.srlgs))

    def _normalize_srlgs(
        self, srlgs
    ) -> Tuple[Tuple[str, Tuple[Tuple[int, int], ...]], ...]:
        canon = []
        for name, pairs in sorted(dict(srlgs or ()).items()):
            if not name or not isinstance(name, str):
                raise ValueError(
                    f"SRLG name must be a non-empty string, got {name!r}"
                )
            norm = set()
            for key in pairs:
                i, j = int(key[0]), int(key[1])
                if i == j:
                    raise ValueError(f"SRLG {name!r} entry {key!r} is not a DC pair")
                lo, hi = (i, j) if i < j else (j, i)
                if lo < 1 or hi > self.num_dcs:
                    raise ValueError(
                        f"SRLG {name!r} pair {key!r} outside DCs 1..{self.num_dcs}"
                    )
                norm.add((lo, hi))
            if not norm:
                raise ValueError(f"SRLG {name!r} has no member pairs")
            canon.append((name, tuple(sorted(norm))))
        return tuple(canon)

    def srlg_pairs(self, name: str) -> Tuple[Tuple[int, int], ...]:
        """Member DC pairs of the named shared-risk group."""
        for group, pairs in self.srlgs:
            if group == name:
                return pairs
        known = tuple(g for g, _ in self.srlgs)
        raise ValueError(f"unknown SRLG {name!r}; declared: {known}")

    @property
    def num_dcs(self) -> int:
        return self.fabric.num_dcs if self.fabric is not None else self.num_pods

    def build(self) -> GeoFabric:
        """Materialize the emulated deployment."""
        return GeoFabric(
            self.num_pods,
            self.workers_per_pod,
            wan=self.wan,
            lan=self.lan,
            wan_pairs=dict(self.wan_pairs) or None,
            num_channels=self.num_channels,
            port_scheme=self.port_scheme,
            seed=self.seed,
            config=self.fabric,
            default_tenant="training" if self.default_tenant else None,
        )

    def to_dict(self) -> Dict[str, object]:
        return {
            "num_pods": self.num_pods,
            "workers_per_pod": self.workers_per_pod,
            "wan": _profile_dict(self.wan),
            "lan": _profile_dict(self.lan),
            "num_channels": self.num_channels,
            "port_scheme": self.port_scheme,
            "seed": self.seed,
            "fabric": None if self.fabric is None else _fabric_dict(self.fabric),
            "default_tenant": self.default_tenant,
            "wan_pairs": [
                [list(pair), _profile_dict(p)] for pair, p in self.wan_pairs
            ],
            "srlgs": [
                [name, [list(p) for p in pairs]] for name, pairs in self.srlgs
            ],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "TopologySpec":
        d = dict(d)
        _reject_unknown_keys(cls, d)
        d["wan"] = NetemProfile(**d["wan"])
        d["lan"] = NetemProfile(**d["lan"])
        if d.get("fabric") is not None:
            d["fabric"] = _fabric_from_dict(d["fabric"])
        d["wan_pairs"] = tuple(
            (tuple(pair), NetemProfile(**p)) for pair, p in d.get("wan_pairs", ())
        )
        d["srlgs"] = tuple(
            (name, tuple(tuple(p) for p in pairs))
            for name, pairs in d.get("srlgs", ())
        )
        return cls(**d)


@dataclass(frozen=True)
class WorkloadSpec:
    """What the scenario trains/synchronizes, and for how many steps.

    ``strategy`` is a registered schedule-strategy name, a
    :class:`CollectiveSchedule` built directly (not JSON-serializable),
    or ``None`` for control-plane-only scenarios (tenancy matrices, pure
    flap storms).  Gradient volume comes from ``grad_bytes`` or is
    derived from a ``repro.configs`` model name (fp32 parameter bytes via
    ``jax.eval_shape`` — exact, allocation-free).  ``compute_seconds`` > 0
    turns each step into :meth:`~repro.core.geo.GeoFabric.step_time` with
    ``overlap_fraction`` of compute overlappable; 0 costs pure sync.
    """

    strategy: Union[str, CollectiveSchedule, None] = "allreduce"
    grad_bytes: int = 0
    model: Optional[str] = None
    compute_seconds: float = 0.0
    overlap_fraction: float = 0.0
    steps: int = 1

    def __post_init__(self):
        if self.steps < 0:
            raise ValueError("steps must be >= 0")
        if not 0.0 <= self.overlap_fraction <= 1.0:
            raise ValueError("overlap_fraction must be in [0, 1]")
        if self.compute_seconds < 0:
            raise ValueError("compute_seconds must be >= 0")
        if self.grad_bytes < 0:
            raise ValueError("grad_bytes must be >= 0")

    def resolve_grad_bytes(self) -> int:
        """Gradient bytes: explicit, or fp32 parameter bytes of ``model``."""
        if self.grad_bytes > 0:
            return self.grad_bytes
        if self.model is not None:
            return model_grad_bytes(self.model)
        if isinstance(self.strategy, CollectiveSchedule):
            return 0  # a schedule carries its own flow byte counts
        if self.strategy is None:
            return 0
        raise ValueError(
            f"workload {self.strategy!r} needs grad_bytes > 0 or a model name"
        )

    def to_dict(self) -> Dict[str, object]:
        if isinstance(self.strategy, CollectiveSchedule):
            raise TypeError(
                f"schedule-valued workloads are not JSON-serializable "
                f"(schedule {self.strategy.name!r}); use a registered "
                "strategy name"
            )
        return {
            "strategy": self.strategy,
            "grad_bytes": self.grad_bytes,
            "model": self.model,
            "compute_seconds": self.compute_seconds,
            "overlap_fraction": self.overlap_fraction,
            "steps": self.steps,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "WorkloadSpec":
        _reject_unknown_keys(cls, d)
        return cls(**d)


_MODEL_GRAD_BYTES: Dict[str, int] = {}


def model_grad_bytes(model: str) -> int:
    """fp32 gradient volume of a ``repro.configs`` model (cached)."""
    cached = _MODEL_GRAD_BYTES.get(model)
    if cached is None:
        from ..configs import get_config
        from ..launch.shapes import params_specs
        from ..tree import tree_leaves

        specs = params_specs(get_config(model))
        cached = int(sum(t.numel() * 4 for t in tree_leaves(specs)))
        _MODEL_GRAD_BYTES[model] = cached
    return cached


_MODEL_KV_BYTES: Dict[str, int] = {}


def model_kv_bytes(model: str, tokens: int = 1) -> int:
    """Decode-cache (KV / recurrent-state) bytes a served session holds
    per context token, times ``tokens`` (cached per model).

    Mirrors :func:`model_grad_bytes`: exact and allocation-free via
    meta-device tensors of the model's ``decode_32k`` cache layout,
    amortized to per-token bytes.  Recurrent/RWKV layers hold O(1) state
    independent of context length, so their per-token share is tiny —
    exactly the serving-cost asymmetry sub-quadratic archs buy.
    """
    if tokens < 0:
        raise ValueError("tokens must be >= 0")
    per_token = _MODEL_KV_BYTES.get(model)
    if per_token is None:
        from ..configs import get_config
        from ..launch.shapes import SHAPES, decode_cache_specs
        from ..tree import tree_leaves

        spec = SHAPES["decode_32k"]
        cache = decode_cache_specs(get_config(model), "decode_32k")
        total = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        per_token = max(total // (spec.global_batch * spec.seq_len), 1)
        _MODEL_KV_BYTES[model] = per_token
    return per_token * int(tokens)


@dataclass(frozen=True)
class ServingSpec:
    """Geo-serving co-load: open-loop inference traffic on the training fabric.

    **Request generation** (``repro.serving.traffic``): each DC hosts a
    pinned user population (``users_per_dc``, or ``users`` split evenly —
    the data-sovereignty assumption), producing Poisson arrivals per step
    at ``requests_per_user_step``, modulated by a sinusoidal diurnal curve
    whose peak rotates across DCs (time zones), with heavy-tailed
    (lognormal/Pareto) per-request token counts.  The whole trace is a
    pure function of this spec and ``seed``, so serving results are
    byte-identical across sweep worker counts.

    **KV sizing**: each request moves ``tokens * kv_bytes_per_token``
    bytes (the prefill -> decode-host cache handoff) and a migrated
    session moves ``session_tokens * kv_bytes_per_token``.  Per-token
    bytes come explicitly or from a ``repro.configs`` model name via
    :func:`model_kv_bytes` (the ``grad_bytes``/``model`` duality of
    :class:`WorkloadSpec`).

    **Affinity + failover** (``repro.serving.router``): sessions are
    sticky to their home DC; ``remote_fraction`` of users are steadily
    served cross-DC (the traffic class WAN brownouts actually hurt).  With
    ``failover=True`` the router re-homes a session when its serving pair
    trips an :class:`~repro.core.slaprobe.SlaProbe` (or, without probes,
    when a ``degrade_pair`` lands or the pair partitions), paying the
    session's KV migration bytes over the WAN.

    Requests whose modeled latency exceeds ``slo_ms`` are SLO misses;
    goodput is reported as ``serving_slo_miss_frac`` (lower is better).
    """

    users: int = 1_000_000
    users_per_dc: Tuple[int, ...] = ()
    requests_per_user_step: float = 8e-6
    diurnal_amplitude: float = 0.5
    diurnal_period_steps: int = 24
    tail: str = "lognormal"
    tail_sigma: float = 0.8
    tail_alpha: float = 2.5
    mean_tokens: int = 256
    session_tokens: int = 2048
    model: Optional[str] = None
    kv_bytes_per_token: int = 0
    remote_fraction: float = 0.0
    slo_ms: float = 250.0
    failover: bool = True
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(
            self, "users_per_dc", tuple(int(u) for u in self.users_per_dc)
        )
        if self.users < 0 or any(u < 0 for u in self.users_per_dc):
            raise ValueError("user populations must be >= 0")
        if self.requests_per_user_step < 0:
            raise ValueError("requests_per_user_step must be >= 0")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1]")
        if self.diurnal_period_steps < 1:
            raise ValueError("diurnal_period_steps must be >= 1")
        if self.tail not in ("lognormal", "pareto"):
            raise ValueError(
                f"tail must be 'lognormal' or 'pareto', got {self.tail!r}"
            )
        if self.tail_sigma <= 0:
            raise ValueError("tail_sigma must be > 0")
        if self.tail_alpha <= 1.0:
            raise ValueError("tail_alpha must be > 1 (finite mean)")
        if self.mean_tokens < 1:
            raise ValueError("mean_tokens must be >= 1")
        if self.session_tokens < 0:
            raise ValueError("session_tokens must be >= 0")
        if not 0.0 <= self.remote_fraction <= 1.0:
            raise ValueError("remote_fraction must be in [0, 1]")
        if self.slo_ms <= 0:
            raise ValueError("slo_ms must be > 0")
        if self.kv_bytes_per_token < 0:
            raise ValueError("kv_bytes_per_token must be >= 0")

    def resolve_kv_bytes_per_token(self) -> int:
        """Per-token KV bytes: explicit, or derived from ``model``."""
        if self.kv_bytes_per_token > 0:
            return self.kv_bytes_per_token
        if self.model is not None:
            return model_kv_bytes(self.model)
        raise ValueError(
            "ServingSpec needs kv_bytes_per_token > 0 or a model name"
        )

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["users_per_dc"] = list(self.users_per_dc)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ServingSpec":
        d = dict(d)
        _reject_unknown_keys(cls, d)
        d["users_per_dc"] = tuple(d.get("users_per_dc", ()))
        return cls(**d)


#: The event kinds :func:`repro.scenario.runner.run_scenario` executes.
EVENT_KINDS = (
    "fail_link",            # BFD/BGP-detected link failure -> RecoveryTimeline
    "restore_link",         # link comes back -> incremental reroute + EVPN resync
    "tenant_attach",        # attach host to tenant (created on first use)
    "tenant_detach",        # withdraw the host's Type-2 routes fabric-wide
    "straggler",            # multiply compute_seconds for duration_steps steps
    "degrade_link",         # gray failure: brownout one link's NetemProfile
    "degrade_pair",         # gray failure: brownout one DC pair's fiber bundle
    "restore_degradation",  # lift a degrade_link/degrade_pair exactly
    "fail_switch",          # atomic multi-link failure of a spine/leaf switch
    "restore_switch",       # bring the switch's failed links back
    "fiber_cut",            # SRLG cut: fail every member pair's WAN links atomically
    "fiber_restore",        # bring the SRLG's links back
    "pod_fail",             # pod stops heartbeating -> detect/restore/remesh chain
)


@dataclass(frozen=True)
class ScenarioEvent:
    """One timed event; fields beyond ``kind``/``at_step`` are per-kind.

    ``fail_link``/``restore_link`` need ``link`` (and ``mechanism`` for
    failures: ``"bfd"`` | ``"bgp"``); ``tenant_attach`` needs ``tenant``,
    ``host`` and — when the tenant does not exist yet — ``vni``;
    ``tenant_detach`` needs ``tenant`` + ``host``; ``straggler`` needs
    ``slowdown`` (compute multiplier) and ``duration_steps``.

    Gray-failure kinds: ``degrade_link`` needs ``link``, ``degrade_pair``
    needs ``pair`` — both take ``bandwidth_fraction`` (brownout),
    ``extra_delay_ms`` (latency inflation) and ``extra_loss`` (loss
    spike), applied through the :meth:`Netem.profile
    <repro.core.wan.Netem.profile>` resolver mid-run;
    ``restore_degradation`` needs exactly one of ``link``/``pair``.
    ``fail_switch``/``restore_switch`` need ``node`` (a spine/leaf name);
    ``fiber_cut``/``fiber_restore`` need ``srlg`` (declared in
    ``TopologySpec.srlgs``); ``pod_fail`` needs ``pod`` (1-based DC
    index).
    """

    kind: str
    at_step: int = 0
    link: Optional[Tuple[str, str]] = None
    mechanism: str = "bfd"
    tenant: Optional[str] = None
    vni: Optional[int] = None
    host: Optional[str] = None
    slowdown: float = 1.0
    duration_steps: int = 1
    pair: Optional[Tuple[int, int]] = None
    bandwidth_fraction: float = 1.0
    extra_delay_ms: float = 0.0
    extra_loss: float = 0.0
    node: Optional[str] = None
    srlg: Optional[str] = None
    pod: Optional[int] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; one of {EVENT_KINDS}")
        if self.at_step < 0:
            raise ValueError("at_step must be >= 0")
        if self.link is not None:
            object.__setattr__(self, "link", tuple(self.link))
        if self.pair is not None:
            i, j = int(self.pair[0]), int(self.pair[1])
            if i == j:
                raise ValueError(f"event pair {self.pair!r} is not a DC pair")
            object.__setattr__(self, "pair", (i, j) if i < j else (j, i))
        if self.kind in ("fail_link", "restore_link", "degrade_link") and self.link is None:
            raise ValueError(f"{self.kind} event needs a link")
        if self.kind == "degrade_pair" and self.pair is None:
            raise ValueError("degrade_pair event needs a pair")
        if self.kind == "restore_degradation" and (self.link is None) == (self.pair is None):
            raise ValueError(
                "restore_degradation event needs exactly one of link/pair"
            )
        if self.kind in ("degrade_link", "degrade_pair"):
            if not 0.0 < self.bandwidth_fraction <= 1.0:
                raise ValueError("bandwidth_fraction must be in (0, 1]")
            if self.extra_delay_ms < 0.0:
                raise ValueError("extra_delay_ms must be >= 0")
            if not 0.0 <= self.extra_loss < 1.0:
                raise ValueError("extra_loss must be in [0, 1)")
        if self.kind in ("fail_switch", "restore_switch") and self.node is None:
            raise ValueError(f"{self.kind} event needs a node")
        if self.kind in ("fiber_cut", "fiber_restore") and self.srlg is None:
            raise ValueError(f"{self.kind} event needs an srlg name")
        if self.kind == "pod_fail" and (self.pod is None or self.pod < 1):
            raise ValueError("pod_fail event needs a pod index >= 1")
        if self.kind in ("tenant_attach", "tenant_detach") and (
            self.tenant is None or self.host is None
        ):
            raise ValueError(f"{self.kind} event needs tenant and host")
        if self.kind == "straggler":
            if self.slowdown < 1.0:
                raise ValueError("straggler slowdown must be >= 1.0")
            if self.duration_steps < 1:
                raise ValueError("straggler duration_steps must be >= 1")

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["link"] = None if self.link is None else list(self.link)
        d["pair"] = None if self.pair is None else list(self.pair)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ScenarioEvent":
        d = dict(d)
        _reject_unknown_keys(cls, d)
        if d.get("link") is not None:
            d["link"] = tuple(d["link"])
        if d.get("pair") is not None:
            d["pair"] = tuple(d["pair"])
        return cls(**d)


@dataclass(frozen=True)
class DegradationPolicy:
    """How a scenario detects gray failures and gracefully degrades.

    **Detection** (the :class:`~repro.core.slaprobe.SlaProbeBank` knobs):
    per-DC-pair probes calibrate against the healthy baseline and trip
    when the observed WAN rate falls below ``rate_floor_frac`` of it or
    the leader RTT exceeds ``rtt_ceiling_frac`` times it, for
    ``trip_after`` consecutive steps; ``recover_after`` clean steps
    recover (hysteresis both ways).

    **Adaptation** while any probe is DEGRADED (applied from the *next*
    step — detect, then react): switch to ``fallback_strategy`` (any
    :func:`repro.core.schedule.register_strategy` name, e.g. ``hier`` to
    concentrate WAN traffic on leaders), raise the sync period to
    ``degraded_sync_every``, and/or engage int8 WAN compression
    (``int8_wan`` — gradient bytes scaled by the options' ``int8_ratio``,
    the :mod:`repro.distributed.compression` wire format).

    **Pod-loss recovery pricing** (the HeartbeatMonitor -> checkpoint ->
    remesh chain): heartbeat cadence/multiplier, the periodic checkpoint
    cadence that bounds lost work, and restore/remesh cost constants fed
    to :func:`repro.runtime.failure.plan_recovery`.
    """

    rate_floor_frac: float = 0.5
    rtt_ceiling_frac: float = 2.0
    trip_after: int = 2
    recover_after: int = 2
    fallback_strategy: Optional[str] = None
    degraded_sync_every: Optional[int] = None
    int8_wan: bool = False
    heartbeat_interval_ms: float = 100.0
    heartbeat_detect_mult: int = 3
    checkpoint_every: int = 4
    restore_bandwidth_gbps: float = 10.0
    remesh_s: float = 30.0

    def __post_init__(self):
        if not 0.0 <= self.rate_floor_frac <= 1.0:
            raise ValueError("rate_floor_frac must be in [0, 1]")
        if self.rtt_ceiling_frac < 1.0:
            raise ValueError("rtt_ceiling_frac must be >= 1")
        if self.trip_after < 1 or self.recover_after < 1:
            raise ValueError("trip_after/recover_after must be >= 1")
        if self.degraded_sync_every is not None and self.degraded_sync_every < 1:
            raise ValueError("degraded_sync_every must be >= 1")
        if self.heartbeat_interval_ms <= 0:
            raise ValueError("heartbeat_interval_ms must be > 0")
        if self.heartbeat_detect_mult < 1:
            raise ValueError("heartbeat_detect_mult must be >= 1")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.restore_bandwidth_gbps <= 0:
            raise ValueError("restore_bandwidth_gbps must be > 0")
        if self.remesh_s < 0:
            raise ValueError("remesh_s must be >= 0")

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "DegradationPolicy":
        _reject_unknown_keys(cls, d)
        return cls(**d)


@dataclass(frozen=True)
class Scenario:
    """One complete, declarative experiment: topology + workload + options
    + events.  ``run_scenario(scenario)`` executes it; ``to_dict`` /
    ``from_dict`` round-trip through JSON losslessly (identity is pinned
    in ``tests/test_scenario.py``)."""

    name: str
    topology: TopologySpec = field(default_factory=TopologySpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    options: SyncOptions = field(default_factory=SyncOptions)
    events: Tuple[ScenarioEvent, ...] = ()
    description: str = ""
    #: gray-failure detection + graceful degradation; None (the default)
    #: keeps the runner's historical behavior byte-for-byte
    policy: Optional[DegradationPolicy] = None
    #: geo-serving co-load on the same fabric; None (the default) keeps
    #: the runner's costing path byte-for-byte
    serving: Optional[ServingSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if not self.name:
            raise ValueError("scenario name must be non-empty")

    @property
    def num_steps(self) -> int:
        """Steps the runner emulates: the workload's, extended to cover
        every event."""
        last_event = max((e.at_step for e in self.events), default=-1)
        return max(self.workload.steps, last_event + 1)

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "topology": self.topology.to_dict(),
            "workload": self.workload.to_dict(),
            "options": self.options.to_dict(),
            "events": [e.to_dict() for e in self.events],
            "description": self.description,
            "policy": None if self.policy is None else self.policy.to_dict(),
            "serving": None if self.serving is None else self.serving.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Scenario":
        _reject_unknown_keys(cls, d)
        policy = d.get("policy")
        serving = d.get("serving")
        return cls(
            name=d["name"],
            topology=TopologySpec.from_dict(d["topology"]),
            workload=WorkloadSpec.from_dict(d["workload"]),
            options=SyncOptions.from_dict(d["options"]),
            events=tuple(ScenarioEvent.from_dict(e) for e in d["events"]),
            description=d.get("description", ""),
            policy=None if policy is None else DegradationPolicy.from_dict(policy),
            serving=None if serving is None else ServingSpec.from_dict(serving),
        )
