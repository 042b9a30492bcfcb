"""Sweep/campaign engine: one base :class:`Scenario`, many variants, one table.

PR 5 made one study = one spec; this module makes *thousands* of studies =
one campaign (the ROADMAP's scenario-fleets item):

* :func:`apply_overrides` — expand dotted-field overrides
  (``{"workload.overlap_fraction": 0.5, "topology.wan_pairs": {...}}``)
  into a new :class:`Scenario`, replacing through the nested frozen
  dataclasses in one pass per level so co-dependent fields (``num_pods`` +
  ``wan_pairs``) validate together;
* :class:`Sweep` — a base scenario plus a list of override dicts;
  :meth:`Sweep.run` executes every variant (``run_scenario`` is
  embarrassingly parallel, so ``workers > 1`` fans out over a process
  pool) and joins the per-variant ``metrics()`` into a
  :class:`SweepResult` table.  Every variant is fully determined by its
  serialized spec — all randomness inside a run flows through the spec's
  seed — so the joined table is identical for any worker count;
* :func:`random_campaign` — Monte Carlo campaign generation: sampled
  topologies, per-DC-pair RTT/bandwidth draws (the asymmetric-WAN axis),
  WAN flap scripts and straggler mixes, all drawn from one seeded
  ``numpy`` Generator, returned as a plain :class:`Sweep` — a
  reproducible, serializable campaign artifact;
* :func:`fiber_latency_campaign` — the headline study: per-pair RTT x
  overlap fraction, reproducing the Papavasileiou-style
  overlap-benefit-vs-RTT curve ("Modeling the Impact of Fiber Latency on
  Compute-Communication Overlap", PAPERS.md) as one spec, gated in
  ``benchmarks/bench_sweeps.py``.

``SweepResult.to_dict()`` is the campaign's joined result table —
``benchmarks/compare.py`` reads its ``variants`` list exactly like a
suite's ``rows``, so campaign conclusions are regression-gated like
everything else.
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from __future__ import annotations

import dataclasses
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.wan import NetemProfile
from ..scenario.runner import run_scenario
from ..scenario.spec import (
    Scenario,
    ScenarioEvent,
    ServingSpec,
    SyncOptions,
    TopologySpec,
    WorkloadSpec,
)

__all__ = [
    "Sweep",
    "SweepResult",
    "SweepRow",
    "apply_overrides",
    "fiber_latency_campaign",
    "random_campaign",
    "run_sweep",
]

OverrideMap = Mapping[str, object]


@dataclass(frozen=True)
class _Leaf:
    """Marks an override *value* in the nested update tree (a value may
    itself be a dict — ``topology.wan_pairs`` — without being a subtree)."""

    value: object


def apply_overrides(scenario: Scenario, overrides: OverrideMap) -> Scenario:
    """Return ``scenario`` with dotted-field ``overrides`` applied.

    Paths name nested dataclass fields (``"workload.overlap_fraction"``,
    ``"topology.wan.delay_ms"``, ``"options.congestion"``, ``"events"``,
    ``"name"``).  Sibling overrides of one dataclass are applied in a
    single ``dataclasses.replace`` call, so ``topology.num_pods`` and
    ``topology.wan_pairs`` set together validate against each other, not
    against the base spec.
    """
    tree: Dict[str, object] = {}
    for path, value in overrides.items():
        parts = path.split(".")
        node = tree
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if isinstance(nxt, _Leaf):
                raise ValueError(f"override path {path!r} descends into leaf {p!r}")
            node = nxt
        if isinstance(node.get(parts[-1]), dict):
            raise ValueError(f"override path {path!r} conflicts with a deeper path")
        node[parts[-1]] = _Leaf(value)
    return _apply_tree(scenario, tree, "")


def _apply_tree(obj, tree: Dict[str, object], prefix: str):
    updates = {}
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, _Leaf):
            updates[key] = sub.value
        else:
            if not hasattr(obj, key):
                raise ValueError(f"no field {path!r} on {type(obj).__name__}")
            child = getattr(obj, key)
            if not dataclasses.is_dataclass(child):
                raise ValueError(
                    f"override path descends into non-spec field {path!r}"
                )
            updates[key] = _apply_tree(child, sub, f"{path}.")
    try:
        return dataclasses.replace(obj, **updates)
    except TypeError as e:
        raise ValueError(
            f"bad override field(s) {sorted(updates)} for "
            f"{type(obj).__name__}: {e}"
        ) from None


def _jsonify(value):
    """JSON-able record of an override value (specs, profiles, tuple keys)."""
    if isinstance(value, (NetemProfile, ScenarioEvent)):
        return dataclasses.asdict(value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.asdict(value)
    if isinstance(value, Mapping):
        return [[_jsonify(k), _jsonify(v)] for k, v in value.items()]
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


@dataclass(frozen=True)
class SweepRow:
    """One variant of the joined table: its name, what changed vs the base,
    and its deterministic ``ScenarioResult.metrics()``."""

    name: str
    overrides: Dict[str, object]
    metrics: Dict[str, float]

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "overrides": {k: _jsonify(v) for k, v in self.overrides.items()},
            "metrics": dict(self.metrics),
        }


@dataclass
class SweepResult:
    """The campaign's joined result table.

    ``to_dict()`` is the gateable artifact: ``benchmarks/compare.py``
    reads the ``variants`` list exactly like a suite's ``rows`` (one
    BenchRow-shaped entry per variant).
    """

    name: str
    base: Scenario
    rows: List[SweepRow]
    seed: Optional[int] = None  # set for random campaigns

    def metric(self, key: str) -> List[float]:
        """One metric as a per-variant column (missing entries -> nan)."""
        return [float(r.metrics.get(key, float("nan"))) for r in self.rows]

    def row(self, name: str) -> SweepRow:
        for r in self.rows:
            if r.name == name:
                return r
        raise KeyError(f"no variant {name!r} in sweep {self.name!r}")

    def to_dict(self) -> Dict[str, object]:
        return {
            "campaign": self.name,
            "base": self.base.to_dict(),
            "seed": self.seed,
            "variants": [r.to_dict() for r in self.rows],
        }


@dataclass(frozen=True)
class Sweep:
    """A base scenario and the override dicts that expand it into variants.

    ``overrides[i]`` may carry a ``"name"`` key; otherwise variant ``i``
    is named ``{base.name}#{i:03d}``.  The expansion is pure spec algebra
    (no fabric is built), so a Sweep is cheap to construct, serialize and
    inspect before committing to a run.
    """

    base: Scenario
    overrides: Tuple[OverrideMap, ...]
    name: str = ""
    seed: Optional[int] = None  # provenance for random campaigns

    def __post_init__(self):
        object.__setattr__(self, "overrides", tuple(self.overrides))
        if not self.name:
            object.__setattr__(self, "name", f"{self.base.name}_sweep")

    def variant_name(self, i: int) -> str:
        name = self.overrides[i].get("name")
        return str(name) if name else f"{self.base.name}#{i:03d}"

    def variants(self) -> List[Scenario]:
        """Expand every override dict into a concrete :class:`Scenario`."""
        out = []
        for i, ov in enumerate(self.overrides):
            ov = dict(ov)
            ov.setdefault("name", self.variant_name(i))
            out.append(apply_overrides(self.base, ov))
        return out

    def run(self, *, workers: int = 0) -> SweepResult:
        return run_sweep(self, workers=workers)


def _run_variant_payload(payload: Dict[str, object]) -> Dict[str, float]:
    """Process-pool work item: spec dict in, joined-table metrics out.

    Module-level (picklable) and fed the *serialized* spec, so parallel
    workers execute byte-identical inputs to the serial path.
    """
    return run_scenario(Scenario.from_dict(payload)).metrics()


def run_sweep(sweep: Sweep, *, workers: int = 0) -> SweepResult:
    """Execute every variant and join the per-variant metrics.

    ``workers > 1`` fans the variants out over a process pool
    (``run_scenario`` is embarrassingly parallel); results are joined in
    variant order and each variant's randomness is seeded by its own spec,
    so the table is identical for any worker count — pinned by
    ``tests/test_sweep.py`` and the ``bench_sweeps`` parallel-identity
    gate.
    """
    variants = sweep.variants()
    payloads = [v.to_dict() for v in variants]
    if workers > 1:
        with ProcessPoolExecutor(max_workers=workers) as pool:
            metrics = list(pool.map(_run_variant_payload, payloads))
    else:
        metrics = [_run_variant_payload(p) for p in payloads]
    rows = [
        SweepRow(
            name=v.name,
            overrides={k: v2 for k, v2 in ov.items() if k != "name"},
            metrics=m,
        )
        for v, ov, m in zip(variants, sweep.overrides, metrics)
    ]
    return SweepResult(name=sweep.name, base=sweep.base, rows=rows, seed=sweep.seed)


# -- the headline fiber-latency campaign --------------------------------------


def fiber_latency_campaign(
    rtt_ms: Sequence[float] = (2.0, 10.0, 30.0, 60.0),
    overlap_fractions: Sequence[float] = (0.0, 0.75),
    *,
    grad_bytes: int = 48_000_000,
    compute_seconds: float = 0.35,
    bandwidth_gbps: float = 0.8,
) -> Sweep:
    """Per-pair RTT x overlap fraction: the Papavasileiou-style study.

    Every variant pins the 2-DC pair's WAN profile to one sampled one-way
    ``delay_ms`` (= RTT/2 per netem interface pair, jitter-free) through
    ``topology.wan_pairs`` and sweeps the overlappable fraction of the
    compute window.  The overlap *benefit* — the fraction of the
    no-overlap step time that overlap recovers — decays as per-pair RTT
    grows past the compute window: propagation is exposed no matter when
    communication starts.  ``benchmarks/bench_sweeps.py`` gates exactly
    that monotone decay.
    """
    base = Scenario(
        name="fiber_latency",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, seed=11),
        workload=WorkloadSpec(
            strategy="allreduce",
            grad_bytes=grad_bytes,
            compute_seconds=compute_seconds,
            steps=1,
        ),
        options=SyncOptions(jitter=False),
        description=(
            "Fiber-latency campaign: overlap benefit vs per-DC-pair RTT "
            "(asymmetric-WAN axis), one spec per (rtt, overlap) point."
        ),
    )
    overrides = []
    for rtt in rtt_ms:
        profile = NetemProfile(
            delay_ms=rtt / 2.0, jitter_ms=0.0, bandwidth_gbps=bandwidth_gbps
        )
        for frac in overlap_fractions:
            overrides.append(
                {
                    "name": f"rtt{rtt:g}ms_f{int(frac * 100):02d}",
                    "topology.wan_pairs": {(1, 2): profile},
                    "workload.overlap_fraction": frac,
                }
            )
    return Sweep(base=base, overrides=tuple(overrides), name="fiber_latency_campaign")


def overlap_benefit_curve(result: SweepResult) -> List[Tuple[float, float]]:
    """Join a :func:`fiber_latency_campaign` result into the
    overlap-benefit-vs-RTT curve: ``(rtt_ms, benefit_frac)`` per swept
    RTT, where ``benefit_frac`` is the largest fraction of the no-overlap
    step time any swept overlap fraction recovers."""
    by_rtt: Dict[float, Dict[str, float]] = {}
    for row in result.rows:
        rtt_part, frac_part = row.name.rsplit("_f", 1)
        rtt = float(rtt_part[len("rtt"):-len("ms")])
        by_rtt.setdefault(rtt, {})[frac_part] = row.metrics["mean_step_seconds"]
    curve = []
    for rtt in sorted(by_rtt):
        steps = by_rtt[rtt]
        t0 = steps.pop("00")
        best = min(steps.values(), default=t0)
        curve.append((rtt, (t0 - best) / t0 if t0 > 0 else 0.0))
    return curve


# -- Monte Carlo campaign generation ------------------------------------------

def _campaign_base() -> Scenario:
    """Default base for :func:`random_campaign`: a 2-step contended
    geo-training workload every sampled axis perturbs."""
    return Scenario(
        name="campaign",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, seed=0),
        workload=WorkloadSpec(
            strategy="allreduce",
            grad_bytes=24_000_000,
            compute_seconds=1.0,
            overlap_fraction=0.5,
            steps=2,
        ),
        options=SyncOptions(jitter=False, congestion=True),
        description="Monte Carlo campaign over asymmetric WANs.",
    )


def random_campaign(
    seed: int,
    *,
    variants: int = 8,
    base: Optional[Scenario] = None,
    num_pods_choices: Sequence[int] = (2, 3),
    rtt_ms_range: Tuple[float, float] = (4.0, 60.0),
    bandwidth_gbps_range: Tuple[float, float] = (0.4, 2.0),
    flap_probability: float = 0.5,
    straggler_probability: float = 0.5,
    degrade_probability: float = 0.0,
    storm_probability: float = 0.0,
    serving_probability: float = 0.0,
) -> Sweep:
    """Sample a reproducible Monte Carlo campaign as a :class:`Sweep`.

    Every variant draws, from one ``numpy`` Generator seeded with
    ``seed`` (so the campaign — specs *and* results — is a deterministic
    artifact of the seed alone):

    * a topology (``num_pods`` from ``num_pods_choices``);
    * a full per-DC-pair asymmetric WAN: one RTT and bandwidth draw per
      inter-DC fiber bundle (``topology.wan_pairs``);
    * an overlap fraction and per-variant spec seed;
    * optionally a WAN flap script (fail + BFD recovery + restore of one
      sampled spine-pair link) and a straggler mix (sampled slowdown over
      a sampled step span);
    * with ``degrade_probability > 0``, a gray-failure brownout: one
      sampled DC pair quietly loses a sampled bandwidth fraction and
      gains latency (``degrade_pair`` — BFD never fires), restored one
      step later;
    * with ``storm_probability > 0``, a multi-pair flap storm: one
      sampled spine dies whole (``fail_switch`` — every incident link,
      WAN links to *all* peer DCs included, fails atomically through one
      shared detection window), then comes back;
    * with ``serving_probability > 0``, a geo-serving co-load: a sampled
      :class:`~repro.scenario.spec.ServingSpec` (population, per-user
      request rate, remote fraction, per-token KV bytes, its own seed)
      rides the training fabric, adding ``serving_*`` metrics to the row.

    Probability-gated axes draw nothing when their probability is 0, so
    campaigns generated before an axis existed replay byte-identically.
    """
    rng = np.random.default_rng(seed)
    base = base if base is not None else _campaign_base()
    overrides: List[Dict[str, object]] = []
    for i in range(variants):
        num_pods = int(rng.choice(np.asarray(num_pods_choices)))
        wan_pairs = {}
        for a in range(1, num_pods + 1):
            for b in range(a + 1, num_pods + 1):
                rtt = float(rng.uniform(*rtt_ms_range))
                bw = float(rng.uniform(*bandwidth_gbps_range))
                wan_pairs[(a, b)] = NetemProfile(
                    delay_ms=rtt / 2.0, jitter_ms=0.0, bandwidth_gbps=bw
                )
        events: List[ScenarioEvent] = []
        if float(rng.uniform()) < flap_probability:
            a = int(rng.integers(1, num_pods))  # a < b always exists
            b = int(rng.integers(a + 1, num_pods + 1))
            link = (f"d{a}s{int(rng.integers(1, 3))}", f"d{b}s{int(rng.integers(1, 3))}")
            at = int(rng.integers(0, base.workload.steps))
            events.append(ScenarioEvent(kind="fail_link", at_step=at, link=link))
            events.append(ScenarioEvent(kind="restore_link", at_step=at + 1, link=link))
        if float(rng.uniform()) < straggler_probability:
            events.append(
                ScenarioEvent(
                    kind="straggler",
                    at_step=int(rng.integers(0, base.workload.steps)),
                    slowdown=float(rng.uniform(1.5, 4.0)),
                    duration_steps=int(rng.integers(1, base.workload.steps + 1)),
                )
            )
        if degrade_probability > 0 and float(rng.uniform()) < degrade_probability:
            pairs = sorted(wan_pairs)
            pair = pairs[int(rng.integers(0, len(pairs)))]
            at = int(rng.integers(0, base.workload.steps))
            events.append(
                ScenarioEvent(
                    kind="degrade_pair",
                    at_step=at,
                    pair=pair,
                    bandwidth_fraction=float(rng.uniform(0.2, 0.8)),
                    extra_delay_ms=float(rng.uniform(0.0, 10.0)),
                )
            )
            events.append(
                ScenarioEvent(kind="restore_degradation", at_step=at + 1, pair=pair)
            )
        if storm_probability > 0 and float(rng.uniform()) < storm_probability:
            node = f"d{int(rng.integers(1, num_pods + 1))}s{int(rng.integers(1, 3))}"
            at = int(rng.integers(0, base.workload.steps))
            events.append(ScenarioEvent(kind="fail_switch", at_step=at, node=node))
            events.append(
                ScenarioEvent(kind="restore_switch", at_step=at + 1, node=node)
            )
        serving: Optional[ServingSpec] = None
        if serving_probability > 0 and float(rng.uniform()) < serving_probability:
            serving = ServingSpec(
                users=int(rng.integers(50_000, 500_001)),
                requests_per_user_step=float(rng.uniform(2e-6, 2e-5)),
                remote_fraction=float(rng.uniform(0.0, 0.5)),
                kv_bytes_per_token=int(rng.integers(8_192, 65_537)),
                mean_tokens=128,
                session_tokens=1024,
                seed=int(rng.integers(0, 2**31 - 1)),
            )
        overrides.append(
            {
                "name": f"mc{i:03d}_p{num_pods}",
                "topology.num_pods": num_pods,
                "topology.wan_pairs": wan_pairs,
                "topology.seed": int(rng.integers(0, 2**31 - 1)),
                "workload.overlap_fraction": float(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0])),
                "events": tuple(events),
                **({"serving": serving} if serving is not None else {}),
            }
        )
    return Sweep(
        base=base,
        overrides=tuple(overrides),
        name=f"random_campaign_s{seed}",
        seed=seed,
    )
