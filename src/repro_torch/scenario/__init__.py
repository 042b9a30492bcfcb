"""Declarative Scenario/Experiment API: one spec from topology to metrics.

The experiment surface of the reproduction, consolidated (ISSUE 5): a
:class:`Scenario` declares the emulated topology, the training workload,
the costing options (:class:`~repro.core.geo.SyncOptions`) and a timed
event script (link flaps, tenant churn, stragglers);
:func:`run_scenario` executes it into a :class:`ScenarioResult` with a
per-step timeline and ``SyncCost`` / ``RecoveryTimeline`` /
``EvpnResyncStats`` rollups, JSON-serializable and gate-able by
``benchmarks/compare.py``.  The named library (:mod:`.library`) ships the
paper's §5 studies, so a new study is a spec edit::

    from repro.scenario import get_scenario, run_scenario

    result = run_scenario(get_scenario("fig14_allreduce"))
    print(result.sync.wan_seconds, result.metrics())

The sweep/campaign engine (:mod:`.sweep`, ISSUE 6) scales one spec to a
fleet: a :class:`Sweep` expands dotted-field overrides into variants and
joins their metrics into one gateable table (optionally over a process
pool), and :func:`random_campaign` samples reproducible Monte Carlo
campaigns over asymmetric per-DC-pair WANs::

    from repro.scenario import fiber_latency_campaign

    table = fiber_latency_campaign().run(workers=4)
"""
# Port: the imports of ``repro.*`` modules are relative (``..*``), to the port's own copies; nothing else differs.

from ..core.geo import SyncOptions
from ..scenario.library import (
    get_scenario,
    register_scenario,
    scenario_names,
)
from ..scenario.runner import (
    PodRecovery,
    ScenarioResult,
    StepRecord,
    run_scenario,
)
from ..scenario.spec import (
    EVENT_KINDS,
    DegradationPolicy,
    Scenario,
    ScenarioEvent,
    ServingSpec,
    TopologySpec,
    WorkloadSpec,
    model_grad_bytes,
    model_kv_bytes,
)
from ..scenario.sweep import (
    Sweep,
    SweepResult,
    SweepRow,
    apply_overrides,
    fiber_latency_campaign,
    random_campaign,
    run_sweep,
)

__all__ = [
    "EVENT_KINDS",
    "DegradationPolicy",
    "PodRecovery",
    "Scenario",
    "ScenarioEvent",
    "ScenarioResult",
    "ServingSpec",
    "StepRecord",
    "Sweep",
    "SweepResult",
    "SweepRow",
    "SyncOptions",
    "TopologySpec",
    "WorkloadSpec",
    "apply_overrides",
    "fiber_latency_campaign",
    "get_scenario",
    "model_grad_bytes",
    "model_kv_bytes",
    "random_campaign",
    "register_scenario",
    "run_scenario",
    "run_sweep",
    "scenario_names",
]
