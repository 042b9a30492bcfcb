"""The port's runtime (GeoTrainer, monitors, WAN pricing) against the JAX
package's, on the CPU.

* ``repro_torch/core/*.py`` are verbatim copies of the JAX package's numpy
  cost model, held byte for byte; ``runtime/failure.py`` and
  ``straggler.py`` differ only in their one ``repro.core.bfd`` import.
* ``GeoFabric.sync_cost`` and the monitors: exact (the same numpy code).
* Cross-resume: a checkpoint one package's ``GeoTrainer`` wrote, resumed by
  the other on the CPU; the losses of the resumed steps at float32 2e-5
  (``test_torch_train.py::TOL``), ``wan_s_est`` exact.
"""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.core.geo import GeoFabric as JaxGeoFabric
from repro.core.geo import SyncOptions as JaxSyncOptions
from repro.launch.mesh import make_host_mesh
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import GeoTrainer as JaxGeoTrainer
from repro.runtime import HeartbeatMonitor as JaxHeartbeatMonitor
from repro.runtime import StragglerMonitor as JaxStragglerMonitor
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro.runtime import optimal_checkpoint_interval as jax_young_daly
from repro.runtime import plan_recovery as jax_plan_recovery
from repro_torch.configs import get_smoke_config
from repro_torch.core import GeoFabric, SyncOptions
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (
    GeoTrainer,
    HeartbeatMonitor,
    StragglerMonitor,
    TrainerConfig,
    optimal_checkpoint_interval,
    plan_recovery,
)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
CORE = ("fabric", "evpn", "bfd", "ports", "flows", "metrics", "tenancy", "congestion", "wan", "schedule", "geo")
STRATEGIES = ("allreduce", "ps", "hier", "hier_int8", "local_sgd")
TOL = 2e-5  # float32, test_torch_train.py::TOL
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
# distilgpt2-82m at full width: 81,126,144 float32 parameters
FULL_GRAD_BYTES = 324_504_576


@pytest.mark.parametrize("name", CORE)
def test_core_copy_is_byte_identical(name):
    port = (ROOT / "src/repro_torch/core" / f"{name}.py").read_bytes()
    assert port == (ROOT / "src/repro/core" / f"{name}.py").read_bytes()


@pytest.mark.parametrize("name", ["failure", "straggler"])
def test_monitor_copy_differs_only_in_its_import(name):
    port = (ROOT / "src/repro_torch/runtime" / f"{name}.py").read_text()
    ref = (ROOT / "src/repro/runtime" / f"{name}.py").read_text()
    assert port == ref.replace("from repro.core.bfd import", "from ..core.bfd import")


def _smoke_grad_bytes():
    return sum(t.numel() * 4 for t in tree_leaves(init_params(get_smoke_config("distilgpt2-82m"), device="meta")))


@pytest.mark.parametrize("grad_bytes", ["smoke", FULL_GRAD_BYTES])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sync_cost_matches_jax(strategy, grad_bytes):
    nbytes = _smoke_grad_bytes() if grad_bytes == "smoke" else grad_bytes
    port = GeoFabric(num_pods=2).sync_cost(strategy, nbytes, options=SyncOptions(jitter=False))
    ref = JaxGeoFabric(num_pods=2).sync_cost(strategy, nbytes, options=JaxSyncOptions(jitter=False))
    assert port.amortized_seconds == ref.amortized_seconds
    assert [(p.name, p.duration_s) for p in port.phases] == [(p.name, p.duration_s) for p in ref.phases]


def test_full_width_sync_costs_are_the_documented_ones():
    want = {"allreduce": 3.67299648, "ps": 4.88988864, "hier": 1.23921216,
            "hier_int8": 0.32654304, "local_sgd": 0.15490152}
    geo = GeoFabric(num_pods=2)
    got = {s: geo.sync_cost(s, FULL_GRAD_BYTES, options=SyncOptions(jitter=False)).amortized_seconds
           for s in want}
    assert got == pytest.approx(want, rel=1e-12)


def _script(mon_cls):
    """A scripted heartbeat sequence: pod1 falls silent, pod2 stutters."""
    mon = mon_cls(["pod0", "pod1", "pod2"], interval_ms=10, detect_mult=3)
    trace = []
    for t in range(1, 12):
        now = 10.0 * t
        mon.heartbeat("pod0", now)
        if t < 4:
            mon.heartbeat("pod1", now)
        if t % 2:
            mon.heartbeat("pod2", now)
        dead = mon.poll(now + 1.0)
        trace.append((dead, {w: h.state.value for w, h in mon.workers.items()}, mon.alive()))
    return trace, mon.detect_time_ms()


def test_heartbeat_monitor_matches_jax():
    port, ref = _script(HeartbeatMonitor), _script(JaxHeartbeatMonitor)
    assert port == ref
    assert any("pod1" in dead for dead, _, _ in port[0])


def test_recovery_plan_and_young_daly_match_jax():
    for step, last, dt in ((100, 90, 2.0), (7, 4, 0.125), (3, 8, 0.5)):
        kw = dict(step=step, last_checkpoint_step=last, step_time_s=dt, detect_time_ms=300.0,
                  checkpoint_bytes=3 * FULL_GRAD_BYTES)
        assert dataclasses.asdict(plan_recovery(**kw)) == dataclasses.asdict(jax_plan_recovery(**kw))
    for dt, save, mtbf in ((2.0, 10.0, 3600.0), (0.125, 0.3245, 21600.0), (1e-4, 0.05, 60.0)):
        kw = dict(step_time_s=dt, save_overhead_s=save, mtbf_s=mtbf)
        assert optimal_checkpoint_interval(**kw) == jax_young_daly(**kw)


def test_straggler_monitor_matches_jax():
    out = []
    for cls in (StragglerMonitor, JaxStragglerMonitor):
        mon = cls(["a", "b", "c"], min_samples=3)
        rows = []
        for i in range(30):
            mon.record("a", 1.0)
            mon.record("b", 1.05 + 0.01 * (i % 3))
            mon.record("c", 1.8 if i < 10 else 30.0)
            rows.append(([dataclasses.asdict(r) for r in mon.reports()], mon.sync_efficiency(),
                         mon.critical_path_s(), mon.median_ewma()))
        out.append(rows)
    assert out[0] == out[1]
    assert any(r["action"] == "exclude" for r in out[0][-1][0])


# -- GeoTrainer ----------------------------------------------------------------------


def _jax_trainer(ckpt, steps):
    tc = JaxTrainerConfig(seq_len=32, global_batch=4, steps=steps, strategy="allreduce",
                          checkpoint_every=4, log_every=100, opt=JaxAdamWConfig(**OPT))
    return JaxGeoTrainer(jax_smoke("distilgpt2-82m"), make_host_mesh(), trainer_cfg=tc, checkpoint_dir=str(ckpt))


def _port_trainer(ckpt, steps):
    tc = TrainerConfig(seq_len=32, global_batch=4, steps=steps, strategy="allreduce",
                       checkpoint_every=4, log_every=100, opt=AdamWConfig(**OPT))
    return GeoTrainer(get_smoke_config("distilgpt2-82m"), trainer_cfg=tc, checkpoint_dir=str(ckpt), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_resume(tmp_path, writer):
    """One package trains steps 0-3 and checkpoints step 4; each package
    resumes from its own copy of that directory for steps 4-7.  The two
    resumed runs give the same losses."""
    make = {"jax": _jax_trainer, "port": _port_trainer}
    first = make[writer](tmp_path / "first", 4).run()
    assert first["last_checkpoint"] == 4 and [r["step"] for r in first["metrics"]] == [0, 1, 2, 3]
    results = {}
    for side in ("jax", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / side)
        results[side] = make[side](tmp_path / side, 8).run()
    jax_rows, port_rows = results["jax"]["metrics"], results["port"]["metrics"]
    assert [r["step"] for r in port_rows] == [r["step"] for r in jax_rows] == [4, 5, 6, 7]
    np.testing.assert_allclose([r["loss"] for r in port_rows], [r["loss"] for r in jax_rows], rtol=TOL, atol=TOL)
    assert [r["wan_s_est"] for r in port_rows] == [r["wan_s_est"] for r in jax_rows]
    assert results["port"]["wan_phases"] == results["jax"]["wan_phases"]
    assert results["port"]["last_checkpoint"] == results["jax"]["last_checkpoint"] == 8


def test_port_trainer_resumes_where_it_stopped(tmp_path):
    """8 uninterrupted steps against 4 steps, a new trainer, and 4 more: the
    same losses, bit for bit (the CPU path is deterministic)."""
    whole = _port_trainer(tmp_path / "whole", 8).run()
    _port_trainer(tmp_path / "split", 4).run()
    rest = _port_trainer(tmp_path / "split", 8).run()
    assert [r["loss"] for r in rest["metrics"]] == [r["loss"] for r in whole["metrics"][4:]]
    losses = [r["loss"] for r in whole["metrics"]]
    assert losses[-1] < losses[0]


def test_failure_drill(tmp_path):
    """tests/test_runtime.py::TestGeoTrainerEndToEnd::test_failure_drill on the port."""
    tc = TrainerConfig(seq_len=32, global_batch=4, steps=6, strategy="allreduce",
                       checkpoint_every=2, log_every=100)
    trainer = GeoTrainer(get_smoke_config("distilgpt2-82m"), trainer_cfg=tc, checkpoint_dir=str(tmp_path),
                         device="cpu")
    # pretend there are 2 pods for the monitor
    trainer.heartbeats = HeartbeatMonitor(["pod0", "pod1"], interval_ms=10)
    trainer.stragglers = StragglerMonitor(["pod0", "pod1"])
    result = trainer.run(inject_failure_at=3)
    assert result["recovery_drills"], "failure injection should trigger a drill"
    drill = result["recovery_drills"][0]
    assert "pod1" in drill["dead"]
    assert drill["plan"]["lost_steps"] >= 0


def test_two_pod_drill_declares_pod1_dead_after_detect_mult_steps(tmp_path):
    tc = TrainerConfig(seq_len=32, global_batch=4, steps=5, strategy="hier_int8", npods=2,
                       checkpoint_every=2, log_every=100)
    trainer = GeoTrainer(get_smoke_config("distilgpt2-82m"), trainer_cfg=tc, checkpoint_dir=str(tmp_path),
                         device="cpu")
    result = trainer.run(inject_failure_at=1)
    detect_mult = trainer.heartbeats.workers["pod1"].session.detect_mult
    assert [(d["step"], d["dead"]) for d in result["recovery_drills"]] == [(detect_mult, ["pod1"])]
    plan = result["recovery_drills"][0]["plan"]
    assert plan["lost_steps"] == detect_mult - 2  # last checkpoint at step 2
    assert plan["restore_s"] == pytest.approx(trainer.grad_bytes * 3 * 8 / 10e9)
    assert trainer.heartbeats.alive() == ["pod0"]
    assert set(result) == {"final_loss", "metrics", "recovery_drills", "sync_efficiency",
                           "last_checkpoint", "wan_phases", "scenario_recoveries", "scenario_evpn_resyncs"}


def test_trainer_prices_one_pod_as_two_dcs(tmp_path):
    """npods == 1 stands for a mesh without a pod axis, which the JAX
    trainer prices on a 2-DC fabric."""
    trainer = _port_trainer(tmp_path, 1)
    assert trainer.geo.num_pods == 2 and list(trainer.heartbeats.workers) == ["pod0"]
    assert trainer.grad_bytes == _smoke_grad_bytes()
