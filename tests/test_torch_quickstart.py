"""The port's ``examples/quickstart.py`` on the CPU, against the JAX package's functions.

``python -m repro_torch.examples.quickstart --device cpu`` runs once, in a
fresh checkpoint directory, for its whole 20 steps.  Its fabric RTTs, its
port lists and every strategy's modelled milliseconds and WAN megabytes
must equal what the JAX package's ``run_scenario``, ``allocate_ports`` and
``params_specs`` give for the same spec, computed here directly (the JAX
script itself writes a fixed checkpoint directory); those parts are numpy
on both sides, so they are held bit for bit.  Its losses are finite and
fall.
"""

from __future__ import annotations

import contextlib
import io

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.core import allocate_ports as jax_allocate_ports
from repro.core import make_correlated_queue_pairs as jax_queue_pairs
from repro.core import strategy_names as jax_strategy_names
from repro.launch.shapes import params_specs as jax_params_specs
from repro.scenario import Scenario, SyncOptions, TopologySpec, WorkloadSpec, run_scenario
from repro_torch.examples import quickstart


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = quickstart.main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("quickstart")
    return _run(["--device", "cpu", "--checkpoint-dir", str(ckpt)]) + (ckpt,)


@pytest.fixture(scope="module")
def jax_side():
    """What the JAX script computes for parts 1-3, in its order, on its spec."""
    spec = Scenario(
        name="quickstart",
        topology=TopologySpec(num_pods=2, workers_per_pod=2, seed=0),
        workload=WorkloadSpec(strategy="allreduce", grad_bytes=0, steps=20),
        options=SyncOptions(jitter=False, congestion=True),
    )
    geo = spec.topology.build()
    rtt = geo.rtt_ms(count=20)
    qps = jax_queue_pairs(8, base_number=1234)
    ports = {s: jax_allocate_ports(qps, scheme=s) for s in ("baseline", "qp_aware")}
    grad_bytes = sum(s.size * 4 for s in jax.tree.leaves(jax_params_specs(jax_smoke("distilgpt2-82m"))))
    costs = {}
    for strategy in jax_strategy_names():
        edit = WorkloadSpec(strategy=strategy, grad_bytes=grad_bytes, steps=1)
        costs[strategy] = run_scenario(Scenario(name=spec.name, topology=spec.topology, workload=edit,
                                                options=spec.options), geo=geo).sync
    return {"rtt": rtt, "ports": ports, "grad_bytes": grad_bytes, "costs": costs}


def test_fabric_rtt_equals_jax(run, jax_side):
    result, out, _ = run
    np.testing.assert_array_equal(result["rtt_ms"], jax_side["rtt"])
    assert f"inter-DC RTT {jax_side['rtt'].mean():.1f} ms" in out


def test_ports_equal_jax(run, jax_side):
    result, out, _ = run
    assert result["ports"] == jax_side["ports"]
    assert len(set(result["ports"]["qp_aware"])) == 8
    assert f"[ports] Algorithm 1: {sorted(jax_side['ports']['qp_aware'])}" in out


def test_every_strategy_costs_what_jax_gives(run, jax_side):
    result, out, _ = run
    assert result["grad_bytes"] == jax_side["grad_bytes"] == quickstart.smoke_grad_bytes()
    assert list(result["costs"]) == list(jax_side["costs"])
    for strategy, want in jax_side["costs"].items():
        got = result["costs"][strategy]
        assert got.amortized_seconds == want.amortized_seconds, strategy
        assert got.wan_bytes == want.wan_bytes, strategy
        assert [(p.name, p.duration_s) for p in got.phases] == [(p.name, p.duration_s) for p in want.phases]
        assert (f"{strategy:14s} {want.amortized_seconds * 1e3:8.1f} ms/step "
                f"({want.wan_bytes / 1e6:6.1f} MB on WAN links)") in out


def test_trains_the_specs_20_steps_and_the_loss_falls(run):
    result, out, _ = run
    losses = result["losses"]
    assert len(losses) == quickstart.QUICKSTART.workload.steps == 20
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert result["result"]["last_checkpoint"] == 20
    assert f"[train] loss {losses[0]:.3f} -> {losses[-1]:.3f} over 20 steps" in out


def test_a_second_run_restores_the_finished_checkpoint(run):
    _, _, ckpt = run
    result, out = _run(["--device", "cpu", "--checkpoint-dir", str(ckpt)])
    assert result["losses"] == [] and "nothing to do: restored checkpoint already at step 20" in out
