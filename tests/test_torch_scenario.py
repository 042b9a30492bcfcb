"""The port's scenario path against the JAX package's, on the CPU.

``repro_torch.scenario`` and ``repro_torch.serving`` are copies of the JAX
package's numpy-only modules: each differs from its original only in its
import lines (relative, to the port's own copies), a one-line ``# Port:``
note, and the bodies of ``model_grad_bytes`` / ``model_kv_bytes``, which
size the port's trees on the meta device.  Every library scenario, a sweep
and the serving trace give equal results in both packages; the trainer's
scenario path gives the JAX trainer's rollups; ``request_batch`` and a
traced request's prefill hold to the JAX package's.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenario as jsc
from repro import serving as jsv
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.mesh import make_host_mesh
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import GeoTrainer as JaxGeoTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch import scenario as tsc
from repro_torch import serving as tsv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import prefill
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import ElasticCoordinator, GeoTrainer, MeshPlan, TrainerConfig, plan_remesh, reshard_tree

ROOT = Path(__file__).resolve().parents[1]
COPIES = (
    "core/slaprobe.py",
    "scenario/__init__.py",
    "scenario/library.py",
    "scenario/runner.py",
    "scenario/spec.py",
    "scenario/sweep.py",
    "serving/__init__.py",
    "serving/engine.py",
    "serving/router.py",
    "serving/traffic.py",
)
VERBATIM = ("core/slaprobe.py",)
# functions whose bodies the port rewrites (signatures kept)
REWRITTEN = {"scenario/spec.py": ("model_grad_bytes", "model_kv_bytes")}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
SERVE_TOL = 1e-4  # float32 prefill logits: test_torch_serve.py::TOL["float32"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"), env.get("PYTHONPATH")]))
    return env


def _relative_imports(text: str) -> str:
    """``from repro.x import`` -> ``from ..x import`` on import statements
    only (docstrings and comments stay as they are)."""
    lines = text.splitlines(keepends=True)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").startswith("repro."):
            lines[node.lineno - 1] = lines[node.lineno - 1].replace("from repro.", "from ..", 1)
    return "".join(lines)


def _without_bodies(text: str, names) -> str:
    lines = text.splitlines(keepends=True)
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            for i in range(node.body[0].lineno - 1, node.end_lineno):
                lines[i] = ""
    return "".join(lines)


@pytest.mark.parametrize("name", COPIES)
def test_copy_differs_only_in_imports_and_named_bodies(name):
    port = (ROOT / "src/repro_torch" / name).read_text()
    ref = (ROOT / "src/repro" / name).read_text()
    if name in VERBATIM:
        assert port == ref
        return
    lines = port.splitlines(keepends=True)
    notes = [ln for ln in lines if ln.startswith("# Port: ")]
    assert len(notes) == 1, f"{name}: one '# Port:' line says what the port changed"
    port = "".join(ln for ln in lines if not ln.startswith("# Port: "))
    names = REWRITTEN.get(name, ())
    assert _without_bodies(port, names) == _without_bodies(_relative_imports(ref), names)


@pytest.mark.parametrize("name", jsc.scenario_names())
def test_library_scenario_runs_equal(name):
    assert tsc.scenario_names() == jsc.scenario_names()
    assert tsc.run_scenario(tsc.get_scenario(name)).to_dict() == jsc.run_scenario(jsc.get_scenario(name)).to_dict()


@pytest.mark.parametrize("name", jsc.scenario_names())
def test_scenario_dict_round_trips_across_packages(name):
    ref = jsc.get_scenario(name).to_dict()
    port = tsc.Scenario.from_dict(json.loads(json.dumps(ref)))
    assert port == tsc.get_scenario(name)
    assert port.to_dict() == ref
    assert jsc.Scenario.from_dict(port.to_dict()) == jsc.get_scenario(name)


def test_two_variant_sweep_gives_the_same_rows():
    """The port's sweep over a process pool (in a fresh interpreter: its
    workers import the simulator and no torch) against the JAX package's,
    run serially."""
    code = (
        "import json, sys\n"
        "from repro_torch.scenario import fiber_latency_campaign, run_sweep\n"
        "sweep = fiber_latency_campaign(rtt_ms=(2.0,), overlap_fractions=(0.0, 0.75))\n"
        "rows = [r.to_dict() for r in run_sweep(sweep, workers=2).rows]\n"
        "assert 'torch' not in sys.modules\n"
        "print(json.dumps(rows))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    ref = jsc.run_sweep(jsc.fiber_latency_campaign(rtt_ms=(2.0,), overlap_fractions=(0.0, 0.75)))
    assert len(ref.rows) == 2
    assert json.loads(out.stdout) == json.loads(json.dumps([r.to_dict() for r in ref.rows]))


def test_serving_trace_and_steps_equal():
    spec = jsc.get_scenario("serving_under_flap")
    pspec = tsc.get_scenario("serving_under_flap")
    args = (spec.topology.num_pods, spec.workload.steps)
    ref_trace = jsv.generate_trace(spec.serving, *args)
    port_trace = tsv.generate_trace(pspec.serving, *args)
    assert [[vars(r) for r in step] for step in port_trace] == [[vars(r) for r in step] for step in ref_trace]
    ref_steps = jsc.run_scenario(spec).serving_steps
    port_steps = tsc.run_scenario(pspec).serving_steps
    assert [vars(s) for s in port_steps] == [vars(s) for s in ref_steps]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pins_the_jax_serving_metrics():
    """``chip_smoke.py`` holds the card run's ``serving_under_flap`` metrics
    to constants; they are the JAX package's values, and its peak step's
    first eight requests are the prompt lengths it prefills."""
    smoke = _chip_smoke()
    result = jsc.run_scenario(jsc.get_scenario("serving_under_flap"))
    metrics = result.metrics()
    assert {k: metrics[k] for k in smoke.SERVING_UNDER_FLAP} == smoke.SERVING_UNDER_FLAP
    peak = max(result.serving_steps, key=lambda s: s.requests)
    spec = jsc.get_scenario("serving_under_flap")
    trace = jsv.generate_trace(spec.serving, spec.topology.num_pods, spec.workload.steps)
    assert (peak.step, [r.tokens for r in trace[peak.step][:8]]) == (smoke.PEAK_STEP, list(smoke.PEAK_TOKENS))


def test_elastic_plans_equal_jax():
    from repro.runtime.elastic import ElasticCoordinator as JaxCoordinator
    from repro.runtime.elastic import plan_remesh as jax_plan_remesh

    for cur, alive in ((2, 1), (4, 3), (3, 4)):
        assert plan_remesh(cur, alive, data=2, model=1).to_dict() == jax_plan_remesh(cur, alive, data=2, model=1).to_dict()
    port, ref = ElasticCoordinator(["a", "b", "c"], data=4, model=2), JaxCoordinator(["a", "b", "c"], data=4, model=2)
    for side in (port, ref):
        side.on_pod_lost("b", 3)
        side.on_pod_joined("d", 5)
        side.on_pod_lost("a", 7)
    assert [(e.step, e.kind, e.pod, e.plan.to_dict()) for e in port.events] == [
        (e.step, e.kind, e.pod, e.plan.to_dict()) for e in ref.events
    ]
    with pytest.raises(ValueError, match="no survivors"):
        plan_remesh(1, 0, data=1, model=1)
    for call in (lambda: MeshPlan((1,), ("data",), 1, "").build(), lambda: reshard_tree({}, None)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 16"):
            call()


# -- request_batch and a traced request's prefill -----------------------------


@pytest.mark.parametrize("arch", ["distilgpt2-82m", "phi-3-vision-4.2b", "musicgen-large"])
def test_request_batch_matches_jax_layout_and_is_deterministic(arch):
    req = tsv.Request(rid=7, step=0, home_dc=1, user=3, tokens=40)
    jreq = jsv.Request(rid=7, step=0, home_dc=1, user=3, tokens=40)
    cfg = get_smoke_config(arch)
    port = tsv.request_batch(cfg, req, device="cpu")
    ref = jsv.request_batch(jax_smoke(arch), jreq)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in port.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()
    }
    again = tsv.request_batch(cfg, req, device="cpu")
    assert all(torch.equal(port[k], again[k]) for k in port)
    other = tsv.request_batch(cfg, tsv.Request(rid=8, step=0, home_dc=1, user=3, tokens=40), device="cpu")
    assert not all(torch.equal(port[k], other[k]) for k in port)


def test_request_batch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the refusal without one")
    req = tsv.Request(rid=0, step=0, home_dc=1, user=0, tokens=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tsv.request_batch(get_smoke_config("distilgpt2-82m"), req)


def test_traced_request_prefill_matches_jax():
    """The peak step's first request of ``serving_under_flap`` (102 tokens),
    materialised by the JAX package, prefilled by both packages from the
    same (converted) weights: test_torch_serve.py's float32 tolerance."""
    spec = jsc.get_scenario("serving_under_flap")
    trace = jsv.generate_trace(spec.serving, spec.topology.num_pods, spec.workload.steps)
    req = trace[13][0]
    jcfg = jax_smoke("distilgpt2-82m")
    cfg = get_smoke_config("distilgpt2-82m")
    batch = jsv.request_batch(jcfg, req)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jlogits, _ = jax.jit(lambda p, b: jax_prefill(p, b, jcfg, max_len=req.tokens + 8))(jparams, batch)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tlogits, _ = prefill(tparams, tbatch, cfg, max_len=req.tokens + 8)
    assert tuple(tlogits.shape) == (1, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.float().numpy(), np.asarray(jlogits.astype(jnp.float32)),
                               rtol=SERVE_TOL, atol=SERVE_TOL)


# -- the trainer's scenario path ----------------------------------------------


def _drill_spec(mod):
    return mod.Scenario(
        name="drill",
        workload=mod.WorkloadSpec(strategy="hier", steps=3),
        options=mod.SyncOptions(jitter=False),
        events=(
            mod.ScenarioEvent(kind="fail_link", at_step=1, link=("d1s1", "d2s1")),
            mod.ScenarioEvent(kind="restore_link", at_step=2, link=("d1s1", "d2s1")),
        ),
    )


def _port_trainer(ckpt, scenario=None, **tc):
    tc = dict(dict(seq_len=32, global_batch=4, steps=100, log_every=100, opt=AdamWConfig(**OPT)), **tc)
    return GeoTrainer(get_smoke_config("distilgpt2-82m"), trainer_cfg=TrainerConfig(**tc),
                      checkpoint_dir=str(ckpt), scenario=scenario, device="cpu")


def test_trainer_honors_spec_and_replays_events(tmp_path):
    """tests/test_scenario.py::TestTrainerScenario on the port: the spec
    beats the TrainerConfig, its event script fires at step boundaries, and
    the events touch only the modelled fabric: the losses equal a run
    without the scenario."""
    trainer = _port_trainer(tmp_path / "scenario", _drill_spec(tsc))
    assert trainer.tc.steps == 3  # spec beats the TrainerConfig default
    assert trainer.tc.strategy == "hier"
    result = trainer.run()
    assert len(result["metrics"]) == 3
    assert len(result["scenario_recoveries"]) == 1
    assert result["scenario_recoveries"][0]["mechanism"] == "bfd"
    assert result["scenario_evpn_resyncs"] == 2  # fail + restore
    assert trainer.geo.fabric.link_up("d1s1", "d2s1")  # the flapped link healed
    assert [(e["step"], e["kind"]) for e in trainer.event_s] == [(1, "fail_link"), (2, "restore_link")]
    plain = _port_trainer(tmp_path / "plain", strategy="hier", steps=3).run()
    assert [r["loss"] for r in result["metrics"]] == [r["loss"] for r in plain["metrics"]]
    assert plain["scenario_recoveries"] == [] and plain["scenario_evpn_resyncs"] == 0


def test_trainer_scenario_rollups_equal_jax(tmp_path):
    """The rollups of the event script and the sync's price; the losses are
    not compared here (each package draws its own weights: the losses of the
    two trainers are held to each other from one checkpoint in
    test_torch_runtime.py::test_cross_resume)."""
    port = _port_trainer(tmp_path / "port", _drill_spec(tsc)).run()
    jtc = JaxTrainerConfig(seq_len=32, global_batch=4, steps=100, log_every=100, opt=JaxAdamWConfig(**OPT))
    ref = JaxGeoTrainer(jax_smoke("distilgpt2-82m"), make_host_mesh(), trainer_cfg=jtc,
                        checkpoint_dir=str(tmp_path / "jax"), scenario=_drill_spec(jsc)).run()
    for key in ("scenario_recoveries", "scenario_evpn_resyncs", "wan_phases"):
        assert port[key] == ref[key], key
    assert [r["wan_s_est"] for r in port["metrics"]] == [r["wan_s_est"] for r in ref["metrics"]]


def test_trainer_refuses_scenario_with_geo(tmp_path):
    from repro_torch.core import GeoFabric

    with pytest.raises(ValueError, match="not both"):
        GeoTrainer(get_smoke_config("distilgpt2-82m"), trainer_cfg=TrainerConfig(), checkpoint_dir=str(tmp_path),
                   geo=GeoFabric(num_pods=2), scenario=_drill_spec(tsc), device="cpu")


# -- the two examples ------------------------------------------------------------


def test_train_geo_example_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_geo", "--device", "cpu", "--steps", "4"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "\nloss: " in out.stdout
    assert "WAN sync estimate [hier]: " in out.stdout and "(fabric: 2 DCs," in out.stdout
    assert "last checkpoint: step 4" in out.stdout


def test_serve_geo_example_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_geo", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("=== serving_under_flap: ")
    assert "123 requests, p99 1074 ms, 4.9% SLO misses, 23 sessions migrated (434 MB of KV over the WAN)" in out.stdout
    assert "materializing request rid=108 (102 tokens, home DC 1) as a model batch:" in out.stdout
    assert out.stdout.rstrip().endswith("prefill logits: (1, 256)")


def test_examples_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the refusal without one")
    from repro_torch.examples import serve_geo, train_geo

    for main in (train_geo.main, serve_geo.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--steps", "1"] if main is train_geo.main else [])
