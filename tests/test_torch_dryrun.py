"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX one, on the CPU.

* ``model_flops`` equals the JAX dry run's for every assigned arch x shape;
* a ``decode_32k`` cell's ``argument_bytes`` equal the JAX dry run's
  ``memory_analysis().argument_size_in_bytes`` to the byte, for the smoke
  configs of olmo-1b, mixtral-8x22b and recurrentgemma-9b on a ``(data 4,
  model 2)`` mesh (JAX on 8 forced host devices, the port on a fake group
  of 8);
* a rank's FLOPs are its own, not the global program's: four ranks' counts
  add up to the one-process count, plus, with the sequence whole on every
  rank, what the dense FFN's sharding rule makes every ``model`` rank
  compute whole (its up-projection: the stacked ``[L, D, F]`` leaf keeps
  L on ``model``, and the FSDP gather replicates it; under sequence
  parallelism that FFN runs on the rank's own positions);
* a prefill on a ``(data 2, model 2)`` group shards the residual's
  sequence over ``model``, as the JAX dry run lowers it: every residual
  the model places holds half the local bytes of the prefill without the
  context, and a prefill record has no ``prefill_sequence`` key;
* a multi-pod train cell's cross-pod bytes equal the WAN bytes the step's
  own pod group counts (``sync.group_wan_bytes`` of ``hier``), and its
  metrics' gathers;
* collectives count their result bytes, as ``hlo_stats.parse_collectives``
  counts HLO results;
* every kernel op's fake outputs have the shapes and dtypes of the plain
  version's, and its FLOP formula is ``kernels/costs.py``'s;
* ``costs.py`` gives PERF.md's ``bound_ms`` at the table's shapes;
* the CLI writes an ``ok`` record.

The JAX dry run sets ``XLA_FLAGS`` when it is imported (512 host devices),
so it runs only in subprocesses here; the fake process groups are this
process's and are destroyed after each test.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke_config
from repro_torch.device import has_values
from repro_torch.kernels import LAUNCHES, card_routes, costs
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.rglru_scan import CHUNK, rglru_scan_bwd, rglru_scan_fwd
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_bwd, wkv6_bwd_ref, wkv6_ref
from repro_torch.kernels.wan_quant import wan_dequant, wan_quant
from repro_torch.launch import dryrun
from repro_torch.launch.collectives import CollectiveStats, record, tensor_bytes
from repro_torch.launch.counting import DeviceCounter
from repro_torch.launch.mesh import AXES, intra_pod_mesh, make_mesh
from repro_torch.launch.shapes import SHAPES, token_specs
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
DECODE_ARCHS = ("olmo-1b", "mixtral-8x22b", "recurrentgemma-9b")


def _jax(script: str, *args: str, devices: int = 1) -> dict:
    """Run ``script`` in a JAX subprocess; its last line of stdout is JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script), *args], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def fake_world():
    """``start(n)``: a fake process group of n ranks, destroyed after the test."""
    def start(world: int):
        dryrun._start_fake_world(world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, axes):
    mesh = make_mesh(shape, axes, device=dryrun.TRACE_DEVICE)
    intra_pod_mesh(mesh)
    return mesh


# -- model FLOPs and argument bytes against the JAX dry run ------------------------


@pytest.fixture(scope="module")
def jax_model_flops():
    return _jax("""
        import json
        from repro.configs import ASSIGNED_ARCHS, get_config
        from repro.launch.dryrun import model_flops
        from repro.launch.shapes import SHAPES
        print(json.dumps({a: {s: model_flops(get_config(a), s) for s in SHAPES} for a in ASSIGNED_ARCHS}))
    """)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_model_flops_match_jax(jax_model_flops, arch, shape):
    assert dryrun.model_flops(get_config(arch), shape) == jax_model_flops[arch][shape]


@pytest.fixture(scope="module")
def jax_decode_arguments():
    return _jax("""
        import json, sys
        import numpy as np
        import jax
        from jax.sharding import Mesh
        from repro.configs import get_smoke_config
        from repro.launch.dryrun import _lower_decode  # sets XLA_FLAGS: 512 devices, of which 8 are used
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
        out = {}
        for arch in sys.argv[1:]:
            with mesh:
                mem = _lower_decode(get_smoke_config(arch), mesh, "decode_32k").compile().memory_analysis()
            out[arch] = mem.argument_size_in_bytes
        print(json.dumps(out))
    """, *DECODE_ARCHS, devices=8)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_argument_bytes_match_jax(jax_decode_arguments, fake_world, arch):
    fake_world(8)
    main = dryrun.trace_cell(get_smoke_config(arch), _mesh((4, 2), ("data", "model")), "decode_32k")
    assert main["memory"]["argument_bytes"] == jax_decode_arguments[arch] > 0
    # decode writes its cache in place: those outputs are the inputs' storage
    assert 0 < main["memory"]["alias_bytes"] <= main["memory"]["output_bytes"]


# -- one device's counts --------------------------------------------------------------


def _sequence_whole(monkeypatch):
    """The prefill traced with the sequence whole on every rank, as the
    serving path runs it."""
    from repro_torch.distributed import steps

    monkeypatch.setattr(steps, "_seq_axes", lambda mesh: None)


@pytest.mark.parametrize("sequence_parallel", [True, False], ids=["sequence_parallel", "sequence_whole"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["data2_model2", "data4_model1"])
def test_rank_flops_are_the_ranks_share(fake_world, monkeypatch, shape, sequence_parallel):
    """With the sequence whole on every ``model`` rank, the dense FFN's up-
    projection is computed whole there too; under sequence parallelism
    (the dry run's prefill) that FFN runs on the rank's own positions."""
    cfg = get_smoke_config("distilgpt2-82m")
    b, s = 4, 64
    specs = token_specs(cfg, b, s)
    one = dryrun.trace_prefill(cfg, specs)["flops_per_device"]
    fake_world(4)
    if not sequence_parallel:
        _sequence_whole(monkeypatch)
    rank = dryrun.trace_prefill(cfg, specs, mesh=_mesh(shape, ("data", "model")))["flops_per_device"]
    model = shape[1]
    up = 2 * b * s * cfg.d_model * cfg.d_ff * cfg.num_layers  # computed whole on every model rank
    assert rank * 4 == pytest.approx(one + (0 if sequence_parallel else (model - 1) * up), rel=1e-2)


def test_prefill_shards_the_residual_sequence_over_model(fake_world, monkeypatch, tmp_path):
    from repro_torch.distributed import act_sharding

    cfg = get_smoke_config("distilgpt2-82m")
    b, s = 4, 64
    specs = token_specs(cfg, b, s)
    fake_world(4)
    mesh = _mesh((2, 2), ("data", "model"))
    real = act_sharding.shard_activations

    def residual_bytes():
        """The local bytes of every [B, S, D] residual the model places."""
        got = []

        def placed(x):
            out = real(x)
            if out.ndim == 3 and tuple(out.shape) == (b, s, cfg.d_model):
                local = out.to_local()
                got.append(local.numel() * local.element_size())
            return out

        monkeypatch.setattr(act_sharding, "shard_activations", placed)
        try:
            main = dryrun.trace_prefill(cfg, specs, mesh=mesh)
        finally:
            monkeypatch.setattr(act_sharding, "shard_activations", real)
        return got, main

    sharded, main = residual_bytes()
    _sequence_whole(monkeypatch)
    whole, whole_main = residual_bytes()
    assert len(sharded) == len(whole) >= 2 * cfg.num_layers + 1  # the embedding's, each block's output
    assert [2 * n for n in sharded] == whole
    assert main["flops_per_device"] < whole_main["flops_per_device"]  # the whole-weight FFN on the rank's positions
    # the record: its peak falls, all of the fall in activations, by at
    # least the half of the residual it carries there; the sequence a block
    # gathers at its entry stays whole, so the activations do not halve
    act = {k: rec["memory"]["by_category"]["activations"] for k, rec in (("sharded", main), ("whole", whole_main))}
    saved = act["whole"] - act["sharded"]
    assert saved == whole_main["memory"]["peak_estimate_bytes"] - main["memory"]["peak_estimate_bytes"]
    assert saved >= whole[0] - sharded[0] > 0
    monkeypatch.undo()  # the dry run's own prefill again
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    rec = dryrun.run_cell("distilgpt2-82m", "prefill_32k", "single", probes=False, out_dir=tmp_path)
    assert rec["status"] == "ok" and "prefill_sequence" not in rec


def test_multi_pod_train_cross_pod_bytes_are_the_steps_wan_bytes(fake_world):
    fake_world(8)
    main = dryrun.trace_cell(get_smoke_config("olmo-1b"), _mesh((2, 2, 2), AXES), "train_4k")
    colls = main["collectives"]
    # the step's loss, ce, aux and tokens, float32 scalars gathered over the
    # 2 pods (PodGroup.mean_in_rank_order: metrics, not WAN traffic of the strategy)
    metrics = 4 * 2 * 4
    assert colls["cross_pod_bytes"] - metrics == main["wan_bytes_rank"] > 0  # sync.group_wan_bytes("hier", ...)
    assert colls["unclassified_bytes"] == 0
    assert colls["count"] > 0 and colls["total_bytes"] > colls["cross_pod_bytes"]  # the LAN's too


@pytest.mark.parametrize("route", ["c10d", "functional"])
def test_collectives_count_result_bytes(fake_world, route):
    """``TestParseCollectives::test_counts_and_bytes``'s three collectives:
    an all-gather to f32 [64, 128] over a pair of ranks, an all-reduce of
    bf16 [256] within a pod, a reduce-scatter to f32 [32] over ranks 0 and
    256; on the 2 x 256 layout only the last crosses pods."""
    import torch.distributed._functional_collectives as funcol

    fake_world(512)
    pair, pod0, across = dist.new_group([0, 1]), dist.new_group(list(range(256))), dist.new_group([0, 256])
    counter = DeviceCounter(pod_size=256)
    with FakeTensorMode(), counter:
        x, y, z = torch.empty(32, 128), torch.empty(256, dtype=torch.bfloat16), torch.empty(64)
        if route == "c10d":
            dist.all_gather_into_tensor(torch.empty(64, 128), x, group=pair)
            dist.all_reduce(y, group=pod0)
            dist.reduce_scatter_tensor(torch.empty(32), z, group=across)
        else:
            funcol.wait_tensor(funcol.all_gather_tensor(x, 0, pair))
            funcol.wait_tensor(funcol.all_reduce(y, "sum", pod0))
            funcol.wait_tensor(funcol.reduce_scatter_tensor(z, "sum", 0, across))
    stats = counter.collectives
    assert stats.count == 3
    assert stats.bytes_by_kind == {"all-gather": 64 * 128 * 4, "all-reduce": 256 * 2, "reduce-scatter": 32 * 4}
    assert stats.cross_pod_bytes == 32 * 4 and stats.unclassified_bytes == 0
    assert counter.bytes == 0  # collectives are not an op's bytes


def test_collective_stats_without_pods():
    stats = CollectiveStats()
    out = (torch.empty(8, 4), None)
    assert record(stats, torch.ops.c10d._allgather_base_.default, (), {}, out, pod_size=0)
    assert not record(stats, torch.ops.aten.add.Tensor, (), {}, torch.empty(3), pod_size=0)
    assert stats.bytes_by_kind == {"all-gather": tensor_bytes(out[0])} and stats.cross_pod_bytes == 0
    assert stats.total_bytes == 128 and stats.count == 1


# -- the kernel ops' fake implementations -----------------------------------------------


def _flash(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g, dtype=dtype)
    k = torch.randn(2, 40, 2, 16, generator=g, dtype=dtype)
    return q, k, torch.randn(2, 40, 2, 16, generator=g, dtype=dtype)


def _wkv(n=16):
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn(2, 37, 2, n, generator=g, dtype=torch.bfloat16) for _ in range(3))
    w = torch.rand(2, 37, 2, n, generator=g) * 0.5 + 0.4
    return r, k, v, w, torch.randn(2, n, generator=g) * 0.1, torch.zeros(2, 2, n, n)


def _rglru(t=130, dr=64):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, t, dr, generator=g)
    r, i = torch.rand(2, t, dr, generator=g), torch.rand(2, t, dr, generator=g)
    return x, r, i, torch.randn(dr, generator=g), torch.zeros(2, dr)


def _case(name):
    """(the wrapper's call on the given tensors, the CPU inputs)."""
    if name in ("flash_fwd", "flash_fwd_lse"):
        return (lambda q, k, v: flash_attention_fwd(q, k, v, window=16, with_lse=name.endswith("lse"))), _flash()
    if name == "flash_bwd":
        q, k, v = _flash()
        o, lse = flash_attention_fwd(q, k, v, with_lse=True)
        return (lambda *a: flash_attention_bwd(*a)), (q, k, v, o, lse, torch.randn_like(o))
    if name == "wan_quant":
        return wan_quant, (torch.randn(6, 300),)
    if name == "wan_dequant":
        q, s = wan_quant(torch.randn(6, 300))
        return (lambda q, s: wan_dequant(q, s, 300)), (q, s)
    if name == "wkv6_fwd":
        return wkv6, _wkv()
    if name == "wkv6_bwd":  # the launcher has no plain route: the plain version is wkv6_bwd_ref
        r, k, v, w, u, s0 = _wkv()
        out, final, bounds = wkv6_ref(r, k, v, w, u, s0, chunk=32)
        return (lambda *a: wkv6_bwd_ref(*a, 32) if has_values(a[0]) else wkv6_bwd(*a, chunk=32)), (
            r, k, v, w, u, bounds, torch.randn_like(out), torch.randn_like(final))
    if name == "rglru_scan_fwd":  # h and h_last; the chunks' states are the card's own (the CPU's backward
        return (lambda *a: rglru_scan_fwd(*a)[:2]), _rglru()  # recomputes h), held to their shape below
    if name == "rglru_scan_bwd":
        x, r, i, lam, h0 = _rglru()
        h, h_last = rglru_scan_fwd(x, r, i, lam, h0)[:2]
        states = torch.zeros(x.shape[0], -(-x.shape[1] // CHUNK), x.shape[2])  # the card's, which the CPU ignores
        return (lambda *a: rglru_scan_bwd(*a[:7], states=a[7])), (x, r, i, lam, h0, torch.randn_like(h),
                                                                  torch.randn_like(h_last), states)
    raise KeyError(name)


KERNEL_OPS = ("flash_fwd", "flash_fwd_lse", "flash_bwd", "wan_quant", "wan_dequant", "wkv6_fwd", "wkv6_bwd",
              "rglru_scan_fwd", "rglru_scan_bwd")


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_fake_outputs_match_the_plain_version(name):
    fn, inputs = _case(name)
    plain = [t for t in tree_leaves(fn(*inputs)) if isinstance(t, torch.Tensor)]
    before = dict(LAUNCHES)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, card_routes(), FlopCounterMode(display=False) as fc:
        fake_inputs = [mode.from_tensor(t) for t in inputs]
        got = [t for t in tree_leaves(fn(*fake_inputs)) if isinstance(t, torch.Tensor)]
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in plain]
    assert dict(LAUNCHES) == before  # a fake tensor's op launches nothing
    ops = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    assert list(ops) == [f"repro_torch.{_op_name(name)}"] and ops[f"repro_torch.{_op_name(name)}"] >= 0


def test_fake_scan_keeps_the_cards_chunk_states():
    x, r, i, lam, h0 = _rglru()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, card_routes():
        states = rglru_scan_fwd(*(mode.from_tensor(t) for t in (x, r, i, lam, h0)))[2]
    assert (tuple(states.shape), states.dtype) == ((2, -(-130 // CHUNK), 64), torch.float32)


def _op_name(name):
    return {"flash_fwd_lse": "flash_fwd", "rglru_scan_fwd": "rglru_scan"}.get(name, name)


def test_op_flop_formulas_come_from_costs():
    q, k, v = (t.to(torch.bfloat16) for t in _flash())
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, card_routes(), FlopCounterMode(display=False) as fc:
        flash_attention_fwd(*(mode.from_tensor(t) for t in (q, k, v)), window=16)
    want = costs.flash_fwd(2, 40, 40, 4, 2, 16, "bfloat16", 16)[0]["bfloat16"]
    assert fc.get_total_flops() == want == 4 * 2 * 4 * 16 * costs.attention_pairs(40, 40, True, 16)


# -- kernels/costs.py against PERF.md's kernel table ---------------------------------------


def _wan_step():
    """The 19 leaves of one distilgpt2-82m train step, stacked over 2 pods."""
    from repro_torch.launch.shapes import params_specs

    total = 0
    for t in tree_leaves(params_specs(get_config("distilgpt2-82m"))):
        shp = tuple(t.shape)
        cols = shp[-1] if shp else 1
        total += costs.wan_quant(2 * (math.prod(shp) // cols), cols)[1]
    return {}, total


BOUNDS = [  # (what, its cost, PERF.md's bound_ms as printed)
    ("flash fwd path", lambda: costs.flash_fwd(8, 1024, 1024, 12, 12, 64, "bfloat16", None), "0.0150"),
    ("flash fwd hd 256", lambda: costs.flash_fwd(4, 4096, 4096, 16, 1, 256, "bfloat16", 2048), "0.417"),
    ("flash fwd hd 256 1x4096", lambda: costs.flash_fwd(1, 4096, 4096, 16, 1, 256, "bfloat16", 2048), "0.1042"),
    ("flash fwd mixtral", lambda: costs.flash_fwd(4, 4096, 4096, 48, 8, 128, "bfloat16", 4096), "0.834"),
    ("flash fwd arctic", lambda: costs.flash_fwd(4, 4096, 4096, 56, 8, 128, "bfloat16", None), "0.973"),
    ("flash fwd mesh hd 256 8/1", lambda: costs.flash_fwd(2, 4096, 4096, 8, 1, 256, "bfloat16", 2048), "0.1042"),
    ("flash fwd mesh hd 256 4/1", lambda: costs.flash_fwd(2, 4096, 4096, 4, 1, 256, "bfloat16", 2048), "0.0521"),
    ("flash fwd mesh hd 128 24/4", lambda: costs.flash_fwd(2, 4096, 4096, 24, 4, 128, "bfloat16", 4096), "0.2085"),
    ("flash fwd mesh hd 128 12/2", lambda: costs.flash_fwd(2, 4096, 4096, 12, 2, 128, "bfloat16", 4096), "0.1043"),
    ("flash bwd path", lambda: costs.flash_bwd(8, 1024, 1024, 12, 12, 64, "bfloat16", None), "0.0326"),
    ("flash bwd hd 256", lambda: costs.flash_bwd(1, 4096, 4096, 16, 1, 256, "bfloat16", 2048), "0.2606"),
    ("flash bwd mixtral", lambda: costs.flash_bwd(1, 4096, 4096, 48, 8, 128, "bfloat16", 4096), "0.5213"),
    ("flash bwd mesh hd 256", lambda: costs.flash_bwd(2, 4096, 4096, 4, 1, 256, "bfloat16", 2048), "0.1303"),
    ("flash bwd mesh hd 128", lambda: costs.flash_bwd(2, 4096, 4096, 12, 2, 128, "bfloat16", 4096), "0.2606"),
    ("wan 19 leaves", _wan_step, "0.2429"),
    ("wan expert leaf", lambda: costs.wan_quant(2 * 8 * 6144, 16384), "2.4114"),
    ("wkv6_fwd", lambda: costs.wkv6_fwd(4, 4096, 64, 64, "bfloat16", "float32"), "0.2830"),
    ("wkv6_bwd", lambda: costs.wkv6_bwd(4, 4096, 64, 64, "bfloat16", "float32", 256), "0.5033"),
    ("rglru_scan", lambda: costs.rglru_scan(4, 4096, 4096, "bfloat16"), "0.1603"),
    ("rglru_scan 1x4096", lambda: costs.rglru_scan(1, 4096, 4096, "bfloat16"), "0.0401"),
    ("rglru_scan mesh 2048", lambda: costs.rglru_scan(2, 4096, 2048, "bfloat16"), "0.0401"),
    ("rglru_scan mesh 1024", lambda: costs.rglru_scan(2, 4096, 1024, "bfloat16"), "0.0200"),
    ("rglru_scan_bwd", lambda: costs.rglru_scan_bwd(1, 4096, 4096, "bfloat16"), "0.0704"),
    ("rglru_scan_bwd 4x4096", lambda: costs.rglru_scan_bwd(4, 4096, 4096, "bfloat16"), "0.2818"),
    ("rglru_scan_bwd mesh", lambda: costs.rglru_scan_bwd(2, 4096, 1024, "bfloat16"), "0.0352"),
]


@pytest.mark.parametrize("what,cost,printed", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_costs_give_perf_md_bounds(what, cost, printed):
    ms, _ = costs.bound(*cost())
    assert f"{ms:.{len(printed.split('.')[1])}f}" == printed
    assert printed in (ROOT / "PERF.md").read_text()


# -- the CLI ------------------------------------------------------------------------------


def test_cli_writes_an_ok_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b", "--shape", "decode_32k",
           "--mesh", "single", "--out", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[ok] olmo-1b decode_32k single" in proc.stdout
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["device"] == "cuda" and rec["fits"]
    main = rec["main"]
    assert main["flops_per_device"] > 0 and main["bytes_per_device"] > 0 and main["collectives"]["count"] > 0
    mem = main["memory"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                                          - mem["alias_bytes"])
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "model_flops_ratio", "bottleneck"}
    assert set(rec["probes"]) >= {"per_group", "base", "estimated_total", "probe1", "probe2"}
