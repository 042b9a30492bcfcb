"""recurrentgemma-9b, mixtral-8x22b and arctic-480b on a ``(data, model)`` mesh, on the CPU.

One module-scoped 4-rank spawn (smoke configs, float32, one thread a rank,
the JAX package's initial weights through ``convert``) runs every rank's
share of the cases below, beside a JAX subprocess running the JAX
``make_train_step`` (strategy ``hier``) on meshes of 4 fake CPU devices.
The RG-LRU conv and scan run on each rank's rows and channels, the MoE
experts on each rank's rows and experts (``on_local_shards``).
Tolerances, each stated with its reason:

(a) one train step at 8 x 16 of each arch on ``(data 2, model 2)`` and
    ``(data 1, model 4)`` against the JAX mesh step from the same weights
    and batch: loss and aux within rtol 1e-5, every parameter leaf within
    atol 2e-5 but on lanes whose mean gradient is below 10 x AdamW's eps
    (``test_torch_mesh.py`` (a)'s bars and its rule for such lanes); the
    step runs sequence parallel: its LAN calls hold reduce-scatters onto
    ``[B / data, S / model, D]`` and no all-reduce of a ``[B / data, S, D]``
    activation, in (b)'s cases too;
(b) MoE cases, each a ``dataclasses.replace`` of the mixtral smoke
    config, against the JAX mesh step at (a)'s bars: capacity factor 0.5
    (choices drop) at 8 x 16 (one 128-token group over both ``data``
    ranks: the [T, k] choices all-gathered over ``data``) and at 8 x 128
    (two 512-token groups, one a ``data`` rank); 6 experts on ``(data 1,
    model 4)`` (E does not divide ``model``: the FFN width over ``("model",
    "data")``, a ``_StridedShard``); ``impl="gather"`` on ``(data 2,
    model 2)`` (the rows whole on each rank);
(c) the mesh's aux loss is the global ``E * sum_e f_e P_e`` of one process
    over every row (rtol 1e-6: sums in another order), and the mean of the
    two ``data`` ranks' own values is another number on these inputs;
(d) on ``(data 1, model 4)`` every ``model`` rank's router input is
    bit-equal (the residual replicated over ``model``), so its expert
    choices are equal on every rank: both checked bit for bit;
(e) prefill and 4 decode steps of each arch on ``(data 2, model 2)``,
    ``(data 1, model 4)`` and, over ranks 0 and 1, ``(data 1, model 2)``
    against the one-process ``prefill`` / ``decode_step``: float32 1e-4
    (``test_torch_serve.py``'s bar); every cache leaf placed as
    ``cache_placements`` lays it, and the RG-LRU state (``h`` and the conv
    tail) written in its own storage on every decode step, no gather; the
    parameters gathered by the first decode step only, and again after one
    of them changes in place;
(f) recurrentgemma-9b on ``(pod 2, data 1, model 2)`` under ``hier_int8``,
    two steps against the port's one-process stacked step: losses rtol
    1e-6 and WAN bytes equal, as ``test_torch_mesh.py`` (b); the
    parameters after each step at (b)'s bar for its second step, rtol 1e-3
    and atol 1e-6, but on lanes whose summed gradient nearly cancels (fewer
    than 1e-3 of the values, each within 2 lr).  (b) holds its first step
    at rtol 1e-6; over ``model`` every gradient is also a sum over the
    ranks' partial products, in another order than one process's, and the
    first AdamW step (g / (|g| + eps)) and the int8 quantiser's rounding
    turn that into more lanes beyond rtol 1e-6 (measured on the CPU:
    1.7e-3 of the values under ``hier_int8``, 4.3e-3 under ``hier``, each
    within 2 lr; at rtol 1e-3 one value after the first step and 2.9e-4 of
    them after the second).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import loader_for_model
from repro_torch.distributed import (
    init_pod_params,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    spawn,
)
from repro_torch.distributed.placement import full_tree
from repro_torch.distributed.sharding import cache_placements, params_placements
from repro_torch.launch import mesh as tmesh
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_items, tree_map
from test_torch_mesh import OPT, _close_but_cancelling_lanes, _close_but_eps_lanes, _flat, _np, _scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("recurrentgemma-9b", "mixtral-8x22b", "arctic-480b")
MESHES = ((2, 2), (1, 4))
B, S = 8, 16
PROMPT, GEN = 12, 4
#: (case id, arch, mesh, moe overrides, seq): one step against the JAX mesh step
TRAIN_CASES = (
    [(f"{a}-data{m[0]}-model{m[1]}", a, m, {}, S) for a in ARCHS for m in MESHES]
    + [("mixtral-drops-one-group-over-data", "mixtral-8x22b", (2, 2), {"capacity_factor": 0.5}, 16),
       ("mixtral-drops-a-group-a-rank", "mixtral-8x22b", (2, 2), {"capacity_factor": 0.5}, 128),
       ("mixtral-6-experts-data1-model4", "mixtral-8x22b", (1, 4), {"num_experts": 6}, 16),
       ("mixtral-gather-data2-model2", "mixtral-8x22b", (2, 2), {"impl": "gather"}, 16)]
)
SERVE_CASES = [(a, m) for a in ARCHS for m in MESHES + ((1, 2),)]
POD_MESH = (2, 1, 2)
CHOICES_CASE = "mixtral-8x22b-data1-model4"


def _cfg(arch, over=None, smoke=get_smoke_config):
    cfg = smoke(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over)) if over else cfg


def _batches(cfg, n, seq=S, seed=11):
    loader = loader_for_model(cfg, seq_len=seq, global_batch=B, seed=seed)
    return [loader.next_batch() for _ in range(n)]


def _jax_params_np(arch, over=None):
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import init_params as jax_init_params

    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), _cfg(arch, over, jax_smoke)))


def _serve_id(arch, shape):
    return f"{arch}-data{shape[0]}-model{shape[1]}"


# -- what the ranks run ------------------------------------------------------------


def _train(cfg, strategy, opt, batches, mesh, params):
    state = init_train_state(params, opt, strategy=strategy, mesh=mesh)
    params = init_pod_params(params, strategy=strategy, mesh=mesh)
    step = make_train_step(cfg, mesh=mesh, strategy=strategy, opt_cfg=opt, device="cpu")
    rows, states = [], []
    for batch in batches:
        params, state, metrics = step(params, state, batch)
        rows.append(dict(_scalars(metrics), lan_shapes=dict(step.lan.shapes)))
        with step.lan:
            states.append(_np(full_tree(params)))
    return rows, states


class _RouterInputs:
    """Within ``with``: every MoE router call's input rows and expert
    choices on this rank."""

    def __enter__(self):
        from repro_torch.models import ffn

        self.ffn, self.real, self.calls = ffn, ffn._router_probs, []

        def route(params, x, moe):
            out = self.real(params, x, moe)
            self.calls.append((x.detach().numpy().copy(), out[2].numpy().copy()))
            return out

        ffn._router_probs = route
        return self.calls

    def __exit__(self, *exc):
        self.ffn._router_probs = self.real


def _serve(cfg, mesh, params, tokens, decode_tokens):
    """Prefill and decode steps -> (logits, cache placements against the
    rules', whether the RG-LRU state kept its storage and changed)."""
    prefill_step, placements = make_prefill_step(cfg, mesh, device="cpu")
    decode, _ = make_decode_step(cfg, mesh, device="cpu")
    logits, cache = prefill_step(params, {"tokens": tokens}, max_len=PROMPT + GEN)
    out = [logits.numpy().copy()]
    want = cache_placements(tree_map(lambda t: torch.empty(tuple(t.shape), device="meta"), cache),
                            tmesh.mesh_shape(mesh))
    sizes = tmesh.intra_pod_mesh(mesh).shape
    placed = all(  # a Shard on an axis of size 1 is the whole tensor, as Replicate() is
        all(p == w or n == 1 for p, w, n in zip(t.placements, want_leaf, sizes))
        for (_, t), (_, want_leaf) in zip(tree_items(cache), _placement_items(want))
    )
    state = [(k, t) for k, t in tree_items(cache) if k.rsplit("/", 1)[-1] in ("h", "conv")]
    before = [(k, t.to_local().data_ptr(), t.to_local().clone()) for k, t in state]
    gathers = []
    for i, t in enumerate(decode_tokens):
        logits, cache = decode(params, t, cache, PROMPT + i)
        out.append(logits.numpy().copy())
        gathers.append(decode.lan.calls["all_gather_into_tensor"])
    after = dict(tree_items(cache))
    in_place = [after[k].to_local().data_ptr() == ptr and not torch.equal(after[k].to_local(), old)
                for k, ptr, old in before]
    params["final_norm"]["scale"].add_(0)  # changed in place (its version): gathered again
    decode(params, decode_tokens[-1], cache, PROMPT + len(decode_tokens) - 1)
    gathers.append(decode.lan.calls["all_gather_into_tensor"])
    return out, {"placed": placed, "in_place": in_place, "gathers": gathers}


def _placement_items(tree, prefix=""):
    """(path, placements) pairs of a placements tree (tuples of placements are its leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _placement_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _placement_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _gathered_expert_stack(mesh):
    """mixtral's bf16 expert stack ``w_up`` [L, E, D, F], placed by the
    rules (E over ``model``, F over ``data``), as the step gathers it for
    the forward: its dtype, placements and local shape."""
    from repro_torch.distributed.lan import LanCollectives
    from repro_torch.distributed.steps import _fsdp_gather_tree

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"), param_dtype="bfloat16")
    placed = init_pod_params(init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"), mesh=mesh)
    with LanCollectives(torch.device("cpu")):
        w = _fsdp_gather_tree(placed)["groups"]["slot0"]["ffn"]["w_up"]
    return w.dtype, tuple(w.placements), tuple(w.to_local().shape)


def _rank_main(rank, train_in, serve_in, pod_in):
    torch.set_num_threads(1)
    meshes = {shape: tmesh.make_mesh(shape, ("data", "model"), device="cpu") for shape in MESHES}
    meshes[(1, 2)] = tmesh.make_mesh((1, 2), ("data", "model"), device="cpu", ranks=[0, 1])
    out = {"train": {}, "serve": {}, "gathered": _gathered_expert_stack(meshes[(2, 2)])}
    for (key, arch, shape, over, _), (p_np, batches) in zip(TRAIN_CASES, train_in):
        params = params_from_numpy(p_np, device="cpu")
        with _RouterInputs() as calls:
            out["train"][key] = _train(_cfg(arch, over), "hier", AdamWConfig(warmup_steps=1), batches, meshes[shape],
                                       params)
        if key == CHOICES_CASE:
            out["router_calls"] = calls
    for (arch, shape), (p_np, tokens, dec) in zip(SERVE_CASES, serve_in):
        if meshes[shape] is not None:
            out["serve"][_serve_id(arch, shape)] = _serve(
                get_smoke_config(arch), meshes[shape], params_from_numpy(p_np, device="cpu"), tokens, dec)
    pod_mesh = tmesh.make_mesh(POD_MESH, tmesh.AXES, device="cpu")
    p_np, batches = pod_in
    out["pods"] = _train(get_smoke_config("recurrentgemma-9b"), "hier_int8", OPT, batches, pod_mesh,
                         params_from_numpy(p_np, device="cpu"))
    return out


# -- the parent's side ---------------------------------------------------------------

_JAX_SCRIPT = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.distributed import init_train_state, make_train_step
from repro.launch.mesh import make_mesh
from repro.launch.shapes import params_specs
from repro.optim import AdamWConfig

cases = pickle.load(open(sys.argv[1], "rb"))
opt = AdamWConfig(warmup_steps=1)
out = {}
for key, arch, shape, over, params_np, batches in cases:
    cfg = get_smoke_config(arch)
    if over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))
    params = jax.tree.map(jnp.asarray, params_np)
    mesh = make_mesh(shape, ("data", "model"))
    b_shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batches[0])
    with mesh:
        step, _ = make_train_step(cfg, mesh, opt_cfg=opt, strategy="hier", params_shapes=params_specs(cfg),
                                  batch_shapes=b_shapes, donate=False)
        state = init_train_state(params, opt, strategy="hier")
        rows = []
        for b in batches:
            params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
            rows.append({k: float(m[k]) for k in ("loss", "ce", "aux")})
    out[key] = {"rows": rows, "params": jax.tree.map(np.asarray, params),
                "m": jax.tree.map(np.asarray, state.adam.m)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX mesh steps in a subprocess beside the 4-rank spawn."""
    tmp = tmp_path_factory.mktemp("mesh_models")
    train_in = [(_jax_params_np(arch, over), _batches(_cfg(arch, over), 1, seq))
                for _, arch, _, over, seq in TRAIN_CASES]
    src, dst = tmp / "jax_in.pkl", tmp / "jax_out.pkl"
    src.write_bytes(pickle.dumps([(key, arch, shape, over, *inputs)
                                  for (key, arch, shape, over, _), inputs in zip(TRAIN_CASES, train_in)]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(src), str(dst)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    rng = np.random.default_rng(7)
    serve_in = []
    for arch, _ in SERVE_CASES:
        c = get_smoke_config(arch)
        tokens = torch.from_numpy(rng.integers(0, c.vocab_size, (4, PROMPT)))
        dec = [torch.from_numpy(rng.integers(0, c.vocab_size, (4,))) for _ in range(GEN)]
        serve_in.append((_jax_params_np(arch), tokens, dec))
    pod_in = (_jax_params_np("recurrentgemma-9b"), _batches(get_smoke_config("recurrentgemma-9b"), 2, seed=3))
    try:
        ranks = spawn(_rank_main, 4, train_in, serve_in, pod_in, device="cpu", join_timeout_s=400)
        _, stderr = proc.communicate(timeout=400)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    return {"ranks": ranks, "jax": pickle.loads(dst.read_bytes()), "train_in": train_in, "serve_in": serve_in,
            "pod_in": pod_in}


# -- (a), (b) the JAX mesh step ------------------------------------------------------


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)), ids=[c[0] for c in TRAIN_CASES])
def test_mesh_step_matches_jax_mesh_step(run, case):
    key = TRAIN_CASES[case][0]
    want = run["jax"][key]
    ref, moment = _flat(want["params"]), _flat(want["m"])
    for r, rank in enumerate(run["ranks"]):
        rows, states = rank["train"][key]
        for name in ("loss", "aux"):
            np.testing.assert_allclose([x[name] for x in rows], [x[name] for x in want["rows"]], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{key} rank {r} {name}")
        got = _flat(states[-1])
        assert set(got) == set(ref)
        _close_but_eps_lanes(got, ref, moment, len(rows), f"{key} rank {r}")


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)), ids=[c[0] for c in TRAIN_CASES])
def test_mesh_step_reduce_scatters_onto_sequence_shards(run, case):
    """Sequence parallelism in (a) and (b): the residual's partial sums
    over ``model`` go to the rank's ``[B / data, S / model, D]`` in
    reduce-scatters, and no ``[B / data, S, D]`` residual is all-reduced.
    The RG-LRU's two gate products ``[B, S, d_rnn]`` may be all-reduced
    inside the block; the smoke config's d_rnn is d_model, so they are
    counted apart: at most two a recurrent layer a forward."""
    key, arch, (data, model), over, seq = TRAIN_CASES[case]
    cfg = _cfg(arch, over)
    d, b = cfg.d_model, B // data
    kinds = list(cfg.pattern) * cfg.num_groups + list(cfg.remainder)
    recurrent = kinds.count("recurrent")
    forwards = 2 if cfg.remat in ("full", "dots") else 1
    gates = 2 * recurrent * forwards if cfg.d_rnn == d else 0
    for r, rank in enumerate(run["ranks"]):
        shapes = rank["train"][key][0][0]["lan_shapes"]
        assert shapes.get(("reduce_scatter_tensor", (model * b, seq // model, d)), 0) > 0, (r, shapes)
        assert shapes.get(("all_reduce", (b, seq, d)), 0) <= gates, (r, shapes)


def test_moe_cases_cover_drops_spans_and_placements():
    """What (b) exercises: the choices drop at capacity factor 0.5, a group
    spans the ``data`` ranks at 8 x 16 but not at 8 x 128, 6 experts take
    the strided few-expert width on ``model`` 4."""
    from repro_torch.models.ffn import MOE_GROUP_SIZE, _capacity

    moe = _cfg("mixtral-8x22b", {"capacity_factor": 0.5}).moe
    for seq, groups in ((16, 1), (128, 2)):
        tokens = B * seq
        tg = min(MOE_GROUP_SIZE, tokens)
        assert tokens // tg == groups
        assert (tokens // 2) % tg == (0 if groups == 2 else tokens // 2)  # a data rank's rows: whole groups or part of one
        assert _capacity(tg, moe) * moe.num_experts < tg * moe.num_experts_per_tok  # some choice must drop
    cfg = _cfg("mixtral-8x22b", {"num_experts": 6})
    placements = params_placements(init_params(cfg, device="meta"), {"data": 1, "model": 4})
    assert "_StridedShard" in type(placements["groups"]["slot0"]["ffn"]["w_up"][0]).__name__


def test_the_step_keeps_expert_stacks_on_model_and_in_bf16(run):
    """The forward's gather of a bf16 expert stack on ``(data 2, model 2)``:
    F gathered over ``data``, E kept over ``model`` (each rank its 2 of 4
    experts), the dtype unchanged."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_smoke_config("mixtral-8x22b")
    for r, rank in enumerate(run["ranks"]):
        dtype, placements, shape = rank["gathered"]
        assert dtype == torch.bfloat16, r
        assert placements == (Replicate(), Shard(1)), (r, placements)
        assert shape == (cfg.num_groups, cfg.moe.num_experts // 2, cfg.d_model, cfg.d_ff), (r, shape)


# -- (c) the global aux loss ------------------------------------------------------------


def test_mesh_aux_is_the_global_one_not_a_mean_of_ranks(run):
    key = "mixtral-8x22b-data2-model2"
    cfg = get_smoke_config("mixtral-8x22b")
    (p_np, batches) = run["train_in"][[c[0] for c in TRAIN_CASES].index(key)]
    params = params_from_numpy(p_np, device="cpu")
    tokens = torch.as_tensor(batches[0]["tokens"])
    with torch.no_grad():
        whole = float(forward(params, {"tokens": tokens}, cfg)[1])
        halves = [float(forward(params, {"tokens": tokens[i:i + B // 2]}, cfg)[1]) for i in (0, B // 2)]
    for r, rank in enumerate(run["ranks"]):
        got = rank["train"][key][0][0]["aux"]
        np.testing.assert_allclose(got, whole, rtol=1e-6, err_msg=f"rank {r}")
    assert abs(np.mean(halves) - whole) > 1e-3 * whole, (halves, whole)


# -- (d) the same choices on every model rank -------------------------------------------


def test_every_model_rank_routes_alike(run):
    calls = [rank["router_calls"] for rank in run["ranks"]]
    assert len(calls[0]) == get_smoke_config("mixtral-8x22b").num_layers
    for r in range(1, 4):
        assert len(calls[r]) == len(calls[0])
        for (x0, idx0), (x, idx) in zip(calls[0], calls[r]):
            np.testing.assert_array_equal(x, x0, err_msg=f"rank {r}: router input")
            np.testing.assert_array_equal(idx, idx0, err_msg=f"rank {r}: expert choices")


# -- (e) serving against one process -----------------------------------------------------


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=[_serve_id(a, m) for a, m in SERVE_CASES])
def test_mesh_prefill_and_decode_match_one_process(run, case):
    arch, shape = SERVE_CASES[case]
    cfg = get_smoke_config(arch)
    p_np, tokens, dec = run["serve_in"][case]
    params = params_from_numpy(p_np, device="cpu")
    logits, cache = prefill(params, {"tokens": tokens}, cfg, max_len=PROMPT + GEN)
    want = [logits.numpy().copy()]
    for i, t in enumerate(dec):
        logits, cache = decode_step(params, t, cache, cfg, PROMPT + i)
        want.append(logits.numpy().copy())
    ranks = run["ranks"][:2] if shape == (1, 2) else run["ranks"]
    for r, rank in enumerate(ranks):
        got, info = rank["serve"][_serve_id(arch, shape)]
        assert info["placed"], f"rank {r}: cache placements differ from cache_placements"
        if arch == "recurrentgemma-9b":
            assert info["in_place"] and all(info["in_place"]), f"rank {r}: RG-LRU state not written in place"
        first, *later, again = info["gathers"]
        assert all(n == later[0] for n in later) and again == first, info["gathers"]
        if shape == (2, 2):  # the first decode step gathers the parameters over data, the next ones reuse them
            assert later[0] < first, info["gathers"]
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"rank {r} call {i}")


def test_rglru_state_write_refuses_a_placement_that_would_move_data(tmp_path):
    """The decode write of the state is local: a target placed otherwise
    than the new state raises instead of gathering."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.rglru import _write_local

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        dst = distribute_tensor(torch.zeros(2, 4), one, [Shard(0), Replicate()])
        src = distribute_tensor(torch.ones(2, 4), one, [Replicate(), Shard(1)])
        ptr = dst.to_local().data_ptr()
        _write_local(dst, src)  # on axes of size 1 a Shard is the whole tensor: local
        assert dst.to_local().data_ptr() == ptr and bool((dst.to_local() == 1).all())
        with pytest.raises(ValueError, match="would not be local"):
            _write_local(dst, torch.ones(2, 4))
    finally:
        if made:
            dist.destroy_process_group()


# -- (f) hier_int8 over pods of a (data 1, model 2) mesh ---------------------------------


def test_pod_model_hier_int8_matches_one_process(run):
    from repro_torch.distributed.steps import make_train_step as step_of

    cfg = get_smoke_config("recurrentgemma-9b")
    p_np, batches = run["pod_in"]
    params = params_from_numpy(p_np, device="cpu")
    state = init_train_state(params, OPT, strategy="hier_int8", npods=2)
    params = init_pod_params(params, strategy="hier_int8", npods=2)
    step = step_of(cfg, npods=2, strategy="hier_int8", opt_cfg=OPT, device="cpu")
    ref_rows, ref_states = [], []
    for batch in batches:
        params, state, metrics = step(params, state, batch)
        ref_rows.append(_scalars(metrics))
        ref_states.append(_np(params))
    for r, rank in enumerate(run["ranks"]):
        rows, states = rank["pods"]
        np.testing.assert_allclose([x["loss"] for x in rows], [x["loss"] for x in ref_rows], rtol=1e-6,
                                   err_msg=f"rank {r}")
        assert [x["wan_bytes"] for x in rows] == [x["wan_bytes"] for x in ref_rows], f"rank {r}"
        for i in range(2):
            _close_but_cancelling_lanes(states[i], ref_states[i], OPT.lr, f"rank {r} step {i + 1}", rtol=1e-3,
                                        atol=1e-6)


def test_a_training_ranks_hd256_backward_takes_a_valid_cluster():
    """recurrentgemma-9b's local attention on a ``(data 1, model 4)`` rank:
    2 x 4096, 4 query heads over the one kv head (G 4); the hd-256 dK/dV
    kernel splits an item's query heads over a cluster that divides G."""
    from repro_torch.kernels.flash_attention.ops import KV_CLUSTERS, dkdv_cluster

    for sms in (132, 114):  # H100 SXM, PCIe
        size = dkdv_cluster(2, 1, 4096, 4, sms)
        assert size in KV_CLUSTERS and 4 % size == 0, (sms, size)
