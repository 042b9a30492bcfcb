"""Intra-pod placement on the CPU: pods of several ranks over gloo, the model on DTensors.

Three module-scoped spawns (smoke config of distilgpt2-82m, float32, one
thread a rank) run every rank's share of the cases below; the parent holds
what the ranks return.  Tolerances, each stated with its reason:

(a) 4 ranks, ``(data 2, model 2)``: two train steps against the JAX
    ``make_train_step`` on a ``(2, 2)`` mesh of 4 fake CPU devices (a
    subprocess, as ``tests/test_distributed.py`` runs its meshes), from the
    same JAX weights and batches: losses within rtol 1e-5, every parameter
    leaf within atol 2e-5 (the JAX suite's bar for a mesh step against one
    device); and one step of starcoder2-7b, chatglm3-6b and yi-34b on
    ``(data 2, model 2)`` and ``(data 1, model 4)``, whose q, kv heads or
    both do not divide ``model`` (fault F4), against the JAX step on the
    same mesh at the same bars;
(b) 4 ranks, ``(pod 2, data 2, model 1)``: two steps of each of the five
    strategies against the port's one-process stacked step (itself held to
    ``jax.vmap`` of the JAX functions in ``test_torch_train.py``): losses
    within rtol 1e-6, counted WAN bytes equal.  Parameters after the first
    step within rtol 1e-6 (atol 1e-8) but on lanes where the summed
    gradient nearly cancels: the gradient summed over ``data`` adds in
    another order than one process, and AdamW's g / (|g| + eps) or a .5
    tie of the int8 quantiser turns ulps there into up to lr; such lanes
    may be fewer than 1e-3 of the values and are held to 2 lr (the rule of
    ``test_torch_train.py``).  After the second step AdamW's m / sqrt(v)
    mixes two gradients of different signs, and float32 ulps in them move
    a lane by up to ~1e-3 of its value (measured: at most 0.8% of a leaf's
    values beyond 1e-6 + 1e-3 |w|, lr 1e-2): held at rtol 1e-3, atol 1e-6,
    by the same rule.
    The ``hier_int8`` WAN hop on the same seeded gradients: every leaf's
    pieces' int8 payloads and scales, put together, equal the global
    array's bit for bit, and the synced gradient and error feedback equal
    the stacked form's exactly;
(c) ``GeoTrainer(cfg, mesh)`` on that mesh writes a checkpoint the
    one-process ``GeoTrainer`` and the JAX ``CheckpointStore`` restore, and
    resumes from a one-process checkpoint (losses rtol 1e-6, as (b));
(d) ``plan_remesh(2, 1, data=2, model=1).build()``: pod1's ranks leave,
    the survivors ``reshard_tree`` the restored checkpoint onto the new
    ``(data 2)`` mesh and take a step, which equals a fresh 2-rank
    ``(data 2)`` run from that checkpoint bit for bit (same ranks, same
    order of every sum);
(e) prefill and 4 decode steps on ``(data 2, model 2)`` against the
    one-process ``prefill`` / ``decode_step``, for distilgpt2-82m and
    rwkv6-7b (heads over ``model``), the same on ``(data 1, model 2)``
    over ranks 0 and 1 (the cache's batch dim on a size-1 ``data``: fault
    F3), and starcoder2-7b, chatglm3-6b and yi-34b on ``(data 2, model
    2)`` and ``(data 1, model 4)`` (F4: a head_dim-over-``model`` cache
    where the kv heads do not divide): float32 1e-4, test_torch_serve.py's
    bar;
(f) ``launch.train --mesh group --pods 2 --data 2`` runs, and ``--mesh
    single`` fails with the world-size ``ValueError``;
(g) ``chip_smoke.py``'s ``train_mesh`` bar on the parameters after the last
    step separates a rank that trains on half its rows (emulated in one
    process): it moves them by over twice ``MESH_PARAM_RTOL`` of the change;
(h) sequence parallelism on ``(data 1, model 2)`` over ranks 0 and 1, remat
    "full", two steps against the JAX mesh step at (a)'s bars: each group
    checkpoint's input is a DTensor placed ``Shard(1)`` over ``model``, and
    the local bytes the checkpoints save for the backward of it
    (``saved_tensors_hooks``) are groups x B x S/2 x D x 4 exactly; the
    step's LAN calls hold reduce-scatters of ``[2 B, S/2, D]`` and no
    all-reduce of a ``[B, S, D]`` activation; a ragged S (15) keeps the
    sequence whole (groups x B x S x D saved, the all-reduces back) and
    matches the JAX step at the same bars; a checkpoint's recomputation,
    which autograd runs on the card's device thread, sees the forward's
    activation context (emulated with the backward on a new thread);
(i) ``make_train_step(donate=True)`` on ``(data 2, model 2)`` and ``(pod 2,
    data 2)`` for ``allreduce``, ``hier_int8``, ``ps`` and ``local_sgd``:
    two steps give bit-equal parameters, moments, error feedback, DiLoCo
    state and metrics (but the host seconds) to the functional step's, in
    the local tensors' own storage (their ``data_ptr``s unchanged).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import pickle
import shutil
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
    sync_hier_int8,
)
from repro_torch.distributed.compression import int8_compress
from repro_torch.distributed.placement import full_tree, place_tree
from repro_torch.distributed.sharding import params_placements
from repro_torch.distributed.steps import (
    TrainState,
    _pieces,
    _unpieces,
    intra_placements,
    place_train_state,
)
from repro_torch.distributed.sync import sync_hier_int8_group
from repro_torch.launch import mesh as tmesh
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.optim import AdamWConfig, DilocoConfig
from repro_torch.optim.adamw import init_adamw
from repro_torch.runtime import GeoTrainer, TrainerConfig
from repro_torch.runtime.elastic import plan_remesh, reshard_tree
from repro_torch.tree import tree_items, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "distilgpt2-82m"
STRATEGIES = ("allreduce", "hier", "hier_int8", "ps", "local_sgd")
B, S = 8, 16
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5, weight_decay=0.1)
DILOCO = DilocoConfig(sync_every=2)
RTOL, ATOL = 1e-6, 1e-8
PROMPT, GEN = 12, 4
#: smoke archs whose q heads (starcoder2-7b: 6, yi-34b: 7) or kv heads
#: (chatglm3-6b: 2, yi-34b: 1) do not divide a ``model`` axis of 2 or 4
TP_ARCHS = ("starcoder2-7b", "chatglm3-6b", "yi-34b")
TP_MESHES = ((2, 2), (1, 4))
#: (arch, (data, model), steps) trained against the JAX mesh step
TRAIN_CASES = [(ARCH, (2, 2), 2)] + [(a, m, 1) for a in TP_ARCHS for m in TP_MESHES]
#: (arch, (data, model)) served against one process; (1, 2) over ranks 0, 1
SERVE_CASES = ([(ARCH, (2, 2)), ("rwkv6-7b", (2, 2)), (ARCH, (1, 2)), ("rwkv6-7b", (1, 2))]
               + [(a, m) for a in TP_ARCHS for m in TP_MESHES])
#: (case id, seq) of (h): ARCH under remat "full" on (data 1, model 2), over ranks 0 and 1
SP_MESH = (1, 2)
SP_CASES = [("sequence-parallel", S), ("ragged-sequence", S - 1)]
SP_OVER = {"remat": "full"}
#: the strategies (i) holds the donating step to the functional one under
DONATED = ("allreduce", "hier_int8", "ps", "local_sgd")


def _case_id(arch, shape):
    return f"{arch}-data{shape[0]}-model{shape[1]}"


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy() if torch.is_tensor(t) else t, tree)


def _scalars(m):
    return {k: (v.item() if torch.is_tensor(v) else v) for k, v in m.items()}


def _batches(cfg, n, seed=3, seq=S):
    loader = loader_for_model(cfg, seq_len=seq, global_batch=B, seed=seed)
    return [loader.next_batch() for _ in range(n)]


# -- what the ranks run ------------------------------------------------------------


def _local_ptrs(tree):
    """The storage address of every leaf's local tensor."""
    return [(t.to_local() if hasattr(t, "to_local") else t).data_ptr() for _, t in tree_items(tree)]


def _train(cfg, strategy, opt, batches, *, mesh=None, npods=None, params=None, donate=False):
    """Steps over ``batches`` from ``params`` (default: the seed's): per
    step the metrics (on a mesh with the LAN calls by shape, and whether
    every leaf of the parameters and state kept its storage), then the
    whole params and state after the last."""
    if params is None:
        params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(params, opt, strategy=strategy, npods=npods, mesh=mesh)
    params = init_pod_params(params, strategy=strategy, npods=npods, mesh=mesh)
    step = make_train_step(cfg, mesh=mesh, npods=npods, strategy=strategy, opt_cfg=opt, diloco_cfg=DILOCO,
                           device="cpu", donate=donate)
    rows, states = [], []
    for batch in batches:
        before = _local_ptrs((params, state.adam.m, state.adam.v, state.ef, state.diloco))
        params, state, metrics = step(params, state, batch)
        rows.append(_scalars(metrics))
        rows[-1]["storage_kept"] = before == _local_ptrs((params, state.adam.m, state.adam.v, state.ef, state.diloco))
        if getattr(step, "lan", None) is not None:
            rows[-1]["lan_shapes"] = dict(step.lan.shapes)
        if getattr(step, "lan", None) is not None:
            with step.lan:
                states.append(_np((full_tree(params), full_tree(state)._asdict())))
        else:
            states.append(_np((params, state._asdict())))
    return rows, states


def _serve(cfg, mesh, params, tokens, decode_tokens):
    prefill_step, placements = make_prefill_step(cfg, mesh, device="cpu")
    decode, dplace = make_decode_step(cfg, mesh, device="cpu")
    logits, cache = prefill_step(params, {"tokens": tokens}, max_len=PROMPT + GEN)
    out = [logits.numpy().copy()]
    for i, t in enumerate(decode_tokens):
        logits, cache = decode(params, t, cache, PROMPT + i)
        out.append(logits.numpy().copy())
    return out, {"cache": str(placements["cache"]), "tokens": str(dplace["tokens"])}


class _GroupInputs:
    """Within ``with``: for each group checkpoint of the model, its residual
    input's placements and local shape, and the local bytes saved for the
    backward there of tensors shaped as that input (``saved_tensors_hooks``
    around the call; what the checkpoint's forward saves inside goes
    through its own hooks)."""

    def __enter__(self):
        import torch.utils.checkpoint as ckpt

        self.mod, self.real, self.seen = ckpt, ckpt.checkpoint, []

        def wrapped(fn, x, *args, **kw):
            saved = []

            def pack(t):
                if tuple(t.shape) == tuple(x.shape):
                    local = t.to_local() if hasattr(t, "to_local") else t
                    saved.append(local.numel() * local.element_size())
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                out = self.real(fn, x, *args, **kw)
            self.seen.append({"placements": str(tuple(x.placements)), "local": tuple(x.to_local().shape),
                              "saved": sum(saved)})
            return out

        ckpt.checkpoint = wrapped
        return self.seen

    def __exit__(self, *exc):
        self.mod.checkpoint = self.real


def _rank_data_model(rank, train_in, serve_in, sp_in):
    """(a), (e), (h) and (i) on ``(data 2, model 2)``, ``(data 1, model 4)``
    and, over ranks 0 and 1, ``(data 1, model 2)``."""
    torch.set_num_threads(1)
    meshes = {shape: tmesh.make_mesh(shape, ("data", "model"), device="cpu") for shape in TP_MESHES}
    meshes[(1, 2)] = tmesh.make_mesh((1, 2), ("data", "model"), device="cpu", ranks=[0, 1])
    out = {"train": {}, "serve": {}, "group_inputs": {}}
    for (arch, shape, _), (params_np, batches) in zip(TRAIN_CASES, train_in):
        params = params_from_numpy(params_np, device="cpu")
        out["train"][_case_id(arch, shape)] = _train(
            get_smoke_config(arch), "hier", AdamWConfig(warmup_steps=1), batches, mesh=meshes[shape], params=params)
    for (key, _), (params_np, batches) in zip(SP_CASES, sp_in):
        if meshes[SP_MESH] is not None:
            with _GroupInputs() as seen:
                out["train"][key] = _train(dataclasses.replace(get_smoke_config(ARCH), **SP_OVER), "hier",
                                           AdamWConfig(warmup_steps=1), batches, mesh=meshes[SP_MESH],
                                           params=params_from_numpy(params_np, device="cpu"))
            out["group_inputs"][key] = seen
    mesh = meshes[(2, 2)]
    out["donated"] = _donated(get_smoke_config(ARCH), mesh, _batches(get_smoke_config(ARCH), 2))
    out["one_layer"] = _train(_one_layer(), "hier", OPT, train_in[0][1][:1], mesh=mesh)
    out["strided"] = _strided(mesh)
    for (arch, shape), (p_np, tokens, dec) in zip(SERVE_CASES, serve_in):
        if meshes[shape] is not None:
            out["serve"][_case_id(arch, shape)] = _serve(
                get_smoke_config(arch), meshes[shape], params_from_numpy(p_np, device="cpu"), tokens, dec)
    return out


def _donated(cfg, mesh, batches, functional=None):
    """(i): each of ``DONATED``'s functional (unless given) and donating
    runs on ``mesh`` -> {strategy: (functional run, donating run)}."""
    functional = functional or {s: _train(cfg, s, OPT, batches, mesh=mesh) for s in DONATED}
    return {s: (functional[s], _train(cfg, s, OPT, batches, mesh=mesh, donate=True)) for s in DONATED}


def _one_layer():
    """One layer: the stacked FFN's layer dim (1) does not divide ``model``,
    so the rule shards its width over ``("model", "data")``, a strided placement."""
    import dataclasses

    return dataclasses.replace(get_smoke_config(ARCH), num_layers=1)


def _strided(mesh):
    """A [2, 8] tensor placed by the few-expert rule's strided placement on
    its last dim: the rank's local slice, and the whole tensor back."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.distributed.lan import LanCollectives

    t = torch.arange(16.0).reshape(2, 8)
    dt = place_tree(t, tmesh.intra_pod_mesh(mesh), (_StridedShard(1, split_factor=2), Shard(1)))
    with LanCollectives(torch.device("cpu")):
        return dt.to_local().clone(), dt.full_tensor()


def _int8_hop(mesh, pod_grads, pod_ef, group):
    """The mesh step's ``hier_int8`` hop on seeded gradients: each piece's
    payload, and the synced gradient and new error feedback, whole."""
    from repro_torch.distributed.pod_group import PodGroup

    cfg = get_smoke_config(ARCH)
    intra = tmesh.intra_pod_mesh(mesh)
    pl = intra_placements(params_placements(init_params(cfg, device="meta"), mesh), mesh)
    pod = tmesh.pod_index(mesh)
    grads = place_tree(tree_map(lambda a: torch.from_numpy(a[pod]), pod_grads), intra, pl)
    ef = place_tree(tree_map(lambda a: torch.from_numpy(a[pod]), pod_ef), intra, pl)
    from repro_torch.distributed.lan import LanCollectives

    with LanCollectives(torch.device("cpu")):
        pieces, ef_pieces = _pieces(grads), _pieces(ef)
        payload = {k: (c.values.numpy().copy(), c.scales.numpy().copy())
                   for k, c in ((k, int8_compress(v.float() + ef_pieces[k])) for k, v in pieces.items())}
        synced, new_ef = sync_hier_int8_group(pieces, ef_pieces, PodGroup(group, device="cpu"))
        whole = full_tree((_unpieces(synced, grads), _unpieces(new_ef, ef)))
    return payload, _np(whole)


def _rank_pod_data(rank, pod_grads, pod_ef, ckpt_root):
    """(b), the int8 hop, (c) and (d) on ``(pod 2, data 2, model 1)``."""
    torch.set_num_threads(1)
    cfg = get_smoke_config(ARCH)
    mesh = tmesh.make_mesh((2, 2, 1), tmesh.AXES, device="cpu")
    batches = _batches(cfg, 2)
    out = {"train": {s: _train(cfg, s, OPT, batches, mesh=mesh) for s in STRATEGIES}}
    out["donated"] = _donated(cfg, mesh, batches, out["train"])
    out["int8"] = _int8_hop(mesh, pod_grads, pod_ef, tmesh.pod_process_group(mesh))
    whole = GeoTrainer(cfg, mesh, trainer_cfg=_tc("hier_int8", 4), checkpoint_dir=str(ckpt_root / "mesh"),
                       device="cpu").run()
    resumed = GeoTrainer(cfg, mesh, trainer_cfg=_tc("hier_int8", 4), checkpoint_dir=str(ckpt_root / "host_at2"),
                         device="cpu").run()
    out["ckpt"] = ([r["loss"] for r in whole["metrics"]], [r["loss"] for r in resumed["metrics"]])
    # (d): pod1 is lost; every rank takes part in the new groups, pod1's leave
    plan = plan_remesh(2, 1, data=2, model=1)
    new_mesh = plan.build(device="cpu")
    if new_mesh is None:
        out["remesh"] = None
        return out
    out["remesh"] = _step_from_checkpoint(cfg, new_mesh, ckpt_root / "mesh", survivor=True)
    return out


def _step_from_checkpoint(cfg, mesh, root, *, survivor):
    """One ``hier`` step on ``mesh`` from the step-4 checkpoint's parameters
    and AdamW state."""
    from repro_torch.checkpoint import CheckpointStore

    like_p = init_params(cfg, device="cpu")
    like = (like_p, TrainState(adam=init_adamw(like_p), ef=(), diloco=()))
    (params, state), _ = CheckpointStore(str(root)).restore(4, like)
    if survivor:
        params = reshard_tree(params, mesh)
    params = init_pod_params(params, mesh=mesh)
    state = place_train_state(state, mesh, strategy="hier")
    step = make_train_step(cfg, mesh=mesh, strategy="hier", opt_cfg=OPT, device="cpu")
    params, state, metrics = step(params, state, _batches(cfg, 1, seed=9)[0])
    with step.lan:
        params = full_tree(params)
    return {"mesh": (tmesh.mesh_shape(mesh), torch.distributed.get_world_size(tmesh.data_process_group(mesh))),
            "loss": float(metrics["loss"]), "params": _np(params)}


def _rank_fresh_data2(rank, ckpt_root):
    torch.set_num_threads(1)
    cfg = get_smoke_config(ARCH)
    return _step_from_checkpoint(cfg, tmesh.make_mesh((2, 1), ("data", "model"), device="cpu"),
                                 ckpt_root / "mesh", survivor=False)


def _tc(strategy, steps, **more):
    return TrainerConfig(seq_len=S, global_batch=B, steps=steps, strategy=strategy, checkpoint_every=2,
                         log_every=100, opt=OPT, diloco=DILOCO, **more)


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
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    params = jax.tree.map(jnp.asarray, params_np)
    mesh = make_mesh(shape, ("data", "model"))
    b_shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batches[0])
    with mesh:
        step, _ = make_train_step(cfg, mesh, opt_cfg=opt, strategy="hier", params_shapes=params_specs(cfg),
                                  batch_shapes=b_shapes, donate=False)
        state = init_train_state(params, opt, strategy="hier")
        losses = []
        for b in batches:
            params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    out[key] = {"losses": losses, "params": jax.tree.map(np.asarray, params),
                "m": jax.tree.map(np.asarray, state.adam.m)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _jax_params_np(arch):
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import init_params as jax_init_params

    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jax_smoke(arch)))


def _start_jax(tmp, cases):
    src, dst = tmp / "jax_in.pkl", tmp / "jax_out.pkl"
    src.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(src), str(dst)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return proc, dst


def _pod_tree(seed):
    """Per-pod float32 gradients [2, ...] shaped as the smoke parameters."""
    rng = np.random.default_rng(seed)
    shapes = init_params(get_smoke_config(ARCH), device="meta")
    return tree_map(lambda t: (rng.standard_normal((2, *t.shape)) * 3).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def dm_run(tmp_path_factory):
    """(a) and (e): the JAX mesh step in a subprocess beside a 4-rank spawn."""
    tmp = tmp_path_factory.mktemp("data_model")
    train_in = [(_jax_params_np(arch), _batches(get_smoke_config(arch), steps, seed=11))
                for arch, _, steps in TRAIN_CASES]
    sp_in = [(_jax_params_np(ARCH), _batches(get_smoke_config(ARCH), 2, seq=seq, seed=12)) for _, seq in SP_CASES]
    proc, dst = _start_jax(tmp, [(_case_id(arch, shape), arch, shape, {}, *inputs)
                                 for (arch, shape, _), inputs in zip(TRAIN_CASES, train_in)]
                           + [(key, ARCH, SP_MESH, SP_OVER, *inputs) for (key, _), inputs in zip(SP_CASES, sp_in)])
    rng = np.random.default_rng(6)
    serve_in = []
    for arch, _ in SERVE_CASES:
        c = get_smoke_config(arch)
        tokens = torch.from_numpy(rng.integers(0, c.vocab_size, (4, PROMPT)))
        dec = [torch.from_numpy(rng.integers(0, c.vocab_size, (4,))) for _ in range(GEN)]
        serve_in.append((_jax_params_np(arch), tokens, dec))
    try:
        ranks = spawn(_rank_data_model, 4, train_in, serve_in, sp_in, device="cpu", join_timeout_s=300)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    return {"ranks": ranks, "jax": pickle.loads(dst.read_bytes()), "serve_in": serve_in}


@pytest.fixture(scope="module")
def pd_run(tmp_path_factory):
    """(b), (c), (d): the 4-rank ``(pod 2, data 2)`` spawn, the one-process
    references and a fresh 2-rank ``(data 2)`` spawn."""
    root = tmp_path_factory.mktemp("pod_data")
    cfg = get_smoke_config(ARCH)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        host = {s: _train(cfg, s, OPT, _batches(cfg, 2), npods=2) for s in STRATEGIES}
        host_run = GeoTrainer(cfg, trainer_cfg=_tc("hier_int8", 4, npods=2), checkpoint_dir=str(root / "host"),
                              device="cpu").run()
        _keep_step(root / "host", root / "host_at2", 2)
        pod_grads, pod_ef = _pod_tree(0), tree_map(lambda a: a * 0.01, _pod_tree(1))
        ranks = spawn(_rank_pod_data, 4, pod_grads, pod_ef, root, device="cpu", join_timeout_s=300)
        _keep_step(root / "mesh", root / "mesh_at2", 2)
        from_mesh = GeoTrainer(cfg, trainer_cfg=_tc("hier_int8", 4, npods=2), checkpoint_dir=str(root / "mesh_at2"),
                               device="cpu").run()
        fresh = spawn(_rank_fresh_data2, 2, root, device="cpu", join_timeout_s=120)
    finally:
        torch.set_num_threads(before)
    return {"ranks": ranks, "host": host, "host_run": host_run, "from_mesh": from_mesh, "fresh": fresh,
            "pod_grads": pod_grads, "pod_ef": pod_ef, "root": root}


def _keep_step(src, dst, step):
    dst.mkdir(parents=True)
    shutil.copytree(src / f"step_{step:08d}", dst / f"step_{step:08d}")
    shutil.copy(src / f"step_{step:08d}.COMMITTED", dst)


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_items(tree)}


def _close_but_cancelling_lanes(got, want, lr, what, *, rtol=RTOL, atol=ATOL):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    off = total = 0
    for k, w in want.items():
        g = got[k]
        bad = np.abs(g - w) > atol + rtol * np.abs(w)
        assert (np.abs(g - w)[bad] <= 2 * lr + 1e-7).all(), f"{what} {k}: beyond 2 lr"
        off += int(bad.sum())
        total += w.size
    assert off < 1e-3 * total, f"{what}: {off} of {total} values beyond rtol {rtol}"


# -- (a) the JAX mesh step -----------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [(a, m) for a, m, _ in TRAIN_CASES],
                         ids=[_case_id(a, m) for a, m, _ in TRAIN_CASES])
def test_data_model_step_matches_jax_mesh_step(dm_run, arch, shape):
    key = _case_id(arch, shape)
    want = dm_run["jax"][key]
    for r, rank in enumerate(dm_run["ranks"]):
        rows, states = rank["train"][key]
        params = states[-1][0]
        np.testing.assert_allclose([x["loss"] for x in rows], want["losses"], rtol=1e-5, err_msg=f"rank {r}")
        got, ref = _flat(params), _flat(want["params"])
        assert set(got) == set(ref)
        if arch == ARCH:
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5, err_msg=f"rank {r} {k}")
        else:
            _close_but_eps_lanes(got, ref, _flat(want["m"]), len(rows), f"{key} rank {r}")


def _close_but_eps_lanes(got, ref, moment, steps, what, atol=2e-5):
    """atol 2e-5 but on lanes whose mean gradient (the JAX step's bias-
    corrected first moment) is below 10 x AdamW's eps: there the first
    step's g / (|g| + eps) is linear in a gradient at float32 noise level,
    so its summation order (DTensor's against GSPMD's) moves the parameter
    by up to lr, which bounds such a lane; fewer than 1e-4 of all values may
    leave atol (``test_torch_train.py``'s rule; measured: one embed lane of
    yi-34b on (data 2, model 2), off by 2.12e-5)."""
    cfg = AdamWConfig()
    exempt = total = 0
    for k, want in ref.items():
        flat = np.abs(moment[k]) / (1 - cfg.b1 ** steps) < 10 * cfg.eps
        diff = np.abs(got[k] - want)
        assert (diff[~flat] <= atol).all(), f"{what} {k}: {diff[~flat].max()} > {atol}"
        assert (diff[flat] <= cfg.lr).all(), f"{what} {k}"
        exempt += int((diff[flat] > atol).sum())
        total += want.size
    assert exempt < 1e-4 * total, f"{what}: {exempt} of {total} values off by more than {atol}"


def test_strided_placement_is_model_major(dm_run):
    """Rank (data i, model j) holds piece j * 2 + i of the dim, and the
    pieces gather back to the tensor."""
    t = torch.arange(16.0).reshape(2, 8)
    for r, rank in enumerate(dm_run["ranks"]):
        local, whole = rank["strided"]
        i, j = divmod(r, 2)
        assert torch.equal(local, t[:, 2 * (j * 2 + i):2 * (j * 2 + i) + 2]), r
        assert torch.equal(whole, t), r


def test_one_layer_step_with_a_strided_ffn_matches_one_process(dm_run):
    """A one-layer model on ``(data 2, model 2)``: its FFN placed by the
    strided few-expert rule; one step's loss and parameters against the
    one-process step, as (b) holds a first step."""
    cfg = _one_layer()
    placements = params_placements(init_params(cfg, device="meta"), {"data": 2, "model": 2})
    assert "_StridedShard" in type(placements["groups"]["slot0"]["ffn"]["w_up"][0]).__name__
    rows, states = _train(cfg, "hier", OPT, _batches(get_smoke_config(ARCH), 2, seed=11)[:1])
    for r, rank in enumerate(dm_run["ranks"]):
        got_rows, got_states = rank["one_layer"]
        np.testing.assert_allclose(got_rows[0]["loss"], rows[0]["loss"], rtol=RTOL, err_msg=f"rank {r}")
        _close_but_cancelling_lanes(got_states[0][0], states[0][0], OPT.lr, f"one layer rank {r}")


def test_data_model_step_counts_lan_not_wan(dm_run):
    for rank in dm_run["ranks"]:
        rows, _ = rank["train"][_case_id(ARCH, (2, 2))]
        for row in rows:
            assert row["wan_bytes"] == 0 and row["wan_bytes_rank"] == 0
            assert row["lan_bytes"] > 0 and row["lan_s"] > 0


# -- (h) sequence parallelism -------------------------------------------------------


@pytest.mark.parametrize("key", [k for k, _ in SP_CASES])
def test_sequence_parallel_step_matches_jax_mesh_step(dm_run, key):
    want = dm_run["jax"][key]
    assert all(key not in rank["train"] for rank in dm_run["ranks"][2:])
    for r, rank in enumerate(dm_run["ranks"][:2]):
        rows, states = rank["train"][key]
        np.testing.assert_allclose([x["loss"] for x in rows], want["losses"], rtol=1e-5, err_msg=f"{key} rank {r}")
        got, ref = _flat(states[-1][0]), _flat(want["params"])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5, err_msg=f"{key} rank {r} {k}")


@pytest.mark.parametrize("key,seq", SP_CASES)
def test_group_residuals_are_sequence_shards_over_model(dm_run, key, seq):
    cfg = get_smoke_config(ARCH)
    split = seq % SP_MESH[1] == 0
    local = (B, seq // SP_MESH[1] if split else seq, cfg.d_model)
    placed = "(Replicate(), Shard(dim=1))" if split else "(Replicate(), Replicate())"
    for r, rank in enumerate(dm_run["ranks"][:2]):
        seen = rank["group_inputs"][key]
        assert len(seen) == 2 * cfg.num_groups, seen  # one checkpoint a group a step
        assert [c["placements"] for c in seen] == [placed] * len(seen), f"rank {r}"
        assert [c["local"] for c in seen] == [local] * len(seen), f"rank {r}"
        for i in range(2):
            step = seen[i * cfg.num_groups:(i + 1) * cfg.num_groups]
            assert sum(c["saved"] for c in step) == cfg.num_groups * math.prod(local) * 4, f"rank {r} step {i}"


@pytest.mark.parametrize("key,seq", SP_CASES)
def test_sequence_parallel_reduce_scatters_row_parallel_outputs(dm_run, key, seq):
    d = get_smoke_config(ARCH).d_model
    whole = ("all_reduce", (B, seq, d))
    for r, rank in enumerate(dm_run["ranks"][:2]):
        for i, row in enumerate(rank["train"][key][0]):
            shapes = row["lan_shapes"]
            if seq % SP_MESH[1]:  # the ragged sequence stays whole: its partial sums are all-reduced
                assert shapes.get(whole, 0) > 0, (r, i, shapes)
                continue
            assert shapes.get(("reduce_scatter_tensor", (SP_MESH[1] * B, seq // SP_MESH[1], d)), 0) > 0, (r, i)
            assert whole not in shapes, (r, i, shapes)


def test_remat_recomputation_sees_the_activation_context_on_another_thread(monkeypatch):
    """On the card autograd runs a checkpoint's recomputation on its device
    thread, where the step's context variable is unset; the stack's
    checkpoint re-enters the forward's context there.  Emulated in one
    process: the backward taken on a new thread, every block entry's
    context recorded."""
    import threading

    from repro_torch.distributed import act_sharding
    from repro_torch.models import loss_fn

    seen, real = [], act_sharding.replicate_seq

    def spy(x):
        seen.append(act_sharding._SPEC.get())
        return real(x)

    monkeypatch.setattr(act_sharding, "replicate_seq", spy)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **SP_OVER)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    leaves = [t.requires_grad_(True) for _, t in tree_items(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    with act_sharding.activation_sharding("data", "model"):
        loss, _ = loss_fn(params, batch, cfg)
    forward = len(seen)
    done = []
    worker = threading.Thread(target=lambda: done.append(torch.autograd.grad(loss, leaves)))
    worker.start()
    worker.join()
    assert done and forward > 0 and len(seen) > forward  # the recomputation gathered again
    assert set(seen) == {("data", "model")}, seen


# -- (i) the donating step -------------------------------------------------------------


def _assert_donated_bits(pair, what):
    (rows, states), (got_rows, got_states) = pair
    timed = ("lan_s", "collective_s", "storage_kept")
    for i, (want, got) in enumerate(zip(rows, got_rows, strict=True)):
        assert got["storage_kept"], f"{what} step {i + 1}: a leaf left its storage"
        assert {k: v for k, v in got.items() if k not in timed} == {k: v for k, v in want.items()
                                                                        if k not in timed}, f"{what} step {i + 1}"
    for i, (want, got) in enumerate(zip(states, got_states, strict=True)):
        want, got = _flat(want), _flat(got)
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} step {i + 1} {k}")


@pytest.mark.parametrize("strategy", DONATED)
def test_donating_data_model_step_gives_the_same_bits_in_the_same_storage(dm_run, strategy):
    for r, rank in enumerate(dm_run["ranks"]):
        _assert_donated_bits(rank["donated"][strategy], f"(data 2, model 2) {strategy} rank {r}")


@pytest.mark.parametrize("strategy", DONATED)
def test_donating_pod_data_step_gives_the_same_bits_in_the_same_storage(pd_run, strategy):
    for r, rank in enumerate(pd_run["ranks"]):
        _assert_donated_bits(rank["donated"][strategy], f"(pod 2, data 2) {strategy} rank {r}")


# -- (b) the five strategies against the one-process step -----------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pod_data_step_matches_one_process(pd_run, strategy):
    ref_rows, ref_states = pd_run["host"][strategy]
    for r, rank in enumerate(pd_run["ranks"]):
        rows, states = rank["train"][strategy]
        np.testing.assert_allclose([x["loss"] for x in rows], [x["loss"] for x in ref_rows], rtol=RTOL,
                                   err_msg=f"rank {r}")
        assert [x["wan_bytes"] for x in rows] == [x["wan_bytes"] for x in ref_rows], f"rank {r}"
        for i, (rtol, atol) in enumerate(((RTOL, ATOL), (1e-3, 1e-6))):
            params, ref_params = states[i][0], ref_states[i][0]
            if strategy == "local_sgd":  # the one-process step keeps one replica per pod
                ref_params = tree_map(lambda a: a[r // 2], ref_params)
            _close_but_cancelling_lanes(params, ref_params, OPT.lr, f"{strategy} rank {r} step {i + 1}",
                                        rtol=rtol, atol=atol)


def test_pod_data_wan_bytes_split_over_the_pods_ranks(pd_run):
    """Each pod's ranks hand the WAN disjoint pieces: their counted bytes sum
    to the pod's, which equal the one-process step's analytic bytes."""
    for s in STRATEGIES:
        for pod in (0, 1):
            per_rank = [pd_run["ranks"][r]["train"][s][0] for r in (2 * pod, 2 * pod + 1)]
            for i, (a, b) in enumerate(zip(*per_rank)):
                assert a["wan_bytes_rank"] + b["wan_bytes_rank"] == a["wan_bytes"] == b["wan_bytes"], (s, i)


def test_int8_hop_payload_is_the_global_arrays_bit_for_bit(pd_run):
    grads, ef = pd_run["pod_grads"], pd_run["pod_ef"]
    ranks = pd_run["ranks"]
    stacked_synced, stacked_ef, _ = sync_hier_int8(tree_map(torch.from_numpy, grads), tree_map(torch.from_numpy, ef))
    for pod in (0, 1):
        want = {k: int8_compress(torch.from_numpy(g[pod] + e[pod]))
                for (k, g), (_, e) in zip(tree_items(grads), tree_items(ef))}
        for k, c in want.items():
            pieces = [ranks[r]["int8"][0].get(k) for r in (2 * pod, 2 * pod + 1)]
            pieces = [p for p in pieces if p is not None]
            values = np.concatenate([p[0].reshape(-1, p[0].shape[-1]) for p in pieces])
            scales = np.concatenate([p[1].reshape(-1, p[1].shape[-1]) for p in pieces])
            np.testing.assert_array_equal(values, c.values.numpy().reshape(-1, c.values.shape[-1]), err_msg=k)
            np.testing.assert_array_equal(scales, c.scales.numpy().reshape(-1, c.scales.shape[-1]), err_msg=k)
        for r in (2 * pod, 2 * pod + 1):
            synced, new_ef = ranks[r]["int8"][1]
            for (k, got), (_, w) in zip(tree_items(synced), tree_items(_np(stacked_synced))):
                np.testing.assert_array_equal(got, w, err_msg=k)
            for (k, got), (_, w) in zip(tree_items(new_ef), tree_items(_np(stacked_ef))):
                np.testing.assert_array_equal(got, w[pod], err_msg=k)


# -- (c) checkpoints both ways -------------------------------------------------------


def test_mesh_trainer_checkpoints_move_both_ways(pd_run):
    host = [r["loss"] for r in pd_run["host_run"]["metrics"]]
    for r, rank in enumerate(pd_run["ranks"]):
        whole, resumed = rank["ckpt"]
        np.testing.assert_allclose(whole, host, rtol=RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(resumed, host[2:], rtol=RTOL, err_msg=f"rank {r} resumed")
    np.testing.assert_allclose([r["loss"] for r in pd_run["from_mesh"]["metrics"]], host[2:], rtol=RTOL)


def test_mesh_checkpoint_restores_in_the_jax_store(pd_run):
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointStore as JaxStore
    from repro.distributed.steps import TrainState as JaxTrainState
    from repro.optim.adamw import AdamWState as JaxAdamWState

    from repro_torch.checkpoint import CheckpointStore

    root = pd_run["root"] / "mesh"
    params = init_params(get_smoke_config(ARCH), device="cpu")
    zeros = tree_map(lambda t: np.zeros(tuple(t.shape), np.float32), params)
    stacked = tree_map(lambda a: np.zeros((2, *a.shape), np.float32), zeros)
    jlike = (zeros, JaxTrainState(adam=JaxAdamWState(step=np.zeros((), np.int32), m=zeros, v=zeros), ef=stacked,
                                  diloco=()))
    theirs, meta = JaxStore(str(root)).restore(4, jax.tree.map(jnp.asarray, jlike))
    assert meta == {"data_step": 4}
    like = (params, TrainState(adam=init_adamw(params), ef=tree_map(lambda t: torch.zeros((2, *t.shape)), params),
                               diloco=()))
    ours, _ = CheckpointStore(str(root)).restore(4, like)
    got, want = jax.tree.leaves(theirs), jax.tree.leaves(_np(ours))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


# -- (d) the elastic re-mesh ----------------------------------------------------------


def test_remesh_survivors_step_equals_a_fresh_data2_run(pd_run):
    ranks, fresh = pd_run["ranks"], pd_run["fresh"]
    assert [r["remesh"] is None for r in ranks] == [False, False, True, True]
    for r in (0, 1):
        got, want = ranks[r]["remesh"], fresh[r]
        assert got["mesh"] == ({"data": 2, "model": 1}, 2) == want["mesh"]
        assert got["loss"] == want["loss"]
        for (k, g), (_, w) in zip(tree_items(got["params"]), tree_items(want["params"])):
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_meshplan_build_in_one_process_is_a_local_mesh():
    from repro_torch.runtime.elastic import MeshPlan

    assert isinstance(MeshPlan((1,), ("data",), 1, "").build(device="cpu"), tmesh.LocalMesh)
    tree = {"w": torch.ones(2, 3)}
    assert reshard_tree(tree, tmesh.LocalMesh({"data": 1})) is tree


# -- (e) serving on the mesh ------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(SERVE_CASES)),
                         ids=[a if m == (2, 2) and a in (ARCH, "rwkv6-7b") else _case_id(a, m) for a, m in SERVE_CASES])
def test_mesh_prefill_and_decode_match_one_process(dm_run, case):
    arch, shape = SERVE_CASES[case]
    cfg = get_smoke_config(arch)
    p_np, tokens, dec = dm_run["serve_in"][case]
    params = params_from_numpy(p_np, device="cpu")
    logits, cache = prefill(params, {"tokens": tokens}, cfg, max_len=PROMPT + GEN)
    want = [logits.numpy().copy()]
    for i, t in enumerate(dec):
        logits, cache = decode_step(params, t, cache, cfg, PROMPT + i)
        want.append(logits.numpy().copy())
    ranks = dm_run["ranks"][:2] if shape == (1, 2) else dm_run["ranks"]
    assert all(_case_id(arch, shape) not in rank["serve"] for rank in dm_run["ranks"][len(ranks):])
    for r, rank in enumerate(ranks):
        got, placements = rank["serve"][_case_id(arch, shape)]
        assert "Shard(dim=1)" in placements["cache"] and placements["tokens"] == "(Shard(dim=0), Replicate())"
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"rank {r} call {i}")


# -- (f) the launcher ---------------------------------------------------------------------


def test_train_cli_runs_a_pod_data_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--mesh", "group", "--pods", "2",
         "--data", "2", "--steps", "1", "--seq-len", "16", "--strategy", "hier_int8",
         "--checkpoint-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rank 3:" in out.stdout and "LAN bytes" in out.stdout


def test_train_cli_single_mesh_needs_its_world():
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="256 devices .* world of 1 ranks"):
        train.main(["--device", "cpu", "--mesh", "single"])


# -- (g) the card's parameter bar ---------------------------------------------------------


def _distance(a, b) -> float:
    """The norm of ``a - b`` over every leaf, in float64."""
    return sum(float(np.square(np.float64(x) - np.float64(y)).sum())
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b))) ** 0.5


@pytest.mark.parametrize("strategy, steps", [("allreduce", 3), ("hier_int8", 6)])
def test_train_mesh_parameter_bar_catches_a_rank_on_half_its_rows(strategy, steps):
    """Each pod of 2 ranks of 4 rows: a data rank that trains on its even
    rows only (its odd rows replaced by the even ones) against the whole
    batch, in one process, on ``chip_smoke.py``'s optimizer schedule."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_smoke_config(ARCH)
    opt = AdamWConfig(lr=1e-3, warmup_steps=smoke.WARMUP, total_steps=smoke.STEPS)
    loader = loader_for_model(cfg, seq_len=64, global_batch=16, seed=0)
    batches = [loader.next_batch() for _ in range(steps)]
    halved = [{k: np.repeat(v[0::2], 2, axis=0) for k, v in b.items()} for b in batches]
    init = _np(init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    ref, bad = (_train(cfg, strategy, opt, bs, npods=2)[1][-1][0] for bs in (batches, halved))
    change, diff = _distance(ref, init), _distance(bad, ref)
    assert diff > 2 * smoke.MESH_PARAM_RTOL * change, (diff, change)
