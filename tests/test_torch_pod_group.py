"""The pod axis as a process group, on the CPU: one rank per pod over gloo.

One module-scoped spawn per world size (2 and 4 ranks, smoke config of
distilgpt2-82m: 2 layers, d_model 64, seq 32, 4 rows a pod) runs every
rank's share of the cases below; each rank joins its group through a
``FileStore`` in the test's temporary directory, so xdist workers never
share a port, and the spawn kills its ranks if they outlive its timeout.
The parent holds what the ranks return:

1. three group steps of each strategy against the one-process stacked
   step (itself held to the JAX functions under ``jax.vmap(...,
   axis_name="pod")`` in ``test_torch_train.py``): params, AdamW state,
   error feedback, DiLoCo anchor and momentum, loss, metrics, wan_bytes.
   Bit for bit on 2 ranks, and on 4 for ``hier_int8`` and ``ps``, whose
   sums over pods run over gathered payloads in rank order.  A 4-rank
   ``all_reduce`` sums in gloo's ring order, not the stacked step's, so
   ``allreduce``, ``hier`` and the DiLoCo delta mean hold at float32
   rtol 1e-6 over one step (the first step, for local_sgd its first outer
   step), with atol 1e-8, one float32 ulp at the operands' scale (~0.1),
   for values that nearly cancel (anchor - lr * step).  After AdamW's first
   step the parameters are held so but on lanes whose mean gradient is
   below 100 x eps (|m_hat| < 1e-6): there g / (|g| + eps) has a slope of
   up to 1 / eps in a gradient whose summation-order error is a few ulp of
   the pods' own gradients, so the parameter moves by up to lr; such lanes
   are held to lr and may be fewer than 1e-3 of all values
   (test_torch_train.py's rule for the same effect, there at 10 x eps and
   1e-4 of the values of a 2-pod step);
2. one call of each group sync against ``jax.vmap`` of the JAX ``sync_*``
   functions and ``outer_step`` on the same numpy inputs, and against the
   stacked forms: exact on 2 pods (a two-term sum commutes); on 4, exact
   against the stacked ``hier_int8`` and ``ps``, and otherwise within
   1e-6 of the terms summed (|error| <= 1e-6 x the mean over pods of the
   summands' magnitudes, times the output's gain on the mean: the bound of
   a reordered float32 sum, which cancellation leaves far from the sum's
   own magnitude); the error feedback exact everywhere;
3. the bytes each group counted against ``full_precision_bytes``,
   ``ps_bytes`` and the stacked ``hier_int8`` payload;
4. the mesh helpers against the JAX package's on meshes of the same shape;
5. ``make_prefill_step`` / ``make_decode_step`` against JAX ``prefill`` /
   ``decode_step`` (float32 1e-4, test_torch_serve.py's bar);
6. a mesh the world cannot hold (wide ``data``/``model`` axes, the
   production meshes, in one process) raising the world-size ``ValueError``;

and, on 2 ranks, checkpoints written by a group run resumed by the
one-process trainer and the reverse, losses equal to the uninterrupted
run's, and the single pod count of ``GeoTrainer``.

Every one-process reference runs on one thread, as every rank does, so
that CPU reductions split alike.
"""

from __future__ import annotations

import contextlib
import functools
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import loader_for_model
from repro_torch.distributed import (
    PodGroup,
    full_precision_bytes,
    group_wan_bytes,
    init_pod_params,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    ps_bytes,
    pull_params_group,
    spawn,
    sync_allreduce,
    sync_allreduce_group,
    sync_hier,
    sync_hier_group,
    sync_hier_int8,
    sync_hier_int8_group,
    sync_ps,
    sync_ps_group,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, DilocoConfig, DilocoState, outer_step, outer_step_group
from repro_torch.runtime import GeoTrainer, TrainerConfig
from repro_torch.tree import tree_items, tree_map

ARCH = "distilgpt2-82m"
STRATEGIES = ("allreduce", "hier", "hier_int8", "ps", "local_sgd")
OPT = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5, weight_decay=0.1)
DILOCO = DilocoConfig(sync_every=2)
STEPS, SEQ, ROWS = 3, 32, 4  # ROWS a pod
RTOL_4, ATOL_4 = 1e-6, 1e-8  # 4 ranks: gloo's all-reduce order
PROMPT, GEN_STEPS = 12, 2
CKPT_STRATEGIES = ("hier_int8", "local_sgd")
# bit for bit on 4 ranks: every sum over pods runs over gathered payloads
EXACT_ON_4 = ("hier_int8", "ps")


@contextlib.contextmanager
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy() if torch.is_tensor(t) else t, tree)


def _scalars(metrics):
    return {k: (v.item() if torch.is_tensor(v) else v) for k, v in metrics.items()}


# -- what each rank (and the one-process reference) runs ------------------------------


def _train(strategy, *, mesh=None, npods=None):
    """STEPS steps from the seed's weights: per step the metrics, and the
    params and state after the first step, the first outer step and the last."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(params, OPT, strategy=strategy, npods=npods, mesh=mesh)
    params = init_pod_params(params, strategy=strategy, npods=npods, mesh=mesh)
    step = make_train_step(cfg, mesh=mesh, npods=npods, strategy=strategy, opt_cfg=OPT, diloco_cfg=DILOCO,
                           device="cpu")
    pods = npods or tmesh.num_pods(mesh)
    loader = loader_for_model(cfg, seq_len=SEQ, global_batch=ROWS * pods, seed=3)
    rows, states = [], {}
    for i in range(STEPS):
        params, state, metrics = step(params, state, loader.next_batch())
        rows.append(_scalars(metrics))
        if i + 1 in (1, DILOCO.sync_every, STEPS):
            states[i + 1] = _np((params, state._asdict()))
    return rows, states


def _pod_tree(seed, world):
    """Per-pod float32 leaves [world, ...]: a 0-d, a ragged, a stacked one."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (), "b": (7,), "c": (3, 300), "d": {"e": (6, 64, 256), "f": (5, 512)}}

    def draw(s):
        return (rng.standard_normal((world, *s)) * 3).astype(np.float32)

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else draw(t)

    return walk(shapes)


def _own(tree, rank):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a[rank])), tree)


def _syncs(mesh, world, rank):
    """One call of each group sync on this rank's slice of seeded inputs,
    with the bytes each handed to the collectives."""
    group = PodGroup(tmesh.pod_process_group(mesh), device="cpu")
    grads = _own(_pod_tree(0, world), rank)
    out = {}

    def run(name, fn):
        group.reset()
        out[name] = (_np(fn()), dict(group.handed))

    run("allreduce", lambda: sync_allreduce_group(grads, group))
    run("hier", lambda: sync_hier_group(grads, group, num_channels=4))
    ef = tree_map(lambda t: t * 0.01, _own(_pod_tree(1, world), rank))
    run("hier_int8", lambda: sync_hier_int8_group(grads, ef, group))
    params = _own(_pod_tree(2, world), rank)

    def ps():
        g_mean = sync_ps_group(grads, group)
        return g_mean, pull_params_group(tree_map(lambda p, g: p - 0.5 * g, params, g_mean), group)

    run("ps", ps)
    shared = _own(_pod_tree(3, world), 0)
    diloco = DilocoState(anchor=shared, momentum=tree_map(lambda t: t * 0.1, _own(_pod_tree(4, world), 0)))
    run("local_sgd", lambda: outer_step_group(DilocoConfig(), params, diloco, group))
    return out


def _serve(mesh, params_np, tokens, decode_tokens):
    from repro_torch.convert import params_from_numpy

    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(params_np, device="cpu")
    prefill_step, placements = make_prefill_step(cfg, mesh, device="cpu")
    decode, _ = make_decode_step(cfg, mesh, device="cpu")
    logits, cache = prefill_step(params, {"tokens": tokens}, max_len=PROMPT + GEN_STEPS)
    out = [logits.numpy().copy()]
    for i, t in enumerate(decode_tokens):
        logits, cache = decode(params, t, cache, PROMPT + i)
        out.append(logits.numpy().copy())
    return out, {k: _pod_entries(v) for k, v in placements.items()}


def _placement_leaves(tree):
    """The placement tuples of a placements tree (dicts and lists are its nodes)."""
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _placement_leaves(v)]
    if isinstance(tree, list):
        return [p for v in tree for p in _placement_leaves(v)]
    return [tree]


def _pod_entries(tree):
    """The distinct names of the placements over the pod dimension (the first)."""
    return sorted({type(pl[0]).__name__ for pl in _placement_leaves(tree)})


def _tc(strategy, steps, **more):
    return TrainerConfig(seq_len=SEQ, global_batch=2 * ROWS, steps=steps, strategy=strategy, checkpoint_every=2,
                         log_every=100, opt=OPT, diloco=DILOCO, **more)


def _rank_work(rank, world, params_np, tokens, decode_tokens, ckpt_root):
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    mesh = tmesh.make_host_mesh(pods=world, device="cpu")
    pod_only = tmesh.make_mesh((world,), ("pod",), device="cpu")
    out = {
        "mesh": [(isinstance(m, DeviceMesh), tuple(m.mesh_dim_names), tmesh.num_pods(m), tmesh.chips_per_pod(m),
                  tmesh.batch_axes(m)) for m in (mesh, pod_only)],
        "train": {s: _train(s, mesh=mesh) for s in STRATEGIES},
        "sync": _syncs(mesh, world, rank),
        "serve": _serve(mesh, params_np, tokens, decode_tokens),
    }
    if ckpt_root is not None:  # 2 ranks: the cross-path checkpoints
        cfg = get_smoke_config(ARCH)
        out["ckpt"] = {}
        for s in CKPT_STRATEGIES:
            whole = GeoTrainer(cfg, mesh, trainer_cfg=_tc(s, 4), checkpoint_dir=str(ckpt_root / f"group_{s}"),
                               device="cpu").run(inject_failure_at=1)
            resumed = GeoTrainer(cfg, mesh, trainer_cfg=_tc(s, 4), checkpoint_dir=str(ckpt_root / f"host_{s}_at2"),
                                 device="cpu").run()
            out["ckpt"][s] = (whole, resumed)
    return out


# -- the parent's side ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_params_np():
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import init_params as jax_init_params

    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jax_smoke(ARCH)))


def _host_trainer(strategy, steps, directory):
    return GeoTrainer(get_smoke_config(ARCH), trainer_cfg=_tc(strategy, steps, npods=2),
                      checkpoint_dir=str(directory), device="cpu")


def _keep_step(src, dst, step):
    dst.mkdir(parents=True)
    shutil.copytree(src / f"step_{step:08d}", dst / f"step_{step:08d}")
    shutil.copy(src / f"step_{step:08d}.COMMITTED", dst)


_RUNS = {}


def _spawned(world, tmp_path_factory):
    """Spawn ``world`` ranks once per module; the one-process references beside them."""
    if world not in _RUNS:
        _RUNS[world] = _spawn_run(world, tmp_path_factory.mktemp(f"pods{world}"))
    return _RUNS[world]


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def run(request, tmp_path_factory):
    return _spawned(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    """The 2-rank spawn, which also holds the checkpoint cases."""
    return _spawned(2, tmp_path_factory)


def _spawn_run(world, root):
    rng = np.random.default_rng(5)
    cfg = get_smoke_config(ARCH)
    tokens = rng.integers(0, cfg.vocab_size, (2 * world, PROMPT))
    decode_tokens = [rng.integers(0, cfg.vocab_size, (2 * world,)) for _ in range(GEN_STEPS)]
    params_np = _jax_params_np()
    host = {}
    ckpt_root = None
    with _one_thread():
        host["train"] = {s: _train(s, npods=world) for s in STRATEGIES}
        if world == 2:
            ckpt_root = root / "ckpt"
            host["ckpt"] = {}
            for s in CKPT_STRATEGIES:
                whole = _host_trainer(s, 4, ckpt_root / f"host_{s}").run(inject_failure_at=1)
                _keep_step(ckpt_root / f"host_{s}", ckpt_root / f"host_{s}_at2", 2)
                host["ckpt"][s] = whole
    ranks = spawn(_rank_work, world, world, params_np, tokens, decode_tokens, ckpt_root, device="cpu",
                  join_timeout_s=240)
    if world == 2:
        with _one_thread():
            for s in CKPT_STRATEGIES:
                _keep_step(ckpt_root / f"group_{s}", ckpt_root / f"group_{s}_at2", 2)
                host["ckpt_resumed"] = host.get("ckpt_resumed", {})
                host["ckpt_resumed"][s] = _host_trainer(s, 4, ckpt_root / f"group_{s}_at2").run()
    return {"world": world, "ranks": ranks, "host": host, "tokens": tokens, "decode_tokens": decode_tokens,
            "params_np": params_np}


def _assert_trees(got, want, what, *, exact=True):
    got, want = dict(tree_items(got)), dict(tree_items(want))
    assert set(got) == set(want), what
    for path, w in want.items():
        g = got[path]
        if isinstance(w, np.ndarray):
            if exact:
                np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL_4, atol=ATOL_4, err_msg=f"{what} {path}")
        else:
            assert g == w, f"{what} {path}"


def _close_to_sum(got, want, scale, what):
    """4 pods, another summation order: |got - want| <= RTOL_4 x scale."""
    got, want, scale = dict(tree_items(got)), dict(tree_items(want)), dict(tree_items(scale))
    assert set(got) == set(want), what
    for path, w in want.items():
        bad = np.abs(got[path] - w) > RTOL_4 * scale[path]
        assert not bad.any(), f"{what} {path}: {int(bad.sum())} values beyond {RTOL_4} x the summed terms"


def _sum_scales(strategy, world):
    """Per output leaf, the mean over pods of the summands' magnitudes
    times the output's gain on their mean."""
    mean_abs = lambda t: np.abs(t).mean(0)  # noqa: E731
    grads = tree_map(mean_abs, _pod_tree(0, world))
    if strategy in ("allreduce", "hier"):
        return grads
    if strategy == "hier_int8":  # the dequantised g + ef, close to g + ef
        boosted = tree_map(lambda g, e: g + np.float32(0.01) * e, _pod_tree(0, world), _pod_tree(1, world))
        return tree_map(mean_abs, boosted), None
    if strategy == "ps":  # (the mean, p0 - 0.5 x the mean)
        return grads, tree_map(lambda g: 0.5 * g, grads)
    anchor = tree_map(lambda a: a[0], _pod_tree(3, world))
    deltas = tree_map(lambda a, p: np.abs(a[None] - p).mean(0), anchor, _pod_tree(2, world))
    gain = DilocoConfig().outer_lr * (1 + DilocoConfig().outer_momentum)  # on params (and the anchor)
    params = tree_map(lambda d: gain * d, deltas)
    return params, (params, deltas)  # (params, (anchor, momentum))


def _check_sync(got, want, strategy, world, what, *, exact):
    if exact:
        _assert_trees(got, want, what)
        return
    scale = _sum_scales(strategy, world)
    if strategy == "hier_int8":  # the synced mean; the error feedback is held exactly by the caller
        got, want, scale = got[0], want[0], scale[0]
    _close_to_sum(got, want, scale, what)


def _rank_slice(tree, rank):
    return tree_map(lambda a: a[rank] if isinstance(a, np.ndarray) else a, tree)


def _host_view(strategy, state_np, rank, npods):
    """The one-process (params, state) as rank ``rank`` holds it: its slice
    of every per-pod leaf (map_pod_leaves' leaves)."""
    params, state = state_np
    state = dict(state)
    if strategy == "hier_int8":
        state["ef"] = _rank_slice(state["ef"], rank)
    if strategy == "local_sgd" and npods > 1:
        params = _rank_slice(params, rank)
        adam = state["adam"]
        state["adam"] = type(adam)(adam[0], _rank_slice(adam[1], rank), _rank_slice(adam[2], rank))
    return params, state


# -- 1. the group step against the one-process step ------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_group_losses_and_metrics_equal_one_process(run, strategy):
    """Every step's loss, ce, aux, tokens, grad_norm, lr and wan_bytes on
    every rank; on 4 ranks a plain all-reduce is held over one step."""
    world = run["world"]
    exact = world == 2 or strategy in EXACT_ON_4
    want = run["host"]["train"][strategy][0]
    for r, rank in enumerate(run["ranks"]):
        rows = rank["train"][strategy][0]
        for i, (got, ref) in enumerate(zip(rows, want)):
            if not exact and i >= (DILOCO.sync_every if strategy == "local_sgd" else 1):
                break
            for k, w in ref.items():
                if exact or k == "wan_bytes":
                    assert got[k] == w, (r, i, k, got[k], w)
                else:
                    np.testing.assert_allclose(got[k], w, rtol=RTOL_4, atol=ATOL_4, err_msg=f"rank {r} step {i} {k}")
        assert rows[0]["collective_s"] >= 0 and set(rows[0]) == set(want[0]) | {"collective_s"}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_group_params_and_state_equal_one_process(run, strategy):
    """Params, AdamW step and moments, error feedback and the DiLoCo anchor
    and momentum, each rank against its slice of the one-process state."""
    world = run["world"]
    exact = world == 2 or strategy in EXACT_ON_4
    after = STEPS if exact else (DILOCO.sync_every if strategy == "local_sgd" else 1)
    want = run["host"]["train"][strategy][1][after]
    for r, rank in enumerate(run["ranks"]):
        got = rank["train"][strategy][1][after]
        ref = _host_view(strategy, want, r, world)
        what = f"rank {r} after step {after}"
        if strategy in ("allreduce", "hier") and not exact:  # AdamW's first step: see the module docstring
            _close_params_but_eps_lanes(got[0], ref[0], ref[1]["adam"][1], what)
            got, ref = got[1], ref[1]
        _assert_trees(got, ref, what, exact=exact)


def _close_params_but_eps_lanes(got, want, m, what):
    """Step-1 parameters at RTOL_4 / ATOL_4 but on lanes with |m_hat| < 100 eps."""
    got, want, m = dict(tree_items(got)), dict(tree_items(want)), dict(tree_items(m))
    b1, eps, lr = OPT.b1, OPT.eps, OPT.lr
    exempt = total = 0
    for path, w in want.items():
        diff = np.abs(got[path] - w)
        flat = np.abs(m[path]) / (1 - b1) < 100 * eps
        assert (diff[~flat] <= ATOL_4 + RTOL_4 * np.abs(w[~flat])).all(), f"{what} {path}"
        assert (diff[flat] <= lr).all(), f"{what} {path}"
        exempt += int((diff[flat] > ATOL_4 + RTOL_4 * np.abs(w[flat])).sum())
        total += w.size
    assert exempt < 1e-3 * total, f"{what}: {exempt} of {total} values off"


def test_group_ranks_hold_the_same_replicated_state(run):
    """Parameters every pod shares (all strategies but local_sgd's inner
    steps) are the same bits on every rank, as are the DiLoCo state and the
    AdamW step."""
    for s in ("allreduce", "hier", "hier_int8", "ps"):
        first = run["ranks"][0]["train"][s][1][STEPS][0]
        for rank in run["ranks"][1:]:
            _assert_trees(rank["train"][s][1][STEPS][0], first, f"{s} params")
    anchors = [rank["train"]["local_sgd"][1][STEPS][1]["diloco"] for rank in run["ranks"]]
    for a in anchors[1:]:
        _assert_trees(a, anchors[0], "diloco")


# -- 2. one group sync against jax.vmap of the JAX functions ---------------------------


@functools.lru_cache(maxsize=None)
def _jax_syncs(world):
    """Eager, as the JAX suite's exact comparisons run them: under jit
    XLA's fusion moves the last bits of the int8 transform and of the
    outer step."""
    import jax

    from repro.distributed.sync import all_gather_compat, sync_allreduce as j_ar, sync_hier as j_hier
    from repro.distributed.sync import sync_hier_int8 as j_int8, sync_ps as j_ps
    from repro.optim.diloco import DilocoConfig as JDilocoConfig, DilocoState as JDilocoState
    from repro.optim.diloco import outer_step as j_outer

    grads, ef = _pod_tree(0, world), jax.tree.map(lambda a: a * np.float32(0.01), _pod_tree(1, world))
    params = _pod_tree(2, world)
    anchor = jax.tree.map(lambda a: a[0], _pod_tree(3, world))
    mom = jax.tree.map(lambda a: a[0] * np.float32(0.1), _pod_tree(4, world))
    vm = lambda f, *a: jax.tree.map(np.asarray, jax.vmap(f, axis_name="pod")(*a))  # noqa: E731
    g_mean = vm(lambda g: jax.tree.map(lambda x: all_gather_compat(x, "pod").mean(0), g), grads)
    pulled = vm(lambda g, p: j_ps(g, p, lambda gm: jax.tree.map(lambda pp, gg: pp - 0.5 * gg, p, gm)),
                grads, params)
    outer = jax.vmap(lambda p: j_outer(JDilocoConfig(), p, JDilocoState(anchor, mom)), axis_name="pod")(params)
    return {
        "allreduce": vm(lambda g: j_ar(g), grads),
        "hier": vm(lambda g: j_hier(g, num_channels=4), grads),
        "hier_int8": vm(lambda g, e: j_int8(g, e), grads, ef),
        "ps": (g_mean, pulled),
        "local_sgd": jax.tree.map(np.asarray, (outer[0], tuple(outer[1]))),
    }


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_group_sync_matches_jax_vmap(run, strategy):
    world = run["world"]
    ref = _jax_syncs(world)[strategy]
    for r, rank in enumerate(run["ranks"]):
        got = rank["sync"][strategy][0]
        if strategy == "hier_int8":  # (synced, ef): the error feedback is each pod's own, exact
            _assert_trees(got[1], _rank_slice(ref[1], r), f"rank {r} ef")
            want = _rank_slice(ref, r)
        elif strategy == "local_sgd":  # (params, (anchor, momentum)): pod r's params, the shared state
            got = (got[0], tuple(got[1]))
            want = (_rank_slice(ref[0], r), tuple(_rank_slice(x, 0) for x in ref[1]))
        else:
            want = _rank_slice(ref, r)
        _check_sync(got, want, strategy, world, f"rank {r} {strategy}", exact=world == 2)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_group_sync_equals_the_stacked_sync(run, strategy):
    """The group forms against the stacked forms on the same inputs: bit
    for bit on 2 ranks, and on 4 where the sums run in rank order."""
    world = run["world"]
    grads = tree_map(torch.from_numpy, _pod_tree(0, world))  # [world, ...] leaves
    exact = world == 2 or strategy in EXACT_ON_4
    if strategy == "allreduce":
        want = _np(sync_allreduce(grads))
    elif strategy == "hier":
        want = _np(sync_hier(grads, num_channels=4))
    elif strategy == "hier_int8":
        ef = tree_map(lambda a: torch.from_numpy(a * np.float32(0.01)), _pod_tree(1, world))
        synced, new_ef, _ = sync_hier_int8(grads, ef)
        want = (_np(synced), _np(new_ef))
    elif strategy == "ps":
        params = tree_map(torch.from_numpy, _pod_tree(2, world))
        g_mean = sync_ps(grads)
        pulled = tree_map(lambda p, g: p[0] - 0.5 * g, params, g_mean)
        want = (_np(g_mean), _np(pulled))
    else:
        params = tree_map(torch.from_numpy, _pod_tree(2, world))
        anchor = _own(_pod_tree(3, world), 0)
        mom = tree_map(lambda t: t * 0.1, _own(_pod_tree(4, world), 0))
        new_p, new_state = outer_step(DilocoConfig(), params, DilocoState(anchor, mom))
        want = (_np(new_p), _np(tuple(new_state)))
    for r, rank in enumerate(run["ranks"]):
        got = rank["sync"][strategy][0]
        if strategy == "hier_int8":
            want_r = (want[0], _rank_slice(want[1], r))
        elif strategy == "local_sgd":
            got, want_r = (got[0], tuple(got[1])), (_rank_slice(want[0], r), want[1])
        else:
            want_r = want
        if strategy == "hier_int8":
            _assert_trees(got[1], want_r[1], f"rank {r} ef")
        _check_sync(got, want_r, strategy, world, f"rank {r} {strategy}", exact=exact)


# -- 3. counted bytes against the analytic bytes ---------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_counted_bytes_equal_the_analytic_bytes(run, strategy):
    world = run["world"]
    grads = tree_map(torch.from_numpy, _pod_tree(0, world))
    analytic = {
        "allreduce": full_precision_bytes(grads),
        "hier": full_precision_bytes(grads),
        "hier_int8": sync_hier_int8(grads, tree_map(torch.zeros_like, grads))[2],
        "ps": ps_bytes(grads),
        "local_sgd": full_precision_bytes(grads),  # the float32 deltas of same-shaped params
    }[strategy]
    for rank in run["ranks"]:
        handed = rank["sync"][strategy][1]
        assert group_wan_bytes(strategy, handed, world) == analytic > 0
    # and in the train step: the stacked step's wan_bytes on every step
    want = [row["wan_bytes"] for row in run["host"]["train"][strategy][0]]
    for rank in run["ranks"]:
        assert [row["wan_bytes"] for row in rank["train"][strategy][0]] == want


# -- 4. the mesh helpers ----------------------------------------------------------------


@pytest.mark.parametrize("shape,axes", [((2, 1, 1), tmesh.AXES), ((1, 1), tmesh.AXES[1:]), ((4,), ("pod",)),
                                        ((1,), ("pod",))])
def test_local_mesh_helpers_match_jax(shape, axes):
    from jax.sharding import AbstractMesh

    from repro.launch import mesh as jmesh

    ours, ref = tmesh.make_mesh(shape, axes, device="cpu"), AbstractMesh(shape, axes)
    assert isinstance(ours, tmesh.LocalMesh) and ours.axis_names == axes
    for fn in ("num_pods", "chips_per_pod", "batch_axes"):
        assert getattr(tmesh, fn)(ours) == getattr(jmesh, fn)(ref), fn


def test_group_mesh_helpers_match_jax(run):
    from jax.sharding import AbstractMesh

    from repro.launch import mesh as jmesh

    world = run["world"]
    refs = [AbstractMesh((world, 1, 1), tmesh.AXES), AbstractMesh((world,), ("pod",))]
    for rank in run["ranks"]:
        for (is_device_mesh, names, pods, chips, axes), ref in zip(rank["mesh"], refs):
            assert is_device_mesh and names == ref.axis_names
            assert (pods, chips, axes) == (jmesh.num_pods(ref), jmesh.chips_per_pod(ref), jmesh.batch_axes(ref))


# -- 5. prefill and decode over the mesh -----------------------------------------------


def test_prefill_and_decode_steps_match_jax(run):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import decode_step as jax_decode_step
    from repro.models import prefill as jax_prefill

    jcfg, world = jax_smoke(ARCH), run["world"]
    params = jax.tree.map(jnp.asarray, run["params_np"])
    logits, cache = jax_prefill(params, {"tokens": jnp.asarray(run["tokens"])}, jcfg, max_len=PROMPT + GEN_STEPS)
    want = [np.asarray(logits)]
    for i, t in enumerate(run["decode_tokens"]):
        logits, cache = jax_decode_step(params, jnp.asarray(t), cache, jcfg, PROMPT + i)
        want.append(np.asarray(logits))
    per = run["tokens"].shape[0] // world
    for r, rank in enumerate(run["ranks"]):
        got, placements = rank["serve"]
        # by the rules: parameters and caches replicated over pod (each pod
        # serves its own rows with its own cache), the batch split over it
        assert placements == {"params": ["Replicate"], "batch": ["Shard"], "cache": ["Replicate"]}
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w[r * per : (r + 1) * per], rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} call {i}")


def test_prefill_step_on_a_local_mesh_runs_the_whole_batch():
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (4, PROMPT)))
    step, placements = make_prefill_step(cfg, tmesh.make_host_mesh(pods=2, device="cpu"), device="cpu")
    from repro_torch.models import prefill

    logits, _ = step(params, {"tokens": tokens})
    assert torch.equal(logits, prefill(params, {"tokens": tokens}, cfg)[0])
    assert set(placements) == {"params", "batch", "cache"}
    assert all(type(p).__name__ == "Replicate" for v in placements.values() for pl in _placement_leaves(v) for p in pl)


# -- 6. a mesh the world cannot hold raises ---------------------------------------------


@pytest.mark.parametrize("make,size", [
    (lambda: tmesh.make_host_mesh(pods=2, data=2, device="cpu"), 4),
    (lambda: tmesh.make_host_mesh(pods=1, model=2, device="cpu"), 2),
    (lambda: tmesh.make_mesh((2, 4), ("pod", "data"), device="cpu"), 8),
    (lambda: tmesh.make_production_mesh(), 256),
    (lambda: tmesh.make_production_mesh(multi_pod=True), 512),
], ids=["data2", "model2", "make_mesh_data4", "production", "production_multi_pod"])
def test_intra_pod_axes_raise_naming_item_16(make, size):
    """Intra-pod axes are placed now (ROADMAP item 16 is done): in one
    process a mesh with data or model above 1 needs a world of its size,
    and says so, naming both numbers."""
    with pytest.raises(ValueError, match=f"a mesh of {size} devices .* in a world of 1 ranks"):
        make()


@pytest.mark.parametrize("mesh,size", [("single", 256), ("multi", 512)])
def test_train_cli_production_meshes_raise_naming_item_16(mesh, size):
    """The production meshes build under a world of their size; here, in
    one process, the launcher fails with the world-size ``ValueError``."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match=f"a mesh of {size} devices .* in a world of 1 ranks"):
        train.main(["--device", "cpu", "--mesh", mesh])


@pytest.mark.parametrize("shape,axes", [((2, 1), ("pod", "pod")), ((2,), ("dc",)), ((2, 1), ("pod",))])
def test_make_mesh_refuses_unknown_or_repeated_axes(shape, axes):
    with pytest.raises(ValueError, match="axes must be"):
        tmesh.make_mesh(shape, axes, device="cpu")


# -- checkpoints across the two layouts, and the single pod count ------------------------


@pytest.mark.parametrize("strategy", CKPT_STRATEGIES)
def test_group_run_equals_the_one_process_run_with_its_drill(run2, strategy):
    run = run2
    host = run["host"]["ckpt"][strategy]
    for rank in run["ranks"]:
        whole = rank["ckpt"][strategy][0]
        assert [r["loss"] for r in whole["metrics"]] == [r["loss"] for r in host["metrics"]]
        assert whole["last_checkpoint"] == host["last_checkpoint"] == 4
        drills = [(d["step"], d["dead"], d["plan"]["lost_steps"], d["plan"]["restore_s"])
                  for d in whole["recovery_drills"]]
        assert drills == [(d["step"], d["dead"], d["plan"]["lost_steps"], d["plan"]["restore_s"])
                          for d in host["recovery_drills"]] and drills


@pytest.mark.parametrize("strategy", CKPT_STRATEGIES)
def test_one_process_trainer_resumes_a_group_checkpoint(run2, strategy):
    run = run2
    want = [r["loss"] for r in run["host"]["ckpt"][strategy]["metrics"][2:]]
    resumed = run["host"]["ckpt_resumed"][strategy]["metrics"]
    assert [r["step"] for r in resumed] == [2, 3]
    assert [r["loss"] for r in resumed] == want


@pytest.mark.parametrize("strategy", CKPT_STRATEGIES)
def test_group_resumes_a_one_process_checkpoint(run2, strategy):
    run = run2
    want = [r["loss"] for r in run["host"]["ckpt"][strategy]["metrics"][2:]]
    for rank in run["ranks"]:
        resumed = rank["ckpt"][strategy][1]["metrics"]
        assert [r["step"] for r in resumed] == [2, 3]
        assert [r["loss"] for r in resumed] == want


def _spec(pods):
    from repro_torch.examples.train_geo import geo_scenario

    return geo_scenario("hier", 2, pods=pods)


@pytest.mark.parametrize("case", ["npods_vs_scenario", "mesh_vs_scenario", "npods_vs_mesh"])
def test_disagreeing_pod_counts_raise(tmp_path, case):
    mesh = tmesh.make_host_mesh(pods=2, device="cpu")
    kw = {
        "npods_vs_scenario": dict(trainer_cfg=TrainerConfig(npods=3), scenario=_spec(2)),
        "mesh_vs_scenario": dict(mesh=mesh, trainer_cfg=TrainerConfig(), scenario=_spec(3)),
        "npods_vs_mesh": dict(mesh=mesh, trainer_cfg=TrainerConfig(npods=3)),
    }[case]
    with pytest.raises(ValueError, match="pod counts disagree"):
        GeoTrainer(get_smoke_config(ARCH), checkpoint_dir=str(tmp_path), device="cpu", **kw)


@pytest.mark.parametrize("source", ["scenario", "mesh", "npods", "none", "podless_mesh_and_scenario"])
def test_pod_count_has_one_source(tmp_path, source):
    """A mesh without a pod axis is one pod whatever the scenario says (the
    JAX quickstart's ``GeoTrainer(cfg, make_host_mesh(), scenario=...)``);
    the scenario's 3 DCs then price its WAN sync."""
    kw = {
        "scenario": dict(trainer_cfg=TrainerConfig(), scenario=_spec(3)),
        "mesh": dict(mesh=tmesh.make_host_mesh(pods=3, device="cpu"), trainer_cfg=TrainerConfig()),
        "npods": dict(trainer_cfg=TrainerConfig(npods=3)),
        "none": dict(trainer_cfg=TrainerConfig()),
        "podless_mesh_and_scenario": dict(mesh=tmesh.make_host_mesh(device="cpu"), trainer_cfg=TrainerConfig(),
                                          scenario=_spec(3)),
    }[source]
    trainer = GeoTrainer(get_smoke_config(ARCH), checkpoint_dir=str(tmp_path), device="cpu", **kw)
    pods = 1 if source in ("none", "podless_mesh_and_scenario") else 3
    assert trainer.tc.npods == pods and list(trainer.heartbeats.workers) == [f"pod{i}" for i in range(pods)]
    if source == "podless_mesh_and_scenario":
        assert trainer.geo.num_pods == 3


def test_make_train_step_refuses_npods_that_disagree_with_the_mesh():
    with pytest.raises(ValueError, match="disagrees"):
        make_train_step(get_smoke_config(ARCH), mesh=tmesh.make_host_mesh(pods=2, device="cpu"), npods=3,
                        device="cpu")


def test_build_trainer_is_gone():
    from repro_torch.examples import train_geo

    assert not hasattr(train_geo, "build_trainer")


# -- the launchers ----------------------------------------------------------------------


def test_spawn_kills_ranks_that_outlive_the_timeout():
    with pytest.raises(TimeoutError, match="killed"):
        spawn(_sleep, 2, 30.0, device="cpu", join_timeout_s=1)


def test_spawn_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="pod rank 1 exited"):
        spawn(_fail_on_rank_1, 2, device="cpu", join_timeout_s=60)


def _sleep(rank, seconds):
    import time

    time.sleep(seconds)


def _fail_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank
