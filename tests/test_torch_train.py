"""The port's training path against the JAX package's, on the CPU.

JAX parameters are initialised from a seed and converted through numpy
(``repro_torch.convert``); both sides take the same loader batches.
Tolerances, each the JAX suite's own or stated with its reason:

* loss and every gradient leaf: float32 2e-5 (the bar of
  ``test_multi_pod_grads_match_single_device``), bf16 2e-2 (the kernel
  suite's bf16 bar: the frameworks round to bf16 at different points);
* AdamW: rtol 1e-5 -- XLA fuses the moment updates into FMAs, ATen does not,
  so values differ by a few float32 ulp, and three steps compound them;
* sync strategies: exact -- a two-pod sum, an exact division by 2, and the
  int8 transform, which must be bit-exact;
* three whole 2-pod ``hier_int8`` steps, each from the JAX state: loss and
  grad norm at 2e-5 (float32); params, moments and error feedback at 2e-5
  on all but fewer than 1e-3 of their values -- the int8 suite's own bar (|dq| <= 1 on
  fewer than 1e-3 of lanes): gradients a few ulp apart can round to
  neighbouring int8 levels where x / scale sits at a .5 tie, which moves
  that lane's synced gradient and error feedback by one quantisation step.

* ``ps`` and ``local_sgd`` steps, each from the JAX state: loss, grad
  norm, params, moments, DiLoCo anchor and momentum at float32 2e-5 (no
  int8 on these paths), but for ``ps`` parameters on the few lanes where
  the pods' mean gradient cancels to below AdamW's eps (see
  ``_close_params_but_eps_lanes``);
* top-k: exact, on inputs whose magnitudes are all distinct (``torch.topk``
  and ``jax.lax.top_k`` may break ties differently).

The JAX multi-pod ``make_train_step`` crashes XLA's partitioner on this
jax; the reference is the JAX functions themselves under
``jax.vmap(..., axis_name="pod")``, composed as ``steps.py`` composes them.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import loader_for_model as jax_loader
from repro.distributed.compression import init_error_feedback as jax_init_ef
from repro.distributed.compression import topk_densify as jax_topk_densify
from repro.distributed.compression import topk_sparsify as jax_topk_sparsify
from repro.distributed.sync import all_gather_compat as jax_all_gather
from repro.distributed.sync import sync_allreduce as jax_sync_allreduce
from repro.distributed.sync import sync_hier as jax_sync_hier
from repro.distributed.sync import sync_hier_int8 as jax_sync_hier_int8
from repro.distributed.sync import wan_bytes_per_step as jax_wan_bytes
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro.optim.diloco import DilocoConfig as JaxDilocoConfig
from repro.optim.diloco import init_diloco as jax_init_diloco
from repro.optim.diloco import outer_step as jax_outer_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data import loader_for_model
from repro_torch.distributed import (
    full_precision_bytes,
    init_pod_params,
    init_train_state,
    make_train_step,
    pod_grads,
    ps_bytes,
    sync_allreduce,
    sync_grads,
    sync_hier,
    sync_hier_int8,
    sync_ps,
    topk_densify,
    topk_sparsify,
    wan_bytes_per_step,
)
from repro_torch.models import loss_fn
from repro_torch.optim import AdamWConfig, DilocoConfig, adamw_update, init_adamw
from repro_torch.tree import tree_items, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5, weight_decay=0.1)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def _flat(tree):
    """{path: numpy leaf} of a numpy tree, with the port's path names."""
    return dict(tree_items(tree))


def _close_trees(port_np, jax_np, tol, what):
    port, ref = _flat(port_np), _flat(jax_np)
    assert set(port) == set(ref), what
    for path, want in ref.items():
        np.testing.assert_allclose(port[path], want, rtol=tol, atol=tol, err_msg=f"{what} {path}")


def _close_trees_but_int8_flips(port_np, jax_np, tol, what):
    """2e-5 everywhere but on fewer than 1e-3 of all values (int8 ties)."""
    port, ref = _flat(port_np), _flat(jax_np)
    assert set(port) == set(ref), what
    off = total = 0
    for path, want in ref.items():
        got = np.asarray(port[path], np.float64)
        off += int((np.abs(got - want) > tol + tol * np.abs(want)).sum())
        total += want.size
    assert off < 1e-3 * total, f"{what}: {off} of {total} values off by more than {tol}"


def _close_params_but_eps_lanes(port_np, jax_np, m_np, step, tol, what):
    """Parameters at ``tol`` but on lanes whose bias-corrected first moment
    (the JAX state's, after the step) is below 10 x AdamW's eps: there the
    update g / (|g| + eps) is linear in a mean gradient at float32 noise
    level (the pods' gradients cancel), so summation-order ulps in g move
    the parameter by up to lr.  There a lane is held to lr, the most that
    term can move it, and fewer than 1e-4 of all values may leave ``tol``."""
    port, ref, moment = _flat(port_np), _flat(jax_np), _flat(m_np)
    assert set(port) == set(ref), what
    b1, eps, lr = AdamWConfig().b1, AdamWConfig().eps, OPT["lr"]
    exempt = total = 0
    for path, want in ref.items():
        got = np.asarray(port[path], np.float64)
        flat = np.abs(moment[path]) / (1 - b1 ** step) < 10 * eps
        diff = np.abs(got - want)
        assert (diff[~flat] <= tol + tol * np.abs(want[~flat])).all(), f"{what} {path}"
        assert (diff[flat] <= lr).all(), f"{what} {path}"
        exempt += int((diff[flat] > tol + tol * np.abs(want[flat])).sum())
        total += want.size
    assert exempt < 1e-4 * total, f"{what}: {exempt} of {total} values off by more than {tol}"


def _batch(cfg, seed=1, seq=32, batch=2):
    return jax_loader(cfg, seq_len=seq, global_batch=batch, seed=seed).next_batch()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "arch,remat",
    [("distilgpt2-82m", "none"), ("olmo-1b", "none"), ("olmo-1b", "full"),
     ("musicgen-large", "none"), ("phi-3-vision-4.2b", "none")],
)
def test_loss_and_every_grad_leaf_match_jax(arch, remat, dtype):
    """Through the port's ``pod_grads`` (one pod).  musicgen-large's frame
    frontend never reads its untied ``embed``: JAX gives that leaf a zero
    gradient, and so must the port."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype, remat=remat)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, remat=remat)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: jax_loss_fn(p, b, jcfg), has_aux=True)
    )(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    loss, metrics, grads = pod_grads(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, 1)
    grads = tree_map(lambda g: g[0], grads)
    tol = TOL[dtype]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol, atol=tol)
    np.testing.assert_allclose(metrics["ce"].item(), float(jmetrics["ce"]), rtol=tol, atol=tol)
    assert metrics["tokens"].item() == float(jmetrics["tokens"])
    assert len(tree_leaves(grads)) == len(jax.tree.leaves(jgrads))
    _close_trees(params_to_numpy(grads), _np_tree(jgrads), tol, "grad")
    if arch == "musicgen-large":
        assert not grads["embed"].any() and not np.asarray(jgrads["embed"]).any()


def test_loss_masks_ignored_labels():
    jcfg = jax_smoke("distilgpt2-82m")
    tcfg = get_smoke_config("distilgpt2-82m")
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batch(jcfg, seed=2)
    batch["labels"][:, ::3] = -100
    jloss, jm = jax_loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        loss, m = loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert m["tokens"].item() == float(jm["tokens"]) == (batch["labels"] != -100).sum()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5, atol=2e-5)


def test_adamw_three_steps_match_jax():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 300)).astype(np.float32), "b": {"x": rng.standard_normal(7).astype(np.float32)}}
    jcfg, tcfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    jp, jstate = jax.tree.map(jnp.asarray, params), jax_init_adamw(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params, device="cpu")
    tstate = init_adamw(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 2).astype(np.float32), params)
        jp, jstate, jm = jax_adamw_update(jcfg, jax.tree.map(jnp.asarray, grads), jstate, jp)
        tp, tstate, tm = adamw_update(tcfg, params_from_numpy(grads, device="cpu"), tstate, tp)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5, err_msg=key)
        for name, t, j in (("params", tp, jp), ("m", tstate.m, jstate.m), ("v", tstate.v, jstate.v)):
            _close_trees(params_to_numpy(t), _np_tree(j), 1e-5, f"step {step} {name}")


def _pod_grads(seed):
    """Per-pod gradients [2, ...] with a 0-d, a ragged and a stacked leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (), "b": (7,), "c": (3, 300), "d": {"e": (6, 64, 256), "f": (5, 512)}}
    return jax.tree.map(
        lambda s: (rng.standard_normal((2, *s)) * 3).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple),
    )


@pytest.mark.parametrize("strategy", ["allreduce", "hier", "hier_int8"])
def test_sync_matches_jax_under_vmap(strategy):
    grads = _pod_grads(0)
    tgrads = params_from_numpy(grads, device="cpu")
    if strategy == "hier_int8":
        ef = jax.tree.map(lambda a: a * np.float32(0.01), _pod_grads(1))
        jsynced, jef = jax.vmap(lambda g, e: jax_sync_hier_int8(g, e, axis="pod"), axis_name="pod")(grads, ef)
        synced, new_ef, wan = sync_hier_int8(tgrads, params_from_numpy(ef, device="cpu"))
        _close_trees(params_to_numpy(new_ef), _np_tree(jef), 0, "ef")  # per pod: they differ
        n_int8 = 256 + 256 + 3 * 512 + 6 * 64 * 256 + 5 * 512  # each leaf padded to 256 lanes
        assert wan == n_int8 + 4 * n_int8 // 256
    elif strategy == "hier":
        jsynced = jax.vmap(lambda g: jax_sync_hier(g, axis="pod", num_channels=4), axis_name="pod")(grads)
        synced = sync_hier(tgrads, num_channels=4)
    else:
        jsynced = jax.vmap(lambda g: jax_sync_allreduce(g, axis="pod"), axis_name="pod")(grads)
        synced = sync_allreduce(tgrads)
    for pod in range(2):  # JAX gives every pod the same synced gradient
        _close_trees(params_to_numpy(synced), jax.tree.map(lambda a: np.asarray(a[pod]), jsynced), 0, f"pod {pod}")


def test_wan_bytes_per_step_matches_jax():
    for strategy in ("allreduce", "ps", "hier", "hier_int8", "local_sgd"):
        for npods in (2, 4):
            assert wan_bytes_per_step(324_504_576, strategy, npods=npods) == jax_wan_bytes(
                324_504_576, strategy, npods=npods
            )


def _jax_step(jcfg, opt_cfg, npods):
    """The JAX package's pod step (``steps.py::make_train_step``'s ``inner``)
    on one pod's batch, run for every pod under ``jax.vmap``."""

    def inner(params, adam, ef, batch):
        (loss, metrics), grads = jax.value_and_grad(lambda p: jax_loss_fn(p, batch, jcfg), has_aux=True)(params)
        loss = jax.lax.psum(loss, "pod") / npods
        grads, new_ef = jax_sync_hier_int8(grads, ef, axis="pod")
        new_params, new_adam, opt_metrics = jax_adamw_update(opt_cfg, grads, adam, params)
        return new_params, new_adam, new_ef, loss, opt_metrics["grad_norm"]

    def step(params, adam, ef, batch):
        pods = jax.tree.map(lambda x: x.reshape(npods, x.shape[0] // npods, *x.shape[1:]), batch)
        out = jax.vmap(inner, in_axes=(None, None, 0, 0), axis_name="pod")(params, adam, ef, pods)
        first = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731  identical over pods
        return first(out[0]), first(out[1]), out[2], out[3][0], out[4][0]

    return jax.jit(step)


def test_three_hier_int8_steps_match_jax():
    """Three steps on three batches.  Each step of the port starts from the
    JAX state of that step (converted through numpy) and must land on the
    JAX state after it; a second, free-running chain of port steps must
    give the same per-step loss.  (Left free, an int8 tie that rounds the
    other way moves one lane by one quantisation step, and AdamW's
    sign-like first steps spread such lanes; the loss does not notice.)"""
    npods, arch = 2, "distilgpt2-82m"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    jadam = jax_init_adamw(jparams)
    jef = jax.tree.map(lambda p: jnp.zeros((npods, *p.shape), jnp.float32), jax_init_ef(jparams))
    jstep = _jax_step(jcfg, JaxAdamWConfig(**OPT), npods)

    free_params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    free_state = init_train_state(free_params, AdamWConfig(**OPT), strategy="hier_int8", npods=npods)
    step = make_train_step(
        tcfg, npods=npods, strategy="hier_int8", opt_cfg=AdamWConfig(**OPT), device="cpu"
    )
    jl, tl = jax_loader(jcfg, seq_len=32, global_batch=4, seed=5), loader_for_model(
        tcfg, seq_len=32, global_batch=4, seed=5
    )
    tol = TOL["float32"]
    for i in range(3):
        jb, tb = jl.next_batch(), tl.next_batch()
        params = params_from_numpy(_np_tree(jparams), device="cpu")
        state = train_state_from_numpy(
            {"adam": {"step": np.asarray(jadam.step), "m": _np_tree(jadam.m), "v": _np_tree(jadam.v)},
             "ef": _np_tree(jef)},
            device="cpu",
        )
        jparams, jadam, jef, jloss, jnorm = jstep(jparams, jadam, jef, {k: jnp.asarray(v) for k, v in jb.items()})
        params, state, metrics = step(params, state, tb)
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=tol, atol=tol, err_msg=f"loss {i}")
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jnorm), rtol=tol, atol=tol)
        _close_trees_but_int8_flips(params_to_numpy(params), _np_tree(jparams), tol, f"step {i} params")
        ts = train_state_to_numpy(state)
        _close_trees_but_int8_flips(ts["adam"]["m"], _np_tree(jadam.m), tol, f"step {i} m")
        _close_trees_but_int8_flips(ts["adam"]["v"], _np_tree(jadam.v), tol, f"step {i} v")
        _close_trees_but_int8_flips(ts["ef"], _np_tree(jef), tol, f"step {i} ef")
        assert int(ts["adam"]["step"]) == int(jadam.step) == i + 1
        assert metrics["wan_bytes"] > 0

        free_params, free_state, free = step(free_params, free_state, tb)
        np.testing.assert_allclose(free["loss"].item(), float(jloss), rtol=tol, atol=tol, err_msg=f"free loss {i}")


def test_musicgen_hier_int8_step_matches_jax():
    """One whole 2-pod hier_int8 step of musicgen-large's smoke config from
    the JAX state.  Its untied ``embed`` is a leaf the loss never reads: a
    zero gradient on both sides, zero error feedback, and AdamW's weight
    decay alone moves it."""
    npods, arch = 2, "musicgen-large"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = jax_init_params(jax.random.PRNGKey(4), jcfg)
    jadam = jax_init_adamw(jparams)
    jef = jax.tree.map(lambda p: jnp.zeros((npods, *p.shape), jnp.float32), jax_init_ef(jparams))
    batch = jax_loader(jcfg, seq_len=32, global_batch=4, seed=6).next_batch()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = init_train_state(params, AdamWConfig(**OPT), strategy="hier_int8", npods=npods)
    step = make_train_step(tcfg, npods=npods, strategy="hier_int8", opt_cfg=AdamWConfig(**OPT), device="cpu")
    embed0 = params["embed"].clone()
    jparams, jadam, jef, jloss, jnorm = _jax_step(jcfg, JaxAdamWConfig(**OPT), npods)(
        jparams, jadam, jef, {k: jnp.asarray(v) for k, v in batch.items()})
    params, state, metrics = step(params, state, batch)
    tol = TOL["float32"]
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=tol, atol=tol)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jnorm), rtol=tol, atol=tol)
    _close_trees_but_int8_flips(params_to_numpy(params), _np_tree(jparams), tol, "params")
    ts = train_state_to_numpy(state)
    _close_trees_but_int8_flips(ts["adam"]["m"], _np_tree(jadam.m), tol, "m")
    _close_trees_but_int8_flips(ts["adam"]["v"], _np_tree(jadam.v), tol, "v")
    _close_trees_but_int8_flips(ts["ef"], _np_tree(jef), tol, "ef")
    # the unused leaf: no moments, no error feedback, decayed and nothing else
    assert not state.adam.m["embed"].any() and not state.adam.v["embed"].any()
    assert not state.ef["embed"].any()
    moved = params["embed"] - embed0
    assert moved.abs().max() > 0 and bool((moved * embed0 <= 0).all())
    np.testing.assert_allclose(params["embed"].numpy(), np.asarray(jparams["embed"]), rtol=tol, atol=tol)


def test_train_state_roundtrips_through_numpy():
    tcfg = get_smoke_config("distilgpt2-82m")
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_smoke("distilgpt2-82m"))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = init_train_state(params, AdamWConfig(), strategy="hier_int8", npods=2)
    step = make_train_step(tcfg, npods=2, strategy="hier_int8", device="cpu")
    params, state, _ = step(params, state, loader_for_model(tcfg, seq_len=16, global_batch=2).next_batch())
    back = train_state_from_numpy(train_state_to_numpy(state), device="cpu")
    assert int(back.adam.step) == 1
    for a, b in zip(tree_leaves((state.adam.m, state.adam.v, state.ef)), tree_leaves((back.adam.m, back.adam.v, back.ef))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["distilgpt2-82m", "phi-3-vision-4.2b", "musicgen-large"])
def test_loader_copy_gives_the_same_batches(arch):
    cfg = jax_smoke(arch)
    a = jax_loader(cfg, seq_len=24, global_batch=4, seed=7, start_step=3)
    b = loader_for_model(get_smoke_config(arch), seq_len=24, global_batch=4, seed=7, start_step=3)
    for _ in range(2):
        x, y = a.next_batch(), b.next_batch()
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["ps", "local_sgd"])
def test_sync_grads_of_ps_and_local_sgd(strategy):
    """ps: the pods' mean gradient (JAX's all-gather then .mean(0)) and 2 x
    the float32 gradient bytes (push, pull); local_sgd: nothing sent."""
    grads = _pod_grads(2)
    tgrads = params_from_numpy(grads, device="cpu")
    synced, ef, wan = sync_grads(tgrads, (), strategy=strategy)
    assert ef == ()
    if strategy == "local_sgd":
        assert synced is tgrads and wan == 0
        return
    gathered = jax.vmap(lambda g: jax.tree.map(lambda x: jax_all_gather(x, "pod").mean(0), g),
                        axis_name="pod")(grads)
    for pod in range(2):
        _close_trees(params_to_numpy(synced), jax.tree.map(lambda a: np.asarray(a[pod]), gathered), 0, f"pod {pod}")
    values = sum(a[0].size for a in jax.tree.leaves(grads))
    assert wan == ps_bytes(tgrads) == 2 * 4 * values == wan_bytes_per_step(4 * values, "ps")
    assert synced.keys() == sync_ps(tgrads).keys()


def _jax_ps_step(jcfg, opt_cfg, npods):
    """The JAX ``ps`` pod step (``steps.py``'s ``inner``): the pushed
    gradients all-gathered and averaged, one AdamW update, and pod 0's
    parameters pulled by every pod (a psum of the server's copy)."""

    def inner(params, adam, batch):
        (loss, _), grads = jax.value_and_grad(lambda p: jax_loss_fn(p, batch, jcfg), has_aux=True)(params)
        loss = jax.lax.psum(loss, "pod") / npods
        g_mean = jax.tree.map(lambda g: jax_all_gather(g.astype(jnp.float32), "pod").mean(0), grads)
        new_params, new_adam, om = jax_adamw_update(opt_cfg, g_mean, adam, params)
        is_server = (jax.lax.axis_index("pod") == 0).astype(jnp.float32)
        new_params = jax.tree.map(lambda u: jax.lax.psum(u * is_server.astype(u.dtype), "pod"), new_params)
        return new_params, new_adam, loss, om["grad_norm"]

    def step(params, adam, batch):
        pods = jax.tree.map(lambda x: x.reshape(npods, x.shape[0] // npods, *x.shape[1:]), batch)
        out = jax.vmap(inner, in_axes=(None, None, 0), axis_name="pod")(params, adam, pods)
        first = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731  identical over pods
        return first(out[0]), first(out[1]), out[2][0], out[3][0]

    return jax.jit(step)


def test_three_ps_steps_match_jax():
    """Three 2-pod ps steps, each from the JAX state, and a free-running
    chain of port steps whose losses must match too."""
    npods, arch = 2, "distilgpt2-82m"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = jax_init_params(jax.random.PRNGKey(5), jcfg)
    jadam = jax_init_adamw(jparams)
    jstep = _jax_ps_step(jcfg, JaxAdamWConfig(**OPT), npods)
    step = make_train_step(tcfg, npods=npods, strategy="ps", opt_cfg=AdamWConfig(**OPT), device="cpu")
    free_params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    free_state = init_train_state(free_params, AdamWConfig(**OPT), strategy="ps", npods=npods)
    jl, tl = jax_loader(jcfg, seq_len=32, global_batch=4, seed=7), loader_for_model(
        tcfg, seq_len=32, global_batch=4, seed=7)
    tol = TOL["float32"]
    for i in range(3):
        jb, tb = jl.next_batch(), tl.next_batch()
        params = params_from_numpy(_np_tree(jparams), device="cpu")
        state = train_state_from_numpy(
            {"adam": {"step": np.asarray(jadam.step), "m": _np_tree(jadam.m), "v": _np_tree(jadam.v)}}, device="cpu")
        jparams, jadam, jloss, jnorm = jstep(jparams, jadam, {k: jnp.asarray(v) for k, v in jb.items()})
        params, state, metrics = step(params, state, tb)
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=tol, atol=tol, err_msg=f"loss {i}")
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jnorm), rtol=tol, atol=tol)
        _close_params_but_eps_lanes(params_to_numpy(params), _np_tree(jparams), _np_tree(jadam.m), i + 1, tol,
                                    f"step {i} params")
        ts = train_state_to_numpy(state)
        _close_trees(ts["adam"]["m"], _np_tree(jadam.m), tol, f"step {i} m")
        _close_trees(ts["adam"]["v"], _np_tree(jadam.v), tol, f"step {i} v")
        assert int(ts["adam"]["step"]) == int(jadam.step) == i + 1
        assert metrics["wan_bytes"] == ps_bytes(tree_map(lambda t: t[None], params))

        free_params, free_state, free = step(free_params, free_state, tb)
        np.testing.assert_allclose(free["loss"].item(), float(jloss), rtol=tol, atol=tol, err_msg=f"free loss {i}")


def _jax_local_step(jcfg, opt_cfg, dcfg, npods):
    """The JAX ``local_sgd`` pod step (``steps.py``'s ``inner``): each pod's
    own AdamW step, then ``outer_step`` under ``lax.cond`` on the updated
    step count -- here with per-pod parameters and moments, as DiLoCo's
    docstring describes, under ``jax.vmap(..., axis_name="pod")``."""

    def inner(params, adam, diloco, batch):
        (loss, _), grads = jax.value_and_grad(lambda p: jax_loss_fn(p, batch, jcfg), has_aux=True)(params)
        loss = jax.lax.psum(loss, "pod") / npods
        new_params, new_adam, om = jax_adamw_update(opt_cfg, grads, adam, params)
        new_params, new_diloco = jax.lax.cond(
            new_adam.step % dcfg.sync_every == 0,
            lambda ops: jax_outer_step(dcfg, *ops),
            lambda ops: ops,
            (new_params, diloco),
        )
        return new_params, new_adam, new_diloco, loss, om["grad_norm"]

    def step(params, adam, diloco, batch):
        pods = jax.tree.map(lambda x: x.reshape(npods, x.shape[0] // npods, *x.shape[1:]), batch)
        p, a, d, loss, norm = jax.vmap(inner, in_axes=(0, 0, None, 0), axis_name="pod")(params, adam, diloco, pods)
        return p, a, jax.tree.map(lambda x: x[0], d), loss[0], norm[0]  # anchor, momentum: the same on every pod

    return jax.jit(step)


def test_four_local_sgd_steps_match_jax():
    """2 pods, sync_every = 2, 4 steps, each from the JAX state: each pod's
    parameters and moments after every step, the DiLoCo anchor and
    momentum after each outer step (steps 2 and 4), and WAN bytes 0 on the
    inner steps and a float32 ring all-reduce on the outer ones."""
    npods, arch = 2, "distilgpt2-82m"
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp0 = jax_init_params(jax.random.PRNGKey(6), jcfg)
    stack = lambda t: jax.tree.map(lambda a: jnp.stack([a] * npods), t)  # noqa: E731
    jparams, jadam, jdiloco = stack(jp0), stack(jax_init_adamw(jp0)), jax_init_diloco(jp0)
    jstep = _jax_local_step(jcfg, JaxAdamWConfig(**OPT), JaxDilocoConfig(sync_every=2), npods)
    step = make_train_step(tcfg, npods=npods, strategy="local_sgd", opt_cfg=AdamWConfig(**OPT),
                           diloco_cfg=DilocoConfig(sync_every=2), device="cpu")
    p0 = params_from_numpy(jax.tree.map(np.asarray, jp0), device="cpu")
    free_state = init_train_state(p0, AdamWConfig(**OPT), strategy="local_sgd", npods=npods)
    free_params = init_pod_params(p0, strategy="local_sgd", npods=npods)
    jl, tl = jax_loader(jcfg, seq_len=32, global_batch=4, seed=8), loader_for_model(
        tcfg, seq_len=32, global_batch=4, seed=8)
    tol = TOL["float32"]
    for i in range(4):
        jb, tb = jl.next_batch(), tl.next_batch()
        params = params_from_numpy(_np_tree(jparams), device="cpu")
        state = train_state_from_numpy({
            "adam": {"step": np.asarray(jadam.step[0]), "m": _np_tree(jadam.m), "v": _np_tree(jadam.v)},
            "diloco": {"anchor": _np_tree(jdiloco.anchor), "momentum": _np_tree(jdiloco.momentum)},
        }, device="cpu")
        jparams, jadam, jdiloco, jloss, jnorm = jstep(jparams, jadam, jdiloco, {k: jnp.asarray(v) for k, v in jb.items()})
        params, state, metrics = step(params, state, tb)
        outer = (i + 1) % 2 == 0
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=tol, atol=tol, err_msg=f"loss {i}")
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jnorm), rtol=tol, atol=tol)
        _close_trees(params_to_numpy(params), _np_tree(jparams), tol, f"step {i} params per pod")
        ts = train_state_to_numpy(state)
        _close_trees(ts["adam"]["m"], _np_tree(jadam.m), tol, f"step {i} m per pod")
        _close_trees(ts["adam"]["v"], _np_tree(jadam.v), tol, f"step {i} v per pod")
        assert int(ts["adam"]["step"]) == i + 1
        if outer:
            _close_trees(ts["diloco"]["anchor"], _np_tree(jdiloco.anchor), tol, f"step {i} anchor")
            _close_trees(ts["diloco"]["momentum"], _np_tree(jdiloco.momentum), tol, f"step {i} momentum")
            for t in tree_leaves(params):  # the pods hold the same parameters again
                assert torch.equal(t[0], t[1])
            assert metrics["wan_bytes"] == full_precision_bytes(params) > 0
        else:
            assert metrics["wan_bytes"] == 0
            assert not torch.equal(params["embed"][0], params["embed"][1])  # the pods drifted apart

        free_params, free_state, free = step(free_params, free_state, tb)
        np.testing.assert_allclose(free["loss"].item(), float(jloss), rtol=tol, atol=tol, err_msg=f"free loss {i}")


@pytest.mark.parametrize("shape,k_fraction", [((6, 50), 0.1), ((1000,), 0.01), ((3, 4, 5), 0.5)])
def test_topk_matches_jax(shape, k_fraction):
    rng = np.random.default_rng(9)
    n = int(np.prod(shape))
    x = (rng.permutation(n) + 1.0) * rng.choice([-1.0, 1.0], n) / n  # distinct magnitudes
    x = x.astype(np.float32).reshape(shape)
    jv, ji, jshape = jax_topk_sparsify(jnp.asarray(x), k_fraction)
    tv, ti, tshape = topk_sparsify(torch.from_numpy(x), k_fraction)
    assert tshape == jshape == shape
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(topk_densify(tv, ti, tshape).numpy(), np.asarray(jax_topk_densify(jv, ji, jshape)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT / "src"), env.get("PYTHONPATH")]))
    return env


def test_train_cli_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "2",
         "--pods", "2", "--strategy", "hier_int8", "--global-batch", "4", "--seq-len", "32",
         "--checkpoint-dir", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "(2 pods, hier_int8, 4 x 32)" in out.stdout


@pytest.mark.parametrize("strategy", ["ps", "local_sgd"])
def test_train_cli_runs_ps_and_local_sgd_with_a_drill_on_cpu(tmp_path, strategy):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "4",
         "--pods", "2", "--strategy", strategy, "--global-batch", "4", "--seq-len", "32",
         "--inject-failure-at", "1", "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert f"(2 pods, {strategy}, 4 x 32)" in out.stdout
    assert f"WAN sync estimate [{strategy}]: " in out.stdout
    assert "recovery drill @step 3: detected ['pod1']" in out.stdout
    assert (tmp_path / "step_00000004.COMMITTED").exists()


def test_train_cli_trains_musicgen_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "musicgen-large", "--device", "cpu",
         "--steps", "1", "--checkpoint-dir", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "after 1 steps" in out.stdout


def test_train_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test checks the refusal without one")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])
