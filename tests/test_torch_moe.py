"""The port's mixture-of-experts FFN against the JAX package's, on the CPU.

Weights are the JAX initialiser's, carried into the port by
``repro_torch.convert``; inputs are drawn by numpy from a seed.  Float32
throughout, at rtol = atol = 1e-5 for the layer: both sides route every
token to the same experts (the indices must be equal), so the outputs
differ only by the order of float32 sums.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import ffn as jf
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ffn as tf

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("mixtral-8x22b", "arctic-480b")


@functools.cache
def _chip_smoke():
    """``chip_smoke.py``, for its drop counter and its depth cuts."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _cfgs(arch, **moe):
    """The arch's smoke config on both sides, its MoE fields overridden."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe)))


def _layer_params(jcfg, seed=0):
    """The first MoE layer's parameters: (JAX tree, port tree)."""
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)["groups"]["slot0"]["ffn"]
    jparams = jax.tree.map(lambda a: a[0], jparams)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(actual, expected, what, **tol):
    np.testing.assert_allclose(np.asarray(actual.detach()), np.asarray(expected), err_msg=what, **(tol or TOL))


# -- router, aux loss, capacity ----------------------------------------------------------


def _router(kind, d, e, seed=1):
    """A router [d, e]: random; all zeros (every probability 1/E); or with
    column 3 a copy of column 1, both scaled up so that on the rows where
    column 1 is the largest logit the pair ties for the top two."""
    if kind == "zero":
        return np.zeros((d, e), np.float32)
    w = _x((d, e), seed) * 0.1
    if kind == "pair_tie":
        w[:, 1] *= 10.0
        w[:, 3] = w[:, 1]
    return w


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("router", ["random", "zero", "pair_tie"])
def test_router_probs_gates_and_indices_match_jax(arch, router):
    """Equal probabilities take the lowest index first, as ``lax.top_k``
    does: a zero router ties all E experts, and a zero input row ties them
    under any router."""
    jcfg, tcfg = _cfgs(arch)
    x = _x((64, jcfg.d_model))
    x[:5] = 0.0
    w = _router(router, jcfg.d_model, jcfg.moe.num_experts)
    jp, ji, jidx = jf._router_probs({"router": jnp.asarray(w)}, jnp.asarray(x), jcfg.moe)
    tp, ti, tidx = tf._router_probs({"router": torch.from_numpy(w)}, torch.from_numpy(x), tcfg.moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tp, jp, "probs")
    _close(ti, ji, "gates")
    k = jcfg.moe.num_experts_per_tok
    np.testing.assert_array_equal(tidx[:5].numpy(), np.tile(np.arange(k), (5, 1)))  # zero rows: 0, 1
    if router == "zero":
        np.testing.assert_array_equal(tidx.numpy(), np.tile(np.arange(k), (64, 1)))
    if router == "pair_tie":  # where the tied pair is the top two, 1 ranks first
        both = (tidx == 1).any(-1) & (tidx == 3).any(-1)
        assert both.sum() > 10 and (tidx[both].numpy() == [1, 3]).all()


def test_router_gate_gradient_flows_to_the_router():
    """The indices carry no gradient; the gates' does reach the router,
    equal to JAX's one-hot contraction's."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    x, w = _x((32, jcfg.d_model)), _router("random", jcfg.d_model, jcfg.moe.num_experts)
    ct = _x((32, jcfg.moe.num_experts_per_tok), 2)
    jgrad = jax.grad(lambda r: jnp.sum(jf._router_probs({"router": r}, jnp.asarray(x), jcfg.moe)[1] * ct))(
        jnp.asarray(w))
    router = torch.from_numpy(w).requires_grad_(True)
    (torch.sum(tf._router_probs({"router": router}, torch.from_numpy(x), tcfg.moe)[1] * torch.from_numpy(ct))
     .backward())
    _close(router.grad, jgrad, "router gradient")


@pytest.mark.parametrize("e,k,t", [(4, 2, 64), (8, 2, 1024), (128, 2, 512)])
def test_aux_loss_matches_jax(e, k, t):
    rng = np.random.default_rng(e)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    moe = tf.MoEConfig(num_experts=e, num_experts_per_tok=k)
    want = jf._aux_loss(jnp.asarray(probs), jnp.asarray(idx), jf.MoEConfig(num_experts=e, num_experts_per_tok=k))
    got = tf._aux_loss(torch.from_numpy(probs), torch.from_numpy(idx), moe)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, "aux")


def test_aux_loss_uniform_is_one():
    """Perfectly uniform routing gives 1 (Switch's scaling), as
    ``tests/test_models.py`` holds the JAX function."""
    e, t = 4, 1024
    probs = torch.full((t, e), 1.0 / e)
    idx = torch.stack([torch.arange(t) % e, (torch.arange(t) + 1) % e], dim=1)
    assert abs(tf._aux_loss(probs, idx, tf.MoEConfig(num_experts=e, num_experts_per_tok=2)).item() - 1.0) < 1e-5


@pytest.mark.parametrize("moe", [dict(num_experts=8, num_experts_per_tok=2, capacity_factor=1.25),
                                 dict(num_experts=128, num_experts_per_tok=2, capacity_factor=1.25),
                                 dict(num_experts=4, num_experts_per_tok=2, capacity_factor=0.5),
                                 dict(num_experts=8, num_experts_per_tok=1, capacity_factor=2.0)])
def test_capacity_matches_jax(moe):
    """At least 4, rounded up to a multiple of 4, for every group size."""
    for tg in list(range(1, 70)) + [128, 500, 512, 1000, 4096]:
        c = tf._capacity(tg, tf.MoEConfig(**moe))
        assert c == jf._capacity(tg, jf.MoEConfig(**moe)), tg
        assert c >= 4 and c % 4 == 0


# -- the layer -------------------------------------------------------------------------


# (capacity factor or None for the smoke config's, batch, sequence): the
# smoke capacity with no drop, a capacity factor of 0.5 that drops, and
# t = 1024 tokens, two groups of 512
LAYER_CASES = [(None, 2, 12), (0.5, 2, 32), (None, 2, 512)]


@pytest.mark.parametrize("case", LAYER_CASES, ids=str)
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, impl, case):
    """Output and aux loss; arctic's smoke config adds the parallel dense FFN."""
    cf, b, s = case
    jcfg, tcfg = _cfgs(arch, impl=impl, **({} if cf is None else dict(capacity_factor=cf)))
    assert tcfg.moe.parallel_dense == (arch == "arctic-480b")
    jparams, tparams = _layer_params(jcfg)
    x = _x((b, s, jcfg.d_model), 3)
    jy, jaux = jax.jit(lambda p, x: jf.moe_ffn(p, x, jcfg))(jparams, jnp.asarray(x))
    ty, taux = tf.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty, jy, "y")
    _close(taux, jaux, "aux")
    idx = tf._router_probs(tparams, torch.from_numpy(x).reshape(b * s, -1), tcfg.moe)[2]
    if cf == 0.5:  # the case is there to drop choices: it must
        assert _chip_smoke().dropped_choices(idx, tcfg.moe) > 0


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax(arch, impl):
    """The gradient of a weighted sum of the output plus the aux loss, with
    respect to the input and every parameter leaf, with choices dropped."""
    jcfg, tcfg = _cfgs(arch, impl=impl, capacity_factor=0.5)
    jparams, tparams = _layer_params(jcfg, seed=1)
    x, ct = _x((2, 32, jcfg.d_model), 4), _x((2, 32, jcfg.d_model), 5)

    def jloss(p, x):
        y, aux = jf.moe_ffn(p, x, jcfg)
        return jnp.sum(y * ct) + aux

    jgx, jgp = jax.grad(lambda x, p: jloss(p, x), argnums=(0, 1))(jnp.asarray(x), jparams)
    leaves = jax.tree.leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tf.moe_ffn(tparams, tx, tcfg)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(ct)) + aux, [tx, *leaves])
    _close(grads[0], jgx, "dx")
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jgp)[0], grads[1:]):
        _close(got, want, jax.tree_util.keystr(path))
    router = next(i for i, t in enumerate(leaves) if t is tparams["router"])
    assert grads[1 + router].abs().max() > 0


def test_token_count_not_a_multiple_of_the_group_raises():
    """600 tokens: more than a group of 512 and not a multiple of it.  JAX
    asserts; the port raises."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    jparams, tparams = _layer_params(jcfg)
    x = _x((1, 600, jcfg.d_model))
    with pytest.raises(AssertionError, match="not divisible"):
        jf.moe_ffn(jparams, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="600 not divisible by group size 512"):
        tf.moe_ffn(tparams, torch.from_numpy(x), tcfg)


def test_unknown_impl_raises():
    _, tcfg = _cfgs("mixtral-8x22b", impl="scatter")
    params = tf.init_moe(tcfg, generator=torch.Generator().manual_seed(0), device=torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown moe impl 'scatter'"):
        tf.moe_ffn(params, torch.zeros((1, 4, tcfg.d_model)), tcfg)


def test_moe_ffn_refuses_a_dtensor_naming_its_item(tmp_path):
    """On a mesh the layer runs: the router and the experts on the local
    shards of DTensors (a one-rank ``(data, model)`` mesh, rows over data,
    the expert stacks' E over model), output and aux loss as on plain
    tensors, for both dispatches and for Arctic's dense FFN beside them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        for arch, impl in (("mixtral-8x22b", "einsum"), ("mixtral-8x22b", "gather"), ("arctic-480b", "einsum")):
            _, tcfg = _cfgs(arch, impl=impl)
            params = tf.init_moe(tcfg, generator=torch.Generator().manual_seed(0), device=torch.device("cpu"))
            x = torch.from_numpy(_x((2, 8, tcfg.d_model)))
            want, want_aux = tf.moe_ffn(params, x, tcfg)

            def place(t):  # an expert stack's E over model
                return distribute_tensor(t, mesh, [Replicate(), Shard(0) if t.ndim == 3 else Replicate()])

            dparams = {k: ({kk: place(vv) for kk, vv in v.items()} if isinstance(v, dict) else place(v))
                       for k, v in params.items()}
            with implicit_replication():
                got, aux = tf.moe_ffn(dparams, distribute_tensor(x, mesh, [Shard(0), Replicate()]), tcfg)
            assert isinstance(got, DTensor), arch
            torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(aux.full_tensor(), want_aux, rtol=1e-6, atol=1e-7)
    finally:
        if made:
            dist.destroy_process_group()


# -- the launchers and the chip run's cuts --------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_serve_clis_run_the_moe_archs_on_cpu(arch, tmp_path, capsys):
    """``launch.train`` (2 pods, ``hier_int8``) and ``launch.serve`` on the
    smoke configs: 8 x 128 tokens a step are two groups of 512 a pod."""
    from repro_torch.launch import serve, train

    train.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--pods", "2", "--strategy", "hier_int8",
                "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "after 2 steps (2 pods, hier_int8, 8 x 128)" in out
    serve.main(["--arch", arch, "--device", "cpu", "--gen", "2"])
    out = capsys.readouterr().out
    assert out.startswith("prefill: 4x32 in ") and "decode: 2 steps in " in out


def test_chip_smoke_moe_cuts_are_the_configs():
    """``chip_smoke.py``'s depth cuts at full width: the parameter counts
    and leaves it holds the card runs to are the sizing hooks' (meta device)
    and the JAX package's analytic count."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import params_specs
    from repro_torch.tree import tree_leaves

    smoke = _chip_smoke()
    for arch, layers, params, leaves in smoke.MOE_CUTS.values():
        cut = dataclasses.replace(get_config(arch), num_layers=layers)
        specs = tree_leaves(params_specs(cut))
        assert (sum(t.numel() for t in specs), len(specs)) == (params, leaves), arch
        assert dataclasses.replace(jax_config(arch), num_layers=layers).param_count() == params == cut.param_count()
        assert cut.num_groups == layers and not cut.remainder and cut.remat == "full"
