"""The port's layers, FFN and parameter layout against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models.ffn import dense_ffn as jax_dense_ffn
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import init_params
from repro_torch.models import layers as tl
from repro_torch.models.ffn import dense_ffn

# f32 elementwise math and short reductions agree to a few ulp.
F32 = dict(rtol=1e-6, atol=1e-6)
# bf16: one rounding step of the output (2**-8 relative) at most.
BF16 = dict(rtol=1e-2, atol=1e-2)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(a).to(dtype)


def _np(t):
    return t.float().numpy()


def test_layer_norm_f32():
    x, s, b = _x((3, 5, 32)), _x((32,), 1), _x((32,), 2)
    np.testing.assert_allclose(
        _np(tl.layer_norm(_t(x), _t(s), _t(b))), np.asarray(jl.layer_norm(x, s, b)), **F32
    )
    np.testing.assert_allclose(
        _np(tl.nonparametric_ln(_t(x))), np.asarray(jl.nonparametric_ln(x)), **F32
    )


def test_layer_norm_bf16_casts_where_jax_puts_them():
    """mean and rsqrt are cast to bf16 before the subtract and multiply.

    Exact bf16 agreement would need identical f32 reductions; what the
    test pins is that the port rounds at the same points, which keeps it
    within one bf16 ulp of JAX where F.layer_norm (f32 throughout, one
    final rounding) lands measurably further away.
    """
    x, s, b = _x((4, 16, 64), 3, 4.0) + 3.0, _x((64,), 4), _x((64,), 5)
    jout = np.asarray(jl.layer_norm(jnp.asarray(x, jnp.bfloat16), s, b).astype(jnp.float32))
    tout = tl.layer_norm(_t(x, torch.bfloat16), _t(s), _t(b))
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), jout, **BF16)
    fused = torch.nn.functional.layer_norm(
        _t(x, torch.bfloat16).float(), (64,), _t(s), _t(b), eps=1e-5
    ).to(torch.bfloat16)
    assert np.abs(_np(tout) - jout).mean() < np.abs(_np(fused) - jout).mean()


def test_rms_norm_f32():
    x, s = _x((3, 5, 32)), _x((32,), 1, 0.1)
    np.testing.assert_allclose(_np(tl.rms_norm(_t(x), _t(s))), np.asarray(jl.rms_norm(x, s)), **F32)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    x = _x((2, 12, 3, 16))
    pos = np.arange(12)
    out = tl.apply_rope(_t(x), torch.tensor(pos), theta=10_000.0, fraction=fraction)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10_000.0, fraction=fraction)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)


@pytest.mark.parametrize("name", ["gelu", "relu_sq", "silu"])
def test_activation_fn(name):
    x = _x((64,), 6, 3.0)
    np.testing.assert_allclose(
        _np(tl.activation_fn(name)(_t(x))), np.asarray(jl.activation_fn(name)(x)), **F32
    )


def test_softcap():
    x = _x((64,), 7, 50.0)
    np.testing.assert_allclose(_np(tl.softcap(_t(x), 30.0)), np.asarray(jl.softcap(x, 30.0)), **F32)
    assert tl.softcap(_t(x), None) is not None and torch.equal(tl.softcap(_t(x), None), _t(x))


@pytest.mark.parametrize(
    "arch,overrides",
    [
        ("distilgpt2-82m", {}),  # gelu + biases
        ("olmo-1b", {}),  # swiglu
        ("recurrentgemma-9b", {}),  # geglu
        ("rwkv6-7b", {}),  # relu_sq
    ],
)
def test_dense_ffn_matches_jax(arch, overrides):
    from repro.models.ffn import init_dense_ffn as jax_init_dense_ffn

    jcfg = dataclasses.replace(jax_smoke(arch), **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    jp = jax_init_dense_ffn(jax.random.PRNGKey(1), jcfg)
    if jcfg.use_bias_mlp:  # zero-initialised: give them values to test
        jp = dict(jp, b_up=jnp.asarray(_x(jp["b_up"].shape, 8)), b_down=jnp.asarray(_x(jp["b_down"].shape, 9)))
    x = _x((2, 5, jcfg.d_model), 10)
    ref = np.asarray(jax_dense_ffn(jp, jnp.asarray(x), jcfg))
    out = dense_ffn(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), _t(x), tcfg)
    np.testing.assert_allclose(_np(out), ref, rtol=1e-5, atol=1e-5)  # d_ff-long f32 sums


def _jax_layout(tree):
    return {
        jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _torch_layout(tree):
    return {
        jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("arch", ["distilgpt2-82m", "olmo-1b", "chatglm3-6b", "musicgen-large", "phi-3-vision-4.2b"])
def test_init_params_layout_matches_jax_smoke(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert _torch_layout(tp) == _jax_layout(jp)


def test_init_params_layout_matches_jax_full_distilgpt2():
    """Full width: jax.eval_shape and the meta device, so nothing is allocated."""
    jshape = jax.eval_shape(lambda k: jax_init_params(k, jax_config("distilgpt2-82m")), jax.random.PRNGKey(0))
    tp = init_params(get_config("distilgpt2-82m"), device="meta")
    assert _torch_layout(tp) == _jax_layout(jshape)
    assert sum(v.numel() for v in jax.tree.leaves(tp)) == sum(
        int(np.prod(v.shape)) for v in jax.tree.leaves(jshape)
    )


def test_init_std_matches_jax():
    """Only shapes and the spread of the draws match the JAX initialisers."""
    kw = dict(generator=torch.Generator().manual_seed(0), device=torch.device("cpu"))
    w = tl.dense_init((768, 3072), **kw)
    # truncated normal at +-2 std has std 0.8796 of the untruncated one
    assert abs(w.std().item() * np.sqrt(768) - 0.8796) < 0.01
    assert w.abs().max().item() <= 2.0 / np.sqrt(768)
    assert abs(tl.embed_init((4096, 768), **kw).std().item() - 0.02) < 1e-3


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-9b", "rwkv6-7b"])
def test_unported_layers_raise(arch):
    """MoE and RG-LRU layers have their parameters, but a pass through them
    raises; RWKV6 layers serve, and a gradient through them (training)
    raises."""
    from repro_torch.models import loss_fn

    cfg = get_smoke_config(arch)
    if arch != "rwkv6-7b":
        params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.zeros((1, 5), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
        return

    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.zeros((1, 5), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
