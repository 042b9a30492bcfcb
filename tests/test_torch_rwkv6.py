"""The port's RWKV6 slice against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The WKV
recurrence is held against the JAX oracle and the Pallas kernel in
interpret mode; the blocks and the whole rwkv6 stack (prefill, every cache
leaf, teacher-forced decode) against the JAX model, whose own time-mix runs
the jnp scan.  JAX initialises the mixes, bonus, decay offsets and norm
scales to constants that would hide swapped or dropped leaves
(``mix_* = 0.5``, ``bonus = 0``, ...), so the parity tests overwrite them
with seeded random values before converting.
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

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.rwkv6_wkv.kernel import wkv6_fwd as jax_wkv6_fwd
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv6_ref
from repro.models import decode_step as jax_decode_step
from repro.models import init_decode_cache as jax_init_decode_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models import rwkv6 as jr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy, params_to_numpy
from repro_torch.kernels.rwkv6_wkv import GRAD_CHUNK, bwd_route, wkv6, wkv6_bwd_chunked_ref, wkv6_bwd_ref, wkv6_ref
from repro_torch.models import DecoderLM, decode_step, init_decode_cache, init_params, loss_fn, prefill
from repro_torch.models import rwkv6 as tr

# TestWkv6's own tolerances: f32 sums in another order; bf16 inputs round
# at other points in the two frameworks' projections.
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, t, h, n, chunk): TestWkv6's sweep
SWEEP = [(1, 32, 1, 8, 8), (2, 64, 3, 16, 16), (2, 128, 2, 64, 32)]
# d_model 128 > LORA_RANK 64: a transposed decay_a / decay_b has the wrong shape
WIDE = dict(d_model=128, rwkv_head_dim=16, num_heads=8, num_kv_heads=8)
GEN, BATCH = 8, 2
RWKV_LEAVES = 27  # embed, final norm, unembed and a group of 19 + 2 x 2 norm leaves


def _close(actual, expected, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(actual, np.float32), np.asarray(expected, np.float32), rtol=tol, atol=tol, err_msg=what
    )


def _wkv_inputs(seed, b, t, h, n):
    """r, k, v, w [B, T, H, N], u [H, N], state0 [B, H, N, N] as TestWkv6 draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)) * 0.5 for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-(rng.standard_normal((b, t, h, n)) + 2.0)))
    u = rng.standard_normal((h, n)) * 0.1
    s0 = rng.standard_normal((b, h, n, n)) * 0.1
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _both(arrays, dtype):
    """The inputs for JAX and for the port: r, k, v, w in ``dtype``; u, state0 f32."""
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays[:4]] + [jnp.asarray(a) for a in arrays[4:]]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays[:4]] + [torch.from_numpy(a) for a in arrays[4:]]
    return j, t


# -- the WKV recurrence ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n,chunk", SWEEP)
def test_wkv6_matches_jax_ref_and_pallas_interpret(dtype, b, t, h, n, chunk):
    j, tt = _both(_wkv_inputs(t, b, t, h, n), dtype)
    out, fin = wkv6(*tt)
    assert out.dtype == fin.dtype == torch.float32
    assert out.shape == (b, t, h, n) and fin.shape == (b, h, n, n)
    plain = wkv6_ref(*tt)
    torch.testing.assert_close(out, plain[0], rtol=0, atol=0)
    torch.testing.assert_close(fin, plain[1], rtol=0, atol=0)
    for name, (jo, jf) in (
        ("ref", jax_wkv6_ref(*j)),
        ("pallas interpret", jax_wkv6_fwd(*j, chunk=chunk, interpret=True)),
    ):
        _close(out, jo, TOL[dtype], f"out vs {name}")
        _close(fin, jf, TOL[dtype], f"state vs {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_ragged_t_matches_jax(dtype):
    """T = 37 is no multiple of any chunk: the port takes it as it is."""
    j, tt = _both(_wkv_inputs(5, 2, 37, 3, 16), dtype)
    out, fin = wkv6(*tt)
    jo, jf = jax_wkv6_ref(*j)
    _close(out, jo, TOL[dtype], "out")
    _close(fin, jf, TOL[dtype], "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_matches_pallas_interpret_off_any_chunk(dtype):
    """T = 51 (three Pallas chunks of 17) is a multiple of none of the
    chunks the CUDA kernel stages (8, 16, 32, 64): the plain version the
    kernel is held to on the card against the Pallas kernel itself."""
    j, tt = _both(_wkv_inputs(9, 2, 51, 2, 64), dtype)
    out, fin = wkv6_ref(*tt)
    jo, jf = jax_wkv6_fwd(*j, chunk=17, interpret=True)
    _close(out, jo, TOL[dtype], "out")
    _close(fin, jf, TOL[dtype], "state")


def test_wkv6_stepwise_equals_whole():
    """T single steps, the state carried in place, == one T-step call
    (mirrors test_models.py::TestRwkv::test_scan_vs_stepwise)."""
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _wkv_inputs(0, 1, 8, 2, 8))
    out_whole, fin_whole = wkv6(r, k, v, w, u)
    state = torch.zeros((1, 2, 8, 8))
    outs = []
    for i in range(8):
        sl = slice(i, i + 1)
        o, same = wkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, state, state_out=state)
        assert same is state
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), out_whole, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state, fin_whole, rtol=1e-5, atol=1e-6)


def test_wkv6_refuses_bad_shapes():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(1, 1, 4, 2, 8))
    with pytest.raises(ValueError, match="shape"):
        wkv6(r, k[:, :3], v, w, u, s0)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="state0 must be"):
        wkv6(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="state_out .* has no gradient"):
        wkv6(r.clone().requires_grad_(True), k, v, w, u, s0, state_out=s0.clone())
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        wkv6(r.clone().requires_grad_(True), k, v, w, u, s0, chunk=0)


# -- the WKV gradient ----------------------------------------------------------------


def _grad_inputs(seed, b, t, h, n, *, tiny_w=False):
    """_wkv_inputs, with w drawn down to 1e-30 on a quarter of the lanes
    where ``tiny_w``, and the gradients of out and of the final state."""
    arrays = _wkv_inputs(seed, b, t, h, n)
    rng = np.random.default_rng(seed + 100)
    if tiny_w:
        arrays[3] = np.where(rng.random(arrays[3].shape) < 0.25, np.float32(1e-30), arrays[3])
    dout = rng.standard_normal((b, t, h, n)).astype(np.float32)
    dstate = (rng.standard_normal((b, h, n, n)) * 0.5).astype(np.float32)
    return arrays, dout, dstate


def _port_grads(arrays, dout, dstate, chunk, dtype=torch.float32):
    xs = [torch.from_numpy(a).to(dtype if i < 4 else torch.float32).requires_grad_(True) for i, a in enumerate(arrays)]
    out, final = tr._wkv_with_initial_state(*xs, chunk=chunk)
    loss = (out * torch.from_numpy(dout)).sum() + (final * torch.from_numpy(dstate)).sum()
    return out, final, torch.autograd.grad(loss, xs)


# T = 3 chunks (JAX's chunked, checkpointed scan) and 2 chunks + 1 (its
# plain scan), chunk 4; a ragged last chunk and one step on the port's side
@pytest.mark.parametrize("t", [12, 9], ids=["jax_chunked", "jax_unchunked"])
def test_wkv_grad_matches_jax_grad(t):
    """The port's WKV function, forward and every input's gradient, against
    ``jax.grad`` of ``repro.models.rwkv6._wkv_with_initial_state`` with the
    same chunk, through a loss that reads the final state too."""
    chunk = 4
    arrays, dout, dstate = _grad_inputs(t, 2, t, 3, 8)

    def jloss(r, k, v, w, u, s0):
        out, final = jr._wkv_with_initial_state(r, k, v, w, u, s0, chunk=chunk)
        return jnp.sum(out * dout) + jnp.sum(final * dstate), (out, final)

    (_, (jout, jfinal)), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    out, final, grads = _port_grads(arrays, dout, dstate, chunk)
    np.testing.assert_allclose(out.detach(), jout, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(final.detach(), jfinal, rtol=1e-4, atol=1e-5)
    for name, got, want in zip(("r", "k", "v", "w", "u", "state0"), grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,chunk,tiny_w", [(1, 4, False), (17, 16, False), (21, 4, True), (12, 12, False)])
def test_wkv6_bwd_ref_matches_autograd_through_wkv6_ref(t, chunk, tiny_w, dtype):
    """The chunked backward against autograd through the plain forward loop;
    with w down to 1e-30 every gradient stays finite."""
    arrays, dout, dstate = _grad_inputs(t + chunk, 2, t, 2, 8, tiny_w=tiny_w)
    out, final, grads = _port_grads(arrays, dout, dstate, chunk, TDT[dtype])
    xs = [torch.from_numpy(a).to(TDT[dtype] if i < 4 else torch.float32).requires_grad_(True)
          for i, a in enumerate(arrays)]
    pout, pfinal = wkv6_ref(*xs)
    want = torch.autograd.grad((pout * torch.from_numpy(dout)).sum() + (pfinal * torch.from_numpy(dstate)).sum(), xs)
    torch.testing.assert_close(out, pout, rtol=0, atol=0)
    torch.testing.assert_close(final, pfinal, rtol=0, atol=0)
    for name, got, w in zip(("r", "k", "v", "w", "u", "state0"), grads, want):
        assert got.dtype == w.dtype and bool(torch.isfinite(got).all()), name
        torch.testing.assert_close(got.float(), w.float(), rtol=1e-5, atol=1e-5, msg=f"d{name}")


def test_wkv6_bwd_ref_takes_no_final_state_gradient():
    """``dstate=None`` (the loss reads only out) equals a zero ``dstate``."""
    arrays, dout, _ = _grad_inputs(3, 1, 10, 2, 8)
    xs = [torch.from_numpy(a) for a in arrays]
    _, _, bounds = wkv6_ref(*xs, chunk=4)
    none = wkv6_bwd_ref(*xs[:5], bounds, torch.from_numpy(dout), None, 4)
    zero = wkv6_bwd_ref(*xs[:5], bounds, torch.from_numpy(dout), torch.zeros_like(xs[5]), 4)
    for a, b in zip(none, zero):
        torch.testing.assert_close(a, b, rtol=0, atol=0)



# -- the chunked backward's plain model (``csrc/wkv6_bwd.cu``'s algorithm) ---------

# w at 1e-30, at a float32 denormal, exactly 0 on a quarter of the lanes, and
# a run of steps with w == 0 on every lane that starts a 16-step sub-chunk
W_MODES = {
    "tiny": np.float32(1e-30),
    "denormal": np.float32(1e-40),
    "zero": np.float32(0.0),
}


def _chunked_inputs(t, n, w_mode, b=2, h=2):
    arrays, dout, dstate = _grad_inputs(t + n, b, t, h, n)
    rng = np.random.default_rng(t + 7 * n)
    if w_mode in W_MODES:
        arrays[3] = np.where(rng.random(arrays[3].shape) < 0.25, W_MODES[w_mode], arrays[3])
    elif w_mode == "zero_run":  # steps 16..20 and, where T reaches it, a whole sub-chunk from 256
        arrays[3][:, 16:21] = 0.0
        arrays[3][:, 256:272] = 0.0
    assert np.isfinite(arrays[3]).all()
    return arrays, dout, dstate


# (T, chunk, N, w): T of one step, one sub-chunk + 1, a chunk + 5 and over
# two chunks; chunks of one sub-chunk (16) and of 256 steps; N 8 and 64
CHUNKED_CASES = [
    (1, 16, 8, None), (1, 256, 64, "zero"),
    (17, 16, 8, "tiny"), (17, 256, 64, None),
    (261, 16, 64, "denormal"), (261, 256, 8, "zero_run"), (261, 256, 64, "tiny"),
    (600, 16, 8, "zero"), (600, 256, 64, "zero_run"), (600, 256, 8, "denormal"),
]


def _exact_grads(arrays, dout, dstate, chunk):
    """wkv6_bwd_ref on float64 copies of the inputs: the exact yardstick."""
    xs = [torch.from_numpy(a).double() for a in arrays]
    _, _, bounds = wkv6_ref(*xs, chunk=chunk)
    return wkv6_bwd_ref(*xs[:5], bounds, torch.from_numpy(dout).double(), torch.from_numpy(dstate).double(), chunk)


def _chunked_grads(arrays, dout, dstate, chunk):
    xs = [torch.from_numpy(a) for a in arrays]
    _, _, bounds = wkv6_ref(*xs, chunk=chunk)
    return wkv6_bwd_chunked_ref(*xs[:5], bounds, torch.from_numpy(dout), torch.from_numpy(dstate), chunk)


@pytest.mark.parametrize("t,chunk,n,w_mode", CHUNKED_CASES, ids=lambda x: str(x))
def test_wkv6_bwd_chunked_ref_matches_wkv6_bwd_ref(t, chunk, n, w_mode):
    """The kernel's algorithm in float32 (chunk-parallel G, sub-chunk
    products, decays as running products, dw from its parts) against the
    step-by-step backward evaluated in float64, every output finite.  (The
    step-by-step backward in float32 sums du over B T = 1200 steps in
    another order, itself up to 1.2x the bar from the float64 value.)"""
    arrays, dout, dstate = _chunked_inputs(t, n, w_mode)
    got = _chunked_grads(arrays, dout, dstate, chunk)
    want = _exact_grads(arrays, dout, dstate, chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.double(), w, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("t,chunk,n,w_mode", CHUNKED_CASES, ids=lambda x: str(x))
def test_wkv6_bwd_chunked_ref_matches_jax_grad(t, chunk, n, w_mode):
    """The same model against ``jax.grad`` of
    ``repro.models.rwkv6._wkv_with_initial_state`` (its chunked, checkpointed
    scan where T allows), through a loss reading out and the final state.
    du, a float32 sum over B T steps in JAX, is held to the float64
    yardstick instead: JAX's own sum is up to 1.1x the bar from it (T 261,
    N 64)."""
    arrays, dout, dstate = _chunked_inputs(t, n, w_mode)

    def jloss(r, k, v, w, u, s0):
        out, final = jr._wkv_with_initial_state(r, k, v, w, u, s0, chunk=chunk)
        return jnp.sum(out * dout) + jnp.sum(final * dstate)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in arrays))
    got = _chunked_grads(arrays, dout, dstate, chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, jgrads):
        assert bool(torch.isfinite(g).all()), name
        if name != "du":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    exact_du = _exact_grads(arrays, dout, dstate, chunk)[4]
    np.testing.assert_allclose(got[4].double().numpy(), exact_du.numpy(), rtol=1e-5, atol=1e-5, err_msg="du")


def test_wkv6_bwd_route_follows_dtype_and_head_dim():
    """The backward kernel's route: TF32 products for bf16 r, k, v (the
    training path), 3xTF32 for float32; a head dim it does not take raises."""
    for n in (8, 16, 32, 64, 128):
        assert bwd_route(torch.bfloat16, n) == "tf32"
        assert bwd_route(torch.float32, n) == "3xtf32"
    with pytest.raises(ValueError, match="head dim"):
        bwd_route(torch.bfloat16, 48)


# -- the blocks ------------------------------------------------------------------


def _randomise_block(block, rng):
    """Seeded values in place of the init constants (any leading group axis kept)."""
    out = dict(block)

    def draw(name, fn):
        out[name] = jnp.asarray(fn(np.shape(block[name])).astype(np.float32))

    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "cm_mix"):
        draw(name, lambda s: rng.uniform(0.05, 0.95, s))
    draw("bonus", lambda s: rng.standard_normal(s) * 0.1)
    draw("gn_scale", lambda s: 1.0 + rng.standard_normal(s) * 0.1)
    draw("decay_w0", lambda s: np.asarray(block["decay_w0"]) + rng.standard_normal(s) * 0.5)
    return out


def _randomise(params, seed):
    """The whole JAX tree with every RWKV layer's and norm's constants drawn."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a, params)
    for slot in params["groups"].values():
        slot["rwkv"] = _randomise_block(slot["rwkv"], rng)
        for norm in ("norm1", "norm2"):
            shape = np.shape(slot[norm]["scale"])
            slot[norm] = {
                "scale": jnp.asarray((1.0 + rng.standard_normal(shape) * 0.1).astype(np.float32)),
                "bias": jnp.asarray((rng.standard_normal(shape) * 0.1).astype(np.float32)),
            }
    return params


def _cfgs(dtype, prompt_overrides=None):
    overrides = dict(prompt_overrides or {}, dtype=dtype)
    return dataclasses.replace(jax_smoke("rwkv6-7b"), **overrides), dataclasses.replace(
        get_smoke_config("rwkv6-7b"), **overrides
    )


def _block_case(dtype, overrides, seed):
    jcfg, tcfg = _cfgs(dtype, overrides)
    jp = _randomise_block(jr.init_rwkv_block(jax.random.PRNGKey(seed), jcfg), np.random.default_rng(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _act(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(dtype):
    jx, tx = _act((2, 5, 64), 0, dtype)
    scale = (1.0 + np.random.default_rng(1).standard_normal(64) * 0.1).astype(np.float32)
    ref = jr._group_norm(jx, jnp.asarray(scale), 4, 16)
    out = tr._group_norm(tx, torch.from_numpy(scale), 4, 16)
    assert out.dtype == TDT[dtype]
    _close(out.float(), ref.astype(jnp.float32), 1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("overrides", [{}, WIDE], ids=["smoke", "d128"])
def test_time_mix_matches_jax(dtype, overrides):
    jcfg, tcfg, jp, tp = _block_case(dtype, overrides, 3)
    d, n = jcfg.d_model, jcfg.rwkv_head_dim
    jx, tx = _act((2, 12, d), 4, dtype)
    jshift, tshift = _act((2, d), 5, dtype)
    s0 = (np.random.default_rng(6).standard_normal((2, d // n, n, n)) * 0.1).astype(np.float32)
    jy, jsh, jwkv = jr.time_mix(jp, jx, jcfg, shift_state=jshift, wkv_state=jnp.asarray(s0))
    ty, tsh, twkv = tr.time_mix(tp, tx, tcfg, shift_state=tshift, wkv_state=torch.from_numpy(s0))
    assert ty.dtype == TDT[dtype] and twkv.dtype == torch.float32
    _close(ty.float(), jy.astype(jnp.float32), TOL[dtype], "y")
    _close(tsh.float(), jsh.astype(jnp.float32), 0.0, "shift")
    _close(twkv, jwkv, TOL[dtype], "wkv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _block_case(dtype, WIDE, 7)
    jx, tx = _act((2, 12, jcfg.d_model), 8, dtype)
    jshift, tshift = _act((2, jcfg.d_model), 9, dtype)
    jy, jsh = jr.channel_mix(jp, jx, jcfg, shift_state=jshift)
    ty, tsh = tr.channel_mix(tp, tx, tcfg, shift_state=tshift)
    _close(ty.float(), jy.astype(jnp.float32), TOL[dtype], "y")
    _close(tsh.float(), jsh.astype(jnp.float32), 0.0, "shift")


# -- the whole slice: prefill, cache, decode -------------------------------------


def _check_cache(tcache, jcache, tol, what):
    jflat = {
        jax.tree_util.keystr(p): np.asarray(v, np.float32)
        for p, v in jax.tree_util.tree_flatten_with_path(jcache)[0]
    }
    tflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(cache_to_numpy(tcache))[0]}
    assert set(tflat) == set(jflat) == {
        "['groups']['slot0']['shift_att']", "['groups']['slot0']['shift_ffn']", "['groups']['slot0']['wkv']",
    }
    for key, jv in jflat.items():
        assert tflat[key].shape == jv.shape, key
        _close(tflat[key], jv, tol, f"{what} {key}")


@pytest.mark.parametrize(
    "dtype,overrides,prompt",
    [
        ("float32", {}, 12),
        ("bfloat16", {}, 12),
        ("float32", WIDE, 12),
        # 768 > 2 * 256 and a multiple of 256: JAX's chunked, checkpointed scan
        ("float32", {}, 768),
    ],
    ids=["f32", "bf16", "f32-d128", "f32-prompt768"],
)
def test_rwkv6_prefill_and_decode_match_jax(dtype, overrides, prompt):
    jcfg, tcfg = _cfgs(dtype, overrides)
    jparams = _randomise(jax_init_params(jax.random.PRNGKey(0), jcfg), 1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (BATCH, prompt))
    tol = TOL[dtype]

    jprefill = jax.jit(lambda p, b: jax_prefill(p, b, jcfg))
    jdecode = jax.jit(lambda p, t, c, pos: jax_decode_step(p, t, c, jcfg, pos))
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)})
    # max_len sizes attention caches only: an RWKV state has no length
    tlogits, tcache = prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, max_len=prompt + GEN)
    _close(tlogits.float(), jlogits.astype(jnp.float32), tol, "prefill logits")
    _check_cache(tcache, jcache, tol, "prefill cache")

    wkv = tcache["groups"]["slot0"]["wkv"]
    for i in range(GEN):
        nxt = np.array(jnp.argmax(jlogits, axis=-1))
        jlogits, jcache = jdecode(jparams, jnp.asarray(nxt), jcache, jnp.int32(prompt + i))
        tlogits, tcache = decode_step(tparams, torch.from_numpy(nxt), tcache, tcfg, prompt + i)
        _close(tlogits.float(), jlogits.astype(jnp.float32), tol, f"decode step {i} logits")
        _check_cache(tcache, jcache, tol, f"decode step {i} cache")
    assert tcache["groups"]["slot0"]["wkv"] is wkv  # updated in place


def test_init_decode_cache_matches_jax_layout():
    jcfg, tcfg = _cfgs("bfloat16", WIDE)
    jcache = jax_init_decode_cache(jcfg, BATCH, 16)
    tcache = init_decode_cache(tcfg, BATCH, 16, device="cpu")
    _check_cache(tcache, jcache, 0.0, "empty cache")
    assert tcache["groups"]["slot0"]["wkv"].dtype == torch.float32
    assert tcache["groups"]["slot0"]["shift_att"].dtype == torch.bfloat16


def test_params_and_cache_round_trip_through_numpy():
    """f32 params and a bf16 cache (ml_dtypes arrays), to the port and back, bit for bit."""
    jcfg, _ = _cfgs("bfloat16", WIDE)
    jparams = jax.tree.map(np.asarray, _randomise(jax_init_params(jax.random.PRNGKey(3), jcfg), 4))
    back = params_to_numpy(params_from_numpy(jparams, device="cpu"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), jparams, back)
    rng = np.random.default_rng(5)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jax_init_decode_cache(jcfg, BATCH, 4)
    )
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert tcache["groups"]["slot0"]["shift_ffn"].dtype == torch.bfloat16
    assert tcache["groups"]["slot0"]["wkv"].dtype == torch.float32
    _check_cache(tcache, jcache, 0.0, "round trip")


def test_full_config_meta_init_matches_jax_eval_shape():
    """rwkv6-7b at full width: the leaves' own count, not cfg.param_count()."""
    jshape = jax.eval_shape(lambda k: jax_init_params(k, jax_config("rwkv6-7b")), jax.random.PRNGKey(0))
    tp = init_params(get_config("rwkv6-7b"), device="meta")
    jl = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype)) for p, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    tl = {
        jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        for p, v in jax.tree_util.tree_flatten_with_path(tp)[0]
    }
    assert tl == jl
    assert len(tl) == 27
    assert sum(v.numel() for v in jax.tree.leaves(tp)) == 7_534_682_112
    assert tl["['groups']['slot0']['rwkv']['decay_a']"][0] == (32, 4096, 64)
    assert tl["['groups']['slot0']['rwkv']['decay_b']"][0] == (32, 64, 4096)


@pytest.mark.parametrize(
    "remat,seq", [("none", 16), ("full", 16), ("none", 768)], ids=["none", "remat_full", "seq768_chunked"]
)
def test_loss_and_every_grad_leaf_match_jax(remat, seq):
    """The whole rwkv6 smoke ``loss_fn`` and every leaf's gradient against
    ``jax.grad`` of the JAX one, through ``convert.py``'s weights (seeded
    constants in place of the init ones).  Sequence 768 runs JAX's chunked,
    checkpointed WKV scan and three of the port's 256-step chunks."""
    jcfg, tcfg = _cfgs("float32", {"remat": remat})
    jparams = _randomise(jax_init_params(jax.random.PRNGKey(0), jcfg), 1)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, seq + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p, b: jax_loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = jax.tree.leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5, atol=2e-5)
    jflat = [(jax.tree_util.keystr(p), np.asarray(g)) for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert len(jflat) == len(grads) == RWKV_LEAVES
    for (path, want), got in zip(jflat, grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5, err_msg=path)


def test_remat_runs_the_wkv_forward_once_a_layer(monkeypatch):
    """Under ``remat="full"`` the recomputed group forward replays the WKV
    outputs of the first: one chunked forward a layer, the same gradients."""
    from repro_torch.kernels.rwkv6_wkv import ops

    calls = []
    plain = ops.wkv6_ref
    monkeypatch.setattr(ops, "wkv6_ref", lambda *a, **kw: calls.append(kw.get("chunk")) or plain(*a, **kw))
    grads = {}
    for remat in ("none", "full"):
        _, tcfg = _cfgs("float32", {"remat": remat})
        params = init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
        leaves = jax.tree.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        tokens = torch.randint(0, tcfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
        calls.clear()
        loss, _ = loss_fn(params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}, tcfg)
        grads[remat] = torch.autograd.grad(loss, leaves)
        assert calls == [GRAD_CHUNK] * tcfg.num_layers, remat
    for a, b in zip(grads["none"], grads["full"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decoder_lm_module_serves_rwkv6():
    _, tcfg = _cfgs("float32", WIDE)
    lm = DecoderLM.random(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert "groups/slot0/rwkv/decay_a" in dict(lm.named_parameters())
    tokens = torch.randint(0, tcfg.vocab_size, (BATCH, 10), generator=torch.Generator().manual_seed(1))
    a_logits, a_cache = lm.prefill({"tokens": tokens})
    b_logits, b_cache = prefill(lm.params(), {"tokens": tokens}, tcfg)
    torch.testing.assert_close(a_logits, b_logits, rtol=0, atol=0)
    nxt = a_logits.argmax(-1)
    a_logits, _ = lm.decode_step(nxt, a_cache, 10)
    b_logits, _ = decode_step(lm.params(), nxt, b_cache, tcfg, 10)
    torch.testing.assert_close(a_logits, b_logits, rtol=0, atol=0)


def test_serve_cli_runs_rwkv6_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(root / "src"), env.get("PYTHONPATH")]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv6-7b", "--device", "cpu", "--gen", "2"],
        env=env, capture_output=True, text=True, timeout=120, cwd=root,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("prefill: 4x32 in ")
    assert "decode: 2 steps in " in out.stdout
