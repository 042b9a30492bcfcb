"""The port's serving path against the JAX package's, on the CPU.

The JAX parameters are initialised from a seed, converted through numpy
(``repro_torch.convert``), and both sides run ``prefill`` and then
``decode_step`` on the same prompt.  Every decode step feeds both sides the
JAX argmax, so a near tie cannot fork the two sequences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.models import DecoderLM, decode_step, init_decode_cache, prefill

# f32: two layers of sums taken in another order (XLA vs ATen, the flash
#      ref vs XLA's dense/chunked sdpa) differ by a few ulp per product.
# bf16: the frameworks round to bf16 at different points (XLA fuses some
#      casts away; the flash ref keeps probabilities in f32).
TOL = {"float32": 1e-4, "bfloat16": 5e-2}

PROMPT, GEN, BATCH = 12, 8, 2


def _cfgs(arch, dtype, moe_impl=None, **overrides):
    """Both sides' smoke configs; ``moe_impl`` sets each side's MoE dispatch."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype, **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **overrides)
    if moe_impl is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, impl=moe_impl))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, impl=moe_impl))
    return jcfg, tcfg


def _close(actual, expected, tol, what):
    np.testing.assert_allclose(
        np.asarray(actual, np.float32), np.asarray(expected, np.float32),
        rtol=tol, atol=tol, err_msg=what,
    )


def _check_cache(tcache, jcache, tol, what):
    jnp_cache = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), jcache)
    tnp_cache = cache_to_numpy(tcache)
    jleaves = jax.tree_util.tree_flatten_with_path(jnp_cache)[0]
    tflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tnp_cache)[0]}
    assert set(tflat) == {jax.tree_util.keystr(p) for p, _ in jleaves}
    for path, jv in jleaves:
        key = jax.tree_util.keystr(path)
        tv = tflat[key]
        assert tv.shape == jv.shape, key
        if key.endswith("['pos']"):
            np.testing.assert_array_equal(tv, jv, err_msg=f"{what} {key}")
        else:
            _close(tv, jv, tol, f"{what} {key}")


def _run_parity(arch, dtype, **overrides):
    jcfg, tcfg = _cfgs(arch, dtype, **overrides)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (BATCH, PROMPT))
    max_len = PROMPT + GEN
    tol = TOL[dtype]

    # jit once per config: eager lax.scan would compile on every call
    jprefill = jax.jit(lambda p, b: jax_prefill(p, b, jcfg, max_len=max_len))
    jdecode = jax.jit(lambda p, t, c, pos: jax_decode_step(p, t, c, jcfg, pos))
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)})
    tlogits, tcache = prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, max_len=max_len)
    _close(tlogits.float(), jlogits.astype(jnp.float32), tol, "prefill logits")
    _check_cache(tcache, jcache, tol, "prefill cache")

    for i in range(GEN):
        nxt = np.array(jnp.argmax(jlogits, axis=-1))
        pos = PROMPT + i
        jlogits, jcache = jdecode(jparams, jnp.asarray(nxt), jcache, jnp.int32(pos))
        tlogits, tcache = decode_step(tparams, torch.from_numpy(nxt), tcache, tcfg, pos)
        _close(tlogits.float(), jlogits.astype(jnp.float32), tol, f"decode step {i} logits")
        _check_cache(tcache, jcache, tol, f"decode step {i} cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distilgpt2_prefill_and_decode_match_jax(dtype):
    _run_parity("distilgpt2-82m", dtype)


def test_gqa_window_prefill_and_decode_match_jax():
    """mixtral's attention (GQA 4/2, window 8 < prompt 12, so the cache is
    trimmed and rolled) with a dense FFN in place of the MoE."""
    _run_parity("mixtral-8x22b", "float32", moe=None)


@pytest.mark.parametrize("arch,impl", [("mixtral-8x22b", "einsum"), ("mixtral-8x22b", "gather"),
                                       ("arctic-480b", "einsum")])
def test_moe_prefill_and_decode_match_jax(arch, impl):
    """The MoE archs with their experts: mixtral (4 experts top-2, window
    8) and arctic (8 experts top-2 beside its parallel dense FFN);
    a prefill of 2 x 12 tokens, then decode steps of 2."""
    _run_parity(arch, "float32", moe_impl=impl)


def test_olmo_prefill_and_decode_match_jax():
    """Non-parametric LayerNorm, SwiGLU, tied embeddings."""
    _run_parity("olmo-1b", "float32")


def test_init_decode_cache_matches_jax_layout():
    from repro.models import init_decode_cache as jax_init_decode_cache

    jcfg, tcfg = _cfgs("mixtral-8x22b", "float32", moe=None)
    jcache = jax_init_decode_cache(jcfg, BATCH, PROMPT + GEN)
    tcache = init_decode_cache(tcfg, BATCH, PROMPT + GEN, device="cpu")
    _check_cache(tcache, jcache, 0.0, "empty cache")


def test_decoder_lm_module_matches_functions():
    """The nn.Module owns the same tensors and runs the same functions."""
    _, tcfg = _cfgs("distilgpt2-82m", "float32")
    gen = torch.Generator().manual_seed(0)
    lm = DecoderLM.random(tcfg, generator=gen, device="cpu")
    params = lm.params()
    assert "groups/slot0/attn/wq" in dict(lm.named_parameters())
    tokens = torch.randint(0, tcfg.vocab_size, (BATCH, PROMPT), generator=gen)
    a_logits, a_cache = lm.prefill({"tokens": tokens}, max_len=PROMPT + 2)
    b_logits, b_cache = prefill(params, {"tokens": tokens}, tcfg, max_len=PROMPT + 2)
    torch.testing.assert_close(a_logits, b_logits, rtol=0, atol=0)
    nxt = a_logits.argmax(-1)
    a_logits, _ = lm.decode_step(nxt, a_cache, PROMPT)
    b_logits, _ = decode_step(params, nxt, b_cache, tcfg, PROMPT)
    torch.testing.assert_close(a_logits, b_logits, rtol=0, atol=0)


def test_cache_round_trip_through_numpy():
    """A bf16 JAX cache (ml_dtypes arrays) to the port and back, bit for bit."""
    from repro.models import init_decode_cache as jax_init_decode_cache

    jcfg, _ = _cfgs("distilgpt2-82m", "bfloat16")
    jcache = jax_init_decode_cache(jcfg, BATCH, 4)
    rng = np.random.default_rng(2)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype) if a.dtype == jnp.bfloat16 else a, jcache)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert tcache["groups"]["slot0"]["k"].dtype == torch.bfloat16
    assert tcache["groups"]["slot0"]["pos"].dtype == torch.int32
    _check_cache(tcache, jcache, 0.0, "round trip")
