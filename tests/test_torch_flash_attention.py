"""The port's flash attention against the JAX package's.

On the CPU the port's wrapper computes its plain version; both it and the
plain version itself are held against the JAX wrapper running the Pallas
kernel in interpret mode, on the shapes of ``TestFlashAttention`` in
``tests/test_kernels.py``, and against ``flash_attention_ref`` at ragged
lengths that the JAX wrapper cannot tile.  The JAX package has no backward
kernel, so the port's plain backward (``flash_attention_bwd_ref``) and its
autograd function (``FlashAttentionFn``, which takes the plain versions on
the CPU) are held against ``jax.vjp`` of ``flash_attention_ref``.
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_ref,
)

# The JAX suite's own tolerances (tests/test_kernels.py::TOL).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (b, sq, sk, h, kvh, hd, causal, window, softcap, block)
SWEEP = [
    (1, 128, 128, 1, 1, 64, True, None, None, 128),
    (2, 256, 256, 4, 2, 64, True, None, None, 128),
    (2, 256, 256, 8, 1, 128, True, None, None, 128),  # MQA
    (1, 512, 512, 4, 4, 128, True, None, None, 256),
    (2, 256, 256, 4, 2, 64, True, 32, None, 128),
    (2, 256, 256, 4, 2, 64, True, 64, None, 128),
    (2, 256, 256, 4, 2, 64, True, 128, None, 128),
    (1, 256, 256, 2, 2, 64, False, None, None, 128),
    (1, 128, 128, 2, 1, 64, True, None, 30.0, 128),
    (1, 128, 384, 2, 2, 64, False, None, None, 128),  # cross lengths
]

RAGGED = [
    (2, 100, 100, 4, 2, 64, True, None, None),
    (1, 37, 37, 2, 2, 16, True, None, None),
    (1, 100, 100, 4, 1, 128, True, 48, None),
    (1, 37, 100, 2, 2, 64, False, None, 30.0),
]


def _qkv(seed, b, sq, sk, h, kvh, hd, dtype):
    """Model layout [B, S, H, hd], made with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd), np.float32)
    k = rng.standard_normal((b, sk, kvh, hd), np.float32)
    v = rng.standard_normal((b, sk, kvh, hd), np.float32)
    if dtype == "bfloat16":  # round once, identically for both frameworks
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    return q, k, v


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.tensor(a).to(device=device, dtype=getattr(torch, dtype))


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP, ids=lambda c: "b{}-sq{}-sk{}-h{}-kvh{}-hd{}-c{}-w{}-cap{}-blk{}".format(*c))
def test_matches_jax_kernel_interpret(dtype, case):
    b, sq, sk, h, kvh, hd, causal, window, cap, block = case
    q, k, v = _qkv(0, b, sq, sk, h, kvh, hd, dtype)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    expected = jax_flash_attention(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
        block_q=block, block_k=block, interpret=True, **kw,
    )
    expected = np.asarray(expected.astype(jnp.float32))
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), expected, rtol=TOL[dtype], atol=TOL[dtype])
    plain, _ = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), **kw)
    np.testing.assert_allclose(
        _np(plain.transpose(1, 2)), expected, rtol=TOL[dtype], atol=TOL[dtype]
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RAGGED, ids=lambda c: "b{}-sq{}-sk{}-h{}-kvh{}-hd{}-c{}-w{}-cap{}".format(*c))
def test_ragged_lengths_match_jax_ref(dtype, case):
    b, sq, sk, h, kvh, hd, causal, window, cap = case
    q, k, v = _qkv(1, b, sq, sk, h, kvh, hd, dtype)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    hf = lambda a: jnp.swapaxes(_jax(a, dtype), 1, 2)  # noqa: E731
    expected = np.asarray(jnp.swapaxes(jax_flash_ref(hf(q), hf(k), hf(v), **kw), 1, 2).astype(jnp.float32))
    out = flash_attention(*(_torch(a, dtype) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(out), expected, rtol=TOL[dtype], atol=TOL[dtype])


# (b, sq, sk, h, kvh, hd, causal, window, softcap)
BWD = [
    (2, 64, 64, 4, 2, 16, True, None, None),  # GQA
    (1, 100, 100, 4, 1, 64, True, 48, None),  # MQA, window, ragged
    (1, 64, 64, 2, 2, 64, True, None, 30.0),  # softcap
    (1, 37, 100, 2, 2, 16, False, None, 30.0),  # cross lengths, no mask
    (1, 100, 37, 2, 1, 16, True, None, None),  # more queries than keys
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD, ids=lambda c: "b{}-sq{}-sk{}-h{}-kvh{}-hd{}-c{}-w{}-cap{}".format(*c))
def test_backward_matches_jax_vjp(dtype, case):
    b, sq, sk, h, kvh, hd, causal, window, cap = case
    q, k, v = _qkv(5, b, sq, sk, h, kvh, hd, dtype)
    do = _qkv(6, b, sq, sq, h, h, hd, dtype)[0]
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    hf = lambda a: jnp.swapaxes(_jax(a, dtype), 1, 2)  # noqa: E731
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_ref(q_, k_, v_, **kw), hf(q), hf(k), hf(v))
    expected = [np.asarray(jnp.swapaxes(g, 1, 2).astype(jnp.float32)) for g in vjp(hf(do))]
    tol = TOL[dtype]

    # the plain backward, heads-first, from the plain forward's output and lse
    th = [_torch(a, dtype).transpose(1, 2) for a in (q, k, v, do)]
    o, lse = flash_attention_ref(*th[:3], **kw)
    np.testing.assert_allclose(_np(o), np.asarray(out.astype(jnp.float32)), rtol=tol, atol=tol)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    grads = flash_attention_bwd_ref(*th[:3], o, lse, th[3], **kw)
    for name, got, want in zip("qkv", grads, expected):
        assert got.dtype == th[0].dtype
        np.testing.assert_allclose(_np(got.transpose(1, 2)), want, rtol=tol, atol=tol, err_msg=f"d{name}")

    # the autograd function through the model-layout wrapper
    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    flash_attention(tq, tk, tv, **kw).backward(_torch(do, dtype))
    for name, t, want in zip("qkv", (tq, tk, tv), expected):
        np.testing.assert_allclose(_np(t.grad), want, rtol=tol, atol=tol, err_msg=f"autograd d{name}")


def test_grad_path_goes_through_the_autograd_function():
    q, k, v = (_torch(a, "float32").requires_grad_(True) for a in _qkv(7, 1, 8, 8, 2, 2, 16, "float32"))
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    gq, = torch.autograd.grad(FlashAttentionFn.apply(q, k, v, True, None, None).sum(), q)
    assert gq.shape == q.shape


def test_cpu_wrapper_counts_no_launch():
    before = LAUNCHES["flash_attention_fwd"]
    q, k, v = (_torch(a, "float32") for a in _qkv(2, 1, 8, 8, 2, 2, 16, "float32"))
    flash_attention(q, k, v)
    assert LAUNCHES["flash_attention_fwd"] == before


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(window=0), "window"),
        (dict(logit_softcap=0.0), "logit_softcap"),
    ],
)
def test_wrapper_rejects_bad_options(kwargs, match):
    q, k, v = (_torch(a, "float32") for a in _qkv(3, 1, 8, 8, 2, 2, 16, "float32"))
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, **kwargs)


def test_wrapper_rejects_a_window_that_leaves_a_row_without_keys():
    q, k, v = (_torch(a, "float32") for a in _qkv(3, 1, 8, 4, 2, 2, 16, "float32"))
    flash_attention(q, k, v, window=5)  # row 7 still sees key 3
    with pytest.raises(ValueError, match="see no key"):
        flash_attention(q, k, v, window=4)  # Sq 8 >= Sk 4 + 4: row 7 sees none


def test_wrapper_rejects_bad_shapes():
    q, k, v = (_torch(a, "float32") for a in _qkv(4, 1, 8, 8, 3, 2, 16, "float32"))
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="differ"):
        flash_attention(q, k, v[:, :4])
