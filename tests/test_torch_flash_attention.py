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
    bwd_route,
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_ref,
    fwd_route,
)
from repro_torch.kernels.flash_attention.ops import (KV_CLUSTER_SIZES, KV_CLUSTERS, bwd_cluster, dkdv_cluster,
                                                     dkdv_cluster_128, kernel_head_dim, pad_head_dim)

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
    (1, 256, 256, 4, 1, 256, True, 64, None, 128),  # recurrentgemma-9b's hd 256, MQA, window
    (1, 256, 256, 12, 2, 128, True, 256, None, 128),  # mixtral's hd 128, G 6, a window of Sq
    (1, 256, 256, 14, 2, 128, True, None, None, 128),  # arctic's hd 128, G 7
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
    (1, 100, 100, 4, 1, 256, True, 48, None),  # recurrentgemma-9b's hd 256: GQA 4 over 1, window, ragged
    (1, 100, 100, 12, 2, 128, True, 100, None),  # mixtral's hd 128: G 6, a window of Sq, ragged
    (1, 100, 100, 14, 2, 128, True, None, None),  # arctic's hd 128: G 7, ragged
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


# Which forward kernel each (dtype, head_dim) pair reaches on the card; None:
# refused.  bf16 at 64, 128 and 256 (every full-width path, recurrentgemma-9b's
# local attention at 256) must stay on wgmma; 96 is phi-3-vision-4.2b's; 8
# and 12 run zero-padded to 16.
ROUTES = {
    (torch.bfloat16, 8): "mma_sync",
    (torch.bfloat16, 12): "mma_sync",
    (torch.bfloat16, 16): "mma_sync",
    (torch.bfloat16, 64): "wgmma",
    (torch.bfloat16, 96): "mma_sync",
    (torch.bfloat16, 128): "wgmma",
    (torch.bfloat16, 256): "wgmma",
    (torch.float32, 8): "f32",
    (torch.float32, 12): "f32",
    (torch.float32, 16): "f32",
    (torch.float32, 64): "f32",
    (torch.float32, 96): "f32",
    (torch.float32, 128): "f32",
    (torch.float32, 256): "f32",
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16], ids=str)
@pytest.mark.parametrize("head_dim", [8, 12, 16, 32, 64, 96, 128, 256])
def test_forward_route(dtype, head_dim):
    want = ROUTES.get((dtype, head_dim))
    if want is None:
        with pytest.raises(ValueError, match="no forward kernel"):
            fwd_route(dtype, head_dim)
    else:
        assert fwd_route(dtype, head_dim) == want


# Which backward kernels each (dtype, head_dim) pair reaches on the card;
# None: refused.  bf16 at 64, 128 and 256 (every full-width training path,
# recurrentgemma-9b's local attention at 256) must stay on wgmma.  The
# forward's table.
BWD_ROUTES = dict(ROUTES)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16], ids=str)
@pytest.mark.parametrize("head_dim", [8, 12, 16, 32, 64, 96, 128, 256])
def test_backward_route(dtype, head_dim):
    want = BWD_ROUTES.get((dtype, head_dim))
    if want is None:
        with pytest.raises(ValueError, match="no backward kernel"):
            bwd_route(dtype, head_dim)
    else:
        assert bwd_route(dtype, head_dim) == want


# (batch, kv heads, Sk, G, SMs, cluster): the hd-256 dK/dV kernel's split of
# an item's query heads.  recurrentgemma-9b's pod shape (64 items, G 16) takes
# 2 (128 CTAs; 4 would need two rounds of items for the same share), 2 x 1024
# with G 4 and the ragged S 300 (5 items) take 4, one query head a kv head 1,
# and G 6 never 4 (not a divisor).
DKDV_CLUSTER_CASES = [
    (1, 1, 4096, 16, 132, 2),
    (2, 1, 1024, 4, 132, 4),
    (1, 1, 300, 16, 132, 4),
    (1, 1, 4096, 1, 132, 1),
    (3, 5, 333, 1, 132, 1),
    (4, 1, 4096, 16, 132, 1),
    (1, 1, 256, 6, 132, 2),
    (1, 2, 128, 2, 132, 2),
    (8, 2, 1024, 4, 132, 1),
]


@pytest.mark.parametrize("case", DKDV_CLUSTER_CASES, ids=str)
def test_dkdv_cluster_divides_the_heads_and_fills_the_card(case):
    b, kvh, sk, groups, sms, want = case
    got = dkdv_cluster(b, kvh, sk, groups, sms)
    assert got == want
    assert got in KV_CLUSTERS and groups % got == 0 and got <= 4


# (b, kvh, sk, groups, sms, want): the hd-128 dK/dV kernel's cluster, a pair
# where the 128-key items are fewer than the SMs and G is even: mixtral's 1 x
# 4096 (48 over 8: 256 items, 1: a pair measured slower), its mesh training
# shard (24 over 4: 128 items on 132 SMs, 2: measured faster), serve_mixtral's
# 4 x 4096 and its mesh shard 2 x 4096 (1), 48 heads over 1 (32 items, 2),
# arctic's G 7 (odd: 1, even with few items), short and ragged ones (2), 8 x
# 1024 with 8 heads over 2 (G 4: 2), and 128 items on 128 SMs (1: they fill it)
DKDV_CLUSTER_128_CASES = [
    (1, 8, 4096, 6, 132, 1),
    (1, 4, 4096, 6, 132, 2),
    (4, 8, 4096, 6, 132, 1),
    (2, 4, 4096, 6, 132, 1),
    (1, 1, 4096, 48, 132, 2),
    (1, 8, 4096, 7, 132, 1),
    (1, 2, 2048, 7, 132, 1),
    (16, 1, 1024, 6, 132, 2),
    (1, 2, 300, 6, 132, 2),
    (2, 1, 1000, 6, 132, 2),
    (8, 2, 1024, 4, 132, 2),
    (1, 4, 4096, 6, 128, 1),
]


@pytest.mark.parametrize("case", DKDV_CLUSTER_128_CASES, ids=str)
def test_dkdv_cluster_128_divides_the_heads_and_picks_the_measured_size(case):
    b, kvh, sk, groups, sms, want = case
    got = dkdv_cluster_128(b, kvh, sk, groups, sms)
    assert got == want
    assert got in KV_CLUSTER_SIZES[128] and groups % got == 0


# (dtype, head_dim, (B, H, KVH, Sk), want): the wrapper's one choice by route:
# bf16 hd 128 and 256 (wgmma) by their size functions, float32, hd 64 and
# hd 96 (mma_sync) never split
BWD_CLUSTER_CASES = [
    ("bfloat16", 128, (1, 24, 4, 4096), 2),
    ("bfloat16", 128, (1, 48, 8, 4096), 1),
    ("bfloat16", 256, (1, 16, 1, 4096), dkdv_cluster(1, 1, 4096, 16, 132)),
    ("float32", 128, (1, 24, 4, 4096), 1),
    ("bfloat16", 64, (1, 24, 4, 4096), 1),
    ("bfloat16", 96, (1, 24, 4, 4096), 1),
]


@pytest.mark.parametrize("case", BWD_CLUSTER_CASES, ids=str)
def test_bwd_cluster_by_route(case):
    dtype, hd, (b, h, kvh, sk), want = case
    assert bwd_cluster(getattr(torch, dtype), b, h, kvh, sk, hd, 132) == want


def test_kv_cluster_sizes_by_head_dim():
    """The sizes the wgmma dK/dV kernel takes: 1, 2, 4 at 256 and a pair at
    128 (each CTA owns 8 of 16 column blocks; the other's go through its Q
    and dO ring); 1 elsewhere."""
    assert KV_CLUSTER_SIZES == {256: (1, 2, 4), 128: (1, 2)}
    assert KV_CLUSTERS == (1, 2, 4)


def test_window_of_sq_or_more_gives_the_same_outputs_and_gradients():
    """A window of Sq or more cuts no pair (k > q - window holds for every
    q < Sq <= window): the plain forward and backward give the same bits
    with it as without, so the wrappers need not drop it."""
    q, k, v = (_torch(a, "float32").requires_grad_(True) for a in _qkv(11, 1, 50, 50, 6, 1, 128, "float32"))
    do = _torch(_qkv(12, 1, 50, 50, 6, 6, 128, "float32")[0], "float32")
    got = []
    for window in (None, 50, 64):
        out = flash_attention(q, k, v, window=window)
        grads = torch.autograd.grad(out, (q, k, v), do)
        got.append((out, *grads))
    for other in got[1:]:
        for x, y in zip(got[0], other):
            assert torch.equal(x, y)


def test_head_dim_256_is_refused_naming_its_item():
    """recurrentgemma-9b's head_dim 256, whose backward and float32 routes
    were once refused naming their ROADMAP item: the bf16 backward runs on
    wgmma (the training path's) and float32 forward and backward on f32
    (the card's float32 check run)."""
    assert bwd_route(torch.bfloat16, 256) == "wgmma"
    assert fwd_route(torch.float32, 256) == bwd_route(torch.float32, 256) == "f32"


def test_head_dim_256_bf16_forward_runs_on_wgmma():
    """recurrentgemma-9b's head_dim 256: the bf16 forward takes the Hopper
    kernel, never the mma_sync one."""
    assert fwd_route(torch.bfloat16, 256) == "wgmma"


# (b, s, h, kvh, hd, window, softcap): yi-34b's smoke heads (7 of hd 8 over
# 1 kv head) and starcoder2-7b's (6 of hd 12 over 2)
PADDED = [
    (2, 40, 7, 1, 8, None, None),
    (1, 37, 6, 2, 12, None, None),
    (1, 50, 6, 2, 12, 16, 30.0),
]


@pytest.mark.parametrize("case", PADDED, ids=str)
def test_padded_head_dim_matches_unpadded_plain(case):
    """What the card runs for head_dim 8 and 12: q, k, v (and o, dO) zero-
    padded to 16 by ``pad_head_dim``, the softmax scaled by the true
    head_dim, the output and gradients sliced back; here with the plain
    versions as the kernels, against the unpadded plain versions (float32,
    1e-5: the zero columns add exact zeros)."""
    b, s, h, kvh, hd, window, cap = case
    kw = dict(causal=True, window=window, logit_softcap=cap)
    q, k, v = (_torch(a, "float32") for a in _qkv(11, b, s, s, h, kvh, hd, "float32"))
    do = _torch(_qkv(12, b, s, s, h, h, hd, "float32")[0], "float32")
    assert kernel_head_dim(hd) == 16
    heads = [t.transpose(1, 2) for t in (q, k, v, do)]
    want_out, want_lse = flash_attention_ref(*heads[:3], **kw)
    want = flash_attention_bwd_ref(*heads[:3], want_out, want_lse, heads[3], **kw)

    pq, pk, pv, pdo = (t.transpose(1, 2) for t in pad_head_dim(q, k, v, do))
    assert pq.shape[3] == pk.shape[3] == 16 and not pq[..., hd:].any()
    out, lse = flash_attention_ref(pq, pk, pv, scale=hd ** -0.5, **kw)
    assert not out[..., hd:].any()
    np.testing.assert_allclose(out[..., :hd].numpy(), want_out.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5, atol=1e-5)
    got = flash_attention_bwd_ref(pq, pk, pv, out, lse, pdo, scale=hd ** -0.5, **kw)
    for name, g, w in zip("qkv", got, want):
        assert not g[..., hd:].any(), f"d{name}: padded columns not zero"
        np.testing.assert_allclose(g[..., :hd].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")
