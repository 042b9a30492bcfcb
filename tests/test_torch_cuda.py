"""Tests of the port that need the card: a CUDA kernel has no CPU mode.

They skip without a GPU.  On a machine with one (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import loader_for_model
from repro_torch.distributed import init_pod_params, init_train_state, make_train_step, pod_grads, sync_grads
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    bwd_route,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
    fwd_route,
)
from repro_torch.kernels.flash_attention.ops import (BWD_ROUTE_LAUNCHES, CLUSTER_LAUNCHES, KV_CLUSTER_SIZES,
                                                     PADDED_LAUNCHES, ROUTE_LAUNCHES, bwd_cluster)
from repro_torch.kernels.rwkv6_wkv import (GRAD_CHUNK, WKV_BWD_ROUTE_LAUNCHES, wkv6, wkv6_bwd,
                                           wkv6_bwd_chunked_ref, wkv6_bwd_ref, wkv6_fwd, wkv6_ref)
from repro_torch.kernels.rwkv6_wkv.ops import bwd_route as wkv_bwd_route
from repro_torch.kernels.rwkv6_wkv.ops import CHUNK as WKV_CHUNK
from repro_torch.kernels.rglru_scan import (CHUNK, rglru_scan, rglru_scan_bwd, rglru_scan_bwd_chunked_ref,
                                            rglru_scan_bwd_ref, rglru_scan_fwd, rglru_scan_ref)
from repro_torch.kernels.wan_quant import wan_dequant, wan_dequant_ref, wan_quant, wan_quant_ref
from repro_torch.launch.batches import synthetic_prompt_batch
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.optim import DilocoConfig, global_norm
from repro_torch.runtime import GeoTrainer, TrainerConfig
from repro_torch.tree import tree_items, tree_map

pytestmark = pytest.mark.cuda

# The kernel sums in another order than the plain version; in bf16 it also
# rounds p to bf16 for P.V, the tensor cores' operand type.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (b, sq, sk, h, kvh, hd, causal, window, softcap)
CASES = [
    (1, 128, 128, 1, 1, 64, True, None, None),
    (2, 256, 256, 4, 2, 64, True, None, None),
    (2, 256, 256, 8, 1, 128, True, None, None),
    (2, 100, 100, 4, 2, 64, True, None, None),
    (1, 37, 37, 2, 2, 16, True, None, None),
    (1, 200, 200, 4, 1, 128, True, 48, None),
    (1, 37, 100, 2, 2, 64, False, None, 30.0),
    (1, 128, 384, 2, 2, 64, False, None, None),
    (2, 256, 256, 4, 2, 64, True, 64, 30.0),
    # edges of the wgmma kernel's 128-row items and 128-key ring:
    (1, 700, 700, 4, 2, 128, True, None, None),  # 6 key tiles: the ring wraps
    (1, 1, 1, 1, 1, 64, True, None, None),  # Sq = Sk = 1
    (1, 1000, 1000, 2, 1, 64, True, 200, None),  # window skips leading tiles, starts mid-tile
    (1, 300, 100, 2, 2, 64, False, None, None),  # Sq > 128 with Sk < 128
    (3, 333, 333, 5, 5, 64, True, None, None),  # items that divide evenly into no grid
    # head dims off the wgmma route: phi-3-vision's 96 (H 32 = KVH), and
    # yi-34b's 8 (7 heads over 1) and starcoder2-7b's 12 (6 over 2) smoke
    # heads, zero-padded to 16
    (1, 300, 300, 32, 32, 96, True, None, None),
    (2, 40, 40, 7, 1, 8, True, None, None),
    (1, 37, 37, 6, 2, 12, True, None, 30.0),
    # the MoE archs' GQA groups at head_dim 128: mixtral's 6 (windowed),
    # arctic's 7, ragged against the 128-row items
    (1, 300, 300, 12, 2, 128, True, 256, None),
    (2, 333, 333, 14, 2, 128, True, None, None),
]

# Edges of the wgmma backward's 128-key dK/dV items and 64-row query ring,
# run by the backward test beside every entry of CASES.
BWD_EDGE_CASES = [
    (1, 100, 300, 2, 2, 64, True, None, None),  # causal Sq < Sk: keys 100-299 get zero dK, dV
    # GQA (G = 4): key tile 1 is reached by the last query tile of each of
    # the 4 heads only, and key tile 2 by no query: its dK, dV are zeros
    (2, 200, 384, 8, 2, 64, True, None, None),
    (1, 500, 500, 4, 2, 128, True, 100, None),  # hd 128, the window's edge mid-tile
    (1, 1000, 1000, 4, 4, 128, True, None, None),  # S 1000 ragged at hd 128
    (1, 300, 300, 2, 1, 128, True, None, 30.0),  # softcap at hd 128
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, h, kvh, hd, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd))
    return [torch.tensor(rng.standard_normal(s, np.float32)).to(device, getattr(torch, dtype)) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_matches_plain(cuda, dtype, case):
    b, sq, sk, h, kvh, hd, causal, window, cap = case
    q, k, v = _qkv(0, b, sq, sk, h, kvh, hd, dtype, cuda)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = LAUNCHES["flash_attention_fwd"]
    route = fwd_route(q.dtype, hd)
    before_route = ROUTE_LAUNCHES[route]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    assert ROUTE_LAUNCHES[route] == before_route + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    plain, _ = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.testing.assert_close(
        out.float(), plain.transpose(1, 2).float(), rtol=TOL[dtype], atol=TOL[dtype]
    )


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one fused [B, S, 3, H, hd] projection: no copy."""
    qkv = torch.randn((2, 128, 3, 4, 64), device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    plain, _ = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    torch.testing.assert_close(out.float(), plain.transpose(1, 2).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", [(1, 300, 300, 16, 1, 128), (2, 256, 256, 4, 1, None), (1, 37, 37, 2, 2, 16)],
                         ids=str)
def test_head_dim_256_forward_runs_and_refuses_backward(cuda, case):
    """head_dim 256 (recurrentgemma-9b's local attention), which until the
    hd-256 backward was ported refused its gradient and float32: the bf16
    forward runs on wgmma against the plain version, the float32 forward on
    f32 (1e-4), and under autograd the gradients come from the wgmma
    backward, against the plain backward (2e-2)."""
    b, sq, sk, h, kvh, window = case
    q, k, v = _qkv(1, b, sq, sk, h, kvh, 256, "bfloat16", cuda)
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    before = dict(ROUTE_LAUNCHES)
    out = flash_attention(q, k, v, window=window)
    out32 = flash_attention(q.float(), k.float(), v.float(), window=window)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["wgmma"] == before.get("wgmma", 0) + 1 and ROUTE_LAUNCHES["f32"] == before.get("f32", 0) + 1
    plain, lse = flash_attention_ref(*heads, window=window)
    torch.testing.assert_close(out.float(), plain.transpose(1, 2).float(), rtol=2e-2, atol=2e-2)
    plain32, _ = flash_attention_ref(*(t.float() for t in heads), window=window)
    torch.testing.assert_close(out32, plain32.transpose(1, 2), rtol=1e-4, atol=1e-4)
    do = _qkv(2, b, sq, sq, h, h, 256, "bfloat16", cuda)[0]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bwd_before = BWD_ROUTE_LAUNCHES["wgmma"]
    flash_attention(*leaves, window=window).backward(do)
    torch.cuda.synchronize()
    assert BWD_ROUTE_LAUNCHES["wgmma"] == bwd_before + 1
    want = flash_attention_bwd_ref(*heads, plain, lse, do.transpose(1, 2), window=window)
    for name, t, w in zip("qkv", leaves, want):
        torch.testing.assert_close(t.grad.float(), w.transpose(1, 2).float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m, name=name: f"d{name}: {m}")


# (b, sq, sk, h, kvh, causal, window, softcap): edges of the hd-256 wgmma
# kernel's 128-row items, 64-key tiles, 2-stage ring and single query buffer
HD256_CASES = [
    (1, 300, 300, 16, 1, True, 100, None),  # Sq not a multiple of 128; the window cuts a 64-key tile; MQA
    (2, 256, 256, 4, 2, True, None, 30.0),  # softcap 30, GQA
    (1, 700, 700, 2, 1, True, 200, 30.0),  # the ring wraps many times; window and softcap
    (1, 37, 100, 2, 2, False, None, None),  # not causal, Sk ragged on a 64-key tile
    (1, 1, 1, 1, 1, True, None, None),  # Sq = Sk = 1: one tile, fewer than the ring holds
    (3, 333, 333, 5, 5, True, None, None),  # items that divide evenly into no grid
    (1, 2100, 2100, 16, 1, True, 2048, None),  # recurrentgemma-9b's heads and window, past it
]


@pytest.mark.parametrize("case", HD256_CASES, ids=str)
def test_head_dim_256_wgmma_backward_matches_plain_and_is_deterministic(cuda, case):
    """The hd-256 wgmma backward (64-key items, consumer 0 handing P^T to
    consumer 1; the dQ kernel's 32-key ring) against the plain backward on
    the kernel forward's output and lse (bf16, 2e-2), on the wgmma route
    alone; two calls give equal bits."""
    b, sq, sk, h, kvh, causal, window, cap = case
    q, k, v = _qkv(4, b, sq, sk, h, kvh, 256, "bfloat16", cuda)
    do = _qkv(5, b, sq, sq, h, h, 256, "bfloat16", cuda)[0]
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    routes = dict(BWD_ROUTE_LAUNCHES)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    took = {r: n - routes.get(r, 0) for r, n in BWD_ROUTE_LAUNCHES.items() if n != routes.get(r, 0)}
    assert took == {"wgmma": 2}
    plain = flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, out)), lse, do.transpose(1, 2), **kw)
    for name, got, want, same in zip("qkv", grads, plain, again):
        assert torch.equal(got, same), f"d{name} differs between two calls"
        torch.testing.assert_close(got.float(), want.transpose(1, 2).float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m, name=name: f"d{name}: {m}")


# (case, cluster): every hd-256 case with each cluster size that divides its
# query heads a kv head, 2 x 1024 with 4 heads over 1, and 128 items (4 x
# 1024, 2 kv heads) that clusters of 2 take in two rounds
KV_CLUSTER_CASES = [(case, size) for case in HD256_CASES + [(2, 1024, 1024, 4, 1, True, None, None),
                                                           (4, 1024, 1024, 4, 2, True, 256, None)]
                    for size in KV_CLUSTER_SIZES[256] if (case[3] // case[4]) % size == 0]


@pytest.mark.parametrize("case,size", KV_CLUSTER_CASES, ids=str)
def test_head_dim_256_backward_at_every_cluster_size(cuda, case, size):
    """The hd-256 dK/dV kernel with its items' query heads split over a
    cluster of 1, 2 or 4 CTAs (forced; the wrapper picks one by
    dkdv_cluster): dQ, dK, dV within 2e-2 of the plain backward, and two
    calls give equal bits (the partials summed in rank order)."""
    b, sq, sk, h, kvh, causal, window, cap = case
    q, k, v = _qkv(4, b, sq, sk, h, kvh, 256, "bfloat16", cuda)
    do = _qkv(5, b, sq, sq, h, h, 256, "bfloat16", cuda)[0]
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, kv_cluster=size, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, kv_cluster=size, **kw)
    torch.cuda.synchronize()
    plain = flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, out)), lse, do.transpose(1, 2), **kw)
    for name, got, want, same in zip("qkv", grads, plain, again):
        assert torch.equal(got, same), f"d{name} differs between two calls"
        torch.testing.assert_close(got.float(), want.transpose(1, 2).float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m, name=name: f"d{name}: {m}")


def test_kv_cluster_is_refused_where_it_does_not_divide_or_apply(cuda):
    """A dK/dV cluster size must be one the route takes at that head_dim
    (``KV_CLUSTER_SIZES``: 1, 2, 4 at 256 and 1, 2 at 128; 1 elsewhere)
    and divide the query heads a kv head."""
    q, k, v = _qkv(4, 1, 64, 64, 6, 1, 256, "bfloat16", cuda)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="kv_cluster 4"):  # does not divide 6
        flash_attention_bwd(q, k, v, out, lse, out, kv_cluster=4)
    with pytest.raises(ValueError, match="kv_cluster 3"):  # divides 6, but not a size at 256
        flash_attention_bwd(q, k, v, out, lse, out, kv_cluster=3)
    q, k, v = _qkv(4, 1, 64, 64, 6, 1, 128, "bfloat16", cuda)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="kv_cluster 3"):  # divides 6, but not a size at 128
        flash_attention_bwd(q, k, v, out, lse, out, kv_cluster=3)
    q, k, v = _qkv(4, 1, 64, 64, 7, 1, 128, "bfloat16", cuda)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="kv_cluster 2"):  # a size at 128, but does not divide 7
        flash_attention_bwd(q, k, v, out, lse, out, kv_cluster=2)
    q, k, v = _qkv(4, 1, 64, 64, 4, 2, 64, "bfloat16", cuda)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="kv_cluster 2"):  # head_dim 64 splits nothing
        flash_attention_bwd(q, k, v, out, lse, out, kv_cluster=2)


# (b, sq, sk, h, kvh, window, strided): the hd-128 GQA groups of mixtral (6,
# window = S) and arctic (7), ragged against the 128-row items and 128-key
# tiles, a cross length, and q, k, v as views of one fused projection
HD128_GQA_CASES = [
    (1, 300, 300, 12, 2, 300, False),
    (2, 333, 333, 14, 2, None, False),
    (1, 700, 700, 6, 1, 700, True),
    (2, 1000, 1000, 7, 1, None, True),
    (1, 200, 457, 12, 2, None, False),
]


def _fused_qkv(seed, b, s, h, kvh, hd, device):
    """q, k, v as strided views of one [B, S, H + 2 KVH, hd] projection."""
    rng = np.random.default_rng(seed)
    fused = torch.tensor(rng.standard_normal((b, s, h + 2 * kvh, hd), np.float32)).to(device, torch.bfloat16)
    return fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]


@pytest.mark.parametrize("case", HD128_GQA_CASES, ids=str)
def test_head_dim_128_gqa_forward_matches_plain(cuda, case):
    """The hd-128 wgmma forward at mixtral's and arctic's groups (one CTA an
    item): out and lse within 2e-2 of the plain version."""
    b, sq, sk, h, kvh, window, strided = case
    if strided:
        assert sq == sk
        q, k, v = _fused_qkv(8, b, sq, h, kvh, 128, cuda)
        assert not q.is_contiguous()
    else:
        q, k, v = _qkv(8, b, sq, sk, h, kvh, 128, "bfloat16", cuda)
    kw = dict(causal=sq <= sk, window=window)
    before = ROUTE_LAUNCHES["wgmma"]
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["wgmma"] == before + 1
    plain, plain_lse = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), **kw)
    torch.testing.assert_close(out.float(), plain.transpose(1, 2).float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, plain_lse, rtol=2e-2, atol=2e-2)


# (b, sq, sk, h, kvh, window): mixtral's G 6 at head_dim 128 (window = S),
# ragged; 128 items (a mesh shard's count at 1 x 4096) at 16 x 1024 with 6
# over 1 (window 300); not causal Sq < Sk
HD128_KV_CLUSTER_CASES = [
    (1, 300, 300, 12, 2, 300, True),
    (2, 1000, 1000, 6, 1, None, True),
    (16, 1024, 1024, 6, 1, 300, True),
    (1, 100, 333, 6, 1, None, False),
]


@pytest.mark.parametrize("case,size", [(c, z) for c in HD128_KV_CLUSTER_CASES for z in (None, *KV_CLUSTER_SIZES[128])],
                         ids=str)
def test_head_dim_128_backward_at_every_cluster_size(cuda, case, size):
    """The hd-128 dK/dV kernel with its items' 6 query heads on one CTA or
    split over a pair (forced, or None: the wrapper's bwd_cluster), K and V
    multicast, the float32 partials summed: the launch counted at its size,
    dQ, dK, dV within 2e-2 of the plain backward, and two calls give equal
    bits."""
    b, sq, sk, h, kvh, window, causal = case
    q, k, v = _qkv(9, b, sq, sk, h, kvh, 128, "bfloat16", cuda)
    do = _qkv(10, b, sq, sq, h, h, 128, "bfloat16", cuda)[0]
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    CLUSTER_LAUNCHES.clear()
    grads = flash_attention_bwd(q, k, v, out, lse, do, kv_cluster=size, **kw)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = size or bwd_cluster(torch.bfloat16, b, h, kvh, sk, 128, sms)
    assert dict(CLUSTER_LAUNCHES) == {want: 1}
    again = flash_attention_bwd(q, k, v, out, lse, do, kv_cluster=size, **kw)
    torch.cuda.synchronize()
    plain = flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, out)), lse, do.transpose(1, 2), **kw)
    for name, got, want, same in zip("qkv", grads, plain, again):
        assert torch.equal(got, same), f"d{name} differs between two calls"
        torch.testing.assert_close(got.float(), want.transpose(1, 2).float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m, name=name: f"d{name}: {m}")


@pytest.mark.parametrize("case", [(1, 300, 300, 4, 1, True, 100, None), (1, 100, 100, 2, 2, True, None, 30.0),
                                  (1, 37, 70, 2, 1, False, None, None)], ids=str)
def test_head_dim_256_f32_forward_and_backward_match_plain(cuda, case):
    """The float32 route at head_dim 256 (the card's float32 check runs):
    the forward, its lse and the backward against the plain versions at
    1e-4."""
    b, sq, sk, h, kvh, causal, window, cap = case
    q, k, v = _qkv(6, b, sq, sk, h, kvh, 256, "float32", cuda)
    do = _qkv(7, b, sq, sq, h, h, 256, "float32", cuda)[0]
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = (ROUTE_LAUNCHES["f32"], BWD_ROUTE_LAUNCHES["f32"])
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (ROUTE_LAUNCHES["f32"], BWD_ROUTE_LAUNCHES["f32"]) == (before[0] + 1, before[1] + 1)
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    plain, plain_lse = flash_attention_ref(*heads, **kw)
    torch.testing.assert_close(out, plain.transpose(1, 2), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-4, atol=1e-4)
    want = flash_attention_bwd_ref(*heads, out.transpose(1, 2), lse, do.transpose(1, 2), **kw)
    for name, got, w in zip("qkv", grads, want):
        torch.testing.assert_close(got, w.transpose(1, 2), rtol=1e-4, atol=1e-4, msg=lambda m, name=name: f"d{name}: {m}")


@pytest.mark.parametrize("case", HD256_CASES, ids=str)
def test_head_dim_256_wgmma_forward_and_lse_match_plain(cuda, case):
    """The hd-256 wgmma forward's output and natural-log lse against the
    plain version (bf16 2e-2; lse 1e-4), on the wgmma route alone."""
    b, sq, sk, h, kvh, causal, window, cap = case
    q, k, v = _qkv(2, b, sq, sk, h, kvh, 256, "bfloat16", cuda)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    routes = dict(ROUTE_LAUNCHES)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    took = {r: n - routes.get(r, 0) for r, n in ROUTE_LAUNCHES.items() if n != routes.get(r, 0)}
    assert took == {"wgmma": 1}
    plain, plain_lse = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.testing.assert_close(out.float(), plain.transpose(1, 2).float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [8, 12])
def test_padded_head_dim_counts_its_launches(cuda, dtype, hd):
    """hd 8 and 12 launch the 16-wide kernels on their route, and the
    padded counter moves with them, forward and backward."""
    q, k, v = (t.requires_grad_(True) for t in _qkv(12, 2, 50, 50, 6, 2, hd, dtype, cuda))
    route = fwd_route(q.dtype, hd)
    assert route == bwd_route(q.dtype, hd) == ("f32" if dtype == "float32" else "mma_sync")
    before = (dict(PADDED_LAUNCHES), ROUTE_LAUNCHES[route], BWD_ROUTE_LAUNCHES[route])
    out = flash_attention(q, k, v)
    assert out.shape == q.shape
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    moved = {n: c - before[0].get(n, 0) for n, c in PADDED_LAUNCHES.items() if c != before[0].get(n, 0)}
    assert moved == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    assert (ROUTE_LAUNCHES[route], BWD_ROUTE_LAUNCHES[route]) == (before[1] + 1, before[2] + 1)
    assert all(t.grad.shape == t.shape and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["distilgpt2-82m", "yi-34b", "starcoder2-7b"])
def test_smoke_prefill_and_decode_card_matches_cpu(cuda, arch, dtype):
    """The serving path at the smoke config on the card and on the CPU
    (yi-34b's head_dim 8 and starcoder2-7b's 12 run padded to 16)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    cpu_params = _tree(params, lambda t: t.cpu())
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    before = LAUNCHES["flash_attention_fwd"]
    g_logits, g_cache = prefill(params, {"tokens": tokens.to(cuda)}, cfg, max_len=44)
    assert LAUNCHES["flash_attention_fwd"] == before + cfg.num_layers
    c_logits, c_cache = prefill(cpu_params, {"tokens": tokens}, cfg, max_len=44)
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(g_logits.float().cpu(), c_logits.float(), rtol=tol, atol=tol)
    for i in range(4):
        nxt = g_logits.argmax(-1)
        g_logits, g_cache = decode_step(params, nxt, g_cache, cfg, 40 + i)
        c_logits, c_cache = decode_step(cpu_params, nxt.cpu(), c_cache, cfg, 40 + i)
        torch.testing.assert_close(g_logits.float().cpu(), c_logits.float(), rtol=tol, atol=tol)
    assert LAUNCHES["flash_attention_fwd"] == before + cfg.num_layers


def test_phi3_vision_full_width_prefill_card_matches_cpu(cuda):
    """phi-3-vision-4.2b at full width (head_dim 96 on the mma_sync route),
    cut to 2 layers: prefill of 256 patch embeddings and 64 tokens on the
    card against the CPU, bf16 at 5e-2."""
    cfg = dataclasses.replace(get_config("phi-3-vision-4.2b"), num_layers=2)
    assert cfg.head_dim == 96 and cfg.dtype == "bfloat16"
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    batch = synthetic_prompt_batch(cfg, torch.Generator(cuda).manual_seed(1), 1, cfg.num_prefix_tokens + 64)
    before = ROUTE_LAUNCHES["mma_sync"]
    g_logits, _ = prefill(params, batch, cfg)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["mma_sync"] == before + cfg.num_layers
    c_logits, _ = prefill(_tree(params, lambda t: t.cpu()), _tree(batch, lambda t: t.cpu()), cfg)
    torch.testing.assert_close(g_logits.float().cpu(), c_logits.float(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + BWD_EDGE_CASES, ids=str)
def test_backward_kernel_matches_plain(cuda, dtype, case):
    """dq, dk, dv from the kernel's own forward output and lse against the
    plain backward on the same inputs; the kernel's lse against the plain
    forward's (float32, 1e-4: sums in another order)."""
    b, sq, sk, h, kvh, hd, causal, window, cap = case
    q, k, v = _qkv(2, b, sq, sk, h, kvh, hd, dtype, cuda)
    do = _qkv(3, b, sq, sq, h, h, hd, dtype, cuda)[0]
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
    _, plain_lse = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-4, atol=1e-4)
    before = LAUNCHES["flash_attention_bwd"]
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 1
    plain = flash_attention_bwd_ref(
        *(t.transpose(1, 2) for t in (q, k, v, out)), lse, do.transpose(1, 2), **kw
    )
    for name, got, want, like in zip("qkv", grads, plain, (q, k, v)):
        assert got.shape == like.shape and got.dtype == like.dtype
        torch.testing.assert_close(
            got.float(), want.transpose(1, 2).float(), rtol=TOL[dtype], atol=TOL[dtype],
            msg=lambda m, name=name: f"d{name}: {m}",
        )


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_forward_lse_feeds_backward_to_plain_gradient(cuda, hd):
    """The wgmma forward's output and natural-log lse, through the backward
    kernel, against the plain forward and backward end to end (bf16, 2e-2)."""
    q, k, v = _qkv(5, 2, 384, 384, 4, 2, hd, "bfloat16", cuda)
    do = _qkv(6, 2, 384, 384, 4, 4, hd, "bfloat16", cuda)[0]
    before = ROUTE_LAUNCHES["wgmma"]
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    assert ROUTE_LAUNCHES["wgmma"] == before + 1
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    plain_out, plain_lse = flash_attention_ref(*heads)
    plain = flash_attention_bwd_ref(*heads, plain_out, plain_lse, do.transpose(1, 2))
    torch.testing.assert_close(lse, plain_lse, rtol=1e-4, atol=1e-4)
    for name, got, want in zip("qkv", grads, plain):
        torch.testing.assert_close(
            got.float(), want.transpose(1, 2).float(), rtol=2e-2, atol=2e-2,
            msg=lambda m, name=name: f"d{name}: {m}",
        )


@pytest.mark.parametrize("hd", [64, 128])
def test_backward_is_deterministic(cuda, hd):
    """No atomics: two calls on the same inputs give the same bits."""
    q, k, v = _qkv(7, 2, 700, 700, 8, 2, hd, "bfloat16", cuda)
    do = _qkv(8, 2, 700, 700, 8, 8, hd, "bfloat16", cuda)[0]
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attention_bwd(q, k, v, out, lse, do)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name} differs between two calls"


@pytest.mark.parametrize(
    "dtype, hd, route",
    [("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"), ("bfloat16", 16, "mma_sync"), ("float32", 64, "f32")],
)
def test_backward_launches_on_its_route(cuda, dtype, hd, route):
    """The backward's route counter moves by one launch, on the route bwd_route names."""
    q, k, v = _qkv(9, 1, 130, 130, 2, 2, hd, dtype, cuda)
    do = _qkv(10, 1, 130, 130, 2, 2, hd, dtype, cuda)[0]
    out, lse = flash_attention_fwd(q, k, v, with_lse=True)
    assert bwd_route(q.dtype, hd) == route
    before = dict(BWD_ROUTE_LAUNCHES)
    flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    moved = {r: n - before.get(r, 0) for r, n in BWD_ROUTE_LAUNCHES.items() if n != before.get(r, 0)}
    assert moved == {route: 1}


def test_autograd_through_the_kernels(cuda):
    q, k, v = (t.requires_grad_(True) for t in _qkv(4, 2, 100, 100, 4, 2, 64, "bfloat16", cuda))
    fwd, bwd = LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"]
    flash_attention(q, k, v).float().square().sum().backward()
    assert (LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"]) == (fwd + 1, bwd + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 256), (13, 300), (2 * 6 * 4, 3072), (3, 1)], ids=str)
def test_wan_quant_kernels_match_plain(cuda, dtype, shape):
    x = torch.tensor(np.random.default_rng(shape[1]).standard_normal(shape, np.float32) * 5)
    x = x.to(cuda, getattr(torch, dtype))
    x[0, : min(shape[1], 256)] = 0  # an all-zero block: scale 1
    q, s = wan_quant(x)
    qr, sr = wan_quant_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qr), (q.int() - qr.int()).abs().max()
    assert torch.equal(s, sr)
    back = wan_dequant(q, s, shape[1])
    assert torch.equal(back, wan_dequant_ref(q, s, shape[1]))


@pytest.mark.parametrize("strategy", ["hier", "hier_int8"])
def test_smoke_train_step_card_matches_cpu(cuda, strategy):
    """Two pods' loss, synced gradients and a full step on the card and on
    the CPU from the same parameters and batch (float32 smoke config: the
    kernels sum in another order, 1e-4; int8 ties may round apart, so the
    synced gradients are held by their relative norm, 1e-3)."""
    cfg = get_smoke_config("distilgpt2-82m")
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    cpu_params = _tree(params, lambda t: t.cpu())
    batch = loader_for_model(cfg, seq_len=64, global_batch=4).next_batch()
    state = init_train_state(params, None, strategy=strategy, npods=2)
    cpu_state = init_train_state(cpu_params, None, strategy=strategy, npods=2)
    out = {}
    for name, p, st, dev in (("card", params, state, cuda), ("cpu", cpu_params, cpu_state, "cpu")):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _, grads = pod_grads(p, b, cfg, 2)
        synced, _, wan = sync_grads(grads, st.ef, strategy=strategy)
        out[name] = (loss.item(), tree_map(lambda t: t.cpu(), synced), wan)
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    assert out["card"][2] == out["cpu"][2]
    for (path, g), (_, c) in zip(tree_items(out["card"][1]), tree_items(out["cpu"][1])):
        assert (g - c).norm() <= 1e-3 * c.norm() + 1e-6, path
    torch.testing.assert_close(global_norm(out["card"][1]), global_norm(out["cpu"][1]), rtol=1e-3, atol=0)
    step = make_train_step(cfg, npods=2, strategy=strategy, device=cuda)
    before = dict(LAUNCHES)
    _, _, metrics = step(params, state, batch)
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
    assert launched["flash_attention_fwd"] == launched["flash_attention_bwd"] == 2 * cfg.num_layers
    leaves = len(list(tree_items(params)))
    assert launched.get("wan_quant", 0) == launched.get("wan_dequant", 0) == (leaves if strategy == "hier_int8" else 0)
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("strategy", ["ps", "local_sgd"])
def test_smoke_ps_and_local_sgd_step_card_matches_cpu(cuda, strategy):
    """One whole 2-pod step on the card and on the CPU from the same
    parameters and batch: ``ps``, and ``local_sgd`` with sync_every = 1 so
    the step is an outer step.  Float32 smoke config: loss and grad norm at
    1e-4 as above; each leaf's update (new minus old parameters) at a
    relative norm of 1e-3, AdamW's first step being sign-like where a
    gradient sits near its eps."""
    cfg = get_smoke_config("distilgpt2-82m")
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    batch = loader_for_model(cfg, seq_len=64, global_batch=4).next_batch()
    out = {}
    for name, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        p = _tree(params, lambda t: t.to(dev))
        state = init_train_state(p, None, strategy=strategy, npods=2)
        step = make_train_step(cfg, npods=2, strategy=strategy, diloco_cfg=DilocoConfig(sync_every=1), device=dev)
        before = dict(LAUNCHES)
        new, _, metrics = step(init_pod_params(p, strategy=strategy, npods=2), state, batch)
        launched = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES if LAUNCHES[k] != before.get(k, 0)}
        if name == "card":
            torch.cuda.synchronize()
            assert launched == {"flash_attention_fwd": 2 * cfg.num_layers, "flash_attention_bwd": 2 * cfg.num_layers}
        if strategy == "local_sgd":  # after the outer step every pod holds the same parameters
            assert all(torch.equal(t[0], t[1]) for _, t in tree_items(new))
            new = _tree(new, lambda t: t[0])
        update = _tree(new, lambda t: t.cpu())
        out[name] = (metrics["loss"].item(), metrics["grad_norm"].item(), metrics["wan_bytes"],
                     {path: u - p0.cpu() for (path, u), (_, p0) in zip(tree_items(update), tree_items(p))})
    (g_loss, g_norm, g_wan, g_upd), (c_loss, c_norm, c_wan, c_upd) = out["card"], out["cpu"]
    torch.testing.assert_close(g_loss, c_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g_norm, c_norm, rtol=1e-4, atol=1e-4)
    assert g_wan == c_wan > 0
    for path, c in c_upd.items():
        assert (g_upd[path] - c).norm() <= 1e-3 * c.norm() + 1e-9, path


def test_smoke_checkpoint_resume_on_the_card_equals_the_uninterrupted_run(cuda, tmp_path):
    """Four 2-pod hier_int8 steps checkpointed every 2; a new trainer
    restores step 2 from a copy of the directory and runs steps 2-3.  Every
    kernel on the path is deterministic, so the losses agree to rtol 1e-6."""
    cfg = get_smoke_config("distilgpt2-82m")
    tc = TrainerConfig(seq_len=64, global_batch=4, steps=4, strategy="hier_int8", npods=2,
                       checkpoint_every=2, log_every=100)
    whole = GeoTrainer(cfg, trainer_cfg=tc, checkpoint_dir=str(tmp_path / "whole"), device=cuda).run()
    assert whole["last_checkpoint"] == 4
    shutil.copytree(tmp_path / "whole", tmp_path / "resume")
    shutil.rmtree(tmp_path / "resume" / "step_00000004")
    (tmp_path / "resume" / "step_00000004.COMMITTED").unlink()
    rest = GeoTrainer(cfg, trainer_cfg=tc, checkpoint_dir=str(tmp_path / "resume"), device=cuda).run()
    assert [r["step"] for r in rest["metrics"]] == [2, 3]
    np.testing.assert_allclose([r["loss"] for r in rest["metrics"]],
                               [r["loss"] for r in whole["metrics"][2:]], rtol=1e-6, atol=0)


# (b, t, h, n, r/k/v dtype, w dtype); the first is rwkv6-7b's layout at a
# shorter prompt, the second a ragged T
WKV_CASES = [
    (2, 256, 4, 64, "bfloat16", "float32"),
    (1, 1000, 2, 64, "bfloat16", "float32"),
    (2, 100, 3, 16, "float32", "float32"),
    (2, 64, 2, 8, "bfloat16", "bfloat16"),
    (1, 50, 2, 32, "float32", "bfloat16"),
    (1, 64, 2, 128, "bfloat16", "float32"),
]
# TestWkv6's tolerances by the r/k/v dtype: both sides compute in float32
# from the same values, summing in another order
WKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _wkv_inputs(seed, b, t, h, n, rkv_dtype, w_dtype, device):
    rng = np.random.default_rng(seed)

    def t_(a, dtype="float32"):
        return torch.tensor(a.astype(np.float32)).to(device, getattr(torch, dtype))

    r, k, v = (t_(rng.standard_normal((b, t, h, n)) * 0.5, rkv_dtype) for _ in range(3))
    w = t_(1.0 / (1.0 + np.exp(-(rng.standard_normal((b, t, h, n)) + 2.0))), w_dtype)
    return r, k, v, w, t_(rng.standard_normal((h, n)) * 0.1), t_(rng.standard_normal((b, h, n, n)) * 0.1)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_kernel_matches_plain(cuda, case):
    b, t, h, n, rkv_dtype, w_dtype = case
    r, k, v, w, u, s0 = _wkv_inputs(t, *case, cuda)
    before = LAUNCHES["wkv6_fwd"]
    out, final = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert LAUNCHES["wkv6_fwd"] == before + 1
    assert out.shape == (b, t, h, n) and final.shape == (b, h, n, n)
    assert out.dtype == final.dtype == torch.float32
    plain_out, plain_final = wkv6_ref(r, k, v, w, u, s0)
    tol = WKV_TOL[rkv_dtype]
    torch.testing.assert_close(out, plain_out, rtol=tol, atol=tol)
    torch.testing.assert_close(final, plain_final, rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 37, WKV_CHUNK, WKV_CHUNK + 1, 4096])
def test_wkv6_kernel_over_t_and_n_is_right_and_deterministic(cuda, t, n):
    """T around the kernel's staged chunk (one step, ragged, one chunk, one
    step more, the prefill's 4096) at every head size; two calls give the
    same bits (no atomics, fixed summation orders)."""
    rkv_dtype = "bfloat16" if n != 32 else "float32"
    r, k, v, w, u, s0 = _wkv_inputs(t + n, 1, t, 2, n, rkv_dtype, "float32", cuda)
    out, final = wkv6(r, k, v, w, u, s0)
    again, again_final = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(final, again_final)
    plain_out, plain_final = wkv6_ref(r, k, v, w, u, s0)
    tol = WKV_TOL[rkv_dtype]
    torch.testing.assert_close(out, plain_out, rtol=tol, atol=tol)
    torch.testing.assert_close(final, plain_final, rtol=tol, atol=tol)


def test_wkv6_kernel_reads_unaligned_strides(cuda):
    """bf16 views whose addresses and strides are 2-byte aligned only (the
    kernel's narrowest copies), a chunk and a half long."""
    big = torch.randn((2, WKV_CHUNK * 3 // 2, 3, 17), device=cuda).to(torch.bfloat16)
    r, k = big[..., 1:], big[..., :16]
    assert r.data_ptr() % 4 and r.stride(2) % 2
    v = torch.randn((2, WKV_CHUNK * 3 // 2, 3, 16), device=cuda).to(torch.bfloat16)
    w = torch.sigmoid(torch.randn((2, WKV_CHUNK * 3 // 2, 3, 16), device=cuda) + 2)
    u = torch.randn((3, 16), device=cuda) * 0.1
    out, final = wkv6(r, k, v, w, u)
    plain_out, plain_final = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(out, plain_out, rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(final, plain_final, rtol=5e-2, atol=5e-2)


def test_wkv6_decode_steps_update_the_state_in_place(cuda):
    """T = 1 steps with state_out = state0, as decode runs them, against one call."""
    r, k, v, w, u, s0 = _wkv_inputs(7, 2, 12, 4, 64, "bfloat16", "float32", cuda)
    whole, final = wkv6(r, k, v, w, u, s0)
    state = s0.clone()
    for i in range(12):
        out, same = wkv6(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], w[:, i:i + 1], u, state, state_out=state)
        assert same is state
        torch.testing.assert_close(out[:, 0], whole[:, i], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, final, rtol=1e-5, atol=1e-5)


def test_wkv6_kernel_reads_strided_inputs(cuda):
    """r, k, v as views of one [B, T, 3, H, N] projection: no copy."""
    rkv = torch.randn((2, 40, 3, 4, 16), device=cuda).to(torch.bfloat16)
    r, k, v = rkv.unbind(2)
    assert not r.is_contiguous()
    w = torch.sigmoid(torch.randn((2, 40, 4, 16), device=cuda) + 2)
    u = torch.randn((4, 16), device=cuda) * 0.1
    out, final = wkv6(r, k, v, w, u)
    plain_out, plain_final = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(out, plain_out, rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(final, plain_final, rtol=5e-2, atol=5e-2)


def test_wkv6_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    r, k, v, w, u, s0 = _wkv_inputs(1, 1, 4, 2, 48, "float32", "float32", cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv6(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = _wkv_inputs(1, 1, 4, 2, 16, "float32", "float32", cuda)
    with pytest.raises(ValueError, match="one dtype"):
        wkv6(r.to(torch.bfloat16), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous float32"):
        wkv6(r, k, v, w, u, s0.transpose(2, 3))


# (b, t, h, n, r/k/v dtype, w dtype, chunk, small w): T around the 16-step
# sub-chunk and the chunk (one step, 17, chunk + 5, three chunks, 256 + 17);
# w at 1e-30, at a float32 denormal or exactly 0 on a quarter of the lanes,
# or 0 on every lane for steps 16-20 ("zero_run": a sub-chunk starts in it)
WKV_BWD_CASES = [
    (2, 1, 4, 64, "bfloat16", "float32", GRAD_CHUNK, None),
    (2, 17, 4, 16, "float32", "float32", GRAD_CHUNK, None),
    (1, GRAD_CHUNK + 5, 2, 64, "bfloat16", "float32", GRAD_CHUNK, None),
    (1, 3 * GRAD_CHUNK, 2, 128, "float32", "float32", GRAD_CHUNK, None),
    (2, 100, 3, 8, "bfloat16", "bfloat16", 32, None),
    (1, 300, 2, 32, "float32", "float32", 64, 1e-30),
    (2, GRAD_CHUNK + 17, 2, 64, "bfloat16", "float32", GRAD_CHUNK, 0.0),
    (1, GRAD_CHUNK + 17, 2, 64, "float32", "float32", GRAD_CHUNK, 0.0),
    (2, 2 * GRAD_CHUNK + 15, 2, 32, "bfloat16", "float32", GRAD_CHUNK, 1e-40),
    (1, 2 * GRAD_CHUNK + 15, 2, 64, "float32", "float32", GRAD_CHUNK, 1e-40),
    (1, 70, 2, 16, "float32", "bfloat16", 32, "zero_run"),
]


@pytest.mark.parametrize("case", WKV_BWD_CASES, ids=str)
def test_wkv6_bwd_kernel_matches_plain(cuda, case):
    """The backward kernel from the forward kernel's saved states against
    wkv6_bwd_ref (step by step) and wkv6_bwd_chunked_ref (its own algorithm
    in plain float32) from the plain forward's, with a nonzero state0 and
    dstate, on the route bwd_route names; two calls give the same bits; all
    finite with w at or near 0."""
    b, t, h, n, rkv_dtype, w_dtype, chunk, small_w = case
    r, k, v, w, u, s0 = _wkv_inputs(t + n, b, t, h, n, rkv_dtype, w_dtype, cuda)
    if small_w == "zero_run":
        w = w.clone()
        w[:, 16:21] = 0.0
    elif small_w is not None:
        w = torch.where(torch.rand(w.shape, device=cuda) < 0.25, torch.full_like(w, small_w), w)
    gen = torch.Generator(cuda).manual_seed(t)
    dout = torch.randn((b, t, h, n), generator=gen, device=cuda)
    dstate = torch.randn((b, h, n, n), generator=gen, device=cuda) * 0.5
    nb = -(-t // chunk)
    bounds, final = torch.empty((b, nb, h, n, n), device=cuda), torch.empty_like(s0)
    out = wkv6_fwd(r, k, v, w, u, s0, final, bounds=bounds, chunk=chunk)
    plain_out, plain_final, plain_bounds = wkv6_ref(r, k, v, w, u, s0, chunk=chunk)
    tol = WKV_TOL[rkv_dtype]
    torch.testing.assert_close(bounds, plain_bounds, rtol=tol, atol=tol)
    torch.testing.assert_close(out, plain_out, rtol=tol, atol=tol)
    before, route = LAUNCHES["wkv6_bwd"], wkv_bwd_route(r.dtype, n)
    routes = dict(WKV_BWD_ROUTE_LAUNCHES)
    got = wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, chunk)
    again = wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["wkv6_bwd"] == before + 2
    assert WKV_BWD_ROUTE_LAUNCHES[route] == routes.get(route, 0) + 2
    want = wkv6_bwd_ref(r, k, v, w, u, plain_bounds, dout, dstate, chunk)
    want_chunked = wkv6_bwd_chunked_ref(r, k, v, w, u, plain_bounds, dout, dstate, chunk)
    for name, g, a, p, pc in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, again, want, want_chunked):
        assert torch.equal(g, a), name
        assert g.dtype == p.dtype and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), p.float(), rtol=tol, atol=tol, msg=name)
        torch.testing.assert_close(g.float(), pc.float(), rtol=tol, atol=tol, msg=f"{name} vs the chunked model")


def test_wkv6_gradient_on_the_card_matches_autograd_through_the_plain_loop(cuda):
    """wkv6 under grad (the forward and backward kernels) against autograd
    through wkv6_ref, a loss reading out and the final state."""
    r, k, v, w, u, s0 = (x.requires_grad_(True) for x in _wkv_inputs(3, 2, 40, 2, 16, "float32", "float32", cuda))
    dout = torch.randn((2, 40, 2, 16), device=cuda)
    dstate = torch.randn((2, 2, 16, 16), device=cuda)
    fwd, bwd = LAUNCHES["wkv6_fwd"], LAUNCHES["wkv6_bwd"]
    out, final = wkv6(r, k, v, w, u, s0, chunk=16)
    got = torch.autograd.grad((out * dout).sum() + (final * dstate).sum(), (r, k, v, w, u, s0))
    assert (LAUNCHES["wkv6_fwd"], LAUNCHES["wkv6_bwd"]) == (fwd + 1, bwd + 1)
    pout, pfinal = wkv6_ref(r, k, v, w, u, s0)
    want = torch.autograd.grad((pout * dout).sum() + (pfinal * dstate).sum(), (r, k, v, w, u, s0))
    for name, g, p in zip(("r", "k", "v", "w", "u", "state0"), got, want):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4, msg=name)


def test_wkv6_bwd_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    r, k, v, w, u, s0 = (x.requires_grad_(True) for x in _wkv_inputs(1, 1, 20, 2, 16, "float32", "float32", cuda))
    with pytest.raises(ValueError, match="multiple of 16"):
        wkv6(r, k, v, w, u, s0, chunk=8)
    with pytest.raises(ValueError, match="bounds must be"):
        wkv6_bwd(r, k, v, w, u, torch.zeros((1, 1, 2, 16, 16), device=cuda), torch.zeros_like(r), None, 16)


# (arch, impl, capacity factor or None for the smoke config's, router):
# zero routers tie every expert, so CUDA's sort must rank them as the CPU's
MOE_CASES = [
    ("mixtral-8x22b", "einsum", None, "random"),
    ("mixtral-8x22b", "gather", None, "random"),
    ("mixtral-8x22b", "einsum", 0.5, "random"),
    ("mixtral-8x22b", "gather", 0.5, "random"),
    ("mixtral-8x22b", "einsum", None, "zero"),
    ("arctic-480b", "einsum", 0.5, "zero"),
    ("arctic-480b", "gather", None, "random"),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=str)
def test_moe_ffn_card_matches_cpu(cuda, case):
    """moe_ffn in float32 at smoke width, 1024 tokens (two groups of 512)
    and 24: the expert choices equal, the output, the aux loss and the
    gradients of x and every leaf at 1e-4.  No kernel launches: MoE is
    plain torch, as the JAX package leaves it to XLA."""
    from repro_torch.models.ffn import _router_probs, init_moe, moe_ffn

    arch, impl, cf, router = case
    cfg = get_smoke_config(arch)
    moe = dataclasses.replace(cfg.moe, impl=impl, **({} if cf is None else dict(capacity_factor=cf)))
    cfg = dataclasses.replace(cfg, moe=moe)
    params = init_moe(cfg, generator=torch.Generator().manual_seed(0), device=torch.device("cpu"))
    if router == "zero":
        params["router"].zero_()
    rng = np.random.default_rng(1)
    for b, s in ((2, 512), (2, 12)):
        x = torch.tensor(rng.standard_normal((b, s, cfg.d_model), np.float32))
        ct = torch.tensor(rng.standard_normal((b, s, cfg.d_model), np.float32))
        sides = {}
        for dev in ("cpu", cuda):
            p = _tree(params, lambda t, dev=dev: t.to(dev).requires_grad_(True))
            xd = x.to(dev).requires_grad_(True)
            before = dict(LAUNCHES)
            y, aux = moe_ffn(p, xd, cfg)
            leaves = [xd] + [t for _, t in tree_items(p)]
            grads = torch.autograd.grad((y * ct.to(dev)).sum() + aux, leaves)
            assert dict(LAUNCHES) == before
            idx = _router_probs(p, xd.detach().reshape(b * s, -1), cfg.moe)[2]
            sides[str(dev)] = [t.detach().cpu() for t in (idx, y, aux, *grads)]
        card, cpu = sides["cuda"], sides["cpu"]
        assert torch.equal(card[0], cpu[0])
        if router == "zero":
            assert (cpu[0] == torch.arange(cfg.moe.num_experts_per_tok)).all()
        for got, want in zip(card[1:], cpu[1:]):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_smoke_prefill_and_decode_card_matches_cpu(cuda, dtype):
    """rwkv6's serving path at the smoke config on the card and on the CPU:
    one WKV launch per layer in prefill and in every decode step."""
    cfg = dataclasses.replace(get_smoke_config("rwkv6-7b"), dtype=dtype)
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    cpu_params = _tree(params, lambda t: t.cpu())
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    before = LAUNCHES["wkv6_fwd"]
    g_logits, g_cache = prefill(params, {"tokens": tokens.to(cuda)}, cfg)
    assert LAUNCHES["wkv6_fwd"] == before + cfg.num_layers
    c_logits, c_cache = prefill(cpu_params, {"tokens": tokens}, cfg)
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(g_logits.float().cpu(), c_logits.float(), rtol=tol, atol=tol)
    for i in range(4):
        nxt = g_logits.argmax(-1)
        g_logits, g_cache = decode_step(params, nxt, g_cache, cfg, 40 + i)
        c_logits, c_cache = decode_step(cpu_params, nxt.cpu(), c_cache, cfg, 40 + i)
        torch.testing.assert_close(g_logits.float().cpu(), c_logits.float(), rtol=tol, atol=tol)
        assert LAUNCHES["wkv6_fwd"] == before + cfg.num_layers * (2 + i)
    torch.testing.assert_close(
        g_cache["groups"]["slot0"]["wkv"].cpu(), c_cache["groups"]["slot0"]["wkv"], rtol=tol, atol=tol
    )


# (b, t, dr, dtype, gates): chip_smoke.py's RGLRU_CASES (the prefill's and
# decode step's shapes, T one past a multiple of the 64-step chunk,
# float32, extreme gates), and T at one chunk and one past it (Dr 256, and
# Dr 200 and 4096: a block's 64-channel slice cut, and the model's width)
RGLRU_CASES = [
    (4, 4096, 4096, "bfloat16", None),
    (4, 1, 4096, "bfloat16", None),
    (1, 4097, 4096, "bfloat16", None),
    (2, 300, 64, "float32", None),
    (3, 37, 72, "float32", None),
    (2, 64, 256, "float32", None),
    (2, 65, 256, "bfloat16", None),
    (2, CHUNK, 200, "float32", None),
    (3, CHUNK + 1, 4096, "bfloat16", None),
    (2, 300, 256, "bfloat16", "r_zero"),
    (2, 300, 256, "float32", "r_one_lam10"),
    (2, 300, 256, "bfloat16", "lam_minus10"),
]


def _rglru_inputs(seed, b, t, dr, dtype, gates=None, device="cuda"):
    g = torch.Generator(device).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn((b, t, dr), generator=g, device=device).to(dt)
    r = torch.sigmoid(torch.randn((b, t, dr), generator=g, device=device)).to(dt)
    i = torch.sigmoid(torch.randn((b, t, dr), generator=g, device=device)).to(dt)
    lam = torch.logit(torch.linspace(0.9, 0.999, dr, device=device) ** (1 / 8))
    if gates == "r_zero":  # a = 1, beta at the 1e-6 clamp
        r = torch.zeros_like(r)
    elif gates == "r_one_lam10":
        r, lam = torch.ones_like(r), torch.full_like(lam, 10.0)
    elif gates == "lam_minus10":  # a near 0
        lam = torch.full_like(lam, -10.0)
    return x, r, i, lam, torch.randn((b, dr), generator=g, device=device)


@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_kernel_matches_plain_and_is_deterministic(cuda, case):
    b, t, dr, dtype, gates = case
    x, r, i, lam, h0 = _rglru_inputs(0, b, t, dr, dtype, gates)
    before = LAUNCHES["rglru_scan"]
    h, last = rglru_scan(x, r, i, lam, h0)
    again, again_last = rglru_scan(x, r, i, lam, h0)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan"] == before + 2
    assert h.dtype == x.dtype and last.dtype == torch.float32
    assert torch.equal(h, again) and torch.equal(last, again_last)
    plain, plain_last = rglru_scan_ref(x, r, i, lam, h0)
    torch.testing.assert_close(h.float(), plain.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(last, plain_last, rtol=1e-4, atol=1e-4)


def test_rglru_decode_steps_carry_h(cuda):
    """Decode's T = 1 steps from h0 held in a view of a stacked cache, each
    step's h_last copied back into it as ``rglru_block`` does: the plain
    loop over all steps, and the cache's other rows untouched."""
    x, r, i, lam, h0 = _rglru_inputs(1, 2, 6, 4096, "bfloat16")
    stacked = torch.zeros((3, 2, 4096), device=cuda)
    stacked[1] = h0
    h = stacked[1]
    outs = []
    for step in range(6):
        y, last = rglru_scan(x[:, step:step + 1], r[:, step:step + 1], i[:, step:step + 1], lam, h)
        h.copy_(last)
        outs.append(y)
    torch.cuda.synchronize()
    plain, plain_last = rglru_scan_ref(x, r, i, lam, h0)
    torch.testing.assert_close(torch.cat(outs, 1).float(), plain.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(h, plain_last, rtol=1e-4, atol=1e-4)
    assert not stacked[0].any() and not stacked[2].any()


def test_rglru_kernel_reads_strided_inputs(cuda):
    """x, r, i as views of one [B, T, 3, Dr] tensor: no copy.  lam and h0
    as views at an odd float offset, which the float2 loads cannot read in
    place: the wrapper copies them."""
    xri = torch.rand((2, 130, 3, 512), device=cuda).to(torch.bfloat16)
    x, r, i = xri.unbind(2)
    _, _, _, lam, h0 = _rglru_inputs(2, 2, 130, 512, "bfloat16")
    lam = torch.cat([lam.new_zeros(1), lam])[1:]
    h0 = torch.cat([h0.new_zeros(1), h0.flatten()])[1:].view(2, 512)
    assert not x.is_contiguous() and lam.data_ptr() % 8 and h0.data_ptr() % 8
    h, last = rglru_scan(x, r, i, lam, h0)
    plain, plain_last = rglru_scan_ref(x, r, i, lam, h0)
    torch.testing.assert_close(h.float(), plain.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(last, plain_last, rtol=1e-4, atol=1e-4)


def test_rglru_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    """The kernels' refusals (the backward's too: it needs the forward's
    chunk states past one chunk); under autograd the wrapper now takes the
    backward kernel, whose gradient must match the plain one."""
    x, r, i, lam, h0 = _rglru_inputs(3, 2, 8, 64, "float32")
    leaves = [x.clone().requires_grad_(True), r, i, lam, h0]
    h, last = rglru_scan(*leaves)
    (h.sum() + last.sum()).backward()
    want = rglru_scan_bwd_ref(x, r, i, lam, h0, torch.ones_like(x), torch.ones_like(h0))[0]
    torch.testing.assert_close(leaves[0].grad, want, rtol=1e-4, atol=1e-4)
    long = _rglru_inputs(3, 2, CHUNK + 1, 64, "float32")
    with pytest.raises(ValueError, match="states must be"):
        rglru_scan_bwd(*long, None, None)
    odd = _rglru_inputs(3, 2, 8, 63, "float32")
    with pytest.raises(ValueError, match="Dr must be even"):
        rglru_scan(*odd)
    with pytest.raises(ValueError, match="one dtype"):
        rglru_scan(x.detach().to(torch.bfloat16), r, i, lam, h0)


# (b, t, dr, dtype, gates, cotangents): T = 1, one chunk, one past it, the
# carry through many chunks (T 300, 4097), r = 0 (the clamp), lam = +-10,
# Dr 200 (a block's slice cut) and 4096; cotangents on h and h_last, on h
# alone, on h_last alone
RGLRU_BWD_CASES = [
    (2, 1, 256, "bfloat16", None, "both"),
    (2, CHUNK, 256, "float32", None, "both"),
    (2, CHUNK + 1, 200, "float32", None, "h_last"),
    (3, CHUNK + 1, 4096, "bfloat16", None, "both"),
    (2, 300, 256, "bfloat16", "r_zero", "both"),
    (2, 300, 256, "float32", "r_one_lam10", "h"),
    (2, 300, 256, "bfloat16", "lam_minus10", "both"),
    (1, 4097, 512, "bfloat16", None, "h"),
]


@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=str)
def test_rglru_bwd_kernel_matches_plain_and_is_deterministic(cuda, case):
    """The backward kernel (the carry through the chunks from the last, h
    recomputed from the forward's chunk states) against the plain reverse
    recurrence and its chunked model on the card: dx, dr, di at the dtype's
    bar, dh0 at 1e-4, dlam (a sum over B x T in another order) at 1e-3;
    two calls give equal bits."""
    b, t, dr, dtype, gates, uses = case
    x, r, i, lam, h0 = _rglru_inputs(4, b, t, dr, dtype, gates)
    g = torch.Generator(cuda).manual_seed(5)
    dy = torch.randn((b, t, dr), generator=g, device=cuda).to(x.dtype) if uses != "h_last" else None
    dh_last = torch.randn((b, dr), generator=g, device=cuda) if uses != "h" else None
    _, _, states = rglru_scan_fwd(x, r, i, lam, h0)
    before = LAUNCHES["rglru_scan_bwd"]
    got = rglru_scan_bwd(x, r, i, lam, h0, dy, dh_last, states=states)
    again = rglru_scan_bwd(x, r, i, lam, h0, dy, dh_last, states=states)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru_scan_bwd"] == before + 2
    for plain in (rglru_scan_bwd_ref, rglru_scan_bwd_chunked_ref):
        want = plain(x, r, i, lam, h0, dy, dh_last)
        tols = (TOL[dtype],) * 3 + (1e-3, 1e-4)
        for name, a, w, same, tol in zip(("dx", "dr", "di", "dlam", "dh0"), got, want, again, tols):
            assert a.dtype == w.dtype and torch.equal(a, same), name
            torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol,
                                       msg=lambda m, name=name, plain=plain: f"{plain.__name__} {name}: {m}")


@pytest.mark.parametrize("t", [1, CHUNK, CHUNK + 1, 3 * CHUNK + 5, 4096])
def test_rglru_bwd_kernel_gives_equal_bits_twice(cuda, t):
    """The persistent backward (tickets taken in any order by the blocks,
    the carry behind flags) at train_recurrentgemma's width, 1 x T x 4096
    bf16, from T = 1 to the pod's 4096: two calls give equal bits in every
    output, within the bf16 bar of its chunked model."""
    x, r, i, lam, h0 = _rglru_inputs(8, 1, t, 4096, "bfloat16")
    g = torch.Generator(cuda).manual_seed(9)
    dy = torch.randn((1, t, 4096), generator=g, device=cuda).to(x.dtype)
    dh_last = torch.randn((1, 4096), generator=g, device=cuda)
    _, _, states = rglru_scan_fwd(x, r, i, lam, h0)
    got = rglru_scan_bwd(x, r, i, lam, h0, dy, dh_last, states=states)
    again = rglru_scan_bwd(x, r, i, lam, h0, dy, dh_last, states=states)
    torch.cuda.synchronize()
    want = rglru_scan_bwd_chunked_ref(x, r, i, lam, h0, dy, dh_last)
    for name, a, same, w, tol in zip(("dx", "dr", "di", "dlam", "dh0"), got, again, want, (2e-2,) * 3 + (1e-3, 1e-4)):
        assert torch.equal(a, same), f"{name} differs between two calls"
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol, msg=lambda m, name=name: f"{name}: {m}")


def test_rglru_bwd_kernel_reads_unaligned_rows(cuda):
    """x, r, i as views of one [B, T, 3, Dr] tensor and Dr = 6 (rows of 12
    bytes, which the TMA maps cannot step): the wrapper copies them into
    16-byte rows and returns views of such rows."""
    xri = torch.rand((2, 70, 3, 6), device=cuda)
    x, r, i = xri.unbind(2)
    _, _, _, lam, h0 = _rglru_inputs(10, 2, 70, 6, "float32")
    g = torch.Generator(cuda).manual_seed(11)
    dy = torch.randn((2, 70, 6), generator=g, device=cuda)
    _, _, states = rglru_scan_fwd(x, r, i, lam, h0)
    got = rglru_scan_bwd(x, r, i, lam, h0, dy, None, states=states)
    want = rglru_scan_bwd_ref(x, r, i, lam, h0, dy, None)
    for name, a, w in zip(("dx", "dr", "di", "dlam", "dh0"), got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4, msg=lambda m, name=name: f"{name}: {m}")


def test_rglru_gradient_on_the_card_matches_autograd_through_the_plain_loop(cuda):
    """rglru_scan under grad (the forward kernel keeping its chunk states,
    then the backward kernel) against autograd through rglru_scan_ref's
    loop on the card, float32 at 1e-4; one launch of each kernel."""
    leaves = [a.requires_grad_(True) for a in _rglru_inputs(6, 2, 150, 64, "float32")]
    w = torch.randn((2, 150, 64), generator=torch.Generator(cuda).manual_seed(7), device=cuda)
    before = dict(LAUNCHES)
    h, last = rglru_scan(*leaves)
    got = torch.autograd.grad((h * w).sum() + last.square().sum(), leaves)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before.get(n, 0) for n in ("rglru_scan", "rglru_scan_bwd")} == {
        "rglru_scan": 1, "rglru_scan_bwd": 1}
    ph, plast = rglru_scan_ref(*leaves)
    want = torch.autograd.grad((ph * w).sum() + plast.square().sum(), leaves)
    for name, a, b in zip(("x", "r", "i", "lam", "h0"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=lambda m, name=name: f"d{name}: {m}")


def test_recurrentgemma_smoke_loss_and_grads_card_match_cpu(cuda):
    """recurrentgemma-9b's smoke config in float32: the loss and every
    gradient leaf on the card (4 rglru_scan and 4 rglru_scan_bwd launches,
    1 flash forward and backward) against the CPU at 1e-4."""
    cfg = get_smoke_config("recurrentgemma-9b")
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    cpu_params = _tree(params, lambda t: t.cpu())
    batch = loader_for_model(cfg, seq_len=80, global_batch=2, seed=3).next_batch()
    out = {}
    for name, p, dev in (("card", params, cuda), ("cpu", cpu_params, "cpu")):
        before = dict(LAUNCHES)
        loss, _, grads = pod_grads(p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg, 1)
        out[name] = (loss.item(), tree_map(lambda t: t.cpu(), grads),
                     {n: c - before.get(n, 0) for n, c in LAUNCHES.items() if c != before.get(n, 0)})
    assert out["card"][2] == {"rglru_scan": 4, "rglru_scan_bwd": 4, "flash_attention_fwd": 1,
                              "flash_attention_bwd": 1}
    assert out["cpu"][2] == {}
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for (path, g), (_, c) in zip(tree_items(out["card"][1]), tree_items(out["cpu"][1])):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4, msg=lambda m, path=path: f"{path}: {m}")


def test_recurrentgemma_smoke_prefill_and_decode_card_matches_cpu(cuda):
    """recurrentgemma-9b's smoke config in float32 on the card and on the
    CPU: 4 rglru_scan launches and 1 flash launch a prefill, 4 rglru_scan a
    decode step; logits and the recurrent states at 1e-4."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"), dtype="float32")
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    cpu_params = _tree(params, lambda t: t.cpu())
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    before = dict(LAUNCHES)
    g_logits, g_cache = prefill(params, {"tokens": tokens.to(cuda)}, cfg, max_len=44)
    moved = {n: c - before.get(n, 0) for n, c in LAUNCHES.items() if c != before.get(n, 0)}
    assert moved == {"rglru_scan": 4, "flash_attention_fwd": 1}
    c_logits, c_cache = prefill(cpu_params, {"tokens": tokens}, cfg, max_len=44)
    torch.testing.assert_close(g_logits.cpu(), c_logits, rtol=1e-4, atol=1e-4)
    for i in range(4):
        nxt = g_logits.argmax(-1)
        g_logits, g_cache = decode_step(params, nxt, g_cache, cfg, 40 + i)
        c_logits, c_cache = decode_step(cpu_params, nxt.cpu(), c_cache, cfg, 40 + i)
        torch.testing.assert_close(g_logits.cpu(), c_logits, rtol=1e-4, atol=1e-4)
    assert LAUNCHES["rglru_scan"] == before.get("rglru_scan", 0) + 4 * 5
    for key in ("h", "conv"):
        torch.testing.assert_close(g_cache["remainder"][1][key].cpu(), c_cache["remainder"][1][key],
                                   rtol=1e-4, atol=1e-4)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def test_smoke_scenario_trainer_on_the_card_equals_the_run_without_events(cuda, tmp_path):
    """The scenario path at smoke size on the card: train_geo's spec with a
    link flap and a brownout, 2 pods under hier_int8; the events touch the
    modelled fabric only, so the losses equal a run of the same spec without
    them (rtol 1e-6: every kernel on the path is deterministic)."""
    from repro_torch.examples.train_geo import geo_scenario
    from repro_torch.scenario import ScenarioEvent

    cfg = get_smoke_config("distilgpt2-82m")
    tc = TrainerConfig(seq_len=64, global_batch=4, steps=100, log_every=100)
    events = (
        ScenarioEvent(kind="fail_link", at_step=1, link=("d1s1", "d2s1")),
        ScenarioEvent(kind="degrade_pair", at_step=1, pair=(1, 2), bandwidth_fraction=0.25),
        ScenarioEvent(kind="restore_link", at_step=2, link=("d1s1", "d2s1")),
        ScenarioEvent(kind="restore_degradation", at_step=3, pair=(1, 2)),
    )
    runs = {}
    for name, evs in (("events", events), ("none", ())):
        trainer = GeoTrainer(cfg, trainer_cfg=tc, scenario=geo_scenario("hier_int8", 4, events=evs),
                             checkpoint_dir=str(tmp_path / name), device=cuda)
        assert trainer.tc.npods == 2 and trainer.tc.steps == 4
        runs[name] = (trainer.run(), trainer)
    result, trainer = runs["events"]
    assert [t["mechanism"] for t in result["scenario_recoveries"]] == ["bfd"]
    assert result["scenario_evpn_resyncs"] == 2
    assert trainer.geo.fabric.link_up("d1s1", "d2s1")
    np.testing.assert_allclose([r["loss"] for r in result["metrics"]],
                               [r["loss"] for r in runs["none"][0]["metrics"]], rtol=1e-6, atol=0)


def test_request_batch_on_the_card(cuda):
    from repro_torch.serving import Request, request_batch

    cfg = get_smoke_config("distilgpt2-82m")
    req = Request(rid=108, step=13, home_dc=1, user=0, tokens=102)
    batch = request_batch(cfg, req, device=cuda)
    assert batch["tokens"].device.type == "cuda" and batch["tokens"].dtype == torch.int32
    assert tuple(batch["tokens"].shape) == (1, 102)
    assert torch.equal(batch["tokens"], request_batch(cfg, req, device=cuda)["tokens"])


def test_serve_geo_ragged_prefill_card_matches_cpu(cuda):
    """A traced request of serving_under_flap's peak step (276 tokens, no
    multiple of the kernel's tiles) prefilled at full width, cut to 2
    layers: one flash launch a layer on wgmma, bf16 logits against the CPU
    at 5e-2."""
    from repro_torch.serving import Request, request_batch

    cfg = dataclasses.replace(get_config("distilgpt2-82m"), num_layers=2)
    params = init_params(cfg, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    req = Request(rid=109, step=13, home_dc=1, user=0, tokens=276)
    batch = request_batch(cfg, req, device=cuda)
    before = ROUTE_LAUNCHES["wgmma"]
    g_logits, _ = prefill(params, batch, cfg, max_len=req.tokens + 8)
    torch.cuda.synchronize()
    assert ROUTE_LAUNCHES["wgmma"] == before + cfg.num_layers
    c_logits, _ = prefill(_tree(params, lambda t: t.cpu()), _tree(batch, lambda t: t.cpu()), cfg,
                          max_len=req.tokens + 8)
    torch.testing.assert_close(g_logits.float().cpu(), c_logits.float(), rtol=5e-2, atol=5e-2)


# -- the pod axis as a process group: two ranks on the card -----------------------------

GROUP_STRATEGIES = ("allreduce", "hier", "hier_int8", "ps", "local_sgd")


def _group_cfg():
    """distilgpt2-82m at full width cut to one layer: bf16, head_dim 64 (wgmma)."""
    return dataclasses.replace(get_config("distilgpt2-82m"), num_layers=1)


def _group_batch(cfg):
    return loader_for_model(cfg, seq_len=128, global_batch=4, seed=2).next_batch()


def _group_step(strategy, device, mesh=None):
    """One step of ``strategy`` from seed 0's weights (sync_every 1: the
    local_sgd step is an outer step); the rank's or the stacked view."""
    cfg = _group_cfg()
    params = init_params(cfg, generator=torch.Generator(device).manual_seed(0), device=device)
    npods = None if mesh is not None else 2
    state = init_train_state(params, None, strategy=strategy, npods=npods, mesh=mesh)
    step = make_train_step(cfg, mesh=mesh, npods=npods, strategy=strategy, diloco_cfg=DilocoConfig(sync_every=1),
                           device=device)
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    BWD_ROUTE_LAUNCHES.clear()
    new, _, metrics = step(init_pod_params(params, strategy=strategy, npods=npods, mesh=mesh), state,
                           _group_batch(cfg))
    torch.cuda.synchronize()
    counts = (dict(LAUNCHES), dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES))
    on_card = all(t.device.type == "cuda" for _, t in tree_items(new))
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "wan_bytes": metrics["wan_bytes"], "params": {p: t.float().cpu() for p, t in tree_items(new)},
            "counts": counts, "on_card": on_card}


def _card_group_rank(rank):
    from repro_torch.distributed import PodGroup
    from repro_torch.launch.mesh import make_host_mesh, pod_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(pods=2, device="cuda")
    out = {s: _group_step(s, torch.device("cuda"), mesh) for s in GROUP_STRATEGIES}
    group = PodGroup(pod_process_group(mesh), device="cuda")
    gloo = {}
    for dtype in (torch.float32, torch.int8):
        x = torch.full((300,), rank + 1, dtype=dtype, device="cuda")
        done = {"all_reduce": group.all_reduce(x.clone()), "all_gather": group.all_gather(x),
                "broadcast": group.broadcast(x.clone())}
        gloo[str(dtype)] = {op: (t.device.type, t.dtype == dtype, t.float().sum().item()) for op, t in done.items()}
    out["gloo"] = gloo
    return out


@pytest.fixture(scope="module")
def card_group():
    """Two ranks of one gloo group on the card, one step of each strategy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.distributed import spawn

    ranks = spawn(_card_group_rank, 2, device="cuda", join_timeout_s=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one = {s: _group_step(s, torch.device("cuda")) for s in GROUP_STRATEGIES}
    return ranks, one


@pytest.mark.parametrize("strategy", GROUP_STRATEGIES)
def test_two_ranks_on_the_card_equal_the_one_process_card_step(card_group, strategy):
    """Loss, grad norm, WAN bytes and every parameter leaf, bit for bit:
    each rank runs its pod's half of the one-process step's work."""
    ranks, one = card_group
    want = one[strategy]
    for r, rank in enumerate(ranks):
        got = rank[strategy]
        assert got["on_card"]
        assert (got["loss"], got["grad_norm"], got["wan_bytes"]) == (want["loss"], want["grad_norm"],
                                                                     want["wan_bytes"])
        for path, w in want["params"].items():
            w = w[r] if strategy == "local_sgd" else w  # after the outer step every pod holds the same
            assert torch.equal(got["params"][path], w), (r, path)


def test_gloo_takes_cuda_tensors_for_the_three_collectives(card_group):
    """all_reduce, all_gather and broadcast of float32 and int8 CUDA
    tensors: gloo moves them through host memory itself, so no op is
    staged by the port (PodGroup has no staging path)."""
    ranks, _ = card_group
    for r, rank in enumerate(ranks):
        for dtype, ops in rank["gloo"].items():
            assert ops == {"all_reduce": ("cuda", True, 900.0), "all_gather": ("cuda", True, 900.0),
                           "broadcast": ("cuda", True, 300.0)}, (r, dtype)


@pytest.mark.parametrize("strategy", GROUP_STRATEGIES)
def test_group_ranks_launch_the_kernels_on_wgmma(card_group, strategy):
    """One flash forward and backward a layer on each rank, all on wgmma;
    under hier_int8 one wan_quant and one wan_dequant a leaf."""
    ranks, one = card_group
    cfg = _group_cfg()
    leaves = len(one[strategy]["params"])
    for rank in ranks:
        launches, routes, bwd_routes = rank[strategy]["counts"]
        want = {"flash_attention_fwd": cfg.num_layers, "flash_attention_bwd": cfg.num_layers}
        if strategy == "hier_int8":
            want.update(wan_quant=leaves, wan_dequant=leaves)
        assert launches == want
        assert routes == {"wgmma": cfg.num_layers} and bwd_routes == {"wgmma": cfg.num_layers}


# -- intra-pod placement on the card: 4 ranks, (pod 2, data 2) and (data 2, model 2) --------

MESH_LOSS_RTOL = 1e-3  # bf16: sums over data ranks and tensor-parallel halves round apart (train_mesh's bar)


def _mesh_step(strategy, mesh):
    """One step on ``mesh`` from seed 0's weights: the rank's view, with
    its launches, routes and LAN / WAN counts."""
    from repro_torch.distributed.placement import full_tree

    cfg = _group_cfg()
    params = init_params(cfg, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    state = init_train_state(params, None, strategy=strategy, mesh=mesh)
    step = make_train_step(cfg, mesh=mesh, strategy=strategy, device="cuda")
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()
    BWD_ROUTE_LAUNCHES.clear()
    new, _, metrics = step(init_pod_params(params, strategy=strategy, mesh=mesh), state, _group_batch(cfg))
    torch.cuda.synchronize()
    counts = (dict(LAUNCHES), dict(ROUTE_LAUNCHES), dict(BWD_ROUTE_LAUNCHES))
    on_card = all(t.to_local().device.type == "cuda" for _, t in tree_items(new))
    with step.lan:
        whole = {p: t.float().cpu() for p, t in tree_items(full_tree(new))}
    return {"loss": metrics["loss"].item(), "wan_bytes": metrics["wan_bytes"], "lan_bytes": metrics["lan_bytes"],
            "lan_calls": dict(step.lan.calls), "params": whole, "counts": counts, "on_card": on_card}


def _mesh_serve(mesh, device, fed=None):
    """Prefill and 3 decode steps, fed ``fed`` (default: this run's own
    greedy tokens, which it returns)."""
    cfg = _group_cfg()
    params = init_params(cfg, generator=torch.Generator(device).manual_seed(0), device=device)
    batch = synthetic_prompt_batch(cfg, torch.Generator(device).manual_seed(1), 4, 128)
    if mesh is None:
        logits, cache = prefill(params, batch, cfg, max_len=131)
    else:
        from repro_torch.distributed import make_decode_step, make_prefill_step

        prefill_step, _ = make_prefill_step(cfg, mesh, device=device)
        decode, _ = make_decode_step(cfg, mesh, device=device)
        LAUNCHES.clear()
        ROUTE_LAUNCHES.clear()
        logits, cache = prefill_step(params, batch, max_len=131)
    out, tokens = [logits.float().cpu()], []
    for i in range(3):
        tokens.append(logits.argmax(-1).cpu() if fed is None else fed[i])
        if mesh is None:
            logits, cache = decode_step(params, tokens[-1].to(device), cache, cfg, 128 + i)
        else:
            logits, cache = decode(params, tokens[-1].to(device), cache, 128 + i)
        out.append(logits.float().cpu())
    return out, tokens, (dict(LAUNCHES), dict(ROUTE_LAUNCHES))


def _card_mesh_rank(rank, fed):
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pod_data = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cuda")
    data_model = make_mesh((2, 2), ("data", "model"), device="cuda")
    return {
        "coordinate": list(pod_data.get_coordinate()),
        "pod_data": _mesh_step("hier_int8", pod_data),
        "data_model": _mesh_step("allreduce", data_model),
        "serve": _mesh_serve(data_model, "cuda", fed),
    }


@pytest.fixture(scope="module")
def card_mesh():
    """Four ranks of one gloo group on the card: one step on each mesh, and
    a prefill with 3 decode steps on (data 2, model 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.distributed import spawn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    served, fed, _ = _mesh_serve(None, "cuda")
    ranks = spawn(_card_mesh_rank, 4, fed, device="cuda", join_timeout_s=400)
    one = {s: _group_step(s, torch.device("cuda")) for s in ("hier_int8", "allreduce")}
    return ranks, one, served


def test_mesh_steps_on_the_card_match_the_one_process_step(card_mesh):
    """The (pod 2, data 2) hier_int8 step and the (data 2, model 2) step:
    loss within MESH_LOSS_RTOL of the one-process card step, every leaf on
    the card, WAN bytes a pod equal to the one-process step's (none on a
    mesh without pods), LAN bytes counted."""
    ranks, one, _ = card_mesh
    for r, rank in enumerate(ranks):
        for key, strategy in (("pod_data", "hier_int8"), ("data_model", "allreduce")):
            got, want = rank[key], one[strategy]
            assert got["on_card"], (r, key)
            assert abs(got["loss"] - want["loss"]) <= MESH_LOSS_RTOL * abs(want["loss"]), (r, key)
            assert got["wan_bytes"] == (want["wan_bytes"] if key == "pod_data" else 0), (r, key)
            assert got["lan_bytes"] > 0 and got["lan_calls"], (r, key)


def test_mesh_ranks_launch_the_kernels_on_local_shards_on_wgmma(card_mesh):
    """One flash forward and backward a layer on every rank, on wgmma
    (the rank's rows, and over model its 6 heads of 64); under hier_int8
    one wan_quant and one wan_dequant a non-empty WAN piece."""
    ranks, one, _ = card_mesh
    cfg = _group_cfg()
    leaves = [p for p in one["hier_int8"]["params"]]
    for r, rank in enumerate(ranks):
        for key in ("pod_data", "data_model"):
            launches, routes, bwd_routes = rank[key]["counts"]
            assert launches["flash_attention_fwd"] == launches["flash_attention_bwd"] == cfg.num_layers, (r, key)
            assert routes == {"wgmma": cfg.num_layers} and bwd_routes == {"wgmma": cfg.num_layers}, (r, key)
        launches = rank["pod_data"]["counts"][0]
        first = rank["coordinate"][1] == 0  # data index 0: the pod's first rank owns the rank-0/1 leaves
        assert launches["wan_quant"] == launches["wan_dequant"] <= len(leaves), r
        assert (launches["wan_quant"] == len(leaves)) == first, r
        assert "wan_quant" not in rank["data_model"]["counts"][0], r


def test_mesh_serving_on_the_card_matches_one_process(card_mesh):
    """Prefill and 3 decode steps on (data 2, model 2), fed the one-process
    card run's greedy tokens, against that run: bf16 rtol = atol = 5e-2,
    the greedy tokens equal but where the one-process top two logits are
    within the tolerance (a near-tie at bf16 rounding), one flash forward a
    layer a rank on wgmma."""
    ranks, _, want = card_mesh
    cfg = _group_cfg()
    for r, rank in enumerate(ranks):
        got, _, (launches, routes) = rank["serve"]
        assert launches == {"flash_attention_fwd": cfg.num_layers} and routes == {"wgmma": cfg.num_layers}, r
        for i, (g, w) in enumerate(zip(got, want)):
            torch.testing.assert_close(g, w, rtol=5e-2, atol=5e-2, msg=f"rank {r} call {i}")
            top2 = w.topk(2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) <= 5e-2 * (1 + top2[:, 0].abs())
            assert not ((g.argmax(-1) != w.argmax(-1)) & ~tie).any(), (r, i)
