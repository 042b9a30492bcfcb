"""Tests of the port that need the card: a CUDA kernel has no CPU mode.

They skip without a GPU.  On a machine with one (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import loader_for_model
from repro_torch.distributed import init_train_state, make_train_step, pod_grads, sync_grads
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_ref,
)
from repro_torch.kernels.wan_quant import wan_dequant, wan_dequant_ref, wan_quant, wan_quant_ref
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.optim import global_norm
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
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
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


def test_wrapper_rejects_unsupported_head_dim(cuda):
    q, k, v = _qkv(1, 1, 16, 16, 2, 2, 32, "float32", cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_prefill_and_decode_card_matches_cpu(cuda, dtype):
    """The serving path at the smoke config on the card and on the CPU."""
    cfg = dataclasses.replace(get_smoke_config("distilgpt2-82m"), dtype=dtype)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
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


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)
