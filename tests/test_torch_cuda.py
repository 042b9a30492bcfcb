"""Tests of the port that need the card: a CUDA kernel has no CPU mode.

They skip without a GPU.  On a machine with one (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.models import decode_step, init_params, prefill

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
    plain = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.testing.assert_close(
        out.float(), plain.transpose(1, 2).float(), rtol=TOL[dtype], atol=TOL[dtype]
    )


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one fused [B, S, 3, H, hd] projection: no copy."""
    qkv = torch.randn((2, 128, 3, 4, 64), device=cuda).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    plain = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
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


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)
