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
from repro_torch.kernels.flash_attention.ops import BWD_ROUTE_LAUNCHES, PADDED_LAUNCHES, ROUTE_LAUNCHES
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_ref
from repro_torch.kernels.rwkv6_wkv.ops import CHUNK as WKV_CHUNK
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


def test_wrapper_rejects_unsupported_head_dim(cuda):
    """head_dim 256 (recurrentgemma-9b) has no kernel until its path is ported."""
    q, k, v = _qkv(1, 1, 16, 16, 2, 2, 256, "float32", cuda)
    with pytest.raises(ValueError, match="head_dim 256.*item 12"):
        flash_attention(q, k, v)


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
    from repro_torch.examples.train_geo import build_trainer, geo_scenario
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
        trainer = build_trainer(cfg, geo_scenario("hier_int8", 4, events=evs), tc,
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
