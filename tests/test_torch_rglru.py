"""The port's RG-LRU slice (recurrentgemma-9b) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The
recurrence's plain version (what ``rglru_scan`` computes on a CPU tensor)
is held against JAX ``rg_lru`` (an associative scan); the kernel's chunked
algorithm (``rglru_scan_chunked_ref``) against the step-by-step loop in
float64; the plain backward (``rglru_scan_bwd_ref``, the reverse
recurrence) and ``RGLRUScanFn`` against ``jax.grad`` of ``rg_lru``, and the
backward kernel's chunked algorithm (``rglru_scan_bwd_chunked_ref``)
against the plain backward in float64; the conv, the block and the whole smoke model (forward, prefill
with every cache leaf, decode, the loss and every gradient leaf) against
the JAX functions, on the same weights (drawn by the port's init, through
``convert.py``).  The init sets the conv bias and the norm scales to
constants that would hide swapped leaves, so the model tests draw them from
a seed too.
``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models import rglru as jrg
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_to_numpy, params_from_numpy, params_to_numpy
from repro_torch.kernels.rglru_scan import (CHUNK, SEGMENT, RGLRUScanFn, rglru_scan, rglru_scan_bwd,
                                            rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref, rglru_scan_chunked_ref,
                                            rglru_scan_fwd, rglru_scan_ref)
from repro_torch.kernels.rglru_scan.ops import _check, _check_cuda
from repro_torch.models import decode_step, forward, init_params, loss_fn, prefill
from repro_torch.models import rglru as trg

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
# TestRgLru's bar for float32; bf16 inputs round at other points
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# the port's serving parity bar (tests/test_torch_serve.py), elementwise;
# bf16 at 5e-2 in relative norm: the two frameworks round bf16 at other
# points (XLA once at the end of a fused elementwise chain, PyTorch after
# every op), and at this size JAX's own bf16 logits lie farther than an
# elementwise 5e-2 from its float32 model's, so the bf16 test holds the
# port's logits to that distance instead
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PROMPT, MAX_LEN, GEN = 19, 24, 4  # prompt > local_window 8: the rolling cache wraps


def _np(t):
    return t.detach().float().numpy()


def _scan_inputs(seed, b, t, dr, gates=None):
    """x, r, i [B, T, Dr], lam [Dr], h0 [B, Dr] (float32 numpy), the gates
    in (0, 1) and lam around the JAX init's logits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, dr))
    r = 1 / (1 + np.exp(-rng.standard_normal((b, t, dr))))
    i = 1 / (1 + np.exp(-rng.standard_normal((b, t, dr))))
    base = np.linspace(0.9, 0.999, dr) ** (1 / 8)
    lam = np.log(base / (1 - base)) + 0.1 * rng.standard_normal(dr)
    h0 = rng.standard_normal((b, dr))
    if gates == "r_zero":  # a = 1, beta at its 1e-6 clamp
        r = np.zeros_like(r)
    elif gates == "r_one_lam10":
        r, lam = np.ones_like(r), np.full_like(lam, 10.0)
    elif gates == "lam_minus10":  # a near 0
        lam = np.full_like(lam, -10.0)
    return [a.astype(np.float32) for a in (x, r, i, lam, h0)]


def _both(arrays, dtype):
    """x, r, i in ``dtype``; lam and h0 float32: for JAX and for the port."""
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays[:3]] + [jnp.asarray(a) for a in arrays[3:]]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays[:3]] + [torch.from_numpy(a) for a in arrays[3:]]
    return j, t


# -- the conv and the recurrence ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 2, 3, 7])
def test_causal_conv1d_matches_jax(t, dtype):
    """Its output and new tail from a non-zero tail; for T < 3 the new tail
    holds part of the old one."""
    rng = np.random.default_rng(t)
    x, tail = rng.standard_normal((2, t, 16)), rng.standard_normal((2, trg.CONV_WIDTH - 1, 16))
    w, b = rng.standard_normal((trg.CONV_WIDTH, 16)) * 0.1, rng.standard_normal(16) * 0.1
    jy, jtail = jrg._causal_conv1d(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32),
        tail=jnp.asarray(tail, JDT[dtype]),
    )
    ty, ttail = trg._causal_conv1d(
        torch.tensor(x).to(TDT[dtype]), torch.tensor(w, dtype=torch.float32), torch.tensor(b, dtype=torch.float32),
        tail=torch.tensor(tail).to(TDT[dtype]),
    )
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_np(ttail), np.asarray(jtail, np.float32))


@pytest.mark.parametrize("gates", [None, "r_zero", "r_one_lam10", "lam_minus10"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 37])
def test_scan_matches_jax_rg_lru(t, dtype, gates):
    """``rglru_scan`` on CPU tensors (the plain loop) against the
    associative scan, from a non-zero h0, which it leaves as it was; h_last
    is float32 on both sides."""
    arrays = _scan_inputs(t, 2, t, 24, gates)
    (jx, jr, ji, jlam, jh0), (tx, tr, ti, tlam, th0) = _both(arrays, dtype)
    jh, jlast = jrg.rg_lru(jx, jr, ji, jlam, h0=jh0)
    th, tlast = rglru_scan(tx, tr, ti, tlam, th0)
    assert th.dtype == tx.dtype and tlast.dtype == torch.float32
    np.testing.assert_allclose(_np(th), np.asarray(jh, np.float32), **(F32 if dtype == "float32" else BF16))
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), **F32)
    np.testing.assert_array_equal(th0.numpy(), arrays[4])


# (T, chunk, segment): the kernel's own chunk and segment with T below, at
# and past one chunk (and past two), and small ones that cut T every way
@pytest.mark.parametrize("t,chunk,segment", [
    (1, 8, 4), (8, 8, 4), (9, 8, 4), (37, 8, 8),
    (37, CHUNK, SEGMENT), (CHUNK, CHUNK, SEGMENT), (CHUNK + 1, CHUNK, SEGMENT), (2 * CHUNK + 44, CHUNK, SEGMENT),
])
@pytest.mark.parametrize("gates", [None, "r_zero", "lam_minus10"])
def test_chunked_ref_matches_step_by_step_in_float64(t, chunk, segment, gates):
    """The kernel's algorithm: segment decay products and local states
    folded into the chunk's, each chunk's start the previous chunk's
    published state, each segment walked again; equal to the loop in
    float64."""
    x, r, i, lam, h0 = (torch.from_numpy(a.astype(np.float64)) for a in _scan_inputs(7, 2, t, 6, gates))
    h, last = rglru_scan_ref(x, r, i, lam, h0)
    ch, clast = rglru_scan_chunked_ref(x, r, i, lam, h0, chunk=chunk, segment=segment)
    torch.testing.assert_close(ch, h, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(clast, last, rtol=1e-10, atol=1e-10)


def test_scan_grad_on_the_cpu_matches_jax_grad():
    """Autograd through the plain loop against ``jax.grad`` of ``rg_lru``."""
    x, r, i, lam, h0 = _scan_inputs(3, 2, 11, 8)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(x, r, i, lam, h0):
        h, last = jrg.rg_lru(x, r, i, lam, h0=h0)
        return jnp.sum(h * w) + jnp.sum(last ** 2)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*(jnp.asarray(a) for a in (x, r, i, lam, h0)))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, i, lam, h0)]
    h, last = rglru_scan(*targs)
    ((h * torch.from_numpy(w)).sum() + last.square().sum()).backward()
    for name, t, j in zip(("x", "r", "i", "lam", "h0"), targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5, err_msg=name)


# -- the gradient -------------------------------------------------------------------


def _jax_grads(arrays, dy, dh_last, dtype):
    """jax.grad of sum(h * dy) + sum(h_last * dh_last) over rg_lru's five
    inputs, as float32 numpy."""
    jargs, _ = _both(arrays, dtype)

    def jloss(x, r, i, lam, h0):
        h, last = jrg.rg_lru(x, r, i, lam, h0=h0)
        return jnp.sum(h.astype(jnp.float32) * dy) + jnp.sum(last * dh_last)

    grads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*jargs)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _cotangents(seed, b, t, dr, dtype):
    """dy (rounded to ``dtype``, as the cotangent of h in that dtype is) and
    dh_last, float32 numpy."""
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((b, t, dr)).astype(np.float32)
    dy = np.array(jnp.asarray(dy, JDT[dtype]).astype(jnp.float32))
    return dy, rng.standard_normal((b, dr)).astype(np.float32)


# (T, gates, dtype): T at 1, one below, at and one past the kernel's 64-step
# chunk, and past several; r = 0 (the clamp), lam = 10 and -10; bf16 at
# the suite's bf16 tolerance
GRAD_CASES = ([(t, None, "float32") for t in (1, 63, CHUNK, CHUNK + 1, 300)]
              + [(t, g, "float32") for t in (1, CHUNK + 1, 300) for g in ("r_zero", "r_one_lam10", "lam_minus10")]
              + [(t, None, "bfloat16") for t in (CHUNK + 1, 300)] + [(300, "r_zero", "bfloat16")])


@pytest.mark.parametrize("t,gates,dtype", GRAD_CASES, ids=str)
def test_bwd_ref_and_autograd_function_match_jax_grad(t, gates, dtype):
    """The plain backward (the reverse recurrence) and the autograd function
    (``rglru_scan`` under grad) against ``jax.grad`` of ``rg_lru``, with
    cotangents on both h and h_last, from a non-zero h0: float32 at rtol
    1e-4 / atol 1e-5, bf16 at the suite's bf16 bar."""
    arrays = _scan_inputs(100 + t, 2, t, 8, gates)
    dy, dh_last = _cotangents(200 + t, 2, t, 8, dtype)
    want = _jax_grads(arrays, dy, dh_last, dtype)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else BF16
    _, targs = _both(arrays, dtype)
    tdy = torch.from_numpy(dy).to(TDT[dtype])
    plain = rglru_scan_bwd_ref(*targs, tdy, torch.from_numpy(dh_last))
    leaves = [a.clone().requires_grad_(True) for a in targs]
    h, last = rglru_scan(*leaves)
    assert type(h.grad_fn).__name__ == "RGLRUScanFnBackward"
    auto = torch.autograd.grad((h.float() * torch.from_numpy(dy)).sum() + (last * torch.from_numpy(dh_last)).sum(),
                               leaves)
    for name, p, a, w, leaf in zip(("x", "r", "i", "lam", "h0"), plain, auto, want, targs):
        assert p.dtype == a.dtype == leaf.dtype, name
        np.testing.assert_allclose(_np(p), w, **tol, err_msg=f"plain d{name}")
        np.testing.assert_allclose(_np(a), w, **tol, err_msg=f"RGLRUScanFn d{name}")


@pytest.mark.parametrize("t,chunk,segment", [
    (1, 8, 4), (8, 8, 4), (9, 8, 4), (37, 8, 8),
    (37, CHUNK, SEGMENT), (CHUNK, CHUNK, SEGMENT), (CHUNK + 1, CHUNK, SEGMENT), (2 * CHUNK + 44, CHUNK, SEGMENT),
])
@pytest.mark.parametrize("gates", [None, "r_zero", "lam_minus10"])
def test_bwd_chunked_ref_matches_step_by_step_in_float64(t, chunk, segment, gates):
    """The backward kernel's algorithm: the carry through the chunks from
    the last, each segment's carry from its zero-carry walk folded in, h
    recomputed from each chunk's published start; equal to the reverse
    recurrence in float64, dh_last and no dh_last."""
    x, r, i, lam, h0 = (torch.from_numpy(a.astype(np.float64)) for a in _scan_inputs(9, 2, t, 6, gates))
    rng = np.random.default_rng(t)
    dy = torch.from_numpy(rng.standard_normal((2, t, 6)))
    for dh_last in (torch.from_numpy(rng.standard_normal((2, 6))), None):
        want = rglru_scan_bwd_ref(x, r, i, lam, h0, dy, dh_last)
        got = rglru_scan_bwd_chunked_ref(x, r, i, lam, h0, dy, dh_last, chunk=chunk, segment=segment)
        for name, g, w in zip(("x", "r", "i", "lam", "h0"), got, want):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=f"d{name}")


def test_autograd_function_matches_autograd_through_the_loop():
    """``RGLRUScanFn`` on the CPU (the plain forward, then the reverse
    recurrence) against autograd through ``rglru_scan_ref``'s loop, float32
    (the two sum in other orders); h alone, h_last alone and both as what
    the loss reads."""
    arrays = [torch.from_numpy(a) for a in _scan_inputs(11, 3, 70, 10)]
    w = torch.from_numpy(np.random.default_rng(12).standard_normal((3, 70, 10)).astype(np.float32))
    for uses in ("h", "h_last", "both"):
        sides = []
        for fn in (RGLRUScanFn.apply, rglru_scan_ref):
            leaves = [a.clone().requires_grad_(True) for a in arrays]
            h, last = fn(*leaves)
            loss = {"h": (h * w).sum(), "h_last": last.square().sum(), "both": (h * w).sum() + last.sum()}[uses]
            sides.append(torch.autograd.grad(loss, leaves))
        for name, got, want in zip(("x", "r", "i", "lam", "h0"), *sides):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=f"{uses}: d{name}")


def test_fwd_states_are_the_chunks_published_states():
    """``rglru_scan_fwd`` on the CPU: h and h_last as ``rglru_scan``, and the
    states the backward kernel starts its chunks from (the chunked
    algorithm's published ones), None where T fits one chunk."""
    x, r, i, lam, h0 = (torch.from_numpy(a) for a in _scan_inputs(13, 2, 2 * CHUNK + 5, 6))
    h, last, states = rglru_scan_fwd(x, r, i, lam, h0)
    want_h, want_last = rglru_scan(x, r, i, lam, h0)
    assert torch.equal(h, want_h) and torch.equal(last, want_last)
    assert states.shape == (2, 3 - 1, 6) and states.dtype == torch.float32
    torch.testing.assert_close(states[:, 0], h[:, CHUNK - 1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(states[:, 1], h[:, 2 * CHUNK - 1], rtol=1e-5, atol=1e-6)
    assert rglru_scan_fwd(x[:, :CHUNK], r[:, :CHUNK], i[:, :CHUNK], lam, h0)[2] is None


# -- the wrapper's checks ---------------------------------------------------------


def test_checks_refuse_what_the_kernel_cannot_take():
    x, r, i, lam, h0 = (torch.from_numpy(a) for a in _scan_inputs(0, 2, 5, 8))
    _check(x, r, i, lam, h0)
    _check_cuda(x, r, i)
    with pytest.raises(ValueError, match="one dtype"):
        _check(x, r.to(torch.bfloat16), i, lam, h0)
    with pytest.raises(ValueError, match="one dtype"):
        _check(x.double(), r.double(), i.double(), lam, h0)
    with pytest.raises(ValueError, match="lam must be float32"):
        _check(x, r, i, lam.to(torch.bfloat16), h0)
    with pytest.raises(ValueError, match=r"h0 must be float32 \[B, Dr\]"):
        _check(x, r, i, lam, h0[:1])
    odd = [torch.from_numpy(a) for a in _scan_inputs(0, 2, 5, 7)]
    with pytest.raises(ValueError, match="Dr must be even"):
        _check_cuda(*odd[:3])
    with pytest.raises(ValueError, match="dy must be"):
        rglru_scan_bwd(x, r, i, lam, h0, x.to(torch.bfloat16), None)
    with pytest.raises(ValueError, match="dh_last must be float32"):
        rglru_scan_bwd(x, r, i, lam, h0, None, h0.double())
    strided = torch.zeros((2, 5, 16))[..., ::2]
    with pytest.raises(ValueError, match="x: the last dimension must be contiguous"):
        _check_cuda(strided, r, i)
    with pytest.raises(ValueError, match="same shape|share one"):
        rglru_scan(x, r[:, :4], i, lam, h0)


@pytest.mark.parametrize("dr,dtype,view", [(64, torch.bfloat16, False), (6, torch.float32, False),
                                           (64, torch.bfloat16, True), (6, torch.bfloat16, True)], ids=str)
def test_backward_rows_for_the_tma_maps(dr, dtype, view):
    """What the backward kernel's TMA maps read: a [B, T, Dr] tensor itself
    where its rows step in multiples of 16 bytes, else a copy into the first
    Dr channels of rows of ``ld`` that do (the wrapper's ``_tma_rows``)."""
    from repro_torch.kernels.rglru_scan.ops import _tma_rows

    base = torch.randn((2, 5, 3, dr) if view else (2, 5, dr)).to(dtype)
    a = base[:, :, 1] if view else base
    ld = -(-dr * a.element_size() // 16) * 16 // a.element_size()
    got = _tma_rows(a, ld)
    torch.testing.assert_close(got, a, rtol=0, atol=0)
    esz = a.element_size()
    readable = a.data_ptr() % 16 == 0 and all(s * esz % 16 == 0 for s in a.stride()[:2])
    assert (got.data_ptr() == a.data_ptr()) == readable
    assert readable == (dr == 64)  # 128-byte rows, as views or not; 6 channels never
    assert got.stride(2) == 1 and all(s * got.element_size() % 16 == 0 for s in got.stride()[:2])


def test_block_refuses_a_dtensor_naming_its_item(tmp_path):
    """On a mesh the block runs: its conv and scan on the local shards of
    DTensors (here a one-rank ``(data, model)`` mesh, rows and channels
    sharded over it), the same values as on plain tensors; the decode
    write lands in the state's own local storage."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_smoke_config(ARCH)
    params = trg.init_rglru_block(cfg, generator=torch.Generator().manual_seed(0), device=torch.device("cpu"))
    params["conv_b"] = torch.randn(cfg.d_rnn, generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator().manual_seed(2))
    want, want_state = trg.rglru_block(params, x, cfg, state=trg.init_rglru_state(cfg, 2, device=torch.device("cpu")))
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        rows = [Shard(0), Replicate()]
        dparams = {k: distribute_tensor(v, mesh, [Replicate(), Shard(v.ndim - 1)]) for k, v in params.items()}
        state = {k: distribute_tensor(v, mesh, [Shard(0), Shard(v.ndim - 1)])
                 for k, v in trg.init_rglru_state(cfg, 2, device=torch.device("cpu")).items()}
        ptr = {k: v.to_local().data_ptr() for k, v in state.items()}
        with implicit_replication():
            got, new_state = trg.rglru_block(dparams, distribute_tensor(x, mesh, rows), cfg, state=state)
            step, _ = trg.rglru_block(dparams, distribute_tensor(x[:, :1], mesh, rows), cfg, state=state,
                                      in_place=True)
        assert isinstance(got, DTensor) and isinstance(new_state["h"], DTensor)
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6, atol=1e-6)
        for k in ("h", "conv"):
            torch.testing.assert_close(new_state[k].full_tensor(), want_state[k], rtol=1e-6, atol=1e-6)
            assert state[k].to_local().data_ptr() == ptr[k] and state[k].to_local().abs().sum() > 0, k
        want_step, _ = trg.rglru_block(params, x[:, :1], cfg, state=trg.init_rglru_state(cfg, 2, device=torch.device("cpu")))
        torch.testing.assert_close(step.full_tensor(), want_step, rtol=1e-6, atol=1e-6)
    finally:
        if made:
            dist.destroy_process_group()


# -- the block -------------------------------------------------------------------------


def _weights(init, seed):
    """Weights for both sides as numpy, drawn by the port's init (the JAX
    init's leaves and spreads, ``tests/test_torch_shapes.py``; far quicker
    than tracing the JAX one), with the conv bias and the norm scales (zeros
    at init) drawn from a seed too, so a swapped or dropped leaf shows."""
    rng = np.random.default_rng(seed)
    tree = params_to_numpy(init(torch.Generator().manual_seed(seed)))

    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['conv_b']") or key.endswith("['scale']"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _cfgs(dtype):
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    return jcfg, tcfg


@pytest.mark.parametrize("t", [1, 7])
def test_rglru_block_matches_jax(t):
    """One block from a non-zero state; the new state equal too.  The
    in-place form (decode) writes it into the given tensors."""
    jcfg, tcfg = _cfgs("float32")
    weights = _weights(lambda g: trg.init_rglru_block(tcfg, generator=g, device=torch.device("cpu")), 3)
    jp, tp = jax.tree.map(jnp.asarray, weights), params_from_numpy(weights, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, jcfg.d_rnn)).astype(np.float32)
    tail = rng.standard_normal((2, trg.CONV_WIDTH - 1, jcfg.d_rnn)).astype(np.float32)
    jy, jstate = jax.jit(lambda p, x, st: jrg.rglru_block(p, x, jcfg, state=st))(
        jp, jnp.asarray(x), {"h": jnp.asarray(h0), "conv": jnp.asarray(tail)})
    for in_place in (False, True):
        state = {"h": torch.from_numpy(h0.copy()), "conv": torch.from_numpy(tail.copy())}
        ty, tstate = trg.rglru_block(tp, torch.from_numpy(x), tcfg, state=state, in_place=in_place)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-4, atol=1e-4)
        for key in ("h", "conv"):
            np.testing.assert_allclose(_np(tstate[key]), np.asarray(jstate[key]), rtol=1e-5, atol=1e-6, err_msg=key)
        assert (tstate is state) == in_place


# -- the whole smoke model ------------------------------------------------------------


def _model(dtype, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    weights = _weights(lambda g: init_params(tcfg, generator=g, device="cpu"), seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, weights), params_from_numpy(weights, device="cpu")


def _close(actual, expected, dtype, what):
    """float32: elementwise at MODEL_TOL; bf16: relative norm at MODEL_TOL."""
    actual, expected = np.asarray(actual, np.float32), np.asarray(expected, np.float32)
    tol = MODEL_TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol, err_msg=what)
        return
    assert actual.shape == expected.shape, what
    err = np.linalg.norm(actual - expected) / max(np.linalg.norm(expected), 1e-30)
    assert err <= tol, f"{what}: relative norm error {err} > {tol}"


def _check_cache(tcache, jcache, dtype, what):
    jflat = {jax.tree_util.keystr(p): np.asarray(v, np.float32)
             for p, v in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    tflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(cache_to_numpy(tcache))[0]}
    assert set(tflat) == set(jflat)
    assert {k.rsplit("[", 1)[1] for k in jflat} == {"'h']", "'conv']", "'k']", "'v']", "'pos']"}
    for key, jv in jflat.items():
        assert tflat[key].shape == jv.shape, key
        if key.endswith("['pos']"):
            np.testing.assert_array_equal(tflat[key], jv, err_msg=f"{what} {key}")
        else:
            _close(tflat[key], jv, dtype, f"{what} {key}")


def _jax_serve(jcfg, jparams, tokens, fed=None):
    """JAX's forward logits, prefill logits and cache, then GEN decode
    steps' logits and caches, fed ``fed`` tokens (default: its own argmax)."""
    batch = {"tokens": jnp.asarray(tokens)}
    logits = [jax.jit(lambda p, b: jax_forward(p, b, jcfg)[0])(jparams, batch)]
    out, cache = jax.jit(lambda p, b: jax_prefill(p, b, jcfg, max_len=MAX_LEN))(jparams, batch)
    logits.append(out)
    caches, fed = [cache], [] if fed is None else fed
    decode = jax.jit(lambda p, t, c, pos: jax_decode_step(p, t, c, jcfg, pos))
    for i in range(GEN):
        if len(fed) <= i:
            fed.append(np.array(jnp.argmax(out, axis=-1)))
        out, cache = decode(jparams, jnp.asarray(fed[i]), cache, jnp.int32(PROMPT + i))
        logits.append(out)
        caches.append(cache)
    return [np.asarray(x, np.float32) for x in logits], caches, fed


def _share(a, b, tol=MODEL_TOL["bfloat16"]):
    """The largest |a - b| / (tol + tol |b|): within rtol = atol = tol where <= 1."""
    return float((np.abs(a - b) / (tol + tol * np.abs(b))).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_forward_prefill_and_decode_match_jax(dtype):
    """recurrentgemma-9b's smoke model (one group and a 2-layer recurrent
    remainder, local window 8): forward logits, the 19-token prefill's
    logits and every cache leaf (LRU states, conv tails, the wrapped rolling
    k / v / pos), then 4 decode steps, each with its cache.  In bf16 each
    logits row is also held to the float32 JAX model: no farther from it,
    elementwise, than 1.5x JAX's own bf16 logits are."""
    jcfg, tcfg, jparams, tparams = _model(dtype)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, PROMPT))
    jlogits, jcaches, fed = _jax_serve(jcfg, jparams, tokens)
    tlogits = [forward(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg)[0]]
    out, tcache = prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, max_len=MAX_LEN)
    tlogits.append(out)
    _check_cache(tcache, jcaches[0], dtype, "prefill")
    h = tcache["groups"]["slot0"]["h"]
    for i in range(GEN):
        out, tcache = decode_step(tparams, torch.from_numpy(fed[i]), tcache, tcfg, PROMPT + i)
        tlogits.append(out)
        _check_cache(tcache, jcaches[i + 1], dtype, f"decode step {i}")
    assert tcache["groups"]["slot0"]["h"] is h  # updated in place
    f32 = _jax_serve(dataclasses.replace(jcfg, dtype="float32"), jparams, tokens, fed)[0] if dtype == "bfloat16" else None
    for i, (t, j) in enumerate(zip(tlogits, jlogits)):
        what = ["forward", "prefill"][i] if i < 2 else f"decode step {i - 2}"
        _close(_np(t), j, dtype, f"{what} logits")
        if f32 is not None:
            assert _share(_np(t), f32[i]) <= 1.5 * _share(j, f32[i]), f"{what}: farther from float32 than JAX's bf16"


@pytest.mark.parametrize("t", [1, 2, 8, 19])
def test_smoke_state_carry_matches_a_longer_prefill(t):
    """Prefill of T tokens then one decode step against a prefill of T + 1,
    in float32: the LRU state, the conv tail (overlapping the old one for
    T < 3) and the rolling window cache (wrapped past the window of 8 at
    T = 19) carry the same model.  The card's bf16 run of this check at full
    width and depth is in chip_smoke.py."""
    _, tcfg, _, tparams = _model("float32", seed=9)
    tokens = torch.from_numpy(np.random.default_rng(t).integers(0, tcfg.vocab_size, (2, t + 1)))
    _, cache = prefill(tparams, {"tokens": tokens[:, :t]}, tcfg, max_len=t + 1)
    carried, _ = decode_step(tparams, tokens[:, t], cache, tcfg, t)
    whole, _ = prefill(tparams, {"tokens": tokens}, tcfg, max_len=t + 1)
    np.testing.assert_allclose(_np(carried), _np(whole), rtol=MODEL_TOL["float32"], atol=MODEL_TOL["float32"])


def test_smoke_loss_and_every_grad_leaf_match_jax(monkeypatch):
    """``loss_fn`` and every leaf's gradient against ``jax.grad``, through
    ``RGLRUScanFn`` on the CPU (the plain forward, then the reverse
    recurrence: one backward a recurrent layer); 16 tokens cross the local
    window of 8."""
    from repro_torch.kernels.rglru_scan import ops

    calls = []
    monkeypatch.setattr(ops, "rglru_scan_bwd", lambda *a, **k: calls.append(1) or rglru_scan_bwd(*a, **k))
    jcfg, tcfg, jparams, tparams = _model("float32", seed=6)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 17))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p, b: jax_loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = jax.tree.leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    kinds = list(tcfg.pattern) * tcfg.num_groups + list(tcfg.remainder)
    assert len(calls) == kinds.count("recurrent") == 4
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    jflat = [(jax.tree_util.keystr(p), np.asarray(g)) for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert len(jflat) == len(grads) == len(leaves)
    assert any("lru_lambda" in path for path, _ in jflat)
    for (path, want), got in zip(jflat, grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4, err_msg=path)


def test_serve_cli_runs_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--gen", "2"])
    out = capsys.readouterr().out
    assert out.startswith("prefill: 4x32 in ") and "decode: 2 steps in " in out


def test_chip_smoke_train_cut_sizes_are_the_configs():
    """``chip_smoke.py``'s train_recurrentgemma cut (one group at full
    width): the parameter count and leaves it holds the card run to are the
    sizing hooks' (meta device) and the JAX package's analytic count."""
    import importlib.util

    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import params_specs
    from repro_torch.tree import tree_leaves

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cut = dataclasses.replace(get_config(ARCH), num_layers=smoke.RG_TRAIN_LAYERS)
    leaves = tree_leaves(params_specs(cut))
    assert (sum(t.numel() for t in leaves), len(leaves)) == (smoke.RG_TRAIN_PARAMS, smoke.RG_TRAIN_LEAVES)
    assert cut.num_groups == 1 and not cut.remainder and cut.remat == "full"
    jcut = dataclasses.replace(jax_get_config(ARCH), num_layers=smoke.RG_TRAIN_LAYERS)
    assert jcut.param_count() == cut.param_count()
