"""Flash attention in the model's [B, S, H, hd] layout, with its gradient.

On a CUDA tensor the forward launches the hand-written kernel
``csrc/flash_fwd.cu`` (the port of the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``) and the
backward ``csrc/flash_bwd.cu`` (the JAX package has no backward kernel), or
they raise if the inputs are ones they cannot take.  On a CPU tensor they
compute the plain versions (:mod:`.ref`).  There is no other fallback: the
kernels take any sequence lengths S >= 1, ragged tiles included, and read
their inputs through their strides with no copy.

:func:`flash_attention` records a gradient only where autograd needs one:
then it goes through :class:`FlashAttentionFn`, whose forward also writes
the rows' log-sum-exp for the backward.  Serving runs under ``no_grad`` and
launches the forward alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import LAUNCHES, _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
HEAD_DIMS = (16, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, logit_softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, hd]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head_dim")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("sequence lengths must be >= 1")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window is not None and sq >= k.shape[1] + window:
        raise ValueError(f"window {window} with Sq {sq} >= Sk {k.shape[1]} + window: a query row would see no key")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")


def _layout_error(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot read ``t`` through its strides, or None."""
    if t.stride(3) != 1:
        return f"{name}: head_dim must be contiguous, strides {t.stride()}"
    # bf16 tiles load as 16-byte vectors of 8 elements
    if t.dtype == torch.bfloat16 and (any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
        return f"{name}: bf16 strides {t.stride()} or address not 16-byte aligned"
    return None


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes {_DTYPES}, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {q.shape[3]}")
    b, sq, h, _ = q.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = _layout_error(name, t)
        if err:
            raise ValueError(err)


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _dims(q: torch.Tensor, k: torch.Tensor) -> ctypes.Array:
    b, sq, h, _ = q.shape
    return (ctypes.c_int * 5)(b, h, k.shape[2], sq, k.shape[1])


def _launch_fwd(q, k, v, out, lse, *, causal, window, logit_softcap) -> None:
    lib = _build.load("flash_fwd")
    fn = lib.repro_flash_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    strides, dims = _strides(q, k, v, out), _dims(q, k)
    hd = q.shape[3]
    err = fn(
        q.device.index, int(q.dtype == torch.bfloat16), hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        ctypes.addressof(strides), ctypes.addressof(dims),
        int(causal), window or 0, logit_softcap or 0.0, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1


def _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, *, causal, window, logit_softcap) -> None:
    lib = _build.load("flash_bwd")
    fn = lib.repro_flash_bwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    strides, dims = _strides(q, k, v, o, do, dq, dk, dv), _dims(q, k)
    hd = q.shape[3]
    err = fn(
        q.device.index, int(q.dtype == torch.bfloat16), hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(strides), ctypes.addressof(dims),
        int(causal), window or 0, logit_softcap or 0.0, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, BWD_KERNEL)
    LAUNCHES[BWD_KERNEL] += 1


def _heads_first(*tensors):
    return [t.transpose(1, 2) for t in tensors]


def flash_attention_fwd(q, k, v, *, causal=True, window=None, logit_softcap=None, with_lse=False):
    """The forward alone -> out [B, Sq, H, hd] (and lse [B, H, Sq] float32 if asked)."""
    _check(q, k, v, window, logit_softcap)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if q.device.type == "cpu":
        out, lse = flash_attention_ref(*_heads_first(q, k, v), **kw)
        out = out.transpose(1, 2)
    else:
        _check_cuda(q, k, v)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = None
        if with_lse:
            lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
        _launch_fwd(q, k, v, out, lse, **kw)
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None, logit_softcap=None):
    """dq, dk, dv [B, S, H, hd] from the forward's inputs, output and lse."""
    _check(q, k, v, window, logit_softcap)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
    if q.device.type == "cpu":
        grads = flash_attention_bwd_ref(*_heads_first(q, k, v, o), lse, do.transpose(1, 2), **kw)
        return tuple(g.transpose(1, 2) for g in grads)
    _check_cuda(q, k, v)
    if _layout_error("do", do):  # autograd's gradient: read it contiguous
        do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q {tuple(q.shape)} {q.dtype}")
        err = _layout_error(name, t)
        if err:
            raise ValueError(err)
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 [B, H, Sq], got {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the kernel backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap):
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, window=window, logit_softcap=logit_softcap, with_lse=True
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, logit_softcap=logit_softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KVH, hd]
    v: torch.Tensor,  # [B, Sk, KVH, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention; query and key indices start at 0."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, logit_softcap)
    return flash_attention_fwd(q, k, v, causal=causal, window=window, logit_softcap=logit_softcap)
