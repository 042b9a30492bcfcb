"""Flash attention in the model's [B, S, H, hd] layout.

On a CUDA tensor this launches the hand-written kernel
``csrc/flash_fwd.cu`` (the port of the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``), or raises
if the inputs are ones it cannot take.  On a CPU tensor it computes the
plain version (:func:`.ref.flash_attention_ref`).  There is no other
fallback: the kernel takes any sequence lengths S >= 1, ragged tiles
included, and reads q, k and v through their strides with no copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import LAUNCHES, _build
from .ref import flash_attention_ref

KERNEL = "flash_attention_fwd"
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
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes {_DTYPES}, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {q.shape[3]}")
    b, sq, h, _ = q.shape
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head_dim must be contiguous, strides {t.stride()}")
        # bf16 tiles load as 16-byte vectors of 8 elements
        if t.dtype == torch.bfloat16 and (any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"{name}: bf16 strides {t.stride()} or address not 16-byte aligned")


def _launch(q, k, v, out, *, causal, window, logit_softcap) -> None:
    lib = _build.load("flash_fwd")
    fn = lib.repro_flash_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out) for s in t.stride()[:3]])
    b, sq, h, hd = q.shape
    dims = (ctypes.c_int * 5)(b, h, k.shape[2], sq, k.shape[1])
    err = fn(
        q.device.index, int(q.dtype == torch.bfloat16), hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), ctypes.addressof(dims),
        int(causal), window or 0, logit_softcap or 0.0, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1


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
    _check(q, k, v, window, logit_softcap)
    if q.device.type == "cpu":
        out = flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, logit_softcap=logit_softcap,
        )
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    _check_cuda(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal=causal, window=window, logit_softcap=logit_softcap)
    return out
