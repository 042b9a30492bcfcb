"""The RWKV6 WKV recurrence in the model's [B, T, H, N] layout.

On CUDA tensors :func:`wkv6` launches the hand-written kernel
``csrc/wkv6.cu`` (the port of the Pallas TPU kernel
``repro/kernels/rwkv6_wkv/kernel.py::wkv6_fwd``), or raises if the inputs
are ones it cannot take.  On CPU tensors it computes the plain version
(:mod:`.ref`).  There is no other fallback: unlike the JAX wrapper, which
takes the reference when T is not a multiple of its chunk, the kernel takes
any T >= 1, and it reads r, k, v, w through their strides with no copy.

The kernel is forward-only, as the TPU kernel is: with grad enabled and an
input that requires grad, :func:`wkv6` raises rather than let autograd
differentiate a T-step loop.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import LAUNCHES, _build
from .ref import wkv6_ref

KERNEL = "wkv6_fwd"
HEAD_DIMS = (8, 16, 32, 64, 128)
#: time steps the kernel stages through shared memory at once (8 at N =
#: 128; ``csrc/wkv6.cu``, ``Shape::L``); the card tests straddle it
CHUNK = 16
_DTYPES = (torch.bfloat16, torch.float32)
NO_BACKWARD = (
    "wkv6 has no backward kernel yet: RWKV6 training waits for it "
    "(ROADMAP queue 1, item 13: the WKV backward kernel)"
)


def _check(r, k, v, w, u, state0) -> None:
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(
            f"r, k, v, w must share one [B, T, H, N] shape, got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}"
        )
    b, t, h, n = r.shape
    if t < 1:
        raise ValueError("T must be >= 1")
    if tuple(u.shape) != (h, n):
        raise ValueError(f"u must be [H, N] = {(h, n)}, got {tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (b, h, n, n):
        raise ValueError(f"state0 must be [B, H, N, N] = {(b, h, n, n)}, got {tuple(state0.shape)}")
    tensors = [r, k, v, w, u] + ([state0] if state0 is not None else [])
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"devices differ: {[str(x.device) for x in tensors]}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6 runs on cpu or cuda, got {r.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(NO_BACKWARD)


def _check_cuda(r, k, v, w, u, state0, state_out) -> None:
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(
            f"kernel takes r, k, v of one dtype and w each in {_DTYPES}, "
            f"got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}"
        )
    b, _, h, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dim N in {HEAD_DIMS}, got {n}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous, strides {x.stride()}")
    for name, x in (("state0", state0), ("state_out", state_out)):
        if x is not None and (x.dtype != torch.float32 or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32, got {x.dtype}, strides {x.stride()}")
    if state_out is not None and (tuple(state_out.shape) != (b, h, n, n) or state_out.device != r.device):
        raise ValueError(f"state_out must be [B, H, N, N] = {(b, h, n, n)} on {r.device}")


def wkv6_fwd(r, k, v, w, u, state0, state_out) -> torch.Tensor:
    """Launch the kernel: out [B, T, H, N] float32; the final state goes to
    ``state_out`` (which may be ``state0``)."""
    b, t, h, n = r.shape
    u = u.float().contiguous()
    out = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    lib = _build.load("wkv6")
    fn = lib.repro_wkv6_fwd
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    flat = [s for x in (r, k, v, w) for s in x.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    err = fn(
        r.device.index, int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), n,
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state_out.data_ptr(), ctypes.addressof(strides),
        b, t, h, torch.cuda.current_stream(r.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1
    return out


def wkv6(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # [H, N]
    state0: Optional[torch.Tensor] = None,  # [B, H, N, N]; zeros if None
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B, T, H, N] float32, final state [B, H, N, N] float32).

    ``state_out``, if given, receives the final state and is returned; it
    may be ``state0`` itself, which is then updated in place.  Otherwise a
    new tensor holds it.
    """
    _check(r, k, v, w, u, state0)
    if r.device.type == "cpu":
        out, final = wkv6_ref(r, k, v, w, u, state0)
        if state_out is None:
            return out, final
        return out, state_out.copy_(final)
    _check_cuda(r, k, v, w, u, state0, state_out)
    b, _, h, n = r.shape
    if state0 is None:
        state0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    if state_out is None:
        state_out = torch.empty_like(state0)
    return wkv6_fwd(r, k, v, w, u, state0, state_out), state_out
