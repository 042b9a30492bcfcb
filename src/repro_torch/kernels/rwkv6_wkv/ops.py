"""The RWKV6 WKV recurrence in the model's [B, T, H, N] layout, with its gradient.

On CUDA tensors :func:`wkv6` launches the hand-written kernel
``csrc/wkv6.cu`` (the port of the Pallas TPU kernel
``repro/kernels/rwkv6_wkv/kernel.py::wkv6_fwd``), or raises if the inputs
are ones it cannot take.  On CPU tensors it computes the plain version
(:mod:`.ref`).  There is no other fallback: unlike the JAX wrapper, which
takes the reference when T is not a multiple of its chunk, the kernel takes
any T >= 1, and it reads r, k, v, w through their strides with no copy.

Where autograd needs a gradient, :func:`wkv6` goes through :class:`WKV6Fn`:
its forward also saves the float32 state before every ``chunk`` steps
(``GRAD_CHUNK``, JAX's ``WKV_CHUNK``, by default), and its backward is the
hand-written kernel ``csrc/wkv6_bwd.cu`` (the JAX package trains through
``jax.grad`` of a checkpointed ``lax.scan``; no Pallas kernel), which works
on all chunks at once from the saved states, its products on the tensor
cores by the route :func:`bwd_route` names (counted in
``WKV_BWD_ROUTE_LAUNCHES``).  On CPU tensors both run the plain versions,
on the same chunked schedule.

Under the model's rematerialisation (``torch.utils.checkpoint`` with
:func:`remat_contexts`) the recomputed forward takes the outputs the first
forward stashed instead of running the recurrence again, so a training step
launches ``wkv6_fwd`` once and ``wkv6_bwd`` once a layer.

Each launch is a custom op, ``torch.ops.repro_torch.wkv6_fwd`` (which
writes ``state_out`` and the saved states) and ``wkv6_bwd``, with a fake
implementation (for the dry run) and a FLOP formula from
:mod:`repro_torch.kernels.costs`.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from .. import LAUNCHES, _build, address, costs, define_op, on_card
from .ref import wkv6_bwd_ref, wkv6_ref

KERNEL = "wkv6_fwd"
BWD_KERNEL = "wkv6_bwd"
HEAD_DIMS = (8, 16, 32, 64, 128)
#: time steps the kernel stages through shared memory at once (8 at N =
#: 128; ``csrc/wkv6.cu``, ``Shape::L``); the card tests straddle it
CHUNK = 16
#: steps between the states the forward saves for the gradient (JAX's
#: ``repro.models.rwkv6.WKV_CHUNK``); the backward kernel takes a multiple
#: of its 16-step stage up to ``MAX_GRAD_CHUNK``
GRAD_CHUNK = 256
MAX_GRAD_CHUNK = 256
_DTYPES = (torch.bfloat16, torch.float32)
#: backward launches by route (:func:`bwd_route`); the wrapper adds one
#: where it launches
WKV_BWD_ROUTE_LAUNCHES: Counter = Counter()


def bwd_route(dtype: torch.dtype, n: int) -> str:
    """The route ``csrc/wkv6_bwd.cu`` takes for r, k, v of ``dtype`` at head
    dim ``n``, by these two and nothing else: ``"tf32"`` (bf16, the
    training path) runs its matrix products on TF32 operands,
    ``"3xtf32"`` (float32) splits each operand into a high and a low TF32
    part; float32 sums on both."""
    if n not in HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"the backward kernel takes head dim N in {HEAD_DIMS} and r, k, v in {_DTYPES}, "
                         f"got {n}, {dtype}")
    return "tf32" if dtype == torch.bfloat16 else "3xtf32"


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


def _check_grad_chunk(chunk: int, card: bool) -> None:
    if chunk < 1 or (card and (chunk % CHUNK or chunk > MAX_GRAD_CHUNK)):
        raise ValueError(
            f"chunk {chunk}: the kernels take a multiple of {CHUNK} up to {MAX_GRAD_CHUNK}"
            if card else f"chunk must be >= 1, got {chunk}"
        )


def wkv6_fwd(r, k, v, w, u, state0, state_out, *, bounds=None, chunk=GRAD_CHUNK) -> torch.Tensor:
    """Launch the kernel: out [B, T, H, N] float32; the final state goes to
    ``state_out`` (which may be ``state0``); ``bounds``, if given
    ([B, ceil(T / chunk), H, N, N] float32), receives the state before
    every ``chunk`` steps."""
    return torch.ops.repro_torch.wkv6_fwd(r, k, v, w, u.float().contiguous(), state0, state_out, bounds, chunk)


def _fwd_out(r):
    return torch.empty(r.shape, dtype=torch.float32, device=r.device)


def _wkv6_fwd_launch(r, k, v, w, u, state0, state_out, bounds, chunk):
    """One launch on checked inputs (u contiguous float32) -> out; writes
    ``state_out`` and, if given, ``bounds``."""
    b, t, h, n = r.shape
    out = _fwd_out(r)
    lib = _build.load("wkv6")
    fn = lib.repro_wkv6_fwd
    fn.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        + [ctypes.c_void_p, ctypes.c_int]
    )
    fn.restype = ctypes.c_int
    flat = [s for x in (r, k, v, w) for s in x.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    err = fn(
        r.device.index, int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), n,
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state_out.data_ptr(), ctypes.addressof(strides),
        b, t, h, torch.cuda.current_stream(r.device).cuda_stream,
        None if bounds is None else bounds.data_ptr(), chunk,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1
    return out


def wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, chunk: int = GRAD_CHUNK):
    """Launch the backward kernel -> (dr, dk, dv, dw in their inputs'
    dtypes, du [H, N] float32, dstate0 [B, H, N, N] float32): the gradient
    of :func:`wkv6` given ``dout`` [B, T, H, N] and the final state's
    ``dstate`` [B, H, N, N] (None: zeros), from the states ``bounds`` the
    forward saved every ``chunk`` steps."""
    _check(r, k, v, w, u, None)
    _check_cuda(r, k, v, w, u, None, None)
    _check_grad_chunk(chunk, card=True)
    b, t, h, n = r.shape
    nc = -(-t // chunk)
    if tuple(bounds.shape) != (b, nc, h, n, n) or bounds.dtype != torch.float32:
        raise ValueError(f"bounds must be float32 [B, ceil(T / chunk), H, N, N] = {(b, nc, h, n, n)}, "
                         f"got {bounds.dtype} {tuple(bounds.shape)}")
    if tuple(dout.shape) != (b, t, h, n) or (dstate is not None and tuple(dstate.shape) != (b, h, n, n)):
        raise ValueError(f"dout must be [B, T, H, N] and dstate [B, H, N, N], got {tuple(dout.shape)}, "
                         f"{None if dstate is None else tuple(dstate.shape)}")
    route = bwd_route(r.dtype, n)

    def staged(x, dtype=None):  # contiguous, 16-byte aligned: the kernel copies 16 bytes at a time
        x = (x if dtype is None else x.to(dtype)).contiguous()
        return x if address(x) % 16 == 0 else x.clone()

    r, k, v, w, bounds = (staged(x) for x in (r, k, v, w, bounds))
    u, dout = staged(u, torch.float32), staged(dout, torch.float32)
    dstate = None if dstate is None else staged(dstate, torch.float32)
    return torch.ops.repro_torch.wkv6_bwd(r, k, v, w, u, bounds, dout, dstate, chunk, route == "3xtf32")


def _bwd_outputs(r, k, v, w, nc):
    """(dr, dk, dv, dw, du, dstate0) and the launch's scratch: G at each
    chunk's end, each chunk's decay, per-chunk du partials."""
    b, _, h, n = r.shape
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.empty((h, n), dtype=torch.float32, device=r.device)
    dstate0 = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    scratch = (torch.empty((b, nc, h, n, n), dtype=torch.float32, device=r.device),
               torch.empty((b, nc, h, n), dtype=torch.float32, device=r.device),
               torch.empty((b, nc, h, n), dtype=torch.float32, device=r.device))
    return (dr, dk, dv, dw, du, dstate0), scratch


def _wkv6_bwd_launch(r, k, v, w, u, bounds, dout, dstate, chunk, three_tf32):
    """One launch on checked, staged inputs -> (dr, dk, dv, dw, du, dstate0)."""
    b, t, h, n = r.shape
    nc = -(-t // chunk)
    grads, (gend, cdecay, du_parts) = _bwd_outputs(r, k, v, w, nc)
    dr, dk, dv, dw, du, dstate0 = grads
    lib = _build.load("wkv6_bwd")
    fn = lib.repro_wkv6_bwd
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        r.device.index, int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), int(three_tf32), n,
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), bounds.data_ptr(),
        dout.data_ptr(), None if dstate is None else dstate.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(), dstate0.data_ptr(),
        gend.data_ptr(), cdecay.data_ptr(), du_parts.data_ptr(),
        b, t, h, chunk, torch.cuda.current_stream(r.device).cuda_stream,
    )
    _build.check(lib, err, BWD_KERNEL)
    LAUNCHES[BWD_KERNEL] += 1
    WKV_BWD_ROUTE_LAUNCHES["3xtf32" if three_tf32 else "tf32"] += 1
    return grads


def _fwd_cost(r, k, v, w, u, state0, state_out, bounds, chunk):
    b, t, h, n = r.shape
    return costs.wkv6_fwd(b, t, h, n, costs.dtype_name(r.dtype), costs.dtype_name(w.dtype))


def _bwd_cost(r, k, v, w, u, bounds, dout, dstate, chunk, three_tf32):
    b, t, h, n = r.shape
    return costs.wkv6_bwd(b, t, h, n, costs.dtype_name(r.dtype), costs.dtype_name(w.dtype), chunk)


define_op("wkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor state0, Tensor(a!) state_out, "
          "Tensor(b!)? bounds, int chunk) -> Tensor", _wkv6_fwd_launch, lambda r, *rest: _fwd_out(r), _fwd_cost)
define_op("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor bounds, Tensor dout, Tensor? dstate, "
          "int chunk, bool three_tf32) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)", _wkv6_bwd_launch,
          lambda r, k, v, w, u, bounds, dout, dstate, chunk, three_tf32: _bwd_outputs(r, k, v, w,
                                                                                    -(-r.shape[1] // chunk))[0],
          _bwd_cost)


# -- rematerialisation: the recomputed forward replays the first one's outputs ----

_STASH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_wkv_stash", default=None)


@contextlib.contextmanager
def _stashing(mode: str, entries: list):
    token = _STASH.set((mode, entries))
    try:
        yield
    finally:
        _STASH.reset(token)


def remat_contexts():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: under the
    first context each :class:`WKV6Fn` forward keeps its outputs, under the
    second (the recomputation) it takes them back in order instead of
    running the recurrence again."""
    entries: list = []
    return _stashing("keep", entries), _stashing("replay", entries)


class WKV6Fn(torch.autograd.Function):
    """The WKV recurrence with the kernel backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, chunk):
        stash = _STASH.get()
        if stash is not None and stash[0] == "replay" and stash[1]:
            out, final, bounds = stash[1].pop(0)
            out, final = out.detach(), final.detach()
        elif not on_card(r):
            out, final, bounds = wkv6_ref(r, k, v, w, u, state0, chunk=chunk)
        else:
            b, t, h, n = r.shape
            _check_cuda(r, k, v, w, u, state0, None)
            if state0 is None:
                state0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
            bounds = torch.empty((b, -(-t // chunk), h, n, n), dtype=torch.float32, device=r.device)
            final = torch.empty_like(state0)
            out = wkv6_fwd(r, k, v, w, u, state0, final, bounds=bounds, chunk=chunk)
        if stash is not None and stash[0] == "keep":
            stash[1].append((out, final, bounds))
        ctx.save_for_backward(r, k, v, w, u, bounds)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out, final

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, bounds = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        bwd = wkv6_bwd if on_card(r) else wkv6_bwd_ref
        dr, dk, dv, dw, du, dstate0 = bwd(r, k, v, w, u, bounds, dout, dstate, ctx.chunk)
        return dr, dk, dv, dw, du.to(u.dtype), dstate0 if ctx.needs_input_grad[5] else None, None


def wkv6(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # [H, N]
    state0: Optional[torch.Tensor] = None,  # [B, H, N, N]; zeros if None
    *,
    state_out: Optional[torch.Tensor] = None,
    chunk: int = GRAD_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B, T, H, N] float32, final state [B, H, N, N] float32).

    ``state_out``, if given, receives the final state and is returned; it
    may be ``state0`` itself, which is then updated in place.  Otherwise a
    new tensor holds it.  Where autograd needs a gradient of an input, the
    call goes through :class:`WKV6Fn`, saving the state every ``chunk``
    steps (no ``state_out`` then: a written input has no gradient).
    """
    _check(r, k, v, w, u, state0)
    inputs = (r, k, v, w, u) + ((state0,) if state0 is not None else ())
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        if state_out is not None:
            raise ValueError("state_out (an in-place final state) has no gradient: pass it under no_grad")
        _check_grad_chunk(chunk, card=on_card(r))
        return WKV6Fn.apply(r, k, v, w, u, state0, chunk)
    if not on_card(r):
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
