"""The RG-LRU recurrence of RecurrentGemma in the model's [B, T, Dr] layout,
with its gradient.

On CUDA tensors :func:`rglru_scan` launches the hand-written kernel
``csrc/rglru_scan.cu`` (which replaces no Pallas kernel: the JAX package
runs the recurrence as ``jax.lax.associative_scan``,
``repro/models/rglru.py::rg_lru``), and :func:`rglru_scan_bwd` the
backward kernel ``csrc/rglru_scan_bwd.cu`` (JAX differentiates the
associative scan), or they raise if the inputs are ones they cannot take.
On CPU tensors they compute the plain versions (:mod:`.ref`).  There is
no other fallback.  Where autograd needs a gradient :func:`rglru_scan`
goes through :class:`RGLRUScanFn`: on the card its forward keeps the
chunks' float32 states that the kernel publishes, and its backward
recomputes each chunk's h from them.

Each launch is a custom op, ``torch.ops.repro_torch.rglru_scan`` and
``rglru_scan_bwd``, with a fake implementation (the outputs' and the
scratch's shapes, for the dry run) and a FLOP formula from
:mod:`repro_torch.kernels.costs`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import LAUNCHES, _build, address, costs, define_op, on_card
from .ref import CHUNK, chunk_states, rglru_scan_bwd_ref, rglru_scan_ref

KERNEL = "rglru_scan"
BWD_KERNEL = "rglru_scan_bwd"
#: channels a block of the kernel takes (``csrc/rglru_scan.cu``, ``kSlice``)
SLICE = 64
_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, r_gate, i_gate, lam, h0) -> None:
    """What both paths require: shapes, one dtype, one device."""
    if x.dim() != 3 or not (x.shape == r_gate.shape == i_gate.shape):
        raise ValueError(f"x, r_gate, i_gate must share one [B, T, Dr] shape, got "
                         f"{tuple(x.shape)}, {tuple(r_gate.shape)}, {tuple(i_gate.shape)}")
    b, t, dr = x.shape
    if t < 1:
        raise ValueError("T must be >= 1")
    if not (x.dtype == r_gate.dtype == i_gate.dtype) or x.dtype not in _DTYPES:
        raise ValueError(f"x, r_gate, i_gate must share one dtype in {_DTYPES}, "
                         f"got {x.dtype}, {r_gate.dtype}, {i_gate.dtype}")
    if tuple(lam.shape) != (dr,) or lam.dtype != torch.float32:
        raise ValueError(f"lam must be float32 [Dr] = [{dr}], got {lam.dtype} {tuple(lam.shape)}")
    if tuple(h0.shape) != (b, dr) or h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32 [B, Dr] = {(b, dr)}, got {h0.dtype} {tuple(h0.shape)}")
    tensors = [x, r_gate, i_gate, lam, h0]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"devices differ: {[str(t.device) for t in tensors]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan runs on cpu or cuda, got {x.device}")


def _check_cuda(x, r_gate, i_gate) -> None:
    """What the kernel requires beyond :func:`_check`; runs on any device."""
    b, t, dr = x.shape
    if dr % 2:
        raise ValueError(f"the kernel loads two adjacent channels a thread: Dr must be even, got {dr}")
    nc = -(-t // CHUNK)
    if b > 65535 or nc > 65535:
        raise ValueError(f"batch {b} or ceil(T / {CHUNK}) = {nc} exceed the grid's 65535")
    if nc * b * -(-dr // SLICE) > 2**31 - 1:
        raise ValueError(f"{nc} chunks x {b} rows x ceil(Dr / {SLICE}) slices exceed the grid's 2^31 - 1 blocks")
    pair = 2 * x.element_size()  # bytes of one two-channel load
    for name, a in (("x", x), ("r_gate", r_gate), ("i_gate", i_gate)):
        if a.stride(2) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous, strides {a.stride()}")
        if a.stride(0) % 2 or a.stride(1) % 2 or address(a) % pair:
            raise ValueError(f"{name}: strides {a.stride()} or address not aligned to two-channel loads")


def _paired(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself where the kernel's float2 loads can read it (contiguous,
    8-byte aligned), else a copy that they can."""
    return a if a.is_contiguous() and address(a) % 8 == 0 else a.clone(memory_format=torch.contiguous_format)


def _launch(x, r_gate, i_gate, lam, h0) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel on checked inputs -> (h [B, T, Dr] in x's dtype,
    h_last [B, Dr] float32, the chunks' published states [B, NC, Dr]
    float32, or None for one chunk)."""
    h, h_last, state = torch.ops.repro_torch.rglru_scan(x, r_gate, i_gate, _paired(lam), _paired(h0))
    return h, h_last, state if state.numel() else None


def _fwd_outputs(x):
    """(h, h_last, the chunks' states (empty for one chunk)) and the launch's
    scratch: the states' ready flags and the block ticket, zeroed (None for
    one chunk)."""
    b, t, dr = x.shape
    h = torch.empty((b, t, dr), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, dr), dtype=torch.float32, device=x.device)
    nc = -(-t // CHUNK)
    if nc == 1:
        return (h, h_last, torch.empty((0,), dtype=torch.float32, device=x.device)), None
    state = torch.empty((b, nc, dr), dtype=torch.float32, device=x.device)
    flags = torch.zeros(nc * b * -(-dr // SLICE) + 1, dtype=torch.int32, device=x.device)
    return (h, h_last, state), flags


def _rglru_scan_launch(x, r_gate, i_gate, lam, h0):
    """One launch on checked inputs (lam, h0 paired) -> (h, h_last, states;
    states empty where T fits one chunk)."""
    b, t, dr = x.shape
    (h, h_last, state), flags = _fwd_outputs(x)
    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = _strides(x, r_gate, i_gate)
    err = fn(
        x.device.index, int(x.dtype == torch.bfloat16), x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
        ctypes.addressof(strides), lam.data_ptr(), h0.data_ptr(), h.data_ptr(), h_last.data_ptr(),
        None if flags is None else state.data_ptr(), None if flags is None else flags.data_ptr(),
        b, t, dr, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1
    return h, h_last, state


def _strides(x, r_gate, i_gate) -> ctypes.Array:
    flat = [s for a in (x, r_gate, i_gate) for s in a.stride()[:2]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _tma_rows(a: torch.Tensor, ld: int) -> torch.Tensor:
    """``a`` [B, T, Dr] itself where the backward kernel's TMA maps can read
    it (channels contiguous, the address and the batch and time strides
    multiples of 16 bytes), else a copy into the first Dr channels of rows
    of ``ld`` that they can."""
    esz = a.element_size()
    if a.stride(2) == 1 and address(a) % 16 == 0 and all(
            n == 1 or s * esz % 16 == 0 for n, s in zip(a.shape[:2], a.stride()[:2])):
        return a
    return _rows(a.shape, a.dtype, a.device, ld).copy_(a)


def _rows(shape, dtype, device, ld: int) -> torch.Tensor:
    """An empty [B, T, Dr] tensor: the first Dr channels of rows of ``ld``."""
    b, t, dr = shape
    buf = torch.empty((b, t, ld), dtype=dtype, device=device)
    return buf if ld == dr else buf[..., :dr]


def _launch_bwd(x, r_gate, i_gate, lam, h0, states, dy, dh_last):
    """Launch the backward kernel on checked inputs -> (dx, dr, di, dlam,
    dh0)."""
    b, t, dr = x.shape
    lam, h0 = _paired(lam), _paired(h0)
    ld = _ld(x)
    x, r_gate, i_gate = (_tma_rows(a, ld) for a in (x, r_gate, i_gate))
    if dy is not None and (dy.stride() != (t * ld, ld, 1) or address(dy) % 16):  # dy shares the outputs' rows
        dy = _rows(dy.shape, dy.dtype, dy.device, ld).copy_(dy)
    return torch.ops.repro_torch.rglru_scan_bwd(x, r_gate, i_gate, lam, h0, states, dy, dh_last)


def _ld(x) -> int:
    """Rows of 16-byte multiples for the TMA maps."""
    return -(-x.shape[2] * x.element_size() // 16) * 16 // x.element_size()


def _bwd_outputs(x):
    """(dx, dr, di, dlam, dh0) and the launch's scratch: dlam's partial sums,
    one row a (chunk, batch row), summed in order by a second kernel; the
    block ticket, zeroed; the chunks' published carries, each word unset
    (0xffffffff) until written (None for one chunk)."""
    b, t, dr = x.shape
    ld = _ld(x)
    dx, d_r, di = (_rows((b, t, dr), x.dtype, x.device, ld) for _ in range(3))
    dlam = torch.empty(dr, dtype=torch.float32, device=x.device)
    dh0 = torch.empty((b, dr), dtype=torch.float32, device=x.device)
    nc = -(-t // CHUNK)
    partial = torch.empty((nc * b, dr), dtype=torch.float32, device=x.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
    carry = torch.full((b, nc, dr), -1, dtype=torch.int32, device=x.device).view(torch.float32) if nc > 1 else None
    return (dx, d_r, di, dlam, dh0), (partial, ticket, carry)


def _rglru_scan_bwd_launch(x, r_gate, i_gate, lam, h0, states, dy, dh_last):
    """One launch on checked, staged inputs -> (dx, dr, di, dlam, dh0)."""
    b, t, dr = x.shape
    grads, (partial, ticket, carry) = _bwd_outputs(x)
    dx, d_r, di, dlam, dh0 = grads
    lib = _build.load("rglru_scan_bwd")
    fn = lib.repro_rglru_scan_bwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = _strides(x, r_gate, i_gate)
    err = fn(
        x.device.index, int(x.dtype == torch.bfloat16), x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
        ctypes.addressof(strides), lam.data_ptr(), h0.data_ptr(), _ptr(states), _ptr(dy), _ptr(dh_last),
        dx.data_ptr(), d_r.data_ptr(), di.data_ptr(), dlam.data_ptr(), dh0.data_ptr(),
        _ptr(carry), ticket.data_ptr(), partial.data_ptr(),
        b, t, dr, _ld(x), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, BWD_KERNEL)
    LAUNCHES[BWD_KERNEL] += 1
    return grads


define_op("rglru_scan(Tensor x, Tensor r_gate, Tensor i_gate, Tensor lam, Tensor h0) -> (Tensor, Tensor, Tensor)",
          _rglru_scan_launch, lambda x, *_: _fwd_outputs(x)[0],
          lambda x, *_: costs.rglru_scan(*x.shape, costs.dtype_name(x.dtype)))
define_op("rglru_scan_bwd(Tensor x, Tensor r_gate, Tensor i_gate, Tensor lam, Tensor h0, Tensor? states, "
          "Tensor? dy, Tensor? dh_last) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
          _rglru_scan_bwd_launch, lambda x, *_: _bwd_outputs(x)[0],
          lambda x, *_: costs.rglru_scan_bwd(*x.shape, costs.dtype_name(x.dtype)))


def rglru_scan_fwd(x, r_gate, i_gate, lam, h0) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The forward alone -> (h, h_last, the chunks' published float32
    states [B, NC, Dr] that :func:`rglru_scan_bwd` takes, or None where T
    fits one chunk)."""
    _check(x, r_gate, i_gate, lam, h0)
    if not on_card(x):
        h, h_last = rglru_scan_ref(x, r_gate, i_gate, lam, h0)
        states = chunk_states(x, r_gate, i_gate, lam, h0)
        return h, h_last, torch.stack(states, dim=1) if states else None
    _check_cuda(x, r_gate, i_gate)
    return _launch(x, r_gate, i_gate, lam, h0)


def rglru_scan_bwd(x, r_gate, i_gate, lam, h0, dy, dh_last, *, states=None):
    """-> (dx, dr, di [B, T, Dr] in x's dtype, dlam [Dr] float32, dh0 [B, Dr]
    float32) from the forward's inputs and the cotangents of h (``dy``, in
    x's dtype) and of h_last (``dh_last``, float32); either may be None (no
    cotangent).  On the card ``states`` are :func:`rglru_scan_fwd`'s (None
    where T fits one chunk); the CPU recomputes h and ignores them."""
    _check(x, r_gate, i_gate, lam, h0)
    b, t, dr = x.shape
    if dy is not None and (tuple(dy.shape) != (b, t, dr) or dy.dtype != x.dtype or dy.device != x.device):
        raise ValueError(f"dy must be {x.dtype} {(b, t, dr)} on {x.device}, got {dy.dtype} {tuple(dy.shape)}")
    if dh_last is not None and (tuple(dh_last.shape) != (b, dr) or dh_last.dtype != torch.float32
                                or dh_last.device != x.device):
        raise ValueError(f"dh_last must be float32 {(b, dr)} on {x.device}, got {dh_last.dtype} "
                         f"{tuple(dh_last.shape)}")
    if not on_card(x):
        return rglru_scan_bwd_ref(x, r_gate, i_gate, lam, h0, dy, dh_last)
    _check_cuda(x, r_gate, i_gate)
    nc = -(-t // CHUNK)
    if nc > 1 and (states is None or tuple(states.shape) != (b, nc, dr) or states.dtype != torch.float32
                   or not states.is_contiguous()):
        got = None if states is None else (states.dtype, tuple(states.shape))
        raise ValueError(f"states must be rglru_scan_fwd's contiguous float32 {(b, nc, dr)}, got {got}")
    dy = None if dy is None else _paired(dy)
    dh_last = None if dh_last is None else _paired(dh_last)
    return _launch_bwd(x, r_gate, i_gate, lam, h0, states if nc > 1 else None, dy, dh_last)


class RGLRUScanFn(torch.autograd.Function):
    """The RG-LRU scan with the kernel backward (plain versions on the CPU).

    Under ``remat="full"`` (non-reentrant ``torch.utils.checkpoint``) the
    recomputation runs the forward again: the kernel gives the same bits
    on every call, so nothing needs replaying."""

    @staticmethod
    def forward(ctx, x, r_gate, i_gate, lam, h0):
        if not on_card(x):
            h, h_last = rglru_scan_ref(x, r_gate, i_gate, lam, h0)
            states = None  # the plain backward recomputes h
        else:
            h, h_last, states = rglru_scan_fwd(x, r_gate, i_gate, lam, h0)
        ctx.save_for_backward(x, r_gate, i_gate, lam, h0, states)
        return h, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, r_gate, i_gate, lam, h0, states = ctx.saved_tensors
        return rglru_scan_bwd(x, r_gate, i_gate, lam, h0, dy, dh_last, states=states)


def rglru_scan(
    x: torch.Tensor,  # [B, T, Dr]
    r_gate: torch.Tensor,  # [B, T, Dr]
    i_gate: torch.Tensor,  # [B, T, Dr]
    lam: torch.Tensor,  # [Dr] float32
    h0: torch.Tensor,  # [B, Dr] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (h [B, T, Dr] in x's dtype, h_last [B, Dr] float32).

    Where autograd needs a gradient it goes through :class:`RGLRUScanFn`;
    otherwise the forward alone runs.
    """
    _check(x, r_gate, i_gate, lam, h0)
    if on_card(x):
        _check_cuda(x, r_gate, i_gate)  # raise before autograd records anything
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r_gate, i_gate, lam, h0)):
        return RGLRUScanFn.apply(x, r_gate, i_gate, lam, h0)
    if not on_card(x):
        return rglru_scan_ref(x, r_gate, i_gate, lam, h0)
    h, h_last, _ = _launch(x, r_gate, i_gate, lam, h0)
    return h, h_last
