"""The RG-LRU recurrence of RecurrentGemma in the model's [B, T, Dr] layout.

On CUDA tensors :func:`rglru_scan` launches the hand-written kernel
``csrc/rglru_scan.cu`` (which replaces no Pallas kernel: the JAX package
runs the recurrence as ``jax.lax.associative_scan``,
``repro/models/rglru.py::rg_lru``), or raises if the inputs are ones it
cannot take.  On CPU tensors it computes the plain version (:mod:`.ref`),
through which autograd also runs.  There is no other fallback.  The kernel
has no backward yet: under autograd on the card the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import LAUNCHES, _build
from .ref import CHUNK, rglru_scan_ref

KERNEL = "rglru_scan"
#: channels a block of the kernel takes (``csrc/rglru_scan.cu``, ``kSlice``)
SLICE = 64
_DTYPES = (torch.bfloat16, torch.float32)
NO_BACKWARD = (
    "the rglru_scan kernel has no backward yet: recurrentgemma-9b training on the card waits "
    "for ROADMAP queue 1, item 19"
)


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
        if a.stride(0) % 2 or a.stride(1) % 2 or a.data_ptr() % pair:
            raise ValueError(f"{name}: strides {a.stride()} or address not aligned to two-channel loads")


def _paired(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself where the kernel's float2 loads can read it (contiguous,
    8-byte aligned), else a copy that they can."""
    return a if a.is_contiguous() and a.data_ptr() % 8 == 0 else a.clone(memory_format=torch.contiguous_format)


def _launch(x, r_gate, i_gate, lam, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on checked inputs -> (h [B, T, Dr] in x's dtype,
    h_last [B, Dr] float32)."""
    b, t, dr = x.shape
    lam, h0 = _paired(lam), _paired(h0)
    h = torch.empty((b, t, dr), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, dr), dtype=torch.float32, device=x.device)
    nc = -(-t // CHUNK)
    state = flags = None
    if nc > 1:  # the chunks' published states; their ready flags and the block ticket, zeroed
        state = torch.empty((b, nc, dr), dtype=torch.float32, device=x.device)
        flags = torch.zeros(nc * b * -(-dr // SLICE) + 1, dtype=torch.int32, device=x.device)
    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    flat = [s for a in (x, r_gate, i_gate) for s in a.stride()[:2]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    err = fn(
        x.device.index, int(x.dtype == torch.bfloat16), x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
        ctypes.addressof(strides), lam.data_ptr(), h0.data_ptr(), h.data_ptr(), h_last.data_ptr(),
        None if state is None else state.data_ptr(), None if flags is None else flags.data_ptr(),
        b, t, dr, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    LAUNCHES[KERNEL] += 1
    return h, h_last


def rglru_scan(
    x: torch.Tensor,  # [B, T, Dr]
    r_gate: torch.Tensor,  # [B, T, Dr]
    i_gate: torch.Tensor,  # [B, T, Dr]
    lam: torch.Tensor,  # [Dr] float32
    h0: torch.Tensor,  # [B, Dr] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (h [B, T, Dr] in x's dtype, h_last [B, Dr] float32).

    Where autograd needs a gradient the CPU path records it through the
    plain loop; the card's raises (no backward kernel yet).
    """
    _check(x, r_gate, i_gate, lam, h0)
    if x.device.type == "cpu":
        return rglru_scan_ref(x, r_gate, i_gate, lam, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r_gate, i_gate, lam, h0)):
        raise NotImplementedError(NO_BACKWARD)
    _check_cuda(x, r_gate, i_gate)
    return _launch(x, r_gate, i_gate, lam, h0)
