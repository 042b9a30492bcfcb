"""WAN int8 quantisation of gradient leaves.

On a CUDA tensor :func:`wan_quant` and :func:`wan_dequant` launch the
hand-written kernels of ``csrc/wan_quant.cu`` (the port of the Pallas TPU
kernels ``repro/kernels/wan_quant/kernel.py::wan_quant`` / ``wan_dequant``),
or raise if the input is one they cannot take.  On a CPU tensor they
compute the plain versions (:mod:`.ref`).  Both take a matrix of any width:
the padding to a multiple of 256 lanes exists only in the int8 output.

:func:`quantize` / :func:`dequantize` port ``repro.kernels.wan_quant.ops``:
a leaf of any shape (0-d and 1-d included) as rows of its last dimension.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import LAUNCHES, _build
from .ref import BLOCK, wan_dequant_ref, wan_quant_ref

QUANT = "wan_quant"
DEQUANT = "wan_dequant"


def _fn(name: str, argtypes):
    lib = _build.load("wan_quant")
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check_matrix(t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty [rows, cols] matrix, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, got {t.device}")


def wan_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, cols] float32 or bf16 -> (int8 [rows, L], float32 scales
    [rows, L / 256]), L = cols rounded up to a multiple of 256."""
    _check_matrix(x, QUANT)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{QUANT} takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return wan_quant_ref(x)
    x = x.contiguous()
    rows, cols = x.shape
    nblocks = -(-cols // BLOCK)
    q = torch.empty((rows, nblocks * BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, nblocks), dtype=torch.float32, device=x.device)
    lib, fn = _fn("repro_wan_quant", [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ])
    err = fn(
        x.device.index, int(x.dtype == torch.bfloat16), x.data_ptr(), q.data_ptr(), s.data_ptr(),
        rows, cols, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, QUANT)
    LAUNCHES[QUANT] += 1
    return q, s


def wan_dequant(q: torch.Tensor, scales: torch.Tensor, cols: int) -> torch.Tensor:
    """(int8 [rows, L], float32 scales [rows, L / 256]) -> float32 [rows, cols]."""
    _check_matrix(q, DEQUANT)
    rows, lanes = q.shape
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{DEQUANT} takes int8 values and float32 scales, got {q.dtype}, {scales.dtype}")
    if lanes % BLOCK or scales.shape != (rows, lanes // BLOCK) or not 0 < cols <= lanes < cols + BLOCK:
        raise ValueError(f"{DEQUANT}: values {tuple(q.shape)}, scales {tuple(scales.shape)}, cols {cols} disagree")
    if q.device != scales.device:
        raise ValueError(f"devices differ: {q.device}, {scales.device}")
    if q.device.type == "cpu":
        return wan_dequant_ref(q, scales, cols)
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty((rows, cols), dtype=torch.float32, device=q.device)
    lib, fn = _fn("repro_wan_dequant", [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ])
    err = fn(
        q.device.index, q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, cols,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, DEQUANT)
    LAUNCHES[DEQUANT] += 1
    return out


def _rows(shape) -> Tuple[int, int]:
    """A leaf's shape as (rows, last): 0-d -> (1, 1), 1-d -> (1, n)."""
    last = shape[-1] if len(shape) else 1
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return rows, last


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape leaf -> (int8 rows [rows, L], scales [rows, L / 256])."""
    return wan_quant(x.reshape(_rows(x.shape)))


def dequantize(q: torch.Tensor, s: torch.Tensor, orig_shape) -> torch.Tensor:
    """Rows from :func:`quantize` -> float32 leaf of ``orig_shape``."""
    return wan_dequant(q, s, _rows(tuple(orig_shape))[1]).reshape(tuple(orig_shape))
