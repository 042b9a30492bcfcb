"""The work of each hand-written kernel, in one place: operations by operand type and bytes.

Each function takes a kernel's shapes and returns ``(flops, nbytes)``:
``flops`` maps an operand type (``"bfloat16"``, ``"float32"`` on the CUDA
cores, ``"tf32"`` on the tensor cores) to the operations the kernel does
in it, and ``nbytes`` counts each input read once and each output written
once.  :func:`bound` turns them into the least time an NVIDIA H100 SXM
could take, from its data sheet's dense rates (``PEAK_FLOPS``,
``HBM_BYTES_PER_S``): data-sheet figures, not measurements.

``chip_smoke.py`` reckons every kernel's ``bound_ms`` here, and each
kernel's custom op (``torch.ops.repro_torch.*``) takes its FLOP formula
from here for ``torch.utils.flop_counter`` and the dry run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM rate and peak rates by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}  # float32: CUDA cores; tf32: tensor cores
HBM_BYTES = 80e9  # one card's memory
SMS = 132  # streaming multiprocessors

Cost = Tuple[Dict[str, int], int]

_ITEMSIZE = {"bfloat16": 2, "float32": 4}


def attention_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """Query-key pairs the mask keeps: the work this input needs."""
    q = np.arange(sq)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_fwd(b, sq, sk, h, kvh, hd, dtype, window, causal=True) -> Cost:
    """q.k and p.v over the pairs the mask keeps; q, o [B, Sq, H, hd] and
    k, v [B, Sk, KVH, hd] each moved once."""
    nbytes = (2 * b * sq * h * hd + 2 * b * sk * kvh * hd) * _ITEMSIZE[dtype]
    return {dtype: 4 * b * h * hd * attention_pairs(sq, sk, causal, window)}, nbytes


def flash_bwd(b, sq, sk, h, kvh, hd, dtype, window, causal=True) -> Cost:
    """Five products over the kept pairs; q, o, dO read and dQ written; k, v
    read and dK, dV written; lse read."""
    nbytes = (4 * b * sq * h * hd + 4 * b * sk * kvh * hd) * _ITEMSIZE[dtype] + 4 * b * h * sq
    return {dtype: 10 * b * h * hd * attention_pairs(sq, sk, causal, window)}, nbytes


def wan_quant(rows, cols) -> Cost:
    """Quantisation (or dequantisation) of a [rows, cols] float32 matrix:
    the float32 values, the padded int8 and the scales moved once; no
    operation worth a bound."""
    nblocks = -(-cols // 256)
    return {}, rows * cols * 4 + rows * nblocks * 256 + rows * nblocks * 4


def wkv6_fwd(b, t, h, n, rkv_dtype, w_dtype) -> Cost:
    """Each input read once (r, k, v, w; u; state0), each output written once
    (out float32, the final state); 4 N^2 float32 operations per (b, t, h)."""
    elems = b * t * h * n
    nbytes = elems * (3 * _ITEMSIZE[rkv_dtype] + _ITEMSIZE[w_dtype] + 4) + h * n * 4 + 2 * b * h * n * n * 4
    return {"float32": 4 * n * n * b * t * h}, nbytes


def wkv6_bwd(b, t, h, n, rkv_dtype, w_dtype, chunk) -> Cost:
    """Bytes: each input read once (r, k, v, w; dy float32; u; the saved
    states and dstate), each output written once (dr, dk, dv in r's type, dw
    in w's; du; dstate0).  Operations: those wkv6_bwd.cu does a (b, t, h),
    by type: on the tensor cores (TF32; three products each for float32 r,
    k, v) P, Q, the state recomputed 1.5 times, G's two updates and dv's K~
    GL: 13 N^2; A and dv's B DY: 4 L N; the pair terms' X: 2 L 17 N (L =
    16); on the CUDA cores (float32) ~170 N for the pair terms and the
    decays."""
    steps, elems, sub = b * t * h, b * t * h * n, 16
    states = (b * -(-t // chunk) + 2 * b) * h * n * n * 4
    nbytes = elems * (2 * (3 * _ITEMSIZE[rkv_dtype] + _ITEMSIZE[w_dtype]) + 4) + 2 * h * n * 4 + states
    tensor = steps * (13 * n * n + 4 * sub * n + 2 * sub * 17 * n) * (3 if rkv_dtype == "float32" else 1)
    return {"tf32": tensor, "float32": steps * 170 * n}, nbytes


def wkv6_scalar_recurrence_flops(b, t, h, n) -> int:
    """The earlier scalar backward's count: 15 N^2 float32 operations a (b,
    t, h) of the step-by-step recurrence on the CUDA cores."""
    return 15 * n * n * b * t * h


def rglru_scan(b, t, dr, dtype) -> Cost:
    """Bytes: x, r, i read once and h written once in ``dtype``; lam, h0 read
    and h_last written in float32.  Operations: ~13 float32 a (b, t,
    channel): the gate products, two exp, a sqrt, the clamp and the update
    (an exp or sqrt counted as one)."""
    elems = b * t * dr
    return {"float32": 13 * elems}, 4 * elems * _ITEMSIZE[dtype] + dr * 4 + 2 * b * dr * 4


def rglru_scan_bwd(b, t, dr, dtype) -> Cost:
    """Bytes: x, r, i and dy read and dx, dr, di written once in ``dtype``;
    lam, h0, dh_last and the forward's chunk states read, dlam and dh0
    written in float32.  Operations: ~20 float32 a (b, t, channel): a and
    exp(2 log_a), beta, the gated x, dlog_a (a division among them), dg, dx,
    di, dr, the dlam term, the carry and h_{t-1} recomputed (an exp, sqrt or
    division counted as one)."""
    elems, chunks = b * t * dr, -(-t // 64)
    nbytes = 7 * elems * _ITEMSIZE[dtype] + (2 * dr + 3 * b * dr + b * (chunks - 1) * dr) * 4
    return {"float32": 20 * elems}, nbytes


def ops_seconds(flops: Dict[str, float]) -> float:
    """Seconds the operations take at the data sheet's peak rate of each type."""
    return sum(n / PEAK_FLOPS[kind] for kind, n in flops.items())


def bound(flops: Dict[str, float], nbytes: float) -> Tuple[float, str]:
    """(least ms the card could take, ``"bytes"`` or ``"operations"``): the
    larger of the bytes over the memory rate and the operations over their
    types' peak rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_seconds(flops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


#: a kernel op's packet (``torch.ops.repro_torch.<name>``) -> its cost as a
#: function of the op's arguments, tensors included
OP_COSTS: Dict[object, Callable[..., Cost]] = {}


def register_op(op, cost: Callable[..., Cost]) -> None:
    """Give the custom op ``op`` its cost: ``cost(*args, **kwargs)`` ->
    (flops by type, bytes), and their sum as the op's FLOP formula for
    ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    OP_COSTS[op] = cost
    if op not in flop_registry:

        @register_flop_formula(op, get_raw=True)
        def _flops(*args, out_val=None, **kwargs):
            return sum(cost(*args, **kwargs)[0].values())


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).replace("torch.", "")
