"""Gradient compression for the WAN hop.

Port of ``repro.distributed.compression``: per-block absmax int8 with blocks
of 256 lanes along the LAST axis (leading dims untouched), 4x fewer bytes
than float32, and the error-feedback helpers that carry each pod's
quantisation residual into its next step (Seide et al.).  The transform
runs through :mod:`repro_torch.kernels.wan_quant`: the CUDA kernels on the
card, their plain versions on the CPU.  Magnitude top-k
(:func:`topk_sparsify` / :func:`topk_densify`) is plain PyTorch, as the
JAX package's is plain ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..kernels.wan_quant import wan_dequant, wan_quant
from ..tree import tree_map


class Int8Compressed(NamedTuple):
    values: torch.Tensor  # int8    [..., L_pad]
    scales: torch.Tensor  # float32 [..., L_pad / 256]
    orig_last: int  # unpadded last-dim size
    orig_shape: Tuple[int, ...]


def int8_compress(x: torch.Tensor) -> Int8Compressed:
    orig_shape = tuple(x.shape)
    x2 = x.reshape(1) if x.dim() == 0 else x
    last = x2.shape[-1]
    q, s = wan_quant(x2.reshape(-1, last))
    lead = tuple(x2.shape[:-1])
    return Int8Compressed(
        values=q.reshape(*lead, q.shape[-1]),
        scales=s.reshape(*lead, s.shape[-1]),
        orig_last=last,
        orig_shape=orig_shape,
    )


def int8_decompress(c: Int8Compressed) -> torch.Tensor:
    q = c.values.reshape(-1, c.values.shape[-1])
    s = c.scales.reshape(-1, c.scales.shape[-1])
    return wan_dequant(q, s, c.orig_last).reshape(c.orig_shape)


def compressed_bytes(c: Int8Compressed) -> int:
    return int(c.values.numel() + c.scales.numel() * 4)


def topk_sparsify(x: torch.Tensor, k_fraction: float = 0.01):
    """Magnitude top-k: returns (values, flat indices, shape)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * k_fraction))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, tuple(x.shape)


def topk_densify(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    size = 1
    for s in shape:
        size *= s
    flat = torch.zeros((size,), dtype=vals.dtype, device=vals.device)
    flat[idx] = vals
    return flat.reshape(shape)


# -- error feedback ----------------------------------------------------------------


def init_error_feedback(grads) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def apply_error_feedback(grads, ef):
    """g' = g + residual (per leaf)."""
    return tree_map(lambda g, e: g.float() + e, grads, ef)


def residual(original, transmitted):
    """New residual = what compression lost this step."""
    return tree_map(lambda o, t: o.float() - t.float(), original, transmitted)
