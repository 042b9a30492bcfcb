"""Plain PyTorch version of the WAN int8 quantisation kernels.

The same transform as ``repro.kernels.wan_quant.ref`` and
``repro.distributed.compression.int8_compress``: per-row blocks of 256
lanes, absmax scale (1.0 for an all-zero block), symmetric round half to
even (``torch.round``), clip to +-127.  Unlike the JAX oracle it takes any
number of columns and pads them with zeros to a multiple of 256 itself, as
the CUDA kernel does.  It is the CPU path of :mod:`.ops` and the yardstick
the kernel is held against on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256


def wan_quant_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, cols] float32 or bf16 -> (int8 [rows, L], float32 scales
    [rows, L / 256]), L = cols rounded up to a multiple of 256."""
    rows, cols = x.shape
    pad = (-cols) % BLOCK
    xf = torch.nn.functional.pad(x.float(), (0, pad))
    blocks = xf.reshape(rows, -1, BLOCK)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on the card ATen turns division by a Python scalar
    # into a multiply by its reciprocal, which can land one ulp off
    scale = torch.where(absmax > 0, absmax / torch.full((), 127.0, device=x.device), 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(rows, cols + pad), scale[..., 0]


def wan_dequant_ref(q: torch.Tensor, scales: torch.Tensor, cols: int) -> torch.Tensor:
    """(int8 [rows, L], scales [rows, L / 256]) -> float32 [rows, cols]."""
    rows, lanes = q.shape
    blocks = q.reshape(rows, lanes // BLOCK, BLOCK).float()
    return (blocks * scales[..., None]).reshape(rows, lanes)[:, :cols]
