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
    xf = x.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    blocks = xf.reshape(rows, -1, BLOCK)
    # max |x| as max(max x, -min x), and the quotient rounded and clamped in
    # its own storage: one temporary the size of x (mixtral-8x22b's stacked
    # expert gradient is 6.4 GB)
    absmax = torch.maximum(blocks.amax(dim=-1, keepdim=True), blocks.amin(dim=-1, keepdim=True).neg_())
    # a tensor divisor: on the card ATen turns division by a Python scalar
    # into a multiply by its reciprocal, which can land one ulp off
    scale = torch.where(absmax > 0, absmax / torch.full((), 127.0, device=x.device), 1.0)
    q = torch.div(blocks, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q.reshape(rows, cols + pad), scale[..., 0]


def wan_dequant_ref(q: torch.Tensor, scales: torch.Tensor, cols: int) -> torch.Tensor:
    """(int8 [rows, L], scales [rows, L / 256]) -> float32 [rows, cols]."""
    rows, lanes = q.shape
    blocks = q.reshape(rows, lanes // BLOCK, BLOCK).float().mul_(scales[..., None])
    return blocks.reshape(rows, lanes)[:, :cols]
