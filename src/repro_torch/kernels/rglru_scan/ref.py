"""Plain PyTorch versions of the RG-LRU scan: loops over time.

:func:`rglru_scan_ref` is the recurrence of ``repro.models.rglru.rg_lru``
(which runs it as ``jax.lax.associative_scan``) step by step, with the JAX
arithmetic:

    log_a   = 8 * r * log_sigmoid(lam)              (float32)
    a       = exp(log_a)
    beta    = sqrt(max(1 - exp(2 log_a), 1e-12))
    gated_x = (i * x) formed in x's dtype, then widened to float32
    h_t     = a_t h_{t-1} + beta_t gated_x_t        from h0

:func:`rglru_scan_chunked_ref` is the CUDA kernel's algorithm in plain
torch (``csrc/rglru_scan.cu``): the same recurrence over chunks of
``chunk`` steps, each chunk's start carried from the chunks before it.
They are the CPU path of :mod:`.ops` and the yardsticks the kernel is held
against on the card; nothing on the card's main path runs them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

LRU_C = 8.0
#: steps a chunk of the kernel walks (``csrc/rglru_scan.cu``, ``kChunk``)
CHUNK = 64


def _wide(a: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for float64 (a test's exact yardstick)."""
    return a if a.dtype == torch.float64 else a.float()


def _coefficients(x, r_gate, i_gate, lam):
    """(a, beta * gated_x), each [B, T, Dr] in the scan's type."""
    log_a = LRU_C * _wide(r_gate) * F.logsigmoid(_wide(lam))[None, None, :]
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * _wide(i_gate * x)


def rglru_scan_ref(
    x: torch.Tensor,  # [B, T, Dr]
    r_gate: torch.Tensor,  # [B, T, Dr], in (0, 1)
    i_gate: torch.Tensor,  # [B, T, Dr], in (0, 1)
    lam: torch.Tensor,  # [Dr] float32 logits of the base decay
    h0: torch.Tensor,  # [B, Dr] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (h [B, T, Dr] in x's dtype, h_last [B, Dr] float32; float64 for
    float64 inputs).  Differentiable: autograd goes through the loop."""
    a, b = _coefficients(x, r_gate, i_gate, lam)
    h = _wide(h0)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rglru_scan_chunked_ref(x, r_gate, i_gate, lam, h0, *, chunk: int = CHUNK):
    """The kernel's three passes (one when T fits one chunk):

    1. each chunk alone from a zero state: its decay product ``A_c`` and its
       local end state ``H_c``;
    2. the chunk starts carried in order: ``s_0 = h0``,
       ``s_{c+1} = A_c s_c + H_c``;
    3. each chunk again, step by step from its start ``s_c``; h_last is the
       last chunk's last step.
    """
    a, b = _coefficients(x, r_gate, i_gate, lam)
    t = x.shape[1]
    bounds = list(range(0, t, chunk))
    starts = [_wide(h0)]
    for c0 in bounds[:-1]:  # passes 1 and 2; the last chunk's end is not needed
        decay, local = torch.ones_like(starts[0]), torch.zeros_like(starts[0])
        for s in range(c0, c0 + chunk):
            decay = decay * a[:, s]
            local = a[:, s] * local + b[:, s]
        starts.append(decay * starts[-1] + local)
    hs = []
    for c0, h in zip(bounds, starts):  # pass 3
        for s in range(c0, min(c0 + chunk, t)):
            h = a[:, s] * h + b[:, s]
            hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h
