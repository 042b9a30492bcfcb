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
torch (``csrc/rglru_scan.cu``): chunks of ``chunk`` steps, each cut into
segments of ``segment`` steps, each chunk's start taken from the previous
chunk's published inclusive state.  They are the CPU path of :mod:`.ops`
and the yardsticks the kernel is held against on the card; nothing on the
card's main path runs them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

LRU_C = 8.0
#: steps a block of the kernel takes (``csrc/rglru_scan.cu``, ``kChunk``)
CHUNK = 64
#: steps a warp of the kernel walks, a chunk's segment (``kSeg``)
SEGMENT = 8


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


def rglru_scan_chunked_ref(x, r_gate, i_gate, lam, h0, *, chunk: int = CHUNK, segment: int = SEGMENT):
    """The kernel's one launch, chunk by chunk:

    1. the chunk's segments, each from a zero state: its decay product
       ``A_w`` and local end state ``H_w`` (steps past T are the identity,
       a = 1, b = 0), folded in order into the chunk's ``(A_c, H_c)``;
    2. the chunk's start ``s_c`` is the previous chunk's published
       inclusive state (``h0`` for the first), and it publishes its own,
       ``A_c s_c + H_c``;
    3. each segment walked again from its start (``s_c``, then
       ``A_w s + H_w`` segment by segment); h_last is step T - 1's h.
    """
    if chunk % segment:
        raise ValueError(f"chunk {chunk} is not a multiple of segment {segment}")
    a, b = _coefficients(x, r_gate, i_gate, lam)
    t = x.shape[1]
    pad = -t % chunk  # identity steps to the chunk's end
    a = F.pad(a, (0, 0, 0, pad), value=1.0)
    b = F.pad(b, (0, 0, 0, pad))
    ones, zeros = torch.ones_like(a[:, 0]), torch.zeros_like(a[:, 0])
    published = _wide(h0)
    hs = []
    for c0 in range(0, t, chunk):
        segs = []
        for w0 in range(c0, c0 + chunk, segment):
            decay, local = ones, zeros
            for s in range(w0, w0 + segment):
                decay = a[:, s] * decay
                local = a[:, s] * local + b[:, s]
            segs.append((w0, decay, local))
        chunk_decay, chunk_local = ones, zeros
        for _, decay, local in segs:
            chunk_decay = decay * chunk_decay
            chunk_local = decay * chunk_local + local
        start, published = published, chunk_decay * published + chunk_local
        for w0, decay, local in segs:
            h = start
            for s in range(w0, w0 + segment):
                h = a[:, s] * h + b[:, s]
                if s < t:
                    hs.append(h)
            start = decay * start + local
    return torch.stack(hs, dim=1).to(x.dtype), hs[-1]
