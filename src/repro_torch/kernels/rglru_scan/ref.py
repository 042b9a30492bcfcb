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
chunk's published inclusive state.

:func:`rglru_scan_bwd_ref` is the gradient, written out as the reverse
recurrence (not autograd through the loop), with the arithmetic of
``jax.grad`` of ``rg_lru``:

    dh_t      = dy_t + a_{t+1} dh_{t+1}           from dh_last (or 0)
    dlog_a_t  = dh_t h_{t-1} a_t - dh_t g_t exp(2 log_a_t) / beta_t
                (the second term 0 where the 1e-12 clamp binds: r = 0)
    dg_t      = dh_t beta_t, rounded to x's dtype;  dx = dg i, di = dg x
    dr        = 8 log_sigmoid(lam) dlog_a;  dlam = sigmoid(-lam) sum_{b,t} 8 r dlog_a
    dh0       = a_0 dh_0

with h_{t-1} in float32 (g = gated_x).  :func:`rglru_scan_bwd_chunked_ref`
is the backward kernel's algorithm (``csrc/rglru_scan_bwd.cu``): the
carry runs through the chunks in reverse, each chunk's h recomputed from
its start, the forward's published state.  They are the CPU path of
:mod:`.ops` and the yardsticks the kernels are held against on the card;
nothing on the card's main path runs them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


def _segments(a, b, c0, chunk, segment):
    """Chunk [c0, c0 + chunk)'s segments, each from a zero state: a list of
    (first step, decay product A_w, local end state H_w), and the chunk's
    (A_c, H_c), the segments folded in order."""
    ones, zeros = torch.ones_like(a[:, 0]), torch.zeros_like(a[:, 0])
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
    return segs, chunk_decay, chunk_local


def _padded(x, r_gate, i_gate, lam, chunk):
    """(a, b) padded with identity steps (a = 1, b = 0) to whole chunks."""
    a, b = _coefficients(x, r_gate, i_gate, lam)
    pad = -x.shape[1] % chunk
    return F.pad(a, (0, 0, 0, pad), value=1.0), F.pad(b, (0, 0, 0, pad))


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
    t = x.shape[1]
    a, b = _padded(x, r_gate, i_gate, lam, chunk)
    published = _wide(h0)
    hs = []
    for c0 in range(0, t, chunk):
        segs, chunk_decay, chunk_local = _segments(a, b, c0, chunk, segment)
        start, published = published, chunk_decay * published + chunk_local
        for w0, decay, local in segs:
            h = start
            for s in range(w0, w0 + segment):
                h = a[:, s] * h + b[:, s]
                if s < t:
                    hs.append(h)
            start = decay * start + local
    return torch.stack(hs, dim=1).to(x.dtype), hs[-1]


def chunk_states(x, r_gate, i_gate, lam, h0, *, chunk: int = CHUNK, segment: int = SEGMENT) -> List[torch.Tensor]:
    """The inclusive state each chunk but the last publishes in the
    forward kernel (``ops`` keeps them for the backward as ``[B, NC, Dr]``
    scratch), in the scan's type."""
    a, b = _padded(x, r_gate, i_gate, lam, chunk)
    published, out = _wide(h0), []
    for c0 in range(0, x.shape[1] - chunk, chunk):
        _, chunk_decay, chunk_local = _segments(a, b, c0, chunk, segment)
        published = chunk_decay * published + chunk_local
        out.append(published)
    return out


def _grad_terms(x, r_gate, i_gate, lam):
    """What the gradient reads a step, [B, T, Dr] in the scan's type:
    (a, beta, gated_x, exp(2 log_a), the clamp not binding), and
    8 log_sigmoid(lam) [Dr]."""
    c8lsl = LRU_C * F.logsigmoid(_wide(lam))
    log_a = _wide(r_gate) * c8lsl[None, None, :]
    u = torch.exp(2.0 * log_a)
    free = 1.0 - u
    return torch.exp(log_a), torch.sqrt(torch.clamp_min(free, 1e-12)), _wide(i_gate * x), u, free > 1e-12, c8lsl


def _step_grad(dh, h_prev, a, beta, g, u, free):
    """(dlog_a, dg) of one step from its dh and h_{t-1}."""
    dlog_a = dh * h_prev * a - torch.where(free, dh * g * u / beta, torch.zeros_like(dh))
    return dlog_a, dh * beta


def _outputs(x, r_gate, i_gate, lam, dlog_a, dg, c8lsl, dh0):
    """(dx, dr, di in x's dtype, dlam in lam's, dh0) from the per-step
    dlog_a and dg [B, T, Dr]: the casts and products of ``rg_lru``'s VJP."""
    dgx = dg.to(x.dtype)
    dr = (dlog_a * c8lsl[None, None, :]).to(x.dtype)
    dlam = (dlog_a * (LRU_C * _wide(r_gate))).sum((0, 1)) * torch.sigmoid(-_wide(lam))
    return dgx * i_gate, dr, dgx * x, dlam.to(lam.dtype), dh0


def _cotangents(x, dy, dh_last):
    """dy in the scan's type ([B, T, Dr] zeros if None) and dh_last ([B, Dr])."""
    b, t, dr = x.shape
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    dy = torch.zeros((b, t, dr), dtype=wide, device=x.device) if dy is None else _wide(dy)
    dh_last = torch.zeros((b, dr), dtype=wide, device=x.device) if dh_last is None else _wide(dh_last)
    return dy, dh_last


def rglru_scan_bwd_ref(
    x: torch.Tensor,  # [B, T, Dr]
    r_gate: torch.Tensor,  # [B, T, Dr]
    i_gate: torch.Tensor,  # [B, T, Dr]
    lam: torch.Tensor,  # [Dr] float32
    h0: torch.Tensor,  # [B, Dr] float32
    dy: Optional[torch.Tensor],  # [B, T, Dr] in x's dtype: the cotangent of h, or None
    dh_last: Optional[torch.Tensor],  # [B, Dr] float32: the cotangent of h_last, or None
):
    """-> (dx, dr, di [B, T, Dr] in x's dtype, dlam [Dr] float32, dh0 [B, Dr]
    float32; float64 throughout for float64 inputs): the explicit reverse
    recurrence, with h_{t-1} recomputed step by step in float32."""
    a, b = _coefficients(x, r_gate, i_gate, lam)
    _, beta, g, u, free, c8lsl = _grad_terms(x, r_gate, i_gate, lam)
    dy, carry = _cotangents(x, dy, dh_last)
    h_prev = [_wide(h0)]
    for t in range(x.shape[1] - 1):
        h_prev.append(a[:, t] * h_prev[-1] + b[:, t])
    dlog_a, dg = torch.empty_like(a), torch.empty_like(a)
    for t in reversed(range(x.shape[1])):
        dh = dy[:, t] + carry
        dlog_a[:, t], dg[:, t] = _step_grad(dh, h_prev[t], a[:, t], beta[:, t], g[:, t], u[:, t], free[:, t])
        carry = a[:, t] * dh
    return _outputs(x, r_gate, i_gate, lam, dlog_a, dg, c8lsl, carry)


def rglru_scan_bwd_chunked_ref(x, r_gate, i_gate, lam, h0, dy, dh_last, *, chunk: int = CHUNK,
                               segment: int = SEGMENT):
    """The backward kernel's one launch, chunk by chunk from the last:

    1. each segment from a zero carry: its decay product ``A_w`` and the
       carry it sends to the step before it, ``L_w`` (walking back from its
       last step, dh = dy + carry, carry = a dh), folded from the last
       segment into the chunk's ``(A_c, L_c)``;
    2. the chunk's incoming carry ``G_c`` is the next chunk's published
       outgoing carry (dh_last for the last chunk), and it publishes its
       own, ``A_c G_c + L_c``; the first chunk's is dh0;
    3. each segment's h_{t-1} recomputed from its start (the chunk's start
       is the forward's published state of the chunk before, or h0), then
       the segment walked back from its carry (``G_c``, then
       ``A_w G + L_w`` segment by segment towards the first), giving
       dlog_a and dg a step.
    """
    if chunk % segment:
        raise ValueError(f"chunk {chunk} is not a multiple of segment {segment}")
    t = x.shape[1]
    a, b = _padded(x, r_gate, i_gate, lam, chunk)
    _, beta, g, u, free, c8lsl = _grad_terms(x, r_gate, i_gate, lam)
    dy, carry = _cotangents(x, dy, dh_last)
    dy = F.pad(dy, (0, 0, 0, -t % chunk))
    starts = [_wide(h0)] + chunk_states(x, r_gate, i_gate, lam, h0, chunk=chunk, segment=segment)
    dlog_a, dg = torch.zeros_like(a), torch.zeros_like(a)
    for c0 in reversed(range(0, t, chunk)):
        segs, _, _ = _segments(a, b, c0, chunk, segment)
        back = []  # per segment, from its zero carry: (A_w, L_w)
        for w0, decay, _ in segs:
            local = torch.zeros_like(decay)
            for s in reversed(range(w0, w0 + segment)):
                local = a[:, s] * (dy[:, s] + local)
            back.append((decay, local))
        chunk_decay, chunk_local = torch.ones_like(carry), torch.zeros_like(carry)
        for decay, local in reversed(back):
            chunk_decay = decay * chunk_decay
            chunk_local = decay * chunk_local + local
        incoming, carry = carry, chunk_decay * carry + chunk_local
        seg_carry = [incoming]
        for decay, local in reversed(back[1:]):
            seg_carry.insert(0, decay * seg_carry[0] + local)
        start = starts[c0 // chunk]
        for (w0, decay, local), cw in zip(segs, seg_carry):
            h, h_prev = start, []
            for s in range(w0, w0 + segment):
                h_prev.append(h)
                h = a[:, s] * h + b[:, s]
            for s in reversed(range(w0, w0 + segment)):
                dh = dy[:, s] + cw
                if s < t:
                    dlog_a[:, s], dg[:, s] = _step_grad(dh, h_prev[s - w0], a[:, s], beta[:, s], g[:, s],
                                                        u[:, s], free[:, s])
                cw = a[:, s] * dh
            start = decay * start + local
    return _outputs(x, r_gate, i_gate, lam, dlog_a[:, :t], dg[:, :t], c8lsl, carry)
