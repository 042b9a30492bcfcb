"""Plain PyTorch versions of the flash-attention kernels.

:func:`flash_attention_ref` is the softmax-attention definition in float32,
as ``repro.kernels.flash_attention.ref.flash_attention_ref``, and also
returns the rows' log-sum-exp.  :func:`flash_attention_bwd_ref` is the
explicit backward pass (the FlashAttention-2 formulas, not autograd) that
``csrc/flash_bwd.cu`` computes.  Both are the CPU path of
:mod:`~repro_torch.kernels.flash_attention.ops` and the yardsticks the CUDA
kernels are held against on the card.
Layout: heads-first [B, H, S, hd].  Query and key indices both start at 0.
Every query row must see at least one key (the wrappers refuse a window
with Sq >= Sk + window): a row that sees none has lse = -1e30 in float32,
which no longer says over how many keys its uniform softmax spreads.

Rounding: both compute in float32 from the inputs' values and round only
their results to the input dtype.  The bf16 kernels also round p (forward
and backward) and dS (backward) to bf16, the tensor cores' operand type;
that stays inside the bf16 tolerance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _logits(q, k, *, causal, window, logit_softcap):
    """Masked float32 logits [B, KVH, G, Sq, Sk], tanh(s / cap) (or None), mask."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, hd).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * hd ** -0.5
    th = None
    if logit_softcap is not None:
        th = torch.tanh(logits / logit_softcap)
        logits = logit_softcap * th
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    return logits, th, mask


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, hd]
    k: torch.Tensor,  # [B, KVH, Sk, hd]
    v: torch.Tensor,  # [B, KVH, Sk, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B, H, Sq, hd] in q's dtype, lse [B, H, Sq] float32)."""
    b, h, sq, hd = q.shape
    logits, _, _ = _logits(q, k, causal=causal, window=window, logit_softcap=logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype), lse.reshape(b, h, sq)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [B, H, Sq, hd]
    k: torch.Tensor,  # [B, KVH, Sk, hd]
    v: torch.Tensor,  # [B, KVH, Sk, hd]
    o: torch.Tensor,  # [B, H, Sq, hd]  the forward's output
    lse: torch.Tensor,  # [B, H, Sq]    the forward's log-sum-exp
    do: torch.Tensor,  # [B, H, Sq, hd]  gradient of the output
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dq, dk, dv) in the inputs' dtype and shapes.

    D = rowsum(dO * O); P = exp(s - lse); dV = P^T dO; dP = dO V^T;
    dS = P * (dP - D), times 1 - tanh^2(s / cap) under a softcap and 0
    where the mask holds the logit at -1e30;
    dK = dS^T Q * scale; dQ = dS K * scale.  GQA sums dK and dV over the
    query heads of each kv head.
    """
    b, h, sq, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    logits, th, mask = _logits(q, k, causal=causal, window=window, logit_softcap=logit_softcap)
    p = torch.exp(logits - lse.reshape(b, kvh, g, sq, 1).float())
    dog = do.reshape(b, kvh, g, sq, hd).float()
    d = (dog * o.reshape(b, kvh, g, sq, hd).float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    ds = torch.where(mask, p * (dp - d), torch.zeros((), device=q.device))  # the mask cuts it
    if th is not None:
        ds = ds * (1.0 - th * th)
    scale = hd ** -0.5
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, q.reshape(b, kvh, g, sq, hd).float()) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
