"""Plain PyTorch version of the flash-attention kernel.

The softmax-attention definition in float32, as
``repro.kernels.flash_attention.ref.flash_attention_ref``: the CPU path
of :func:`~repro_torch.kernels.flash_attention.ops.flash_attention` and the
yardstick the CUDA kernel is held against on the card.
Layout: heads-first [B, H, S, hd].  Query and key indices both start at 0.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, hd]
    k: torch.Tensor,  # [B, KVH, Sk, hd]
    v: torch.Tensor,  # [B, KVH, Sk, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    groups = h // kvh
    qg = q.reshape(b, kvh, groups, sq, hd).float()
    scale = hd ** -0.5
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)
