"""Plain PyTorch version of the RWKV6 WKV kernel: a loop over time.

The same recurrence as ``repro.kernels.rwkv6_wkv.ref.wkv6_ref`` (and
``repro.models.rwkv6.wkv6_scan``), per batch and head, in float32:

    out_t = r_t . (S + u * k_t v_t^T)
    S    <- diag(w_t) S + k_t v_t^T

with ``S[b, h, i, j]`` accumulating ``k_i * v_j``.  It is the CPU path of
:mod:`.ops` and the yardstick the CUDA kernel is held against on the card;
nothing on the card's main path runs it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # [H, N] bonus
    state0: Optional[torch.Tensor] = None,  # [B, H, N, N]; zeros if None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B, T, H, N] float32, final state [B, H, N, N] float32)."""
    b, t, h, n = r.shape
    if state0 is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    else:
        state = state0.float()
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]  # [B, H, N, N]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, i], state + uf * kv))
        state = state * wf[:, i, :, :, None] + kv
    return torch.stack(outs, dim=1), state
