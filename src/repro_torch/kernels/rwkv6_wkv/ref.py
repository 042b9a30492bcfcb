"""Plain PyTorch versions of the RWKV6 WKV kernels: loops over time.

The forward is the same recurrence as ``repro.kernels.rwkv6_wkv.ref.wkv6_ref``
(and ``repro.models.rwkv6.wkv6_scan``), per batch and head, in float32:

    out_t = r_t . (S + u * k_t v_t^T)
    S    <- diag(w_t) S + k_t v_t^T

with ``S[b, h, i, j]`` accumulating ``k_i * v_j``.  The backward
(:func:`wkv6_bwd_ref`) is its gradient on the chunked schedule of
``repro.models.rwkv6._wkv_with_initial_state``: the state saved at every
chunk boundary, each chunk's states recomputed forward from it.  They are
the CPU path of :mod:`.ops` and the yardsticks the CUDA kernels are held
against on the card; nothing on the card's main path runs them.
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
    *,
    chunk: Optional[int] = None,
):
    """-> (out [B, T, H, N] float32, final state [B, H, N, N] float32), and
    with ``chunk`` also the state before every chunk of that many steps,
    ``[B, ceil(T / chunk), H, N, N]`` float32 (entry 0 is ``state0``)."""
    b, t, h, n = r.shape
    if state0 is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    else:
        state = state0.float()
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs, bounds = [], []
    for i in range(t):
        if chunk is not None and i % chunk == 0:
            bounds.append(state)
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]  # [B, H, N, N]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, i], state + uf * kv))
        state = state * wf[:, i, :, :, None] + kv
    if chunk is None:
        return torch.stack(outs, dim=1), state
    return torch.stack(outs, dim=1), state, torch.stack(bounds, dim=1)


def wkv6_bwd_ref(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [H, N]
    bounds: torch.Tensor,  # [B, ceil(T / chunk), H, N, N]: wkv6_ref(..., chunk=chunk)[2]
    dout: torch.Tensor,  # [B, T, H, N]
    dstate: Optional[torch.Tensor],  # [B, H, N, N], the final state's gradient; zeros if None
    chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6_ref` -> (dr, dk, dv, dw in their inputs'
    dtypes, du [H, N] float32, dstate0 [B, H, N, N] float32), in float32.

    With ``G_t = dL/dS_t`` (``G_T = dstate``), going back in time:

        dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
        dk_t = G_t v_t + (u * r_t)(v_t . dy_t)
        dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
        dw_t = rowsum(G_t * S_{t-1})
        du  += r_t * k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate0 = G_0

    ``S_{t-1}`` is recomputed forward from the chunk's saved state, never
    rebuilt backward as ``(S_t - k_t v_t^T) / w_t``: w reaches ~0."""
    b, t, h, n = r.shape
    rf, kf, vf, wf, dy = (a.float() for a in (r, k, v, w, dout))
    uf = u.float()
    g = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device) if dstate is None else dstate.float()
    grads = {name: torch.empty((b, t, h, n), dtype=torch.float32, device=r.device) for name in "rkvw"}
    du = torch.zeros((b, h, n), dtype=torch.float32, device=r.device)
    for c in range((t + chunk - 1) // chunk - 1, -1, -1):
        t0, t1 = c * chunk, min(t, (c + 1) * chunk)
        states = [bounds[:, c].float()]  # states[i] = S_{t0 + i}, the state before step t0 + i
        for i in range(t0, t1 - 1):
            states.append(states[-1] * wf[:, i, :, :, None] + kf[:, i, :, :, None] * vf[:, i, :, None, :])
        for i in range(t1 - 1, t0 - 1, -1):
            s_prev = states[i - t0]
            r_i, k_i, v_i, w_i, dy_i = rf[:, i], kf[:, i], vf[:, i], wf[:, i], dy[:, i]
            vdy = (v_i * dy_i).sum(-1, keepdim=True)  # [B, H, 1]
            grads["r"][:, i] = torch.einsum("bhij,bhj->bhi", s_prev, dy_i) + uf * k_i * vdy
            grads["k"][:, i] = torch.einsum("bhij,bhj->bhi", g, v_i) + uf * r_i * vdy
            grads["v"][:, i] = torch.einsum("bhij,bhi->bhj", g, k_i) + (r_i * uf * k_i).sum(-1, keepdim=True) * dy_i
            grads["w"][:, i] = (g * s_prev).sum(-1)
            du += r_i * k_i * vdy
            g = g * w_i[..., None] + r_i[..., None] * dy_i[..., None, :]
    dr, dk, dv, dw = (grads[name].to(x.dtype) for name, x in zip("rkvw", (r, k, v, w)))
    return dr, dk, dv, dw, du.sum(0), g
