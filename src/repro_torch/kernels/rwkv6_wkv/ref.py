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


def _wide(a: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for float64 (a test's exact yardstick)."""
    return a if a.dtype == torch.float64 else a.float()


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
    ``[B, ceil(T / chunk), H, N, N]`` float32 (entry 0 is ``state0``); all
    float64 for float64 inputs."""
    b, t, h, n = r.shape
    rf, kf, vf, wf = (_wide(a) for a in (r, k, v, w))
    state = torch.zeros((b, h, n, n), dtype=rf.dtype, device=r.device) if state0 is None else _wide(state0)
    uf = _wide(u)[None, :, :, None]
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
    dtypes, du [H, N] float32, dstate0 [B, H, N, N] float32), in float32
    (in float64 for float64 inputs, a test's exact yardstick).

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
    rf, kf, vf, wf, dy = (_wide(a) for a in (r, k, v, w, dout))
    uf, ft = _wide(u), rf.dtype
    g = torch.zeros((b, h, n, n), dtype=ft, device=r.device) if dstate is None else _wide(dstate)
    grads = {name: torch.empty((b, t, h, n), dtype=ft, device=r.device) for name in "rkvw"}
    du = torch.zeros((b, h, n), dtype=ft, device=r.device)
    for c in range((t + chunk - 1) // chunk - 1, -1, -1):
        t0, t1 = c * chunk, min(t, (c + 1) * chunk)
        states = [_wide(bounds[:, c])]  # states[i] = S_{t0 + i}, the state before step t0 + i
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


#: steps a sub-chunk of the chunked backward (``csrc/wkv6_bwd.cu``'s ``L``)
SUB = 16


def _excl_prod(w: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """Running product of w along ``dim`` over the steps strictly before
    (``reverse``: strictly after) each step: every entry is a product of
    factors in [0, 1], so it can underflow to 0 but never overflow."""
    if reverse:
        return _excl_prod(w.flip(dim), dim).flip(dim)
    ones = torch.ones_like(w.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, w.narrow(dim, 0, w.shape[dim] - 1)], dim), dim)


def wkv6_bwd_chunked_ref(
    r: torch.Tensor,  # [B, T, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [H, N]
    bounds: torch.Tensor,  # [B, ceil(T / chunk), H, N, N]
    dout: torch.Tensor,  # [B, T, H, N]
    dstate: Optional[torch.Tensor],  # [B, H, N, N] or None (zeros)
    chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """:func:`wkv6_bwd_ref`'s function computed the way ``csrc/wkv6_bwd.cu``
    computes it, in float32 (plain float32 products where the kernel uses
    the tensor cores).  Tests hold it to :func:`wkv6_bwd_ref` and to
    ``jax.grad``; nothing on the main path runs it.

    1. ``G`` at every chunk's end: each chunk ``c >= 1`` alone gives
       ``Gloc_c = R~_c^T DY_c`` (``r`` scaled by the decay from the chunk's
       start) and its decay ``D_c``; then ``G_{c-1} = D_c G_c + Gloc_c``.
    2. Per chunk, from its saved state and its ``G``: the state before each
       ``SUB``-step sub-chunk, forward (``S <- diag(cL) S + K~^T V``); then
       the sub-chunks backward.  With ``S0`` and ``GL`` at a sub-chunk's
       ends, ``P = DY S0^T``, ``Q = V GL^T``, ``A = DY V^T`` and per row the
       pair decays ``W[t][s] = prod_{s < p < t} w_p``:

           dr_t = cp_t P_t + sum_{s<t} W[t][s] k_s A[t][s] + u k_t A[t][t]
           dk_t = e_t Q_t + sum_{q>t} W[q][t] r_q A[q][t] + u r_t A[t][t]
           dv_t = K~_t GL + sum_{q>=t} B[t][q] dy_q
           dw_t = cp_t e_t rowsum(GL * S0) + e_t sum_{s<t} W[t][s] k_s Q_s
                  + cp_t sum_{q>t} W[q][t] r_q P_q
                  + sum_{q>t} W[q][t] r_q X[t][q],  X[t][q] = sum_{s<t} W[t][s] k_s A[q][s]

       with ``cp_t`` / ``e_t`` the decay from the sub-chunk's start to
       step t / from step t to its end (exclusive), ``K~ = k e``,
       ``B[t][q] = sum_i W[q][t] r_q k_t`` (``q > t``) and
       ``B[t][t] = sum_i r_t u k_t``; then ``GL <- diag(cL) GL + R~^T DY``.

    Every decay is a running product of w over steps of one sub-chunk (or,
    for ``R~`` in step 1, of one chunk): a factor in [0, 1], never an
    inverse, so w == 0 gives exact zeros and nothing divides by w.  dw
    comes from its parts, not from a cumulative log-decay."""
    b, t, h, n = r.shape
    nc = -(-t // chunk)
    pad = nc * chunk - t

    def prep(x, fill):  # [B, T, H, N] -> float32 [B, H, nc * chunk, N], padded
        x = x.float().permute(0, 2, 1, 3)
        return torch.cat([x, x.new_full((b, h, pad, n), fill)], 2) if pad else x

    rf, kf, vf, dy = (prep(x, 0.0) for x in (r, k, v, dout))
    wf = prep(w, 1.0)  # a padded step decays nothing and adds nothing
    uf = u.float()[None, :, None, :]  # [1, H, 1, N]
    dev = r.device

    # 1. G at each chunk's end
    g = torch.zeros((b, h, n, n), dtype=torch.float32, device=dev) if dstate is None else dstate.float()
    g_end = [g] * nc
    for c in range(nc - 1, 0, -1):
        sl = slice(c * chunk, (c + 1) * chunk)
        cp = _excl_prod(wf[:, :, sl], 2)
        gloc = torch.einsum("bhsi,bhsj->bhij", rf[:, :, sl] * cp, dy[:, :, sl])
        decay = cp[:, :, -1] * wf[:, :, sl][:, :, -1]
        g = decay[..., None] * g + gloc
        g_end[c - 1] = g

    grads = {x: torch.zeros((b, h, nc * chunk, n), dtype=torch.float32, device=dev) for x in "rkvw"}
    du_parts = torch.zeros((b, nc, h, n), dtype=torch.float32, device=dev)  # per (b, chunk), as the kernel's blocks
    lower = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool, device=dev), -1)  # [t][s]: s < t
    eye = torch.eye(SUB, dtype=torch.float32, device=dev)
    for c in range(nc - 1, -1, -1):  # chunk 0 last: its G at the start is dstate0
        t0 = c * chunk
        nsub = -(-(min(t, t0 + chunk) - t0) // SUB)
        sub = [slice(t0 + m * SUB, t0 + (m + 1) * SUB) for m in range(nsub)]
        # 2a. the state before each sub-chunk
        states = [bounds[:, c].float()]
        for sl in sub[:-1]:
            e = _excl_prod(wf[:, :, sl], 2, reverse=True)
            cl = e[:, :, 0] * wf[:, :, sl][:, :, 0]
            states.append(cl[..., None] * states[-1] + torch.einsum("bhsi,bhsj->bhij", kf[:, :, sl] * e, vf[:, :, sl]))
        # 2b. the sub-chunks, last first
        g = g_end[c]
        for m in range(nsub - 1, -1, -1):
            sl, s0 = sub[m], states[m]
            rs, ks, vs, ws, ds = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], wf[:, :, sl], dy[:, :, sl]
            cp = _excl_prod(ws, 2)
            e = _excl_prod(ws, 2, reverse=True)
            cl = cp[:, :, -1] * ws[:, :, -1]
            p = torch.einsum("bhtj,bhij->bhti", ds, s0)
            q = torch.einsum("bhtj,bhij->bhti", vs, g)
            a = torch.einsum("bhqj,bhsj->bhqs", ds, vs)  # a[q][s] = dy_q . v_s
            adiag = torch.diagonal(a, dim1=2, dim2=3)[..., None]  # [B, H, L, 1]
            gamma = (g * s0).sum(-1)[:, :, None, :]  # [B, H, 1, N]
            # pair decays W[t][s] = prod_{s < p < t} w_p (zero unless s < t), by running products
            wp = torch.zeros((b, h, SUB, SUB, n), dtype=torch.float32, device=dev)
            for s in range(SUB - 1):
                wp[:, :, s + 1:, s] = _excl_prod(ws[:, :, s + 1:], 2)
            wp = wp * lower[None, None, :, :, None]
            uu = wp * ks[:, :, None, :, :]  # uu[t][s] = W[t][s] k_s
            vv = wp * rs[:, :, :, None, :]  # vv[q][t] = W[q][t] r_q
            x = torch.einsum("bhtsi,bhqs->bhtqi", uu, a)  # X[t][q]
            xdiag = torch.diagonal(x, dim1=2, dim2=3).permute(0, 1, 3, 2)
            grads["r"][:, :, sl] = cp * p + xdiag + uf * ks * adiag
            grads["k"][:, :, sl] = e * q + torch.einsum("bhqti,bhqt->bhti", vv, a) + uf * rs * adiag
            grads["w"][:, :, sl] = (
                cp * e * gamma
                + e * torch.einsum("bhtsi,bhsi->bhti", uu, q)
                + cp * torch.einsum("bhqti,bhqi->bhti", vv, p)
                + torch.einsum("bhqti,bhtqi->bhti", vv, x)
            )
            du_parts[:, c] += (rs * ks * adiag).sum(2)
            bmat = torch.einsum("bhqti,bhti->bhtq", vv, ks) + (rs * uf * ks).sum(-1)[..., None] * eye
            grads["v"][:, :, sl] = torch.einsum("bhti,bhij->bhtj", ks * e, g) + torch.einsum("bhtq,bhqj->bhtj", bmat, ds)
            g = cl[..., None] * g + torch.einsum("bhsi,bhsj->bhij", rs * cp, ds)
    dr, dk, dv, dw = (grads[name][:, :, :t].permute(0, 2, 1, 3).contiguous().to(x.dtype) for name, x in zip("rkvw", (r, k, v, w)))
    du = torch.zeros((h, n), dtype=torch.float32, device=dev)
    for bb in range(b):
        for c in range(nc):
            du += du_parts[bb, c]
    return dr, dk, dv, dw, du, g
