"""Feed-forward blocks: dense (GELU / SwiGLU / GeGLU / relu²) and mixture-of-experts.

Port of ``repro.models.ffn``, function for function.  The large products
stay ``torch.matmul`` / ``torch.einsum``, as the JAX package leaves them to
XLA; MoE has no Pallas kernel there, so its dispatch (sort, scatter,
``index_add``) is plain torch too.  Two MoE dispatch implementations,
chosen by ``MoEConfig.impl``:

* ``einsum``: GShard's grouped dispatch / combine one-hot einsums over
  groups of :data:`MOE_GROUP_SIZE` tokens, each expert taking at most
  :func:`_capacity` tokens of a group; a choice past it drops.
* ``gather``: one slot table of ``E x C`` rows filled by a scatter, the
  experts' outputs summed back per token by ``index_add``.

Where the libraries differ, the port follows JAX: the top-k indices come
from a stable descending sort (``lax.top_k`` ranks equal values lowest
index first; ``torch.topk`` does not), and a slot past the capacity gets
a zero one-hot row (``jax.nn.one_hot``) where ``F.one_hot`` would raise.
Arctic's dense residual (``MoEConfig.parallel_dense``) runs a dense FFN
beside the experts.  On a mesh (DTensor arguments) :func:`moe_ffn` raises:
expert parallelism over ``model`` waits for ROADMAP queue 1, item 21.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_leaves
from .config import ModelConfig, MoEConfig, torch_dtype
from .layers import activation_fn, dense_init, gelu

Params = Dict[str, torch.Tensor]

MOE_GROUP_SIZE = 512  # tokens per dispatch group (GShard "G" dimension)

MOE_ON_A_MESH = (
    "the mixture-of-experts FFN on a mesh (DTensor arguments) is not ported yet: expert "
    "parallelism over model waits for ROADMAP queue 1, item 21"
)


def init_dense_ffn(
    cfg: ModelConfig,
    d_ff: Optional[int] = None,
    *,
    generator: Optional[torch.Generator],
    device: torch.device,
) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    pdt = torch_dtype(cfg.param_dtype)
    kw = dict(dtype=pdt, generator=generator, device=device)
    if cfg.activation in ("swiglu", "geglu"):
        params = {
            "w_gate": dense_init((d, f), **kw),
            "w_up": dense_init((d, f), **kw),
            "w_down": dense_init((f, d), in_axis_size=f, **kw),
        }
    else:
        params = {
            "w_up": dense_init((d, f), **kw),
            "w_down": dense_init((f, d), in_axis_size=f, **kw),
        }
    if cfg.use_bias_mlp:
        params["b_up"] = torch.zeros(f, dtype=pdt, device=device)
        params["b_down"] = torch.zeros(d, dtype=pdt, device=device)
    return params


def dense_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.activation in ("swiglu", "geglu"):
        inner = F.silu if cfg.activation == "swiglu" else gelu
        gate = inner(x @ params["w_gate"].to(dt))
        up = x @ params["w_up"].to(dt)
        if cfg.use_bias_mlp:
            up = up + params["b_up"].to(dt)
        h = gate * up
    else:
        h = x @ params["w_up"].to(dt)
        if cfg.use_bias_mlp:
            h = h + params["b_up"].to(dt)
        h = activation_fn(cfg.activation)(h)
    y = h @ params["w_down"].to(dt)
    if cfg.use_bias_mlp:
        y = y + params["b_down"].to(dt)
    return y


def init_moe(cfg: ModelConfig, *, generator: Optional[torch.Generator], device: torch.device) -> Params:
    """The router (float32 ``[d, E]``), the stacked experts ``[E, d, f]`` /
    ``[E, f, d]`` (``w_gate`` too under a GLU activation) and, for Arctic's
    ``parallel_dense``, a dense FFN beside them."""
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    kw = dict(dtype=torch_dtype(cfg.param_dtype), generator=generator, device=device)
    params: Params = {
        "router": dense_init((d, e), dtype=torch.float32, generator=generator, device=device),
        "w_up": dense_init((e, d, f), in_axis_size=d, **kw),
        "w_down": dense_init((e, f, d), in_axis_size=f, **kw),
    }
    if cfg.activation in ("swiglu", "geglu"):
        params["w_gate"] = dense_init((e, d, f), in_axis_size=d, **kw)
    if cfg.moe.parallel_dense:
        params["dense"] = init_dense_ffn(cfg, generator=generator, device=device)
    return params


def _router_probs(params: Params, x_flat, moe: MoEConfig):
    """Router softmax in float32 and the top-k choices -> (probs [T, E],
    gates [T, k], expert_idx [T, k]).

    The indices are taken without gradient, lowest index first among equal
    probabilities, as ``lax.top_k`` takes them; the gates are read back
    from the differentiable ``probs`` (so the router learns) and
    renormalised to sum to 1."""
    logits = x_flat.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices
    expert_idx = order[:, : moe.num_experts_per_tok]
    gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _aux_loss(probs, expert_idx, moe: MoEConfig):
    """Switch-style load-balancing loss: E * sum_e f_e * P_e."""
    e = moe.num_experts
    counts = torch.bincount(expert_idx.reshape(-1), minlength=e).float()
    f = counts / counts.sum().clamp_min(1.0)
    return e * torch.sum(f * probs.mean(dim=0))


def _capacity(tg: int, moe: MoEConfig) -> int:
    c = math.ceil(moe.capacity_factor * moe.num_experts_per_tok * tg / moe.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _expert_ffn(params: Params, xs, cfg: ModelConfig):
    """xs: (..., E, C, D) -> (..., E, C, D) through per-expert weights."""
    dt = cfg.compute_dtype
    if cfg.activation in ("swiglu", "geglu"):
        inner = F.silu if cfg.activation == "swiglu" else gelu
        gate = inner(torch.einsum("...ecd,edf->...ecf", xs, params["w_gate"].to(dt)))
        up = torch.einsum("...ecd,edf->...ecf", xs, params["w_up"].to(dt))
        h = gate * up
    else:
        h = activation_fn(cfg.activation)(torch.einsum("...ecd,edf->...ecf", xs, params["w_up"].to(dt)))
    return torch.einsum("...ecf,efd->...ecd", h, params["w_down"].to(dt))


def _moe_einsum(params: Params, x_flat, cfg: ModelConfig):
    """GShard grouped dispatch / combine -> (y [T, D], aux)."""
    moe = cfg.moe
    t, d = x_flat.shape
    tg = min(MOE_GROUP_SIZE, t)
    if t % tg:
        raise ValueError(f"token count {t} not divisible by group size {tg}")
    g, c, e, k = t // tg, _capacity(tg, moe), moe.num_experts, moe.num_experts_per_tok

    probs, gates, expert_idx = _router_probs(params, x_flat, moe)
    aux = _aux_loss(probs, expert_idx, moe)

    # per-group capacity assignment; dispatch and combine in the compute dtype
    dt = cfg.compute_dtype
    idx_g = expert_idx.reshape(g, tg, k)
    gate_g = gates.reshape(g, tg, k).to(dt)
    slots = torch.arange(c, device=x_flat.device)
    dispatch = torch.zeros((g, tg, e, c), dtype=dt, device=x_flat.device)
    combine = torch.zeros((g, tg, e, c), dtype=dt, device=x_flat.device)
    counts = torch.zeros((g, e), dtype=torch.int32, device=x_flat.device)
    for j in range(k):  # choice j queues behind choices 0..j-1 of the whole group
        onehot = F.one_hot(idx_g[:, :, j], e).int()  # (g, tg, e)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        pos_of_token = (pos * onehot).sum(dim=-1)  # (g, tg)
        keep = pos_of_token < c
        slot_onehot = (pos_of_token[..., None] == slots).to(dt)  # a zero row past the capacity
        contrib = onehot.to(dt)[..., None] * slot_onehot[:, :, None, :] * keep[..., None, None].to(dt)
        dispatch = dispatch + contrib
        combine = combine + contrib * gate_g[:, :, j][..., None, None]

    xs = torch.einsum("gtec,gtd->gecd", dispatch, x_flat.reshape(g, tg, d))  # (g, e, c, d)
    ys = _expert_ffn(params, xs, cfg)
    y_g = torch.einsum("gtec,gecd->gtd", combine, ys)
    return y_g.reshape(t, d), aux


def _moe_gather(params: Params, x_flat, cfg: ModelConfig):
    """Sort / gather dispatch, no one-hot products -> (y [T, D], aux)."""
    moe = cfg.moe
    t, d = x_flat.shape
    e, k = moe.num_experts, moe.num_experts_per_tok
    c = _capacity(t, moe)

    probs, gates, expert_idx = _router_probs(params, x_flat, moe)
    aux = _aux_loss(probs, expert_idx, moe)

    flat_expert = expert_idx.reshape(-1)  # (t*k,)
    flat_gate = gates.reshape(-1).float()
    flat_token = torch.arange(t, device=x_flat.device).repeat_interleave(k)

    # position of each (token, choice) in its expert's queue
    pos = torch.cumsum(F.one_hot(flat_expert, e), dim=0) - 1  # (t*k, e)
    pos_of = pos.gather(-1, flat_expert[:, None])[:, 0]
    keep = pos_of < c
    slot = torch.where(keep, flat_expert * c + pos_of, e * c)  # overflow -> the spill row

    # token, gate and fill of each (expert, capacity) slot; row e*c takes the overflow
    def table(dtype, src):
        return torch.zeros(e * c + 1, dtype=dtype, device=x_flat.device).scatter(0, slot, src)[: e * c]

    token_of_slot = table(torch.long, flat_token)
    gate_of_slot = table(torch.float32, flat_gate)
    filled = table(torch.bool, keep)

    xs = x_flat[token_of_slot] * filled[:, None].to(x_flat.dtype)  # an empty slot reads token 0, zeroed
    ys = _expert_ffn(params, xs.reshape(1, e, c, d), cfg)[0]  # (e, c, d)
    weighted = ys.reshape(e * c, d) * gate_of_slot[:, None].to(ys.dtype)
    out = torch.zeros((t, d), dtype=weighted.dtype, device=x_flat.device).index_add(0, token_of_slot, weighted)
    return out.to(x_flat.dtype), aux


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over x: [B, S, D] -> ([B, S, D], aux loss)."""
    from torch.distributed.tensor import DTensor

    assert cfg.moe is not None
    if any(isinstance(t, DTensor) for t in (x, *tree_leaves(params))):
        raise NotImplementedError(MOE_ON_A_MESH)
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    if cfg.moe.impl == "einsum":
        y, aux = _moe_einsum(params, x_flat, cfg)
    elif cfg.moe.impl == "gather":
        y, aux = _moe_gather(params, x_flat, cfg)
    else:
        raise ValueError(f"unknown moe impl {cfg.moe.impl!r}")
    y = y.reshape(b, s, d)
    if cfg.moe.parallel_dense:
        y = y + dense_ffn(params["dense"], x, cfg)
    return y, aux
