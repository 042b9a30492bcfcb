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
beside the experts.  On a mesh :func:`moe_ffn` runs expert parallel: each
rank its rows' tokens through its experts, on its local shards.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig, torch_dtype
from .layers import activation_fn, dense_init, gelu

Params = Dict[str, torch.Tensor]

MOE_GROUP_SIZE = 512  # tokens per dispatch group (GShard "G" dimension)


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
    """The dense FFN of ``x`` [B, S, D].  Under sequence parallelism the
    sequence is gathered first for tensor-parallel weights; weights whole
    on every ``model`` rank take the rank's own positions, on its local
    shards (position-wise: nothing moves, and no rank computes another's)."""
    from ..distributed.act_sharding import on_local_shards, replicate_seq, whole_over_sequence

    keys = sorted(params)
    if whole_over_sequence(x, [params[k] for k in keys]):
        positions = (0, 1)  # rows over data, the sequence over model
        return on_local_shards(lambda x, *w: _dense_ffn(dict(zip(keys, w)), x, cfg), (x, *(params[k] for k in keys)),
                               (positions, *((None, None),) * len(keys)), (positions,))
    return _dense_ffn(params, replicate_seq(x), cfg)


def _dense_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
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


def _route(x_flat, router, moe: MoEConfig):
    """:func:`_router_probs` and the choices each expert got -> (probs,
    gates, expert_idx, counts [E] float32)."""
    probs, gates, expert_idx = _router_probs({"router": router}, x_flat, moe)
    return probs, gates, expert_idx, _counts(expert_idx, moe)


def _counts(expert_idx, moe: MoEConfig):
    """The choices each expert got, float32 [E]: ``bincount`` of the ids,
    which are below E, added into E slots so that the shape does not
    depend on the values (a fake tensor of the dry run has none)."""
    idx = expert_idx.reshape(-1)
    ones = torch.ones(idx.shape, dtype=torch.int64, device=idx.device)
    return torch.zeros(moe.num_experts, dtype=torch.int64, device=idx.device).index_add_(0, idx, ones).float()


def _aux_loss(probs, expert_idx, moe: MoEConfig, counts=None):
    """Switch-style load-balancing loss: E * sum_e f_e * P_e, with ``f``
    (from the choices each expert got, ``counts`` where given) and ``P``
    over every token of the batch.  On a mesh both are partial over
    ``data`` (each rank's rows) and are reduced before the product: a mean
    of per-rank losses would be another number."""
    from ..distributed.act_sharding import reduce_partial

    counts = _counts(expert_idx, moe) if counts is None else counts
    counts, p = reduce_partial(counts), reduce_partial(probs.mean(dim=0))
    f = counts / counts.sum().clamp_min(1.0)
    return moe.num_experts * torch.sum(f * p)


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


def _queue_positions(expert_idx, tg: int, e: int):
    """Each choice's place in its expert's queue of its group of ``tg``
    tokens, [T, k] -> [T, k]: choice j queues behind choices 0..j-1 of the
    whole group, then in token order."""
    t, k = expert_idx.shape
    g = t // tg
    idx_g = expert_idx.reshape(g, tg, k)
    counts = torch.zeros((g, e), dtype=torch.int32, device=expert_idx.device)
    out = []
    for j in range(k):
        onehot = F.one_hot(idx_g[:, :, j], e).int()  # (g, tg, e)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        out.append((pos * onehot).sum(dim=-1))  # (g, tg)
    return torch.stack(out, dim=-1).reshape(t, k)


def _moe_einsum(x_flat, gates, expert_idx, experts: Params, cfg: ModelConfig, *, tg: int, choices=None,
                row0: int = 0, e0: int = 0):
    """GShard grouped dispatch / combine of ``x_flat``'s tokens [t, D]
    (``gates``, ``expert_idx`` their choices) through the experts ``e0 ..
    e0 + n`` whose stacks ``experts`` holds -> y [t, D]: their part of the
    combine, all of it when they are all the experts.

    Groups are ``tg`` tokens and each expert takes at most
    :func:`_capacity` of a group's choices.  ``choices`` None: ``x_flat``'s
    rows are whole groups.  Else they lie within one group, whose every
    token's choices ``choices`` holds, ``x_flat``'s first row at ``row0``
    of them: the queue positions are taken over the whole group.  The
    rows of other ranks fill other slots, which stay zero here; an expert
    maps a zero row to zero (no bias), so the rank's part of the combine is
    the same either way."""
    moe = cfg.moe
    t, d = x_flat.shape
    e, k, n = moe.num_experts, moe.num_experts_per_tok, experts["w_up"].shape[0]
    c = _capacity(tg, moe)
    if choices is None:
        pos, g, rows = _queue_positions(expert_idx, tg, e), t // tg, tg
    else:
        pos, g, rows = _queue_positions(choices, tg, e)[row0 : row0 + t], 1, t

    # dispatch and combine in the compute dtype, the experts' slots only
    dt = cfg.compute_dtype
    idx_g, pos_g = expert_idx.reshape(g, rows, k), pos.reshape(g, rows, k)
    gate_g = gates.reshape(g, rows, k).to(dt)
    slots = torch.arange(c, device=x_flat.device)
    dispatch = torch.zeros((g, rows, n, c), dtype=dt, device=x_flat.device)
    combine = torch.zeros((g, rows, n, c), dtype=dt, device=x_flat.device)
    for j in range(k):
        onehot = F.one_hot(idx_g[:, :, j], e)[..., e0 : e0 + n].to(dt)  # (g, rows, n)
        keep = pos_g[:, :, j] < c
        slot_onehot = (pos_g[:, :, j][..., None] == slots).to(dt)  # a zero row past the capacity
        contrib = onehot[..., None] * slot_onehot[:, :, None, :] * keep[..., None, None].to(dt)
        dispatch = dispatch + contrib
        combine = combine + contrib * gate_g[:, :, j][..., None, None]

    xs = torch.einsum("gtec,gtd->gecd", dispatch, x_flat.reshape(g, rows, d))  # (g, n, c, d)
    ys = _expert_ffn(experts, xs, cfg)
    y_g = torch.einsum("gtec,gecd->gtd", combine, ys)
    return y_g.reshape(t, d)


def _moe_gather(x_flat, gates, expert_idx, experts: Params, cfg: ModelConfig, *, e0: int = 0):
    """Sort / gather dispatch of every token, no one-hot products, through
    the experts ``e0 .. e0 + n`` -> y [t, D], their part of the sum."""
    moe = cfg.moe
    t, d = x_flat.shape
    e, k, n = moe.num_experts, moe.num_experts_per_tok, experts["w_up"].shape[0]
    c = _capacity(t, moe)

    flat_expert = expert_idx.reshape(-1)  # (t*k,)
    flat_gate = gates.reshape(-1).float()
    flat_token = torch.arange(t, device=x_flat.device).repeat_interleave(k)

    # position of each (token, choice) in its expert's queue
    pos = torch.cumsum(F.one_hot(flat_expert, e), dim=0) - 1  # (t*k, e)
    pos_of = pos.gather(-1, flat_expert[:, None])[:, 0]
    keep = pos_of < c
    mine = (flat_expert >= e0) & (flat_expert < e0 + n)
    slot = torch.where(keep & mine, (flat_expert - e0) * c + pos_of, n * c)  # overflow -> the spill row

    # token, gate and fill of each (expert, capacity) slot; row n*c takes the overflow
    def table(dtype, src):
        return torch.zeros(n * c + 1, dtype=dtype, device=x_flat.device).scatter(0, slot, src)[: n * c]

    token_of_slot = table(torch.long, flat_token)
    gate_of_slot = table(torch.float32, flat_gate)
    filled = table(torch.bool, keep)

    xs = x_flat[token_of_slot] * filled[:, None].to(x_flat.dtype)  # an empty slot reads token 0, zeroed
    ys = _expert_ffn(experts, xs.reshape(1, n, c, d), cfg)[0]  # (n, c, d)
    weighted = ys.reshape(n * c, d) * gate_of_slot[:, None].to(ys.dtype)
    out = torch.zeros((t, d), dtype=weighted.dtype, device=x_flat.device).index_add(0, token_of_slot, weighted)
    return out.to(x_flat.dtype)


def _row_pieces(x) -> int:
    """How many pieces a DTensor's rows (dim 0) are split into over its
    mesh: 1 for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return 1
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(0))


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over x: [B, S, D] -> ([B, S, D], aux loss).

    On a mesh (DTensor arguments: x's rows over ``data``, the expert stacks
    ``[E, D, F]`` over ``model`` on E, as ``_MOE_RULES`` lay them and the
    step leaves them) each rank routes its rows, and dispatches them only
    to its experts (expert parallelism): the ``(g, e, c, d)`` activations
    are made, run and combined on the rank and never move; the combine is
    a partial sum over ``model``, reduced once where the residual adds it.
    The router input is replicated over ``model`` and bit-equal there (the
    sequence shards of the normed residual all-gathered, or under no
    sequence parallelism an all-reduced residual: the same bytes on every
    rank), so every ``model`` rank takes the same choices.  Where a group spans ``data``
    ranks the rank's queue positions depend on the other ranks' choices:
    the [T, k] choices are all-gathered over ``data`` (the one collective
    this adds, a few KiB) and the positions taken over the whole group.
    Where E does not divide ``model`` the stacks come whole (the
    few-expert width placement, gathered by the step), and every ``model``
    rank runs every expert.  The ``gather`` dispatch fills one slot table
    from every token, so it takes the rows whole (gathered over ``data``).
    """
    from ..distributed.act_sharding import mesh_coordinate, on_local_shards, replicate_seq

    assert cfg.moe is not None
    moe = cfg.moe
    if moe.impl not in ("einsum", "gather"):
        raise ValueError(f"unknown moe impl {moe.impl!r}")
    x = replicate_seq(x)  # under sequence parallelism: the whole sequence for the router and dispatch
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    rows, whole, experts = (0, None), (None, None), (None, 0)
    probs, gates, expert_idx, counts = on_local_shards(
        lambda x, w: _route(x, w, moe), (x_flat, params["router"]), (rows, whole), (rows,) * 3 + (whole,),
        partial=(3,),
    )
    aux = _aux_loss(probs, expert_idx, moe, counts)
    keys = [k for k in ("w_gate", "w_up", "w_down") if k in params]
    model = mesh_coordinate(x, "model")

    def e0(w):  # the first of the rank's experts
        return model * w.shape[0] if w.shape[0] < moe.num_experts else 0

    if moe.impl == "einsum":
        tg = min(MOE_GROUP_SIZE, t)
        if t % tg:
            raise ValueError(f"token count {t} not divisible by group size {tg}")
        t_rank = t // _row_pieces(expert_idx)
        choices, row0 = None, 0
        if t_rank % tg:
            if tg % t_rank:
                raise ValueError(f"a rank's {t_rank} tokens neither hold whole groups of {tg} nor lie in one")
            # the group spans data ranks: all-gather its [T, k] choices over data
            choices, row0 = expert_idx.full_tensor(), mesh_coordinate(x, "data") * t_rank

        def run(x, g, i, ch, *w):
            stacks = dict(zip(keys, w))
            return _moe_einsum(x, g, i, stacks, cfg, tg=tg, choices=ch, row0=row0, e0=e0(w[0]))

        args, dims = (x_flat, gates, expert_idx, choices), (rows, rows, rows, whole)
    else:
        def run(x, g, i, *w):
            return _moe_gather(x, g, i, dict(zip(keys, w)), cfg, e0=e0(w[0]))

        # the slot table spans every token: the rows whole on each rank
        args, dims = (x_flat, gates, expert_idx), (whole,) * 3
    y = on_local_shards(run, (*args, *(params[k] for k in keys)), (*dims, *(experts,) * len(keys)),
                        (dims[0],), partial=(0,))
    y = y.reshape(b, s, d)
    if moe.parallel_dense:
        y = y + dense_ffn(params["dense"], x, cfg)
    return y, aux
