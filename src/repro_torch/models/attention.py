"""Grouped-query attention with full/sliding-window masks and KV caching.

Port of ``repro.models.attention``.  Prefill attention
(:func:`attention_forward`) always goes through
:func:`repro_torch.kernels.flash_attention.flash_attention`: the hand-written
CUDA kernel on the card, its plain version on the CPU.  Decode
(:func:`attention_decode`: one query against the rolling cache, whose empty
slots carry position -1) uses the dense :func:`sdpa`, as the JAX package
does; the kernel has no mask for empty slots.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import has_values
from ..kernels.flash_attention import flash_attention
from .config import ModelConfig, torch_dtype
from .layers import apply_rope, dense_init, softcap

Params = Dict[str, torch.Tensor]


def init_attention(
    cfg: ModelConfig, *, generator: Optional[torch.Generator], device: torch.device
) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    q_out = cfg.num_heads * hd
    kv_out = cfg.num_kv_heads * hd
    pdt = torch_dtype(cfg.param_dtype)
    kw = dict(dtype=pdt, generator=generator, device=device)
    params = {
        "wq": dense_init((d, q_out), **kw),
        "wk": dense_init((d, kv_out), **kw),
        "wv": dense_init((d, kv_out), **kw),
        "wo": dense_init((q_out, d), in_axis_size=q_out, **kw),
    }
    if cfg.use_bias_attn:
        params["bq"] = torch.zeros(q_out, dtype=pdt, device=device)
        params["bk"] = torch.zeros(kv_out, dtype=pdt, device=device)
        params["bv"] = torch.zeros(kv_out, dtype=pdt, device=device)
        params["bo"] = torch.zeros(d, dtype=pdt, device=device)
    return params


def _whole_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """A projection ``[B, S, heads * hd]`` laid on whole heads before the
    reshape to ``[B, S, heads, hd]``: on a mesh whose ``model`` axis shards
    its last dim (the rule shards whenever the axis divides ``heads * hd``)
    but does not divide ``heads``, replicated over ``model``, as GSPMD
    reshards the JAX step; as it is otherwise."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or "model" not in (x.device_mesh.mesh_dim_names or ()):
        return x
    i = x.device_mesh.mesh_dim_names.index("model")
    p = x.placements[i]
    if not (p.is_shard() and p.dim % x.ndim == x.ndim - 1 and heads % x.device_mesh.size(i)):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if j == i else q for j, q in enumerate(x.placements)))


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    dt = cfg.compute_dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.use_bias_attn:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = _whole_heads(q, cfg.num_heads).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = _whole_heads(k, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = _whole_heads(v, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _out_proj(params: Params, attn_out: torch.Tensor, cfg: ModelConfig):
    """``attn_out`` [B, S, H * hd], its heads flattened where the kernel ran
    (on a mesh: on the rank's local heads, so the gradient the row-parallel
    ``wo`` hands back, sharded over ``model``, meets no reshape of heads
    that do not divide the axis)."""
    dt = cfg.compute_dtype
    y = attn_out @ params["wo"].to(dt)
    if cfg.use_bias_attn:
        y = y + params["bo"].to(dt)
    return y


def sdpa(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KVH, hd]
    v: torch.Tensor,  # [B, Sk, KVH, hd]
    *,
    q_positions: torch.Tensor,  # [Sq] absolute positions of queries
    k_positions: torch.Tensor,  # [Sk] absolute positions of keys (-1 = empty slot)
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Fully materialized masked attention with GQA head grouping.

    The dense form of ``repro.models.attention.sdpa``: logits in float32
    from the compute-dtype operands, probabilities cast back to v's dtype
    for the second product.  Causality and windowing come from positions.
    """
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * hd ** -0.5
    logits = softcap(logits, logit_softcap)
    mask = k_positions[None, :] <= q_positions[:, None]  # causal
    mask &= k_positions[None, :] >= 0  # empty cache slots
    if window is not None:
        mask &= k_positions[None, :] > q_positions[:, None] - window
    logits = torch.where(mask, logits, torch.full((), -1e30, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _kv_head_of_rank(q, cfg: ModelConfig) -> Optional[int]:
    """On a mesh whose ``model`` axis divides the query heads but not the
    kv heads, while the kv heads divide it (recurrentgemma-9b's one kv head:
    16 query heads over 1), the one kv head that all the rank's query heads
    read; None elsewhere (heads split alike, or no split of the heads)."""
    from torch.distributed.tensor import DTensor

    from ..distributed.act_sharding import mesh_coordinate

    if not isinstance(q, DTensor) or "model" not in (q.device_mesh.mesh_dim_names or ()):
        return None
    m, h, kvh = q.device_mesh.size(q.device_mesh.mesh_dim_names.index("model")), cfg.num_heads, cfg.num_kv_heads
    if m == 1 or h % m or kvh % m == 0 or m % kvh:
        return None
    return mesh_coordinate(q, "model") * kvh // m


def attention_forward(
    params: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ModelConfig,
    *,
    window: Optional[int],
    positions: Optional[torch.Tensor] = None,  # [S]; must be arange(S)
    return_cache: bool = False,
    cache_len: Optional[int] = None,  # total decode capacity (>= S)
):
    """Training / prefill attention through the flash kernel; optionally
    returns the KV cache.

    The kernel masks by index from 0, so ``positions`` must be
    ``arange(S)``, which is what prefill passes; anything else raises.
    """
    from ..distributed.act_sharding import on_local_shards, replicate_seq

    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    elif has_values(positions) and not torch.equal(positions, torch.arange(S, device=positions.device)):
        raise ValueError("attention_forward's flash path needs positions == arange(S)")
    x = replicate_seq(x)  # under sequence parallelism: the whole sequence for the projections
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    # on a mesh the kernel runs on the rank's rows and heads
    heads = ((0, 2),) * 3
    kv = _kv_head_of_rank(q, cfg)
    if kv is None:
        def attend(q, k, v):
            return flash_attention(q, k, v, causal=True, window=window, logit_softcap=cfg.attn_logit_softcap)
    else:  # k and v whole on every model rank; the rank's query heads read one kv head
        heads = heads[:1] + ((0, None),) * 2

        def attend(q, k, v):
            k, v = k[:, :, kv : kv + 1].contiguous(), v[:, :, kv : kv + 1].contiguous()
            return flash_attention(q, k, v, causal=True, window=window, logit_softcap=cfg.attn_logit_softcap)

    out = on_local_shards(lambda q, k, v: attend(q, k, v).flatten(2), (q, k, v), heads, heads[:1])
    y = _out_proj(params, out, cfg)
    if not return_cache:
        return y, None

    def cache_of(k, v):
        c = make_cache_from_prefill(k, v, positions, window=window, max_len=cache_len or S)
        return c["k"], c["v"], c["pos"]

    ck, cv, cpos = on_local_shards(cache_of, (k, v), heads[:2], (*heads[:2], (None, None)))
    return y, {"k": ck, "v": cv, "pos": cpos}


# -- KV cache ------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, window: Optional[int], device: torch.device
):
    """Empty rolling cache.  ``size = min(window, max_len)`` slots."""
    size = max_len if window is None else min(window, max_len)
    dt = cfg.compute_dtype
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def make_cache_from_prefill(
    k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor, *, window: Optional[int], max_len: int
):
    """Cache holding the (windowed tail of the) prefill keys/values.

    Sized for ``max_len`` total positions and laid out so that absolute
    position ``p`` occupies slot ``p % size``: the invariant
    :func:`attention_decode` relies on when it writes new tokens.
    ``positions`` are the prefill's, ``arange(n)``.
    """
    n = k.shape[1]
    size = max_len if window is None else min(window, max_len)
    # prefill's positions are arange(n): the first one kept is n - size
    first = max(n - size, 0)
    positions = positions.to(torch.int32)
    if n > size:  # keep only the windowed tail
        k, v, positions = k[:, -size:], v[:, -size:], positions[-size:]
        n = size
    if n < size:  # pad to capacity; empty slots flagged with pos = -1
        pad = size - n
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        positions = torch.nn.functional.pad(positions, (0, pad), value=-1)
    # roll so that the entry holding absolute position p sits at slot p % size
    shift = first % size if first > 0 else 0
    return {
        "k": torch.roll(k, shift, dims=1),
        "v": torch.roll(v, shift, dims=1),
        "pos": torch.roll(positions, shift, dims=0),
    }


def attention_decode(
    params: Params,
    x_t: torch.Tensor,  # [B, 1, D]
    cache: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    position: int,  # absolute position of the new token
    *,
    window: Optional[int],
):
    """One decode step against a rolling KV cache.

    Unlike the JAX function, this writes the new key, value and position
    into ``cache``'s tensors in place (a copy of the whole cache per step
    would move its every byte) and returns the same dict.
    """
    from ..distributed.act_sharding import on_local_shards

    q, k_new, v_new = _project_qkv(params, x_t, cfg)
    pos_arr = torch.full((1,), position, dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, pos_arr, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k_new = apply_rope(k_new, pos_arr, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    size = cache["k"].shape[1]
    slot = position % size  # rolling for windows; affine for full caches

    def attend(q, k_new, v_new, ck, cv, cpos):
        ck[:, slot] = k_new[:, 0]
        cv[:, slot] = v_new[:, 0]
        cpos[slot] = position
        return sdpa(
            q, ck, cv, q_positions=pos_arr, k_positions=cpos,
            window=window, logit_softcap=cfg.attn_logit_softcap,
        ).flatten(2)

    # on a mesh: the rank's rows and heads, its cache shard written in place
    heads = (0, 2)
    out = on_local_shards(
        attend, (q, k_new, v_new, cache["k"], cache["v"], cache["pos"]),
        (heads,) * 5 + ((None, None),), (heads,), in_place=(3, 4, 5),
    )
    return _out_proj(params, out, cfg), cache
