"""Decoder stack for the attention (ATTN, LOCAL) and RWKV6 layer kinds.

Port of ``repro.models.transformer``: plain functions over the JAX
package's nested parameter dict, with the same keys and a leading stacked
group axis, so every leaf maps one-to-one to a JAX leaf by its
``jax.tree_util.keystr`` path.  ``lax.scan`` over the groups becomes a loop
over the group index.

Entry points:

* :func:`init_params`
* :func:`forward`      -- full forward -> (logits, aux)
* :func:`loss_fn`      -- next-token cross-entropy (+ z-loss, MoE aux) for training
* :func:`prefill`      -- forward + per-layer KV caches
* :func:`decode_step`  -- one token through the cache

Training takes gradients through autograd; attention's comes from the
flash backward kernel (:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`),
the WKV recurrence's from the WKV backward kernel
(:class:`~repro_torch.kernels.rwkv6_wkv.WKV6Fn`), the RG-LRU's from the
RG-LRU scan's backward kernel
(:class:`~repro_torch.kernels.rglru_scan.RGLRUScanFn`).
``cfg.remat`` "full" recomputes each group in the backward pass
(``torch.utils.checkpoint``, as ``jax.checkpoint``), all but the WKV
recurrence, whose recomputation takes the first forward's outputs
(:func:`~repro_torch.kernels.rwkv6_wkv.remat_contexts`); "dots" is treated
as "full": the JAX policy also saves the matmul outputs, so the two differ
in memory only, never in values.

RWKV6 layers (rwkv6-7b) train and serve: the WKV recurrence runs in the
hand-written kernels (:mod:`repro_torch.kernels.rwkv6_wkv`), and decode
updates their state in place.
Recurrent (RG-LRU) layers (recurrentgemma-9b, with its local-attention
layers at head_dim 256) train and serve: the recurrence runs in the
hand-written kernels :mod:`repro_torch.kernels.rglru_scan` (its gradient
through :class:`~repro_torch.kernels.rglru_scan.RGLRUScanFn`, whose
forward runs again under remat: the kernel gives the same bits on every
call), local attention's gradient in the flash backward at head_dim 256,
and decode updates the LRU state and conv tail in place.  Mixture-of-experts
FFNs (mixtral-8x22b, arctic-480b) train and serve through
:func:`~repro_torch.models.ffn.moe_ffn` (plain torch, as the JAX package
leaves them to XLA); their routers' aux losses are summed over the layers
(through the checkpoint under remat) into :func:`forward`'s second output.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from ..kernels.rwkv6_wkv import remat_contexts
from ..tree import tree_leaves, tree_map, tree_unflatten
from .attention import attention_decode, attention_forward, init_attention, init_cache
from .config import ATTN, LOCAL, RECURRENT, RWKV, ModelConfig
from .ffn import dense_ffn, init_dense_ffn, init_moe, moe_ffn
from .layers import apply_norm, dense_init, embed_init, init_norm, softcap
from .rglru import init_rglru_block, init_rglru_state, rglru_block
from .rwkv6 import channel_mix, init_rwkv_block, init_rwkv_state, time_mix

Params = Dict[str, Any]

IGNORE_LABEL = -100


def _check_kind(kind: str) -> None:
    """The layer kinds a pass (forward, prefill, decode) can run."""
    if kind not in (ATTN, LOCAL, RECURRENT, RWKV):
        raise ValueError(kind)


# -- init --------------------------------------------------------------------------


def _init_layer(kind: str, cfg: ModelConfig, generator, device) -> Params:
    kw = dict(generator=generator, device=device)
    params: Params = {"norm1": init_norm(cfg, device=device), "norm2": init_norm(cfg, device=device)}
    if kind in (ATTN, LOCAL):
        params["attn"] = init_attention(cfg, **kw)
        if cfg.moe is not None and kind == ATTN:
            params["ffn"] = init_moe(cfg, **kw)
        else:
            params["ffn"] = init_dense_ffn(cfg, **kw)
    elif kind == RECURRENT:
        params["rec"] = init_rglru_block(cfg, **kw)
        params["ffn"] = init_dense_ffn(cfg, **kw)
    elif kind == RWKV:
        params["rwkv"] = init_rwkv_block(cfg, **kw)
    else:
        raise ValueError(kind)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_layers(make, n: int):
    """``n`` trees from ``make()`` (called ``n`` times in order, so the
    values do not depend on the way taken), stacked on a leading axis, in
    whichever of two ways holds less at once: into the stacked tree as
    each is made, which holds the stack and one tree (rwkv6-7b's 32 layers
    would otherwise hold its 30 GB of parameters twice); or all ``n``
    made, then stacked a leaf at a time, each leaf's sources dropped as it
    is stacked, which holds the trees and one stacked leaf: less where a
    leaf is under 1/n of a tree (arctic-480b's two layers: 54.4 + 17.8 GB
    against 54.4 + 27.2)."""
    tree = make()
    sizes = [t.numel() * t.element_size() for t in tree_leaves(tree)]
    if n * max(sizes) >= sum(sizes):
        out = tree_map(lambda t: t.new_empty((n, *t.shape)), tree)
        for i in range(n):
            if i:
                tree = make()
            tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
            del tree
        return out
    like = tree_map(lambda t: None, tree)
    flat = [tree_leaves(tree)] + [tree_leaves(make()) for _ in range(n - 1)]
    del tree
    stacked = []
    for j in range(len(sizes)):
        stacked.append(torch.stack([leaves[j] for leaves in flat]))
        for leaves in flat:
            leaves[j] = None
    return tree_unflatten(like, stacked)


def init_params(
    cfg: ModelConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Params:
    """Random parameters, drawn from ``generator`` (which must live on
    ``device``).  On the ``meta`` device only shapes and dtypes are made.

    Embedding tables stay float32, as in the JAX package.
    """
    device = resolve_device(device)
    kw = dict(generator=generator, device=device)
    params: Params = {
        "embed": embed_init((cfg.vocab_size, cfg.d_model), **kw),
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), **kw)
    if cfg.frontend in ("patch", "frame"):
        params["frontend_proj"] = dense_init((cfg.frontend_dim, cfg.d_model), **kw)
    if cfg.num_groups > 0:
        params["groups"] = {
            f"slot{s}": _stack_layers(lambda kind=kind: _init_layer(kind, cfg, **kw), cfg.num_groups)
            for s, kind in enumerate(cfg.pattern)
        }
    if cfg.remainder:
        params["remainder"] = [_init_layer(kind, cfg, **kw) for kind in cfg.remainder]
    return params


# -- blocks ----------------------------------------------------------------------


def _layer_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    if kind == LOCAL:
        return cfg.local_window
    if kind == ATTN:
        return cfg.window
    return None


def _ffn(params: Params, h, kind: str, cfg: ModelConfig):
    """The layer's FFN -> (y, the router's aux loss, or None for a dense FFN)."""
    if cfg.moe is not None and kind == ATTN:
        return moe_ffn(params["ffn"], h, cfg)
    return dense_ffn(params["ffn"], h, cfg), None


def _residual(x, y):
    """``x + y``, a block's output added to the residual: on a mesh ``y``
    placed as the residual first (a row-parallel output's partial sums
    reduce-scattered onto the sequence shards under sequence parallelism,
    all-reduced otherwise)."""
    from ..distributed.act_sharding import shard_activations

    return x + shard_activations(y)


def _rwkv_block(params: Params, x, cfg: ModelConfig, state: Params, *, in_place: bool):
    """One RWKV6 layer from ``state`` -> (x, new state).  ``in_place``
    writes the new state into ``state``'s tensors (decode's cache)."""
    h = apply_norm(params["norm1"], x, cfg)
    tm_out, shift_att, wkv = time_mix(
        params["rwkv"], h, cfg, shift_state=state["shift_att"], wkv_state=state["wkv"],
        wkv_out=state["wkv"] if in_place else None,
    )
    x = _residual(x, tm_out)
    h = apply_norm(params["norm2"], x, cfg)
    cm_out, shift_ffn = channel_mix(params["rwkv"], h, cfg, shift_state=state["shift_ffn"])
    if in_place:
        state["shift_att"].copy_(shift_att)
        state["shift_ffn"].copy_(shift_ffn)
        return _residual(x, cm_out), state
    # the shifts are views of [B, T, D] activations: copy them out
    return _residual(x, cm_out), {"wkv": wkv, "shift_att": shift_att.clone(), "shift_ffn": shift_ffn.clone()}


def _recurrent_block(params: Params, x, cfg: ModelConfig, state: Params, *, in_place: bool):
    """One RG-LRU layer from ``state`` -> (x, new state): norm, the
    recurrent block, residual, norm, the dense (GeGLU) FFN, residual.
    ``in_place`` writes the new state into ``state``'s tensors (decode)."""
    h = apply_norm(params["norm1"], x, cfg)
    rec_out, state = rglru_block(params["rec"], h, cfg, state=state, in_place=in_place)
    x = _residual(x, rec_out)
    h = apply_norm(params["norm2"], x, cfg)
    return _residual(x, dense_ffn(params["ffn"], h, cfg)), state


def _block(params: Params, x, kind: str, cfg: ModelConfig, positions, cache_len):
    """One layer (forward or prefill).  Returns (x, cache or None, the
    router's aux loss or None)."""
    _check_kind(kind)
    if kind == RECURRENT:  # prefill starts from a zero state; max_len does not apply
        x, state = _recurrent_block(
            params, x, cfg, init_rglru_state(cfg, x.shape[0], device=x.device), in_place=False
        )
        return x, state if cache_len is not None else None, None
    if kind == RWKV:  # prefill starts from a zero state; max_len does not apply
        x, state = _rwkv_block(
            params, x, cfg, init_rwkv_state(cfg, x.shape[0], device=x.device), in_place=False
        )
        return x, state if cache_len is not None else None, None
    h = apply_norm(params["norm1"], x, cfg)
    attn_out, cache = attention_forward(
        params["attn"], h, cfg, window=_layer_window(kind, cfg), positions=positions,
        return_cache=cache_len is not None, cache_len=cache_len,
    )
    x = _residual(x, attn_out)
    h = apply_norm(params["norm2"], x, cfg)
    y, aux = _ffn(params, h, kind, cfg)
    return _residual(x, y), cache, aux


def _block_decode(params: Params, x_t, cache, kind: str, cfg: ModelConfig, position: int):
    """One layer, one token.  Returns (x_t, cache), the cache updated in place."""
    _check_kind(kind)
    if kind == RECURRENT:
        return _recurrent_block(params, x_t, cfg, cache, in_place=True)
    if kind == RWKV:
        return _rwkv_block(params, x_t, cfg, cache, in_place=True)
    h = apply_norm(params["norm1"], x_t, cfg)
    attn_out, cache = attention_decode(
        params["attn"], h, cache, cfg, position, window=_layer_window(kind, cfg)
    )
    x_t = _residual(x_t, attn_out)
    h = apply_norm(params["norm2"], x_t, cfg)
    return _residual(x_t, _ffn(params, h, kind, cfg)[0]), cache  # decode drops the aux loss, as JAX does


def _index(tree, i: int):
    """Group ``i`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# -- embedding -------------------------------------------------------------------


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token + stub-frontend embedding -> (x [B, S, D], positions [S])."""
    from ..distributed.act_sharding import shard_activations

    dt = cfg.compute_dtype
    if cfg.frontend == "frame":
        x = batch["frame_embeds"].to(dt) @ params["frontend_proj"].to(dt)
    else:
        x = _lookup(params["embed"].to(dt), batch["tokens"])
        if cfg.frontend == "patch":
            patches = batch["patch_embeds"].to(dt) @ params["frontend_proj"].to(dt)
            x = torch.cat([patches, x], dim=1)
    x = shard_activations(x)  # on a mesh: batch over data, the sequence over model, per the active context
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _lookup(table, tokens):
    """``table[tokens]``; on a mesh on each rank's rows of ``tokens``: where
    ``model`` shards the vocab, each rank looks up the tokens in its slice
    and the rows are a partial sum over ``model`` (nothing else adds to a
    row, so the sum is the row); otherwise with the whole table (DTensor
    has no sharding rule for the index backward)."""
    from ..distributed.act_sharding import mesh_coordinate, on_local_shards

    first = mesh_coordinate(table, "model")

    def look(table, tokens):
        v = table.shape[0]
        index = tokens - first * v
        mine = (index >= 0) & (index < v)
        return table[index.clamp(0, v - 1)] * mine[..., None].to(table.dtype)

    if _vocab_sharded(table, dim=0):
        return on_local_shards(look, (table, tokens), ((None, 0), (0, None)), ((0, None),), partial=(0,))
    return on_local_shards(lambda t, i: t[i], (table, tokens), ((None, None), (0, None)), ((0, None),))


def unembed(params: Params, x, cfg: ModelConfig):
    from ..distributed.act_sharding import replicate_seq, shard_activations

    dt = cfg.compute_dtype
    # on a mesh: the residual placed by the context, normed on its sequence
    # shards, then the sequence gathered, so that the logits come out whole
    # over the sequence and sharded on the vocab, not as partial sums over it
    h = replicate_seq(apply_norm(params["final_norm"], shard_activations(x), cfg))
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(dt).T
    else:
        logits = h @ params["unembed"].to(dt)
    return softcap(logits, cfg.logits_softcap)


# -- full-stack passes -----------------------------------------------------------


def _remat_contexts():
    """``context_fn`` of a group's checkpoint: the WKV replay
    (:func:`~repro_torch.kernels.rwkv6_wkv.remat_contexts`), and around the
    recomputation the forward's activation context as well (autograd runs
    it on the card's device thread, which does not see the step's)."""
    from ..distributed.act_sharding import recompute_context

    keep, replay = remat_contexts()
    return keep, _entered(replay, recompute_context())


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _run_stack(params: Params, x, cfg: ModelConfig, positions, cache_len):
    """Every layer in order -> (x, caches, aux): the per-layer caches stacked
    like the JAX scan's, and the MoE layers' aux losses summed in layer
    order (float32 zero where there are none)."""
    from ..distributed.act_sharding import shard_activations

    def group_body(x, aux, group):
        slots = {}
        for s, kind in enumerate(cfg.pattern):
            x, slots[f"slot{s}"], a = _block(group[f"slot{s}"], x, kind, cfg, positions, cache_len)
            if a is not None:
                aux = aux + a
        # sequence-parallel boundary: between groups the residual (what a
        # checkpoint keeps under remat) lives sharded over (batch, seq) on a mesh
        return shard_activations(x), aux, slots

    remat = cfg.remat in ("full", "dots") and cache_len is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(cfg.num_groups):
        group = _index(params["groups"], i)
        if remat:  # the aux sum is carried through the checkpoint, as x is
            x, aux = torch.utils.checkpoint.checkpoint(
                lambda x, aux, g: group_body(x, aux, g)[:2], x, aux, group,
                use_reentrant=False, context_fn=_remat_contexts,
            )
        else:
            x, aux, slots = group_body(x, aux, group)
            caches.append(slots)
    rem = []
    for i, kind in enumerate(cfg.remainder):
        x, c, a = _block(params["remainder"][i], x, kind, cfg, positions, cache_len)
        if a is not None:
            aux = aux + a
        rem.append(c)
    cache: Params = {}
    if cache_len is not None:
        if caches:
            cache["groups"] = _stack(caches)
        if rem:
            cache["remainder"] = rem
    return x, cache, aux


def forward(params: Params, batch, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass -> (logits [B, S, V], moe_aux scalar)."""
    x, positions = embed_inputs(params, batch, cfg)
    x, _, aux = _run_stack(params, x, cfg, positions, None)
    return unembed(params, x, cfg), aux


def loss_fn(params: Params, batch, cfg: ModelConfig):
    """Next-token cross-entropy with label masking and aux losses.

    Port of ``repro.models.transformer.loss_fn``: float32 log-softmax,
    labels equal to ``IGNORE_LABEL`` masked out, ``cfg.z_loss`` times the
    masked mean of logsumexp^2, and the MoE router's aux term.
    Returns (total, {"ce", "aux", "tokens"}).
    """
    from ..distributed.act_sharding import reduce_partial

    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    logits = logits[:, : labels.shape[1], :].float()  # logits[t] predicts labels[t]
    mask = (labels != IGNORE_LABEL).float()
    safe_labels = labels.clamp_min(0).long()
    if _vocab_sharded(logits):
        token_ll, logz = _vocab_parallel_log_probs(logits, safe_labels)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        token_ll = logp.gather(-1, safe_labels[..., None])[..., 0]
        logz = None
    denom = mask.sum().clamp_min(1.0)
    ce = reduce_partial(-(token_ll * mask).sum() / denom)  # on a mesh: summed over the rows' ranks
    total = ce
    if cfg.z_loss:
        logz = torch.logsumexp(logits, dim=-1) if logz is None else logz
        total = total + cfg.z_loss * reduce_partial(torch.mean(logz.square() * mask))
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_coef * aux
    return total, {"ce": ce, "aux": aux, "tokens": denom}


def _vocab_sharded(t, dim: int = -1) -> bool:
    """A DTensor whose vocab dim ``dim`` (the logits' last, the embedding
    table's first) ``model`` shards: a vocab that divides the axis, which
    the embedding's rule puts there."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor) or "model" not in (t.device_mesh.mesh_dim_names or ()):
        return False
    i = t.device_mesh.mesh_dim_names.index("model")
    return t.device_mesh.size(i) > 1 and t.placements[i].is_shard(dim % t.ndim)


def _vocab_parallel_log_probs(logits, labels):
    """(log p of each label, logsumexp) from logits [B, S, V] whose V is
    sharded over ``model``, without gathering them: each rank sums the
    exponentials of its vocab slice (from the max over every slice) and
    picks the labels that fall in it, on its local shards, and the two
    [B, S] partial sums are reduced over ``model``.  ``log_softmax`` on
    such a DTensor would all-gather the whole float32 logits on every rank
    first (8.4 GB a rank for recurrentgemma-9b's 256,000 words at 2 x
    4096).  The same values as the one-process ``log_softmax`` up to the
    order of the sums."""
    from ..distributed.act_sharding import mesh_coordinate, on_local_shards, reduce_partial

    top = reduce_partial(logits.detach().amax(dim=-1))  # a constant shift: no gradient
    first = mesh_coordinate(logits, "model")

    def local(logits, top, labels):
        v = logits.shape[-1]
        index = labels - first * v
        mine = (index >= 0) & (index < v)
        got = logits.gather(-1, index.clamp(0, v - 1)[..., None])[..., 0]
        zero = torch.zeros((), dtype=got.dtype, device=got.device)
        # the slice's logsumexp saves no [B, S, V] exponentials for the backward
        return torch.exp(torch.logsumexp(logits, dim=-1) - top), torch.where(mine, got, zero)

    rows = (0, None)
    sumexp, picked = on_local_shards(local, (logits, top, labels), ((0, 2), rows, rows), (rows, rows),
                                     partial=(0, 1))
    logz = top + torch.log(reduce_partial(sumexp))
    return reduce_partial(picked) - logz, logz


@torch.no_grad()
def prefill(params: Params, batch, cfg: ModelConfig, *, max_len: Optional[int] = None):
    """Forward + caches.  Returns (last-position logits [B, V], cache).

    ``max_len`` sizes the attention caches; RWKV6 and RG-LRU states have
    no length.
    """
    from ..distributed.act_sharding import replicate_seq, shard_activations

    x, positions = embed_inputs(params, batch, cfg)
    x, cache, _ = _run_stack(params, x, cfg, positions, max_len or x.shape[1])  # prefill drops aux, as JAX does
    x = replicate_seq(shard_activations(x))  # on a mesh the last position is sliced from the whole sequence
    logits = unembed(params, x[:, -1:, :], cfg)[:, 0, :]
    return logits, cache


def init_decode_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: DeviceLike = "cuda"
) -> Params:
    """Empty cache matching :func:`prefill`'s output."""
    device = resolve_device(device)

    def one(kind: str):
        if kind in (ATTN, LOCAL):
            return init_cache(cfg, batch, max_len, window=_layer_window(kind, cfg), device=device)
        if kind == RECURRENT:
            return init_rglru_state(cfg, batch, device=device)
        if kind == RWKV:
            return init_rwkv_state(cfg, batch, device=device)
        raise ValueError(kind)

    cache: Params = {}
    if cfg.num_groups > 0:
        cache["groups"] = {
            f"slot{s}": _stack([one(kind) for _ in range(cfg.num_groups)])
            for s, kind in enumerate(cfg.pattern)
        }
    if cfg.remainder:
        cache["remainder"] = [one(kind) for kind in cfg.remainder]
    return cache


@torch.no_grad()
def decode_step(params: Params, tokens_t, cache: Params, cfg: ModelConfig, position: int):
    """One decode step.

    tokens_t: [B] token ids (or [B, 1, frontend_dim] embeddings for the
    "frame" stub); position: absolute position of the new token.
    Returns (logits [B, V], cache); the cache's tensors are updated in place.
    """
    from ..distributed.act_sharding import shard_activations

    dt = cfg.compute_dtype
    if cfg.frontend == "frame":
        x_t = tokens_t.to(dt) @ params["frontend_proj"].to(dt)
    else:
        x_t = _lookup(params["embed"].to(dt), tokens_t)[:, None, :]
    x_t = shard_activations(x_t)
    for i in range(cfg.num_groups):
        group = _index(params["groups"], i)
        group_cache = _index(cache["groups"], i)
        for s, kind in enumerate(cfg.pattern):
            x_t, _ = _block_decode(
                group[f"slot{s}"], x_t, group_cache[f"slot{s}"], kind, cfg, position
            )
    for i, kind in enumerate(cfg.remainder):
        x_t, _ = _block_decode(
            params["remainder"][i], x_t, cache["remainder"][i], kind, cfg, position
        )
    logits = unembed(params, x_t, cfg)[:, 0, :]
    return logits, cache
