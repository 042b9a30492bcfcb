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
flash backward kernel (:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`).
``cfg.remat`` "full" recomputes each group in the backward pass
(``torch.utils.checkpoint``, as ``jax.checkpoint``); "dots" is treated as
"full": the JAX policy also saves the matmul outputs, so the two differ in
memory only, never in values.

RWKV6 layers (rwkv6-7b) serve: prefill and decode run the WKV recurrence
in the hand-written kernel (:mod:`repro_torch.kernels.rwkv6_wkv`), and
decode updates their state in place.  Their training waits for a WKV
backward kernel (ROADMAP queue 1, item 13): a gradient through them raises.
Recurrent (RG-LRU) layers and mixture-of-experts FFNs have their
parameters and decode state (:func:`init_params`, :func:`init_decode_cache`,
so the sizing hooks of :mod:`repro_torch.launch.shapes` cover every arch),
but a pass through them raises: RG-LRU waits for ROADMAP queue 1, item 12,
MoE for item 11.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from ..tree import tree_map
from .attention import attention_decode, attention_forward, init_attention, init_cache
from .config import ATTN, LOCAL, RECURRENT, RWKV, ModelConfig
from .ffn import dense_ffn, init_dense_ffn, init_moe, moe_ffn
from .layers import apply_norm, dense_init, embed_init, init_norm, softcap
from .rglru import RGLRU_NOT_PORTED, init_rglru_block, init_rglru_state
from .rwkv6 import channel_mix, init_rwkv_block, init_rwkv_state, time_mix

Params = Dict[str, Any]

IGNORE_LABEL = -100


def _check_kind(kind: str) -> None:
    """The layer kinds a pass (forward, prefill, decode) can run."""
    if kind == RECURRENT:
        raise NotImplementedError(RGLRU_NOT_PORTED)
    if kind not in (ATTN, LOCAL, RWKV):
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
    """``n`` trees from ``make()``, stacked on a leading axis as they are
    made: one unstacked tree is alive at a time, not ``n`` (rwkv6-7b's 32
    layers would otherwise hold its 30 GB of parameters twice)."""
    tree = make()
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), tree)
    for i in range(n):
        if i:
            tree = make()
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
    return out


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
    if cfg.moe is not None and kind == ATTN:
        return moe_ffn(params["ffn"], h, cfg)
    return dense_ffn(params["ffn"], h, cfg)


def _rwkv_block(params: Params, x, cfg: ModelConfig, state: Params, *, in_place: bool):
    """One RWKV6 layer from ``state`` -> (x, new state).  ``in_place``
    writes the new state into ``state``'s tensors (decode's cache)."""
    h = apply_norm(params["norm1"], x, cfg)
    tm_out, shift_att, wkv = time_mix(
        params["rwkv"], h, cfg, shift_state=state["shift_att"], wkv_state=state["wkv"],
        wkv_out=state["wkv"] if in_place else None,
    )
    x = x + tm_out
    h = apply_norm(params["norm2"], x, cfg)
    cm_out, shift_ffn = channel_mix(params["rwkv"], h, cfg, shift_state=state["shift_ffn"])
    if in_place:
        state["shift_att"].copy_(shift_att)
        state["shift_ffn"].copy_(shift_ffn)
        return x + cm_out, state
    # the shifts are views of [B, T, D] activations: copy them out
    return x + cm_out, {"wkv": wkv, "shift_att": shift_att.clone(), "shift_ffn": shift_ffn.clone()}


def _block(params: Params, x, kind: str, cfg: ModelConfig, positions, cache_len):
    """One layer (forward or prefill).  Returns (x, cache or None)."""
    _check_kind(kind)
    if kind == RWKV:  # prefill starts from a zero state; max_len does not apply
        x, state = _rwkv_block(
            params, x, cfg, init_rwkv_state(cfg, x.shape[0], device=x.device), in_place=False
        )
        return x, state if cache_len is not None else None
    h = apply_norm(params["norm1"], x, cfg)
    attn_out, cache = attention_forward(
        params["attn"], h, cfg, window=_layer_window(kind, cfg), positions=positions,
        return_cache=cache_len is not None, cache_len=cache_len,
    )
    x = x + attn_out
    h = apply_norm(params["norm2"], x, cfg)
    return x + _ffn(params, h, kind, cfg), cache


def _block_decode(params: Params, x_t, cache, kind: str, cfg: ModelConfig, position: int):
    """One layer, one token.  Returns (x_t, cache), the cache updated in place."""
    _check_kind(kind)
    if kind == RWKV:
        return _rwkv_block(params, x_t, cfg, cache, in_place=True)
    h = apply_norm(params["norm1"], x_t, cfg)
    attn_out, cache = attention_decode(
        params["attn"], h, cache, cfg, position, window=_layer_window(kind, cfg)
    )
    x_t = x_t + attn_out
    h = apply_norm(params["norm2"], x_t, cfg)
    return x_t + _ffn(params, h, kind, cfg), cache


def _index(tree, i: int):
    """Group ``i`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# -- embedding -------------------------------------------------------------------


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token + stub-frontend embedding -> (x [B, S, D], positions [S])."""
    dt = cfg.compute_dtype
    if cfg.frontend == "frame":
        x = batch["frame_embeds"].to(dt) @ params["frontend_proj"].to(dt)
    else:
        x = params["embed"].to(dt)[batch["tokens"]]
        if cfg.frontend == "patch":
            patches = batch["patch_embeds"].to(dt) @ params["frontend_proj"].to(dt)
            x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def unembed(params: Params, x, cfg: ModelConfig):
    dt = cfg.compute_dtype
    h = apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(dt).T
    else:
        logits = h @ params["unembed"].to(dt)
    return softcap(logits, cfg.logits_softcap)


# -- full-stack passes -----------------------------------------------------------


def _run_stack(params: Params, x, cfg: ModelConfig, positions, cache_len):
    """Every layer in order; the per-layer caches stacked like the JAX scan's."""

    def group_body(x, group):
        slots = {}
        for s, kind in enumerate(cfg.pattern):
            x, slots[f"slot{s}"] = _block(group[f"slot{s}"], x, kind, cfg, positions, cache_len)
        return x, slots

    remat = cfg.remat in ("full", "dots") and cache_len is None and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.num_groups):
        group = _index(params["groups"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x, g: group_body(x, g)[0], x, group, use_reentrant=False
            )
        else:
            x, slots = group_body(x, group)
            caches.append(slots)
    rem = []
    for i, kind in enumerate(cfg.remainder):
        x, c = _block(params["remainder"][i], x, kind, cfg, positions, cache_len)
        rem.append(c)
    cache: Params = {}
    if cache_len is not None:
        if caches:
            cache["groups"] = _stack(caches)
        if rem:
            cache["remainder"] = rem
    return x, cache


def forward(params: Params, batch, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass -> (logits [B, S, V], moe_aux scalar)."""
    x, positions = embed_inputs(params, batch, cfg)
    x, _ = _run_stack(params, x, cfg, positions, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, x, cfg), aux


def loss_fn(params: Params, batch, cfg: ModelConfig):
    """Next-token cross-entropy with label masking and aux losses.

    Port of ``repro.models.transformer.loss_fn``: float32 log-softmax,
    labels equal to ``IGNORE_LABEL`` masked out, ``cfg.z_loss`` times the
    masked mean of logsumexp^2, and the MoE router's aux term.
    Returns (total, {"ce", "aux", "tokens"}).
    """
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    logits = logits[:, : labels.shape[1], :].float()  # logits[t] predicts labels[t]
    mask = (labels != IGNORE_LABEL).float()
    safe_labels = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits, dim=-1)
    token_ll = logp.gather(-1, safe_labels[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    ce = -(token_ll * mask).sum() / denom
    total = ce
    if cfg.z_loss:
        logz = torch.logsumexp(logits, dim=-1)
        total = total + cfg.z_loss * torch.mean(logz.square() * mask)
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_coef * aux
    return total, {"ce": ce, "aux": aux, "tokens": denom}


@torch.no_grad()
def prefill(params: Params, batch, cfg: ModelConfig, *, max_len: Optional[int] = None):
    """Forward + caches.  Returns (last-position logits [B, V], cache).

    ``max_len`` sizes the attention caches; RWKV6 states have no length.
    """
    x, positions = embed_inputs(params, batch, cfg)
    x, cache = _run_stack(params, x, cfg, positions, max_len or x.shape[1])
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
    dt = cfg.compute_dtype
    if cfg.frontend == "frame":
        x_t = tokens_t.to(dt) @ params["frontend_proj"].to(dt)
    else:
        x_t = params["embed"].to(dt)[tokens_t][:, None, :]
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
