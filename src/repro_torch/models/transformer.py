"""Decoder stack for the attention layer kinds (ATTN, LOCAL).

Port of ``repro.models.transformer``: plain functions over the JAX
package's nested parameter dict, with the same keys and a leading stacked
group axis, so every leaf maps one-to-one to a JAX leaf by its
``jax.tree_util.keystr`` path.  ``lax.scan`` over the groups becomes a loop
over the group index.

Entry points:

* :func:`init_params`
* :func:`forward`      -- full forward -> (logits, aux)
* :func:`prefill`      -- forward + per-layer KV caches
* :func:`decode_step`  -- one token through the cache

Recurrent (RG-LRU) and RWKV layers, and the training loss, are not ported
yet (ROADMAP queue 1, items 12, 13 and 6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import attention_decode, attention_forward, init_attention, init_cache
from .config import ATTN, LOCAL, RECURRENT, RWKV, ModelConfig
from .ffn import dense_ffn, init_dense_ffn, init_moe, moe_ffn
from .layers import apply_norm, dense_init, embed_init, init_norm, softcap

Params = Dict[str, Any]

_NOT_PORTED = {
    RECURRENT: "RG-LRU recurrent layers are not ported yet (ROADMAP queue 1, item 12)",
    RWKV: "RWKV6 layers are not ported yet (ROADMAP queue 1, item 13)",
}


def _check_kind(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    if kind not in (ATTN, LOCAL):
        raise ValueError(kind)


# -- init --------------------------------------------------------------------------


def _init_layer(kind: str, cfg: ModelConfig, generator, device) -> Params:
    _check_kind(kind)
    kw = dict(generator=generator, device=device)
    params: Params = {
        "norm1": init_norm(cfg, device=device),
        "norm2": init_norm(cfg, device=device),
        "attn": init_attention(cfg, **kw),
    }
    if cfg.moe is not None and kind == ATTN:
        params["ffn"] = init_moe(cfg, **kw)
    else:
        params["ffn"] = init_dense_ffn(cfg, **kw)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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
            f"slot{s}": _stack([_init_layer(kind, cfg, **kw) for _ in range(cfg.num_groups)])
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


def _block(params: Params, x, kind: str, cfg: ModelConfig, positions, cache_len):
    """One layer (forward or prefill).  Returns (x, cache or None)."""
    _check_kind(kind)
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
    caches = []
    for i in range(cfg.num_groups):
        group = _index(params["groups"], i)
        slots = {}
        for s, kind in enumerate(cfg.pattern):
            x, slots[f"slot{s}"] = _block(group[f"slot{s}"], x, kind, cfg, positions, cache_len)
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


@torch.no_grad()
def prefill(params: Params, batch, cfg: ModelConfig, *, max_len: Optional[int] = None):
    """Forward + caches.  Returns (last-position logits [B, V], cache)."""
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
        _check_kind(kind)
        return init_cache(cfg, batch, max_len, window=_layer_window(kind, cfg), device=device)

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
