"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Port of ``repro.models.rwkv6`` (arXiv:2404.05892).  Per head of dimension
``N``:

    wkv_t   = sum_{i<=t} diag(prod_{j=i+1..t} w_j) k_i v_i^T   (+ bonus u k_t v_t^T)
    out_t   = r_t . (wkv state)

with the decay ``w_t = exp(-exp(w0 + lora(x_t)))`` data-dependent.  The
recurrence runs in :func:`~repro_torch.kernels.rwkv6_wkv.wkv6`: the
hand-written CUDA kernels on the card (forward, and under grad the
backward), the plain loops on the CPU.  Casts
sit where the JAX functions put them: the token-shift lerps in the
activation dtype, the decay path and the recurrence in float32, the group
norm's reduction in float32.

Decode is O(1): carry ``(wkv, shift_att, shift_ffn)`` per layer.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_wkv import GRAD_CHUNK, wkv6
from .config import ModelConfig, torch_dtype
from .layers import dense_init

Params = Dict[str, torch.Tensor]

LORA_RANK = 64


def init_rwkv_block(cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> Params:
    """The JAX block's 19 leaves, with its shapes and init constants."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    h = d // n
    pdt = torch_dtype(cfg.param_dtype)
    kw = dict(generator=generator, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        # time-mix projections
        "wr": dense_init((d, d), dtype=pdt, **kw),
        "wk": dense_init((d, d), dtype=pdt, **kw),
        "wv": dense_init((d, d), dtype=pdt, **kw),
        "wg": dense_init((d, d), dtype=pdt, **kw),
        "wo": dense_init((d, d), dtype=pdt, **kw),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x W_a) W_b))
        "decay_w0": full((h, n), -6.0)
        + torch.linspace(0.0, 2.0, n, dtype=torch.float32, device=device)[None, :],
        "decay_a": dense_init((d, LORA_RANK), **kw),
        "decay_b": dense_init((LORA_RANK, d), in_axis_size=LORA_RANK, **kw),
        # per-head bonus u ("first token" boost)
        "bonus": full((h, n), 0.0),
        # token-shift mixing coefficients (static part of ddlerp)
        "mix_r": full((d,), 0.5),
        "mix_k": full((d,), 0.5),
        "mix_v": full((d,), 0.5),
        "mix_g": full((d,), 0.5),
        "mix_w": full((d,), 0.5),
        # group-norm over heads at the output
        "gn_scale": full((d,), 1.0),
        # channel-mix
        "cm_mix": full((d,), 0.5),
        "cm_k": dense_init((d, f), dtype=pdt, **kw),
        "cm_v": dense_init((f, d), in_axis_size=f, dtype=pdt, **kw),
        "cm_r": dense_init((d, d), dtype=pdt, **kw),
    }


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it, 1 / (1 + exp(-x)), rounding to
    x's dtype after each op.  In bf16 it agrees with the JAX package bit for
    bit; ``torch.sigmoid`` rounds once and differs by an ulp on about a third
    of the values, which the recurrence carries on through every step."""
    return 1 / (1 + torch.exp(-x))


def _token_shift(x: torch.Tensor, shift_state: torch.Tensor):
    """Shift the sequence right by one; position 0 takes ``shift_state``.

    x: [B, T, D]; shift_state: [B, D] (last token of the previous segment).
    Returns (shifted x, new shift_state = x[:, -1]).
    """
    prev = torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, n: int, eps: float = 1e-5):
    """Per-head layer norm over the head dim (RWKV's group_norm): float32
    population variance, cast back to x's dtype after the scale."""
    b, t, d = x.shape
    xh = x.reshape(b, t, h, n).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    normed = (xh - mean) * torch.rsqrt(var + eps)
    return (normed.reshape(b, t, d) * scale).to(x.dtype)


def _wkv_with_initial_state(r, k, v, w, u, state0, *, chunk: int = GRAD_CHUNK, state_out=None):
    """The WKV recurrence from ``state0`` -> (out [B, T, H, N] f32, final state).

    One kernel call runs the whole sequence (``state_out`` may be
    ``state0``: updated in place, under no_grad).  The JAX function's memory
    schedule for autodiff, checkpointed chunks of ``chunk`` steps, is the
    kernels': under grad the forward saves the state before every chunk
    and the backward recomputes each chunk's states from it.
    """
    return wkv6(r, k, v, w, u, state0, state_out=state_out, chunk=chunk)


def time_mix(
    params: Params,
    x: torch.Tensor,  # [B, T, D]
    cfg: ModelConfig,
    *,
    shift_state: torch.Tensor,  # [B, D]
    wkv_state: torch.Tensor,  # [B, H, N, N]
    wkv_out: Optional[torch.Tensor] = None,
):
    """RWKV6 attention replacement.  Returns (y, new_shift, new_wkv).

    ``wkv_out``, if given, receives the new WKV state (it may be
    ``wkv_state`` itself).
    """
    from ..distributed.act_sharding import on_local_shards, replicate_seq

    x = replicate_seq(x)  # under sequence parallelism: the whole sequence for the token shift and WKV
    b, t, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    dt = cfg.compute_dtype

    prev, new_shift = _token_shift(x, shift_state)

    def lerp(mix):
        return x + (prev - x) * mix.to(x.dtype)

    r = (lerp(params["mix_r"]) @ params["wr"].to(dt)).reshape(b, t, h, n)
    k = (lerp(params["mix_k"]) @ params["wk"].to(dt)).reshape(b, t, h, n)
    v = (lerp(params["mix_v"]) @ params["wv"].to(dt)).reshape(b, t, h, n)
    g = lerp(params["mix_g"]) @ params["wg"].to(dt)
    g = g * _sigmoid(g)  # jax.nn.silu

    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x a) b)), float32
    xw = lerp(params["mix_w"]).float()
    dd = torch.tanh(xw @ params["decay_a"]) @ params["decay_b"]  # [B, T, D]
    log_neg = params["decay_w0"].reshape(1, 1, h, n) + dd.reshape(b, t, h, n)
    w = torch.exp(-torch.exp(log_neg))  # in (0, 1)

    # on a mesh the kernel runs on the rank's rows and heads (the state
    # written in place when ``wkv_out`` is given)
    heads, state = (0, 2), (0, 1)
    out, new_wkv = on_local_shards(
        lambda r, k, v, w, u, s0, so: _wkv_with_initial_state(r, k, v, w, u, s0, state_out=so),
        (r, k, v, w, params["bonus"], wkv_state, wkv_out), (heads,) * 4 + ((None, 0), state, state),
        (heads, state), in_place=(6,),
    )
    out = _group_norm(out.reshape(b, t, d).to(dt), params["gn_scale"], h, n)
    y = (out * g) @ params["wo"].to(dt)
    return y, new_shift, new_wkv


def channel_mix(params: Params, x: torch.Tensor, cfg: ModelConfig, *, shift_state: torch.Tensor):
    """RWKV6 FFN: squared ReLU with token shift and a receptance gate.

    Like the JAX function, ``cm_mix`` mixes both the key and the receptance
    input.
    """
    from ..distributed.act_sharding import replicate_seq

    dt = cfg.compute_dtype
    x = replicate_seq(x)  # under sequence parallelism: the whole sequence for the token shift
    prev, new_shift = _token_shift(x, shift_state)
    mix = params["cm_mix"].to(x.dtype)
    xk = x + (prev - x) * mix
    xr = x + (prev - x) * mix
    k = torch.square(F.relu(xk @ params["cm_k"].to(dt)))
    kv = k @ params["cm_v"].to(dt)
    r = _sigmoid(xr @ params["cm_r"].to(dt))
    return r * kv, new_shift


def init_rwkv_state(cfg: ModelConfig, batch: int, *, device) -> Params:
    d, n = cfg.d_model, cfg.rwkv_head_dim
    h = d // n
    return {
        "wkv": torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
        "shift_att": torch.zeros((batch, d), dtype=cfg.compute_dtype, device=device),
        "shift_ffn": torch.zeros((batch, d), dtype=cfg.compute_dtype, device=device),
    }
