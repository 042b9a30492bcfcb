"""Feed-forward blocks: the dense FFN (GELU / SwiGLU / GeGLU / relu²).

Port of ``repro.models.ffn``'s dense half.  The large products stay
``torch.matmul``, as the JAX package leaves them to XLA.  Mixture-of-experts
is not ported yet (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig, torch_dtype
from .layers import activation_fn, dense_init, gelu

Params = Dict[str, torch.Tensor]

MOE_NOT_PORTED = (
    "mixture-of-experts FFN is not ported to repro_torch yet "
    "(ROADMAP queue 1, item 11: models/ffn.py MoE)"
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


def init_moe(cfg: ModelConfig, **_):
    raise NotImplementedError(MOE_NOT_PORTED)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig):
    raise NotImplementedError(MOE_NOT_PORTED)
