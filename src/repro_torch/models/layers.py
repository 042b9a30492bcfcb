"""Shared building blocks: norms, rotary embeddings, initializers.

Port of ``repro.models.layers``.  The casts sit where the JAX functions put
them: reductions in float32, elementwise math in the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .config import ModelConfig

# -- initializers -------------------------------------------------------------
#
# Only shapes and standard deviations match the JAX initializers: the two
# frameworks draw different numbers from the same seed, so parity tests
# convert the JAX parameters (``repro_torch.convert``).  On the ``meta``
# device the tensors are shapes only and nothing is drawn.


def dense_init(
    shape: Sequence[int],
    in_axis_size: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    *,
    generator: Optional[torch.Generator],
    device: torch.device,
) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in)), truncated at 2 std.

    A stack of matrices (an MoE leaf ``[E, d, f]``) is drawn a matrix at a
    time, so the float32 draw never holds more than one (arctic-480b's
    128-expert stack is 17.8 GB in float32)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    if len(shape) > 2:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        if t.device.type != "meta":
            for i in range(shape[0]):
                t[i].copy_(dense_init(shape[1:], fan_in, generator=generator, device=device))
        return t
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)
    return t.to(dtype)


def embed_init(
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    *,
    generator: Optional[torch.Generator],
    device: torch.device,
) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, 0.02, generator=generator)
    return t.to(dtype)


# -- norms ---------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6):
    """RMSNorm: float32 reduction, elementwise math in x's dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = x * inv
    if scale is not None:
        out = out * (1.0 + scale).to(x.dtype)
    return out


def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
):
    """LayerNorm written out as ``repro.models.layers.layer_norm``.

    Mean and variance reduce in float32; the subtract and scale run in x's
    dtype with ``mean`` and ``rsqrt`` cast down first.  ``F.layer_norm``
    normalises in float32 throughout and would round differently in bf16.
    """
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mean.to(x.dtype)) * inv
    if scale is not None:
        out = out * scale.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def nonparametric_ln(x: torch.Tensor, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm: no learnable scale or bias."""
    return layer_norm(x, None, None, eps=eps)


def init_norm(cfg: ModelConfig, *, device: torch.device):
    if cfg.norm == "nonparametric_ln":
        return {}
    if cfg.norm == "layernorm":
        return {
            "scale": torch.ones(cfg.d_model, dtype=torch.float32, device=device),
            "bias": torch.zeros(cfg.d_model, dtype=torch.float32, device=device),
        }
    # rmsnorm: stored as (scale - 1) so zeros-init is identity
    return {"scale": torch.zeros(cfg.d_model, dtype=torch.float32, device=device)}


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig):
    if cfg.norm == "nonparametric_ln":
        return nonparametric_ln(x)
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    return rms_norm(x, params["scale"])


# -- rotary position embeddings --------------------------------------------------


def rope_frequencies(head_dim: int, fraction: float, theta: float, *, device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    # a Python-scalar base: a tensor made from theta would be a host-to-device
    # copy, which synchronises the stream on every call
    inv = 1.0 / torch.pow(theta, exponent)
    return inv, rot_dim


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    theta: float = 10_000.0,
    fraction: float = 1.0,
):
    """Rotary embedding over the leading ``fraction`` of the head dim.

    Rotates in float32 by halves (not interleaved) and concatenates the
    pass-through part unchanged.  x: [..., seq, heads, head_dim];
    positions: [..., seq].
    """
    head_dim = x.shape[-1]
    inv, rot_dim = rope_frequencies(head_dim, fraction, theta, device=x.device)
    if rot_dim == 0:
        return x
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    angles = positions[..., None].float() * inv  # [..., seq, rot/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# -- activations -----------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "gelu":
        return gelu
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    if name == "silu":
        return F.silu
    raise ValueError(f"not a simple activation: {name}")


def softcap(x: torch.Tensor, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
