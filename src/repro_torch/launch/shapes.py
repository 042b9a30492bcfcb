"""Assigned input-shape sets and allocation-free input specs.

Port of ``repro.launch.shapes``.  Four LM shapes (seq_len x global_batch):

    train_4k     4,096 x 256   training
    prefill_32k  32,768 x 32   inference
    decode_32k   32,768 x 128  decode
    long_500k    524,288 x 1   long-ctx decode (sub-quadratic archs only)

The stand-ins for ``jax.ShapeDtypeStruct`` are tensors on the ``meta``
device: they carry a shape and a dtype and allocate nothing, so a full-size
model's parameters or a 32k-token decode cache are sized without memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """``long_500k`` requires sub-quadratic attention: pure full-attention
    archs are skipped."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.subquadratic:
        return False, f"{cfg.name}: full attention is quadratic at 500k ctx"
    return True, ""


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """Train/prefill inputs as meta tensors."""
    i32, act = torch.int32, cfg.compute_dtype
    if cfg.frontend == "frame":
        return {
            "frame_embeds": _spec((batch, seq, cfg.frontend_dim), act),
            "labels": _spec((batch, seq), i32),
        }
    if cfg.frontend == "patch":
        p = cfg.num_prefix_tokens
        return {
            "tokens": _spec((batch, seq - p), i32),
            "patch_embeds": _spec((batch, p, cfg.frontend_dim), act),
            "labels": _spec((batch, seq), i32),
        }
    return {"tokens": _spec((batch, seq), i32), "labels": _spec((batch, seq), i32)}


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, object]:
    """Specs for the step selected by the shape's ``kind``.

    train/prefill -> {"batch": ...}
    decode        -> {"tokens_t", "position"} (the cache comes from
                     :func:`decode_cache_specs`).
    """
    spec = SHAPES[shape]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise ValueError(f"shape {shape} unsupported: {why}")
    if spec.kind in ("train", "prefill"):
        return {"batch": token_specs(cfg, spec.global_batch, spec.seq_len)}
    # decode: one new token against a seq_len-deep cache
    if cfg.frontend == "frame":
        tok = _spec((spec.global_batch, 1, cfg.frontend_dim), cfg.compute_dtype)
    else:
        tok = _spec((spec.global_batch,), torch.int32)
    return {"tokens_t": tok, "position": _spec((), torch.int32)}


def decode_cache_specs(cfg: ModelConfig, shape: str):
    """The decode cache for ``shape``, on the meta device."""
    from ..models.transformer import init_decode_cache

    spec = SHAPES[shape]
    return init_decode_cache(cfg, spec.global_batch, spec.seq_len, device=META)


def params_specs(cfg: ModelConfig):
    """The parameter tree, on the meta device."""
    from ..models.transformer import init_params

    return init_params(cfg, device=META)
