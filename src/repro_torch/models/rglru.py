"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): its init.

Port of ``repro.models.rglru``'s parameters and decode state, leaf for leaf:
the in-projections of the recurrent and gate branches, the width-4 causal
conv, the ``lru_lambda`` logits (so that ``a = sigmoid(Lambda)^c`` spans
about (0.9, 0.999), computed in float32 as the JAX package does), the two
gate projections and the out-projection; the state is the LRU hidden
``[B, Dr]`` (float32) and the conv tail ``[B, 3, Dr]``.  The block and its
scan are not ported yet (ROADMAP queue 1, item 12): they raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import ModelConfig, torch_dtype
from .layers import dense_init

Params = Dict[str, torch.Tensor]

CONV_WIDTH = 4
LRU_C = 8.0

RGLRU_NOT_PORTED = (
    "the RG-LRU block and its scan are not ported to repro_torch yet "
    "(ROADMAP queue 1, item 12: models/rglru.py)"
)


def init_rglru_block(
    cfg: ModelConfig, *, generator: Optional[torch.Generator], device: torch.device
) -> Params:
    d, dr = cfg.d_model, cfg.d_rnn
    pdt = torch_dtype(cfg.param_dtype)
    kw = dict(dtype=pdt, generator=generator, device=device)
    # Lambda init so a = sigmoid(Lambda)^c spans ~(0.9, 0.999)
    lam = torch.log(torch.linspace(0.9, 0.999, dr, dtype=torch.float32, device=device) ** (1.0 / LRU_C))
    lam = lam - torch.log1p(-torch.exp(lam))  # logit
    conv_w = torch.empty((CONV_WIDTH, dr), dtype=torch.float32, device=device)
    if conv_w.device.type != "meta":
        conv_w.normal_(generator=generator).mul_(0.1)
    return {
        "w_in_x": dense_init((d, dr), **kw),  # recurrent branch
        "w_in_g": dense_init((d, dr), **kw),  # gate branch
        "conv_w": conv_w.to(pdt),
        "conv_b": torch.zeros(dr, dtype=pdt, device=device),
        "lru_lambda": lam,
        "w_gate_a": dense_init((dr, dr), **kw),
        "w_gate_x": dense_init((dr, dr), **kw),
        "w_out": dense_init((dr, d), in_axis_size=dr, **kw),
    }


def rg_lru(x, r_gate, i_gate, lam, *, h0):
    raise NotImplementedError(RGLRU_NOT_PORTED)


def rglru_block(params: Params, x, cfg: ModelConfig, *, state):
    raise NotImplementedError(RGLRU_NOT_PORTED)


def init_rglru_state(cfg: ModelConfig, batch: int, *, device: torch.device) -> Params:
    return {
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.d_rnn), dtype=cfg.compute_dtype, device=device),
    }
