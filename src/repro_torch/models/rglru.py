"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro.models.rglru``, leaf for leaf: the in-projections of the
recurrent and gate branches, the width-4 causal conv, the ``lru_lambda``
logits (so that ``a = sigmoid(Lambda)^c`` spans about (0.9, 0.999),
computed in float32 as the JAX package does), the two gate projections and
the out-projection; the state is the LRU hidden ``[B, Dr]`` (float32) and
the conv tail ``[B, 3, Dr]``.

The projections and the conv are eager torch, as the JAX package leaves
them to XLA; the recurrence (``rg_lru`` there) runs in the hand-written
kernel :mod:`repro_torch.kernels.rglru_scan` on the card, its plain version
on the CPU; where autograd needs a gradient, through
:class:`~repro_torch.kernels.rglru_scan.RGLRUScanFn` (the backward kernel
on the card, the reverse recurrence on the CPU).  Decode (``in_place=True``) writes the new state into the
cache's tensors.

On a mesh (DTensor arguments) the projections are torch ops on DTensors,
and the conv and the scan run on each rank's local shards
(:func:`~repro_torch.distributed.act_sharding.on_local_shards`): rows over
``data``, channels over ``model``.  Both are channel-wise (the conv is
depthwise, the recurrence elementwise in Dr), so a shard of the channels
needs nothing from another rank, and the kernel sees ``[B/data, T,
Dr/model]``.  The state is laid out the same way (``cache_pspecs``: batch
over ``data``, Dr over ``model``), so decode writes the rank's own shard of
``h`` and of the conv tail, and nothing is gathered.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels.rglru_scan import rglru_scan
from .config import ModelConfig, torch_dtype
from .layers import dense_init, gelu

Params = Dict[str, torch.Tensor]

CONV_WIDTH = 4
LRU_C = 8.0

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


def _causal_conv1d(x, w, b, *, tail):
    """Depthwise causal conv, width CONV_WIDTH, in x's dtype.

    x: [B, T, Dr]; tail: [B, CONV_WIDTH-1, Dr] from the previous segment.
    Returns (y [B, T, Dr], new_tail); the tail is a view of the padded input.
    """
    t = x.shape[1]
    padded = torch.cat([tail.to(x.dtype), x], dim=1)  # [B, T+3, Dr]
    y = torch.zeros_like(x)
    for i in range(CONV_WIDTH):
        y = y + padded[:, i : i + t, :] * w[i][None, None, :].to(x.dtype)
    y = y + b[None, None, :].to(x.dtype)
    return y, padded[:, t:, :]


def _write_local(dst, src) -> None:
    """``dst.copy_(src)``; for DTensors the rank's local shard into its
    own, which needs both placed alike (a ``Shard`` on an axis of size 1
    is ``Replicate()`` there): anything else would move data, and raises."""
    from torch.distributed.tensor import DTensor

    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    mesh = dst.device_mesh
    if not isinstance(src, DTensor) or any(
        a != b and mesh.size(i) > 1 for i, (a, b) in enumerate(zip(dst.placements, src.placements))
    ):
        raise ValueError(f"state placed {dst.placements} written from {getattr(src, 'placements', 'a tensor')}: "
                         "the write would not be local")
    dst.to_local().copy_(src.to_local())


def rglru_block(params: Params, x, cfg: ModelConfig, *, state, in_place: bool = False):
    """Griffin recurrent block -> (y [B, T, D], new state).  ``in_place``
    writes the new state into ``state``'s tensors (decode's cache) and
    returns ``state``; otherwise the state is fresh tensors."""
    from ..distributed.act_sharding import on_local_shards, replicate_seq

    dt = cfg.compute_dtype
    x = replicate_seq(x)  # under sequence parallelism: the whole sequence for the conv and the scan
    branch_x = x @ params["w_in_x"].to(dt)
    branch_g = gelu(x @ params["w_in_g"].to(dt))
    # on a mesh the conv and the scan run on the rank's rows and channels
    seq, vec, chan = (0, 2), (0, 1), (None, 0)
    conv_out, new_tail = on_local_shards(
        lambda x, w, b, tail: _causal_conv1d(x, w, b, tail=tail),
        (branch_x, params["conv_w"], params["conv_b"], state["conv"]), (seq, (None, 1), chan, seq), (seq, seq),
    )
    r_gate = torch.sigmoid(conv_out @ params["w_gate_a"].to(dt))
    i_gate = torch.sigmoid(conv_out @ params["w_gate_x"].to(dt))
    h, h_last = on_local_shards(
        rglru_scan, (conv_out, r_gate, i_gate, params["lru_lambda"], state["h"]), (seq, seq, seq, chan, vec),
        (seq, vec),
    )
    y = (h * branch_g) @ params["w_out"].to(dt)
    if in_place:
        # new_tail views the concatenated input, not the old tail: no overlap
        _write_local(state["h"], h_last)
        _write_local(state["conv"], new_tail)
        return y, state
    # the tail is a view of the [B, T+3, Dr] padded input: copy it out
    return y, {"h": h_last, "conv": new_tail.clone()}


def init_rglru_state(cfg: ModelConfig, batch: int, *, device: torch.device) -> Params:
    return {
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.d_rnn), dtype=cfg.compute_dtype, device=device),
    }
