"""AdamW on the port's parameter trees.

Port of ``repro.optim.adamw``: global-norm clipping, decoupled weight
decay, float32 moments over the parameters, linear warmup then cosine (or
constant) learning rate, and bias correction from the float32 ``b ** step``
as the JAX package computes it.  The step counter is an int32 tensor on the
parameters' device, so an update never waits for the host.  Like the JAX
function, :func:`adamw_update` returns new tensors and leaves its inputs
as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | constant


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # float32 tree
    v: Any  # float32 tree


def init_adamw(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731  (placed as p on a mesh)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step_f = step.float()
    warm = torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        frac = torch.clamp(
            (step_f - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
        )
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _square_sum(g) -> torch.Tensor:
    """The sum of squares of a leaf: over every shard for a DTensor (its
    ``full_tensor()`` reduces the partial sums), a plain 0-d tensor."""
    s = torch.sum(torch.square(g.float()))
    return s.full_tensor() if _is_dtensor(s) else s


def on_local(fn, *leaves):
    """``fn`` on the local tensors of ``leaves``; for DTensor leaves each
    output comes back as a DTensor placed as ``leaves[0]`` is (a tuple of
    outputs, each so).  Plain tensors go straight through."""
    if not _is_dtensor(leaves[0]):
        return fn(*leaves)
    from torch.distributed.tensor import DTensor

    like = leaves[0]
    out = fn(*(t.to_local() if _is_dtensor(t) else t for t in leaves))

    def wrap(t):
        return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def global_norm(tree) -> torch.Tensor:
    sq = sum(_square_sum(g) for g in tree_leaves(tree))
    return torch.sqrt(sq)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: on_local(lambda x: x * scale.to(x.dtype), g), grads), norm


def adamw_update(
    cfg: AdamWConfig, grads, state: AdamWState, params, *, in_place: bool = False
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics).

    ``in_place``: the moments and parameters are updated in their own
    storage, which the returned trees then hold (a donating step's; the
    values are the same: a bf16 parameter is written back rounded as the
    functional step rounds it)."""
    metrics: Dict[str, torch.Tensor] = {}
    scale = None
    if cfg.clip_norm is not None:  # clip_by_global_norm, its scaling a leaf at a time in upd
        metrics["grad_norm"] = global_norm(grads)
        scale = _clip_scale(metrics["grad_norm"], cfg.clip_norm)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    metrics["lr"] = lr
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        # b1 m + (1 - b1) g, b2 v + (1 - b2) g^2, (m / b1c) / (sqrt(v / b2c) + eps)
        # (+ wd p), p - lr delta: each temporary updated in place once formed
        # (the same operations in the same order), so a leaf holds few copies
        # of itself at once: recurrentgemma-9b's embedding leaf is 4.2 GB;
        # a bf16 gradient is taken to float32 here, a leaf at a time
        g = g.float()
        if scale is not None:
            g = g * scale.to(g.dtype)
        m = (m.mul_(cfg.b1) if in_place else torch.mul(m, cfg.b1)).add_(torch.mul(g, 1 - cfg.b1))
        v = (v.mul_(cfg.b2) if in_place else torch.mul(v, cfg.b2)).add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        delta = torch.div(m, b1c).div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            delta.add_(cfg.weight_decay * p.float())
        if in_place and p.dtype == torch.float32:
            return p.sub_(delta.mul_(lr)), m, v
        if in_place:
            return p.copy_(p.float() - delta.mul_(lr)), m, v
        return (p.float() - delta.mul_(lr)).to(p.dtype), m, v

    out = tree_map(lambda *t: on_local(upd, *t), params, grads, state.m, state.v)  # (p, m, v) at each leaf
    new_state = AdamWState(step=step, m=_field(out, 1), v=_field(out, 2))
    return _field(out, 0), new_state, metrics


def _field(tree, i: int):
    """The i-th element of each (p, m, v) triple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _field(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_field(v, i) for v in tree]
    return tree[i]
