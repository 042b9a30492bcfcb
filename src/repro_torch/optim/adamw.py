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
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
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


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(
    cfg: AdamWConfig, grads, state: AdamWState, params
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm is not None:
        grads, norm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = norm
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    metrics["lr"] = lr
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)  # (p, m, v) at each leaf
    new_state = AdamWState(step=step, m=_field(out, 1), v=_field(out, 2))
    return _field(out, 0), new_state, metrics


def _field(tree, i: int):
    """The i-th element of each (p, m, v) triple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _field(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_field(v, i) for v in tree]
    return tree[i]
