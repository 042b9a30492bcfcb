"""DiLoCo-style outer optimization for the ``local_sgd`` sync strategy.

Port of ``repro.optim.diloco``.  Each pod runs H inner AdamW steps on its
own parameters with no WAN traffic; every H steps the pods exchange their
parameter deltas once and apply an outer Nesterov-momentum step, after
which every pod holds the same parameters again.  The JAX functions run
inside ``shard_map`` over a manual ``"pod"`` axis; here, as in
:mod:`repro_torch.distributed.sync`, the pod axis is the LEADING dimension
of each parameter leaf, ``[npods, ...]``, so ``psum(delta) / npods`` is a
float32 sum over that dimension divided by its size.  The anchor and the
momentum are the same on every pod and are kept once.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..tree import tree_map
from .adamw import _field


class DilocoConfig(NamedTuple):
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    sync_every: int = 8  # H


class DilocoState(NamedTuple):
    anchor: Any  # float32 params at the last outer sync (the same on every pod)
    momentum: Any  # float32 outer Nesterov momentum


def init_diloco(params) -> DilocoState:
    """From one pod's parameters (no pod dimension)."""
    return DilocoState(
        anchor=tree_map(lambda p: p.detach().float().clone(), params),
        momentum=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def outer_step(cfg: DilocoConfig, params, state: DilocoState) -> Tuple[Any, DilocoState]:
    """Cross-pod outer Nesterov step on parameter deltas.

    ``params``: leaves ``[npods, ...]``, each pod's parameters after its
    inner steps.  Returns the new parameters (the same on every pod, still
    ``[npods, ...]``) and the new state.

    delta   = anchor - params          (per pod; what inner steps learned)
    d_mean  = sum_pods(delta) / npods  (the ONLY WAN transfer)
    mom     = beta * mom + d_mean
    params' = anchor - outer_lr * (beta * mom + d_mean)   (Nesterov)
    anchor' = params'
    """

    def one(anchor, p, mom):
        n = p.shape[0]
        d_mean = (anchor - p.float()).sum(0) / n
        new_mom = cfg.outer_momentum * mom + d_mean
        step = cfg.outer_momentum * new_mom + d_mean  # Nesterov look-ahead
        new_p = anchor - cfg.outer_lr * step
        return new_p.to(p.dtype).expand(n, *new_p.shape).contiguous(), new_p, new_mom

    out = tree_map(one, state.anchor, params, state.momentum)  # (p, anchor, mom) at each leaf
    return _field(out, 0), DilocoState(anchor=_field(out, 1), momentum=_field(out, 2))
