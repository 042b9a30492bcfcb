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

:func:`outer_step_group` is the form for one rank per pod
(:mod:`repro_torch.distributed.pod_group`): each rank keeps its own
parameters and AdamW moments between outer steps, and the ``all_reduce``
of the float32 deltas is its only transfer.  On a pod of several ranks the
step hands it each rank's pieces of the parameters and state
(:mod:`repro_torch.distributed.placement`).
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
        momentum=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
    )


def _outer_update(cfg: DilocoConfig, anchor, p, mom, d_mean, in_place: bool):
    """The Nesterov step of one leaf from the pods' mean delta -> (the new
    parameters in ``p``'s dtype and shape, anchor, momentum).  ``in_place``
    writes the three into ``p``, ``anchor`` and ``mom`` (a donating step's;
    the same operations, so the same bits)."""
    if not in_place:
        new_mom = cfg.outer_momentum * mom + d_mean
        step = cfg.outer_momentum * new_mom + d_mean  # Nesterov look-ahead
        new_p = anchor - cfg.outer_lr * step
        return new_p.to(p.dtype).expand(p.shape), new_p, new_mom
    mom.mul_(cfg.outer_momentum).add_(d_mean)
    step = torch.mul(mom, cfg.outer_momentum).add_(d_mean)
    anchor.sub_(step.mul_(cfg.outer_lr))
    return p.copy_(anchor.expand(p.shape)), anchor, mom


def outer_step(cfg: DilocoConfig, params, state: DilocoState, *, in_place: bool = False) -> Tuple[Any, DilocoState]:
    """Cross-pod outer Nesterov step on parameter deltas.

    ``params``: leaves ``[npods, ...]``, each pod's parameters after its
    inner steps.  Returns the new parameters (the same on every pod, still
    ``[npods, ...]``) and the new state.

    delta   = anchor - params          (per pod; what inner steps learned)
    d_mean  = sum_pods(delta) / npods  (the ONLY WAN transfer)
    mom     = beta * mom + d_mean
    params' = anchor - outer_lr * (beta * mom + d_mean)   (Nesterov)
    anchor' = params'

    ``in_place``: the parameters, anchor and momentum are written in their
    own storage (a donating step's).
    """

    def one(anchor, p, mom):
        d_mean = (anchor - p.float()).sum(0) / p.shape[0]
        new_p, new_anchor, new_mom = _outer_update(cfg, anchor, p, mom, d_mean, in_place)
        return new_p if in_place else new_p.contiguous(), new_anchor, new_mom

    out = tree_map(one, state.anchor, params, state.momentum)  # (p, anchor, mom) at each leaf
    return _field(out, 0), DilocoState(anchor=_field(out, 1), momentum=_field(out, 2))


def outer_step_group(cfg: DilocoConfig, params, state: DilocoState, group) -> Tuple[Any, DilocoState]:
    """:func:`outer_step` with the rank's own parameters (no pod dimension):
    d_mean = all_reduce(anchor - params) / npods; the rest as above, the
    same on every rank."""

    def one(anchor, p, mom):
        d_mean = group.all_reduce(anchor - p.float()) / group.size
        return _outer_update(cfg, anchor, p, mom, d_mean, in_place=False)

    out = tree_map(one, state.anchor, params, state.momentum)
    return _field(out, 0), DilocoState(anchor=_field(out, 1), momentum=_field(out, 2))
