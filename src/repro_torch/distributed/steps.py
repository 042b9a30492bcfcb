"""The train step: per-pod loss and gradients, cross-pod sync, AdamW.

Port of the train half of ``repro.distributed.steps``.  The JAX step runs
each pod as a shard of a manual ``"pod"`` mesh axis; on one H100 the pods
run one after another on the same card, each on its slice of the global
batch (pod p takes rows [p * B / npods, (p + 1) * B / npods), as the JAX
step's ``P("pod")`` batch spec gives it), and their gradients are stacked
along a leading pod dimension for :mod:`.sync`.  ``npods == 1`` is the
single-device branch: no sync.  The state's error feedback (``hier_int8``)
keeps one leaf per pod, ``[npods, ...]``.

Intra-pod sharding (FSDP / tensor parallelism over ``data`` and ``model``)
and the process group a multi-card run would put the pod axis on are not
ported yet (ROADMAP queue 1, items 10 and 16); nor are ``make_prefill_step``
and ``make_decode_step``, whose work :func:`repro_torch.models.prefill` and
``decode_step`` do on one device.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models import loss_fn
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw
from ..tree import tree_leaves, tree_map, tree_unflatten
from .sync import (
    NOT_PORTED,
    STRATEGIES,
    full_precision_bytes,
    sync_allreduce,
    sync_hier,
    sync_hier_int8,
)


class TrainState(NamedTuple):
    adam: AdamWState
    ef: Any  # error feedback, leaves [npods, ...] ( () when unused )
    diloco: Any  # DiLoCo state ( () : local_sgd is not ported )


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}")
    if strategy in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[strategy])


def init_train_state(params, opt_cfg: AdamWConfig, *, strategy: str = "hier", npods: int = 1) -> TrainState:
    _check_strategy(strategy)
    ef = ()
    if strategy == "hier_int8":
        ef = tree_map(
            lambda p: torch.zeros((npods, *p.shape), dtype=torch.float32, device=p.device), params
        )
    return TrainState(adam=init_adamw(params), ef=ef, diloco=())


def pod_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, npods: int):
    """Each pod's loss and gradients on its slice of ``batch``, pod by pod.

    Returns (loss, metrics, grads): loss and metrics averaged over pods as
    the JAX step's ``psum / npods`` does, grads a tree of float32
    ``[npods, ...]`` leaves.
    """
    b = next(iter(batch.values())).shape[0]
    if b % npods:
        raise ValueError(f"global batch {b} does not split over {npods} pods")
    per = b // npods
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tracked = tree_unflatten(params, leaves)
    losses, metrics, grads = [], [], []
    for p in range(npods):
        pod_batch = {k: v[p * per : (p + 1) * per] for k, v in batch.items()}
        loss, m = loss_fn(tracked, pod_batch, cfg)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss never reads (musicgen's untied embed) gets a zero
        # gradient, as jax.value_and_grad gives it; AdamW still decays it
        grads.append([
            torch.zeros_like(x, dtype=torch.float32) if g is None else g.float() for x, g in zip(leaves, got)
        ])
        losses.append(loss.detach())
        metrics.append({k: v.detach() for k, v in m.items()})
    stacked = tree_unflatten(params, [torch.stack(gs) for gs in zip(*grads)])
    loss = sum(losses) / npods
    mean = {k: sum(m[k] for m in metrics) / npods for k in metrics[0]}
    return loss, mean, stacked


def sync_grads(grads, ef, *, strategy: str, num_channels: int = 4) -> Tuple[Any, Any, int]:
    """Cross-pod sync of ``[npods, ...]`` grads -> (synced, new ef, WAN bytes per pod)."""
    _check_strategy(strategy)
    if strategy == "hier_int8":
        return sync_hier_int8(grads, ef)
    wan = full_precision_bytes(grads)
    if strategy == "allreduce":
        return sync_allreduce(grads), ef, wan
    return sync_hier(grads, num_channels=num_channels), ef, wan


def make_train_step(
    cfg: ModelConfig,
    *,
    npods: int = 1,
    strategy: str = "hier",
    num_channels: int = 4,
    opt_cfg: Optional[AdamWConfig] = None,
    device: DeviceLike = "cuda",
):
    """step(params, state, batch) -> (params, state, metrics).

    ``batch`` holds numpy arrays or tensors; they are moved to ``device``.
    Metrics: ``loss``, ``ce``, ``aux``, ``tokens`` (pod means), ``grad_norm``
    (before clipping) and ``lr`` from AdamW, and ``wan_bytes``: the bytes
    each pod sends over the WAN this step (0 for one pod).
    """
    _check_strategy(strategy)
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        loss, metrics, grads = pod_grads(params, batch, cfg, npods)
        new_ef, wan = state.ef, 0
        if npods > 1:
            grads, new_ef, wan = sync_grads(grads, state.ef, strategy=strategy, num_channels=num_channels)
        else:
            grads = tree_map(lambda g: g[0], grads)
        new_params, new_adam, opt_metrics = adamw_update(opt_cfg, grads, state.adam, params)
        metrics = dict(metrics, loss=loss, wan_bytes=wan, **opt_metrics)
        return new_params, TrainState(new_adam, new_ef, state.diloco), metrics

    return step
