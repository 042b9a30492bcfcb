"""The train step: per-pod loss and gradients, cross-pod sync, AdamW.

Port of the train half of ``repro.distributed.steps``.  The JAX step runs
each pod as a shard of a manual ``"pod"`` mesh axis; on one H100 the pods
run one after another on the same card, each on its slice of the global
batch (pod p takes rows [p * B / npods, (p + 1) * B / npods), as the JAX
step's ``P("pod")`` batch spec gives it), and their gradients are stacked
along a leading pod dimension for :mod:`.sync`.  ``npods == 1`` is the
single-device branch: no sync.  The state's error feedback (``hier_int8``)
keeps one leaf per pod, ``[npods, ...]``.

``local_sgd`` on more than one pod follows DiLoCo's semantics: each pod
keeps its own parameters and AdamW moments between outer steps, so the
step takes and returns parameters with a leading pod dimension
(:func:`init_pod_params` makes them) and the state's moments have one too;
the DiLoCo anchor and momentum, the same on every pod, are kept once.

Intra-pod sharding (FSDP / tensor parallelism over ``data`` and ``model``)
and the process group a multi-card run would put the pod axis on are not
ported yet (ROADMAP queue 1, item 16); nor are ``make_prefill_step`` and
``make_decode_step``, whose work :func:`repro_torch.models.prefill` and
``decode_step`` do on one device.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models import loss_fn
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw
from ..optim.diloco import DilocoConfig, init_diloco, outer_step
from ..tree import tree_leaves, tree_map, tree_unflatten
from .sync import (
    STRATEGIES,
    full_precision_bytes,
    ps_bytes,
    sync_allreduce,
    sync_hier,
    sync_hier_int8,
    sync_local,
    sync_ps,
)


class TrainState(NamedTuple):
    adam: AdamWState  # local_sgd on > 1 pod: m, v [npods, ...]
    ef: Any  # error feedback, leaves [npods, ...] ( () when unused )
    diloco: Any  # DilocoState ( () when unused )


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}")


def _per_pod(strategy: str, npods: int) -> bool:
    """Whether each pod keeps its own parameters and moments."""
    return strategy == "local_sgd" and npods > 1


def _stack(tree, npods: int):
    return tree_map(lambda t: t.unsqueeze(0).expand(npods, *t.shape).contiguous(), tree)


def init_train_state(params, opt_cfg: AdamWConfig, *, strategy: str = "hier", npods: int = 1) -> TrainState:
    """From the model's parameters (one copy, no pod dimension)."""
    _check_strategy(strategy)
    ef = ()
    if strategy == "hier_int8":
        ef = tree_map(
            lambda p: torch.zeros((npods, *p.shape), dtype=torch.float32, device=p.device), params
        )
    adam = init_adamw(params)
    if _per_pod(strategy, npods):
        adam = AdamWState(step=adam.step, m=_stack(adam.m, npods), v=_stack(adam.v, npods))
    diloco = init_diloco(params) if strategy == "local_sgd" else ()
    return TrainState(adam=adam, ef=ef, diloco=diloco)


def init_pod_params(params, *, strategy: str = "hier", npods: int = 1):
    """The parameters the step takes: for ``local_sgd`` on more than one pod
    one replica per pod, ``[npods, ...]`` leaves; otherwise ``params``."""
    _check_strategy(strategy)
    return _stack(params, npods) if _per_pod(strategy, npods) else params


def pod_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, npods: int, *, replicas: bool = False):
    """Each pod's loss and gradients on its slice of ``batch``, pod by pod.

    ``replicas``: the leaves of ``params`` are ``[npods, ...]`` and pod p
    computes with its own slice; otherwise every pod computes with
    ``params``.  Returns (loss, metrics, grads): loss and metrics averaged
    over pods as the JAX step's ``psum / npods`` does, grads a tree of
    float32 ``[npods, ...]`` leaves.
    """
    b = next(iter(batch.values())).shape[0]
    if b % npods:
        raise ValueError(f"global batch {b} does not split over {npods} pods")
    per = b // npods
    losses, metrics, grads = [], [], []
    for p in range(npods):
        src = tree_map(lambda t: t[p], params) if replicas else params
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(src)]
        tracked = tree_unflatten(src, leaves)
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
    stacked = tree_unflatten(src, [torch.stack(gs) for gs in zip(*grads)])
    loss = sum(losses) / npods
    mean = {k: sum(m[k] for m in metrics) / npods for k in metrics[0]}
    return loss, mean, stacked


def sync_grads(grads, ef, *, strategy: str, num_channels: int = 4) -> Tuple[Any, Any, int]:
    """Cross-pod sync of ``[npods, ...]`` grads -> (synced, new ef, WAN bytes per pod).

    ``local_sgd`` sends nothing: its grads come back as they went in, one
    per pod."""
    _check_strategy(strategy)
    if strategy == "hier_int8":
        return sync_hier_int8(grads, ef)
    if strategy == "ps":
        return sync_ps(grads), ef, ps_bytes(grads)
    if strategy == "local_sgd":
        return sync_local(grads), ef, 0
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
    diloco_cfg: Optional[DilocoConfig] = None,
    device: DeviceLike = "cuda",
):
    """step(params, state, batch) -> (params, state, metrics).

    ``batch`` holds numpy arrays or tensors; they are moved to ``device``.
    Metrics: ``loss``, ``ce``, ``aux``, ``tokens`` (pod means), ``grad_norm``
    (before clipping) and ``lr`` from AdamW, and ``wan_bytes``: the bytes
    each pod sends over the WAN this step (0 for one pod).

    ``ps``: one AdamW update from the pods' mean gradient, whose parameters
    every pod pulls.  ``local_sgd`` on more than one pod: each pod's own
    AdamW step on its own parameters (gradient norm clipped per pod), then,
    when the updated step count is a multiple of ``diloco_cfg.sync_every``,
    the DiLoCo outer step; its WAN bytes are those of a ring all-reduce of
    the float32 deltas, 0 on the inner steps.  ``grad_norm`` and ``lr`` are
    pod 0's, which is what the JAX step's unreduced optimizer metrics give
    under ``out_specs=P()``.
    """
    _check_strategy(strategy)
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()
    diloco_cfg = diloco_cfg or DilocoConfig()

    def step(params, state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if _per_pod(strategy, npods):
            return local_step(params, state, batch)
        loss, metrics, grads = pod_grads(params, batch, cfg, npods)
        new_ef, wan = state.ef, 0
        if npods > 1:
            grads, new_ef, wan = sync_grads(grads, state.ef, strategy=strategy, num_channels=num_channels)
        else:
            grads = tree_map(lambda g: g[0], grads)
        new_params, new_adam, opt_metrics = adamw_update(opt_cfg, grads, state.adam, params)
        metrics = dict(metrics, loss=loss, wan_bytes=wan, **opt_metrics)
        return new_params, TrainState(new_adam, new_ef, state.diloco), metrics

    def local_step(params, state: TrainState, batch):
        loss, metrics, grads = pod_grads(params, batch, cfg, npods, replicas=True)
        outs = []
        for p in range(npods):
            pod = lambda tree: tree_map(lambda t: t[p], tree)  # noqa: E731
            adam = AdamWState(state.adam.step, pod(state.adam.m), pod(state.adam.v))
            outs.append(adamw_update(opt_cfg, pod(grads), adam, pod(params)))
        stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)  # noqa: E731
        new_params = stack([o[0] for o in outs])
        new_adam = AdamWState(outs[0][1].step, stack([o[1].m for o in outs]), stack([o[1].v for o in outs]))
        new_diloco, wan = state.diloco, 0
        if int(new_adam.step) % diloco_cfg.sync_every == 0:
            new_params, new_diloco = outer_step(diloco_cfg, new_params, state.diloco)
            wan = full_precision_bytes(new_params)
        metrics = dict(metrics, loss=loss, wan_bytes=wan, **outs[0][2])
        return new_params, TrainState(new_adam, state.ef, new_diloco), metrics

    return step
