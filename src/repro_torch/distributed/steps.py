"""Step builders: train, prefill and decode over a mesh's pod axis.

Port of ``repro.distributed.steps``.  The JAX step runs each pod as a
shard of a manual ``"pod"`` mesh axis; every pod takes its slice of the
global batch (pod p takes rows [p * B / npods, (p + 1) * B / npods), as
the JAX step's ``P("pod")`` batch spec gives it).  The port runs the pods
in one of two ways (:mod:`repro_torch.launch.mesh`):

* in one process (no mesh, or a ``LocalMesh``): the pods run one after
  another on the same device, and their gradients are stacked along a
  leading pod dimension for the stacked forms of :mod:`.sync`.
  ``npods == 1`` is the single-device branch: no sync.  The state's error
  feedback (``hier_int8``) keeps one leaf per pod, ``[npods, ...]``;
* one rank per pod (a group mesh, a ``DeviceMesh`` with a ``"pod"``
  dimension): each rank computes its own pod's slice, and the strategy
  runs as collectives (the ``*_group`` forms of :mod:`.sync`).  Each rank
  holds its own leaves, as the JAX step sees them inside its shard: its
  error feedback, and under ``local_sgd`` its parameters and moments,
  have no pod dimension.  The loss and metrics are the pods' mean, summed
  in rank order; ``wan_bytes`` comes from the bytes handed to the
  collectives (:func:`.sync.group_wan_bytes`) and ``collective_s`` is the
  rank's host seconds in them.

``local_sgd`` on more than one pod follows DiLoCo's semantics: each pod
keeps its own parameters and AdamW moments between outer steps, so the
step takes and returns parameters with a leading pod dimension
(:func:`init_pod_params` makes them) and the state's moments have one too;
the DiLoCo anchor and momentum, the same on every pod, are kept once.

Both layouts give the same bits on the same inputs: per-pod work is the
same computation, and every sum over pods adds in pod order (gloo's
all-reduce of two terms commutes; with more pods its order is its own).
:func:`map_pod_leaves` names the per-pod leaves, which the trainer stacks
into the one-process layout for its checkpoints.

Intra-pod sharding (FSDP / tensor parallelism over ``data`` and ``model``)
is not ported yet (ROADMAP queue 1, item 16): a mesh with those axes larger
than 1 raises.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..launch.mesh import PLACEMENT_TODO, is_group_mesh, mesh_shape, num_pods, pod_process_group
from ..models import decode_step as model_decode_step
from ..models import loss_fn, prefill
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw
from ..optim.diloco import DilocoConfig, init_diloco, outer_step, outer_step_group
from ..tree import tree_leaves, tree_map, tree_unflatten
from .pod_group import PodGroup
from .sync import (
    STRATEGIES,
    full_precision_bytes,
    group_wan_bytes,
    ps_bytes,
    pull_params_group,
    sync_allreduce,
    sync_allreduce_group,
    sync_hier,
    sync_hier_group,
    sync_hier_int8,
    sync_hier_int8_group,
    sync_local,
    sync_ps,
    sync_ps_group,
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


def _pods(mesh, npods: Optional[int]) -> int:
    """The pod count: the mesh's, which ``npods`` may repeat; 1 with neither."""
    if mesh is None:
        return 1 if npods is None else npods
    wide = {a: n for a, n in mesh_shape(mesh).items() if a != "pod" and n > 1}
    if wide:
        raise NotImplementedError(f"mesh axes {wide} larger than 1: {PLACEMENT_TODO}")
    pods = num_pods(mesh)
    if npods is not None and npods != pods:
        raise ValueError(f"npods={npods} disagrees with the mesh's {pods} pods")
    return pods


def init_train_state(
    params, opt_cfg: AdamWConfig, *, strategy: str = "hier", npods: Optional[int] = None, mesh=None
) -> TrainState:
    """From the model's parameters (one copy, no pod dimension).  On a group
    mesh, the rank's own state: no pod dimension anywhere."""
    _check_strategy(strategy)
    npods = 1 if is_group_mesh(mesh) else _pods(mesh, npods)
    ef = ()
    if strategy == "hier_int8":
        lead = () if is_group_mesh(mesh) else (npods,)
        ef = tree_map(
            lambda p: torch.zeros((*lead, *p.shape), dtype=torch.float32, device=p.device), params
        )
    adam = init_adamw(params)
    if _per_pod(strategy, npods):
        adam = AdamWState(step=adam.step, m=_stack(adam.m, npods), v=_stack(adam.v, npods))
    diloco = init_diloco(params) if strategy == "local_sgd" else ()
    return TrainState(adam=adam, ef=ef, diloco=diloco)


def init_pod_params(params, *, strategy: str = "hier", npods: Optional[int] = None, mesh=None):
    """The parameters the step takes: for ``local_sgd`` on more than one pod
    in one process one replica per pod, ``[npods, ...]`` leaves; otherwise
    (a group mesh included: the rank's own) ``params``."""
    _check_strategy(strategy)
    if is_group_mesh(mesh):
        return params
    npods = _pods(mesh, npods)
    return _stack(params, npods) if _per_pod(strategy, npods) else params


def map_pod_leaves(fn, params, state: TrainState, *, strategy: str, npods: int):
    """(params, state) with ``fn`` applied to every per-pod leaf: the error
    feedback under ``hier_int8``; under ``local_sgd`` on more than one pod
    the parameters and AdamW moments.  The other leaves are the same on
    every pod and pass through."""
    if strategy == "hier_int8":
        state = state._replace(ef=tree_map(fn, state.ef))
    if _per_pod(strategy, npods):
        params = tree_map(fn, params)
        state = state._replace(adam=state.adam._replace(m=tree_map(fn, state.adam.m), v=tree_map(fn, state.adam.v)))
    return params, state


def _one_pod(src, pod_batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One pod's loss, metrics and float32 gradient leaves (in leaf order)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(src)]
    loss, m = loss_fn(tree_unflatten(src, leaves), pod_batch, cfg)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss never reads (musicgen's untied embed) gets a zero
    # gradient, as jax.value_and_grad gives it; AdamW still decays it
    grads = [torch.zeros_like(x, dtype=torch.float32) if g is None else g.float() for x, g in zip(leaves, got)]
    return loss.detach(), {k: v.detach() for k, v in m.items()}, grads


def _rows(batch: Dict[str, torch.Tensor], npods: int, pod: int) -> Dict[str, torch.Tensor]:
    """Pod ``pod``'s slice of the global batch."""
    b = next(iter(batch.values())).shape[0]
    if b % npods:
        raise ValueError(f"global batch {b} does not split over {npods} pods")
    per = b // npods
    return {k: v[pod * per : (pod + 1) * per] for k, v in batch.items()}


def pod_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, npods: int, *, replicas: bool = False):
    """Each pod's loss and gradients on its slice of ``batch``, pod by pod.

    ``replicas``: the leaves of ``params`` are ``[npods, ...]`` and pod p
    computes with its own slice; otherwise every pod computes with
    ``params``.  Returns (loss, metrics, grads): loss and metrics averaged
    over pods as the JAX step's ``psum / npods`` does, grads a tree of
    float32 ``[npods, ...]`` leaves.
    """
    losses, metrics, grads = [], [], []
    for p in range(npods):
        src = tree_map(lambda t: t[p], params) if replicas else params
        loss, m, g = _one_pod(src, _rows(batch, npods, p), cfg)
        losses.append(loss)
        metrics.append(m)
        grads.append(g)
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
    mesh=None,
    npods: Optional[int] = None,
    strategy: str = "hier",
    num_channels: int = 4,
    opt_cfg: Optional[AdamWConfig] = None,
    diloco_cfg: Optional[DilocoConfig] = None,
    device: DeviceLike = "cuda",
):
    """step(params, state, batch) -> (params, state, metrics).

    The pods are ``mesh``'s (``npods``, if given, must agree), or ``npods``
    without a mesh; on a group mesh the step runs the rank's pod
    (:func:`_make_group_step`).  ``batch`` is the global batch, numpy
    arrays or tensors; they are moved to ``device``.
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
    npods = _pods(mesh, npods)
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()
    diloco_cfg = diloco_cfg or DilocoConfig()
    if is_group_mesh(mesh):
        group = PodGroup(pod_process_group(mesh), device=device)
        return _make_group_step(cfg, group, strategy, num_channels, opt_cfg, diloco_cfg, device)

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


def _make_group_step(cfg, group: PodGroup, strategy, num_channels, opt_cfg, diloco_cfg, device):
    """The step of one rank of a group mesh: its pod's rows of the global
    batch, the strategy as collectives, AdamW on its own state.  ``ps``:
    the pushed gradients' mean, one AdamW update, rank 0's parameters
    pulled.  ``local_sgd``: the rank's own AdamW step, then the DiLoCo
    outer step on multiples of ``sync_every``; ``grad_norm`` and ``lr``
    are rank 0's, as the stacked step reports pod 0's."""
    n = group.size

    def step(params, state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        group.reset()
        loss, metrics, grads = _one_pod(params, _rows(batch, n, group.rank), cfg)
        grads = tree_unflatten(params, grads)
        loss = group.mean_in_rank_order(loss)
        metrics = {k: group.mean_in_rank_order(v) for k, v in metrics.items()}
        new_ef, new_diloco = state.ef, state.diloco
        if strategy == "allreduce":
            grads = sync_allreduce_group(grads, group)
        elif strategy == "hier":
            grads = sync_hier_group(grads, group, num_channels=num_channels)
        elif strategy == "hier_int8":
            grads, new_ef = sync_hier_int8_group(grads, state.ef, group)
        elif strategy == "ps":
            grads = sync_ps_group(grads, group)
        new_params, new_adam, opt_metrics = adamw_update(opt_cfg, grads, state.adam, params)
        if strategy == "ps":
            new_params = pull_params_group(new_params, group)
        if strategy == "local_sgd":
            opt_metrics = {k: group.broadcast(v.clone(), wan=False) for k, v in opt_metrics.items()}
            if int(new_adam.step) % diloco_cfg.sync_every == 0:
                new_params, new_diloco = outer_step_group(diloco_cfg, new_params, state.diloco, group)
        metrics = dict(metrics, loss=loss, wan_bytes=group_wan_bytes(strategy, group.handed, n),
                       collective_s=group.wan_seconds, **opt_metrics)
        return new_params, TrainState(new_adam, new_ef, new_diloco), metrics

    step.group = group
    return step


def _placements(mesh):
    """Where a serving step's tensors live on ``mesh``'s pod dimension:
    the parameters replicated, the batch, cache and logits split by rows
    over the pods of a group mesh; in one process, everything whole on the
    device."""
    from torch.distributed.tensor import Replicate, Shard

    rows = (Shard(0),) if is_group_mesh(mesh) else (Replicate(),)
    return {"params": (Replicate(),), "batch": rows, "cache": rows, "logits": rows}


def make_prefill_step(cfg: ModelConfig, mesh, *, device: DeviceLike = "cuda"):
    """Inference prefill over ``mesh``: step(params, batch, max_len=None)
    -> (last-position logits, cache) on ``device``.  On a group mesh each
    rank prefills its pod's rows of the global batch.  Returns (step,
    placements)."""
    npods, device = _pods(mesh, None), resolve_device(device)
    group = is_group_mesh(mesh)
    rank = torch.distributed.get_rank(pod_process_group(mesh)) if group else 0

    def step(params, batch, max_len: Optional[int] = None):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        return prefill(params, _rows(batch, npods, rank) if group else batch, cfg, max_len=max_len)

    return step, _placements(mesh)


def make_decode_step(cfg: ModelConfig, mesh, *, device: DeviceLike = "cuda"):
    """One decode step over ``mesh``: step(params, tokens_t, cache,
    position) -> (logits, cache).  ``tokens_t`` holds the global batch's
    tokens; on a group mesh each rank decodes its pod's rows against its
    own cache (from :func:`make_prefill_step`).  Returns (step,
    placements)."""
    npods, device = _pods(mesh, None), resolve_device(device)
    group = is_group_mesh(mesh)
    rank = torch.distributed.get_rank(pod_process_group(mesh)) if group else 0

    def step(params, tokens_t, cache, position: int):
        tokens_t = torch.as_tensor(tokens_t, device=device)
        if group:
            tokens_t = _rows({"t": tokens_t}, npods, rank)["t"]
        return model_decode_step(params, tokens_t, cache, cfg, position)

    return step, _placements(mesh)
