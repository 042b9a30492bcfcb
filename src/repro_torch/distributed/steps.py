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

On a group mesh whose ``data`` or ``model`` axis is larger than 1
(the same step, :func:`_make_group_step`), each pod is itself a ``(data, model)`` mesh of
ranks: parameters, optimizer state and batch are DTensors placed by
:mod:`.sharding`'s rules, the forward and backward run on those
placements (FSDP over ``data``: a parameter all-gathered for use, its
gradient reduce-scattered; tensor parallelism over ``model``, and the
residual's sequence over ``model`` between blocks: sequence parallelism,
:mod:`.act_sharding`), and the WAN
strategies run over ``pod`` on each rank's pieces of the gradients
(:mod:`.placement`), the intra-pod collectives counted apart as LAN
traffic (:mod:`.lan`).  Summing a gradient over ``data`` adds in another
order than one process does, so that step agrees with the one-process
step to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, host_tensors, resolve_device
from ..launch.mesh import (
    data_process_group,
    intra_pod_mesh,
    is_group_mesh,
    mesh_shape,
    model_process_group,
    num_pods,
    pod_index,
    pod_process_group,
)
from ..models import decode_step as model_decode_step
from ..models import init_params, loss_fn, prefill
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw
from ..optim.diloco import DilocoConfig, DilocoState, init_diloco, outer_step, outer_step_group
from ..tree import tree_items, tree_leaves, tree_map, tree_unflatten
from .act_sharding import activation_sharding, gathered_where_shards_move, redistribute
from .lan import LanCollectives
from .placement import drop_pod, from_piece, full, is_dtensor, place_tree, to_piece
from .pod_group import PodGroup
from .sharding import (batch_placements, cache_placements, expert_dim, map_params, map_specs, params_placements,
                       params_pspecs)
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
    pods = num_pods(mesh)
    if npods is not None and npods != pods:
        raise ValueError(f"npods={npods} disagrees with the mesh's {pods} pods")
    return pods


def intra_placements(placements_tree, mesh):
    """A tree of full-mesh placements with each leaf's ``pod`` entry
    dropped: where the leaf lives on the rank's pod mesh."""
    axes = tuple(mesh_shape(mesh))
    return map_specs(lambda pl: drop_pod(pl, axes), placements_tree)


def _state_like(tree, step, strategy: str) -> TrainState:
    """A :class:`TrainState` of ``tree`` (one per parameter) and ``step``."""
    return TrainState(
        adam=AdamWState(step=step, m=tree, v=tree),
        ef=tree if strategy == "hier_int8" else (),
        diloco=DilocoState(anchor=tree, momentum=tree) if strategy == "local_sgd" else (),
    )


def state_pspecs(params_shapes, mesh, *, strategy: str = "hier") -> TrainState:
    """Port of the JAX ``state_pspecs``: AdamW ``m`` and ``v``, the error
    feedback and the DiLoCo anchor and momentum specified as the
    parameters are; the step counter ``()``."""
    return _state_like(params_pspecs(params_shapes, mesh), (), strategy)


def state_placements(params_shapes, mesh, *, strategy: str = "hier") -> TrainState:
    """:func:`state_pspecs` as DTensor placements; the step counter replicated."""
    from torch.distributed.tensor import Replicate

    return _state_like(params_placements(params_shapes, mesh), (Replicate(),) * len(mesh_shape(mesh)), strategy)


def place_train_state(state: TrainState, mesh, *, strategy: str) -> TrainState:
    """The rank's shards of a one-pod :class:`TrainState` of full tensors
    (a restored checkpoint), placed as :func:`state_placements` says."""
    intra = intra_pod_mesh(mesh)
    pl = intra_placements(params_placements(state.adam.m, mesh), mesh)  # each state tree is placed as the parameters
    place = lambda tree: place_tree(tree, intra, pl)  # noqa: E731
    adam = AdamWState(step=state.adam.step, m=place(state.adam.m), v=place(state.adam.v))
    ef = place(state.ef) if strategy == "hier_int8" else state.ef
    diloco = state.diloco
    if strategy == "local_sgd":
        diloco = DilocoState(anchor=place(diloco.anchor), momentum=place(diloco.momentum))
    return TrainState(adam, ef, diloco)


def init_train_state(
    params, opt_cfg: AdamWConfig, *, strategy: str = "hier", npods: Optional[int] = None, mesh=None
) -> TrainState:
    """From the model's parameters (one copy, no pod dimension).  On a group
    mesh, the rank's own state: no pod dimension anywhere; on a pod of
    several ranks, DTensors placed as the parameters are
    (:func:`state_placements`)."""
    _check_strategy(strategy)
    npods = _pods(mesh, npods)
    if is_group_mesh(mesh):
        params, npods = init_pod_params(params, strategy=strategy, mesh=mesh), 1
    ef = ()
    if strategy == "hier_int8":
        if is_group_mesh(mesh):
            ef = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        else:
            ef = tree_map(lambda p: torch.zeros((npods, *p.shape), dtype=torch.float32, device=p.device), params)
    adam = init_adamw(params)
    if _per_pod(strategy, npods):
        adam = AdamWState(step=adam.step, m=_stack(adam.m, npods), v=_stack(adam.v, npods))
    diloco = init_diloco(params) if strategy == "local_sgd" else ()
    return TrainState(adam=adam, ef=ef, diloco=diloco)


def init_pod_params(params, *, strategy: str = "hier", npods: Optional[int] = None, mesh=None):
    """The parameters the step takes: for ``local_sgd`` on more than one pod
    in one process one replica per pod, ``[npods, ...]`` leaves; on a pod
    of several ranks the rank's shards of ``params`` (full tensors, the
    same on every rank), placed by the rules; otherwise (a group mesh
    included: the rank's own) ``params``."""
    _check_strategy(strategy)
    if is_group_mesh(mesh):
        intra = intra_pod_mesh(mesh)
        if intra is None or is_dtensor(tree_leaves(params)[0]):
            return params
        return place_tree(params, intra, intra_placements(params_placements(params, mesh), mesh))
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
    """One pod's loss, metrics and gradient leaves (in leaf order), each in
    its parameter's dtype as ``jax.value_and_grad`` gives it: the syncs and
    AdamW take them to float32 (mixtral-8x22b's bf16 expert stacks would
    take twice the memory as float32)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(src)]
    loss, m = loss_fn(tree_unflatten(src, leaves), pod_batch, cfg)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss never reads (musicgen's untied embed) gets a zero
    # gradient, as jax.value_and_grad gives it; AdamW still decays it
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)]
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
    ``[npods, ...]`` leaves in the parameters' dtypes, stacked a leaf at a
    time (the pods' own copies of a leaf go as it is stacked, so the whole
    tree is never held twice).
    """
    losses, metrics, grads = [], [], []
    for p in range(npods):
        src = tree_map(lambda t: t[p], params) if replicas else params
        loss, m, g = _one_pod(src, _rows(batch, npods, p), cfg)
        losses.append(loss)
        metrics.append(m)
        grads.append(g)
    stacked = []
    for i in range(len(grads[0])):
        stacked.append(torch.stack([g[i] for g in grads]))
        for g in grads:
            g[i] = None
    stacked = tree_unflatten(src, stacked)
    loss = sum(losses) / npods
    mean = {k: sum(m[k] for m in metrics) / npods for k in metrics[0]}
    return loss, mean, stacked


def sync_grads(grads, ef, *, strategy: str, num_channels: int = 4, in_place: bool = False) -> Tuple[Any, Any, int]:
    """Cross-pod sync of ``[npods, ...]`` grads -> (synced, new ef, WAN bytes per pod).

    ``local_sgd`` sends nothing: its grads come back as they went in, one
    per pod.  ``in_place``: ``hier_int8`` writes the new ef into ``ef`` and
    frees each leaf of ``grads`` once it is folded in (the gradients are
    donated: the caller must not read them afterwards)."""
    _check_strategy(strategy)
    if strategy == "hier_int8":
        return sync_hier_int8(grads, ef, in_place=in_place)
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
    donate: bool = False,
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

    ``donate`` (the JAX step's ``donate_argnums``): the step may update
    ``params`` and ``state`` in their own storage, so the caller must not
    use them afterwards; it needs no second copy of the parameters, the
    moments, the error feedback and the DiLoCo anchor and momentum, and the
    one-process ``hier_int8`` frees each pod gradient once folded into the
    error feedback (recurrentgemma-9b's one-group cut and mixtral-8x22b's
    one layer do not fit on one card without it).  Any mesh, any strategy;
    the values are the functional step's, bit for bit.
    """
    _check_strategy(strategy)
    npods = _pods(mesh, npods)
    device = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig()
    diloco_cfg = diloco_cfg or DilocoConfig()
    if is_group_mesh(mesh):
        return _make_group_step(cfg, mesh, strategy, num_channels, opt_cfg, diloco_cfg, device, donate)

    def step(params, state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if _per_pod(strategy, npods):
            return local_step(params, state, batch)
        loss, metrics, grads = pod_grads(params, batch, cfg, npods)
        new_ef, wan = state.ef, 0
        if npods > 1:
            grads, new_ef, wan = sync_grads(grads, state.ef, strategy=strategy, num_channels=num_channels,
                                            in_place=donate)
        else:
            grads = tree_map(lambda g: g[0], grads)
        new_params, new_adam, opt_metrics = adamw_update(opt_cfg, grads, state.adam, params, in_place=donate)
        metrics = dict(metrics, loss=loss, wan_bytes=wan, **opt_metrics)
        return new_params, TrainState(new_adam, new_ef, state.diloco), metrics

    def local_step(params, state: TrainState, batch):
        loss, metrics, grads = pod_grads(params, batch, cfg, npods, replicas=True)
        outs = []
        for p in range(npods):  # donated: each pod's slice of the stacked leaves updated in place
            pod = lambda tree: tree_map(lambda t: t[p], tree)  # noqa: E731
            adam = AdamWState(state.adam.step, pod(state.adam.m), pod(state.adam.v))
            outs.append(adamw_update(opt_cfg, pod(grads), adam, pod(params), in_place=donate))
        if donate:
            new_params, new_adam = params, AdamWState(outs[0][1].step, state.adam.m, state.adam.v)
        else:
            stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)  # noqa: E731
            new_params = stack([o[0] for o in outs])
            new_adam = AdamWState(outs[0][1].step, stack([o[1].m for o in outs]), stack([o[1].v for o in outs]))
        new_diloco, wan = state.diloco, 0
        if int(new_adam.step) % diloco_cfg.sync_every == 0:
            new_params, new_diloco = outer_step(diloco_cfg, new_params, state.diloco, in_place=donate)
            wan = full_precision_bytes(new_params)
        metrics = dict(metrics, loss=loss, wan_bytes=wan, **outs[0][2])
        return new_params, TrainState(new_adam, state.ef, new_diloco), metrics

    return step


def _scalar(x) -> torch.Tensor:
    """A metric's value on this rank: a DTensor reduced over its mesh."""
    return full(x).detach().reshape(())


def place_batch(batch: Dict[str, torch.Tensor], mesh):
    """The rank's pod's rows of a global batch, as DTensors on its pod mesh
    placed by ``batch_pspecs`` (rows over ``data`` where they divide)."""
    rows = _rows(batch, num_pods(mesh), pod_index(mesh))
    return place_tree(rows, intra_pod_mesh(mesh), intra_placements(batch_placements(batch, mesh), mesh))


def _fsdp_gather(p, expert_dim: Optional[int] = None):
    """A parameter as the forward uses it: all-gathered over ``data``
    (FSDP; the gradient flows back reduce-scattered), its ``model`` shard
    kept on a matrix dim (tensor parallelism) or on ``expert_dim``, an
    expert stack's E (expert parallelism), and gathered on a layer-stack
    dim, which the forward indexes layer by layer (the stacked dense FFN's
    ``[L, D, F]`` puts L on ``model``: the JAX rule's MoE quirk).  The
    dtype stays (bf16 expert stacks are gathered in bf16).  A gradient that
    comes back sharded on another dim than its parameter (a stacked FFN's
    F, where the parameter's shard is L) is gathered on that axis before it
    is cut to the parameter's shard: DTensor would move it with an
    all-to-all."""
    from torch.distributed.tensor import Replicate, Shard

    def use(axis, pl):  # a strided shard (the few-expert width) is gathered too
        keep = axis == "model" and type(pl) is Shard and (pl.dim >= p.ndim - 2 or pl.dim == expert_dim)
        return pl if keep else Replicate()

    want = tuple(use(a, pl) for a, pl in zip(p.device_mesh.mesh_dim_names, p.placements))
    if want == tuple(p.placements):
        return p
    used = p.redistribute(p.device_mesh, want)
    if used.requires_grad:
        placed = tuple(p.placements)
        used.register_hook(lambda g: gathered_where_shards_move(g, placed))
    return used


def _fsdp_gather_tree(params):
    """:func:`_fsdp_gather` over a parameter tree, each expert stack's
    expert dim named by its key path."""
    return map_params(lambda names, p: _fsdp_gather(p, expert_dim(names, p.ndim)), params)


# The activation batch axis of the mesh steps: rows over ``data``.
ACT_AXES = "data"


def _seq_axes(mesh) -> Optional[str]:
    """The train step's sequence axis on a pod mesh (:mod:`.act_sharding`):
    ``model`` where the mesh has it, as the JAX step shards the residual's
    sequence between blocks; serving keeps the sequence whole, as the JAX
    prefill and decode steps do."""
    return "model" if "model" in (mesh.mesh_dim_names or ()) else None


def _mesh_grads(params, batch, cfg: ModelConfig):
    """The pod's loss, metrics and gradients on its rows, the model run on
    DTensors: every parameter FSDP-gathered, activations placed by the
    active context (rows over ``data``, the residual's sequence over
    ``model`` between blocks), gradients placed as their parameters and in
    their dtypes, as :func:`_one_pod` gives them (bf16 expert stacks'
    gradients in bf16: their reduce over ``data`` already ran in bf16, and
    a float32 copy would be twice the memory)."""
    from torch.distributed.tensor.experimental import implicit_replication

    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with implicit_replication(), activation_sharding(ACT_AXES, _seq_axes(leaves[0].device_mesh)):
        used = _fsdp_gather_tree(tree_unflatten(params, leaves))
        loss, m = loss_fn(used, batch, cfg)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = []
    for x, g in zip(leaves, got):
        if g is None:
            g = torch.zeros_like(x)
        elif tuple(g.placements) != tuple(x.placements):  # a partial sum over data reduce-scatters here
            g = redistribute(g, x.placements)
        grads.append(g)
    return _scalar(loss), {k: _scalar(v) for k, v in m.items()}, tree_unflatten(params, grads)


def _pieces(tree):
    """Each DTensor leaf's WAN piece (:func:`.placement.to_piece`), as a
    flat dict by path, with the empty pieces left out (the pod group's
    ranks share a coordinate, so they leave out the same ones)."""
    return {k: v for k, v in ((k, to_piece(t)) for k, t in tree_items(tree)) if v.numel()}


def _unpieces(pieces, like, dtype=None):
    """A tree placed as ``like`` from its pieces (missing: empty), in
    ``like``'s dtypes or ``dtype`` (the synced gradients stay float32, as
    the strategies give them)."""
    leaves = []
    for k, t in tree_items(like):
        piece = pieces.get(k)
        want = dtype or t.dtype
        if piece is None:
            piece = torch.empty((0, *t.shape[1:]) if t.ndim >= 2 else (0,), dtype=want, device=t.to_local().device)
        leaves.append(from_piece(piece.to(want), t))
    return tree_unflatten(like, leaves)


def _write_into(dst, src):
    """``src``'s values in ``dst``'s own storage (a DTensor's local shard,
    ``src`` placed alike or moved there first); returns ``dst``."""
    if is_dtensor(dst):
        if tuple(src.placements) != tuple(dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)
    return dst


def _make_group_step(cfg, mesh, strategy, num_channels, opt_cfg, diloco_cfg, device, donate=False):
    """The step of one rank of a group mesh.

    The rank's pod computes the loss, metrics and gradients on its rows of
    the global batch: with one rank a pod, that rank on whole leaves
    (:func:`_one_pod`); on a pod of several ranks, the model run on
    DTensors (:func:`_mesh_grads`), every intra-pod collective through
    :class:`.lan.LanCollectives` (``lan_bytes``, ``lan_s``: what this rank
    handed them this step, its host seconds in them).  With more than one
    pod the strategy runs over the pod group on the rank's pieces of the
    gradients (and, for ``ps`` and ``local_sgd``, of the parameters and
    DiLoCo state): its whole leaves with one rank a pod, else
    :func:`_pieces`, rebuilt into their placements after.  AdamW updates
    the rank's own leaves or local shards.  ``ps``: the pushed gradients'
    mean, one AdamW update, the pod group's rank 0's parameters pulled.
    ``local_sgd``: the rank's own AdamW step, then the DiLoCo outer step on
    multiples of ``sync_every``; ``grad_norm`` and ``lr`` are the pod
    group's rank 0's, as the stacked step reports pod 0's.  ``wan_bytes``
    is what the rank's pod sends, summed over the pod's ranks, and
    ``collective_s`` the rank's host seconds in WAN collectives; on a pod of
    several ranks ``wan_bytes_rank`` is the rank's share of ``wan_bytes``.

    ``hier_int8``'s error feedback, ``ps``'s pull and ``local_sgd``'s
    outer step (parameters, anchor, momentum) run a leaf at a time.
    ``donate``: AdamW updates the rank's leaves (local shards) in place, and
    each of those leaf results is written into the leaf's own storage.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    intra, n = intra_pod_mesh(mesh), num_pods(mesh)
    group = PodGroup(pod_process_group(mesh), device=device) if n > 1 else None
    if intra is None:
        lan, pieces, unpieces = None, (lambda tree: tree), (lambda got, like, dtype=None: got)

        def grads_of(params, batch):
            loss, metrics, grads = _one_pod(params, _rows(batch, n, pod_index(mesh)), cfg)
            return loss, metrics, tree_unflatten(params, grads)
    else:
        lan, pieces, unpieces = LanCollectives(device), _pieces, _unpieces

        def grads_of(params, batch):
            return _mesh_grads(params, place_batch(batch, mesh), cfg)

    def keep(dst, src):
        """A leaf's new value: written into ``dst``'s own storage where the
        step donates, else ``src`` itself."""
        return _write_into(dst, src) if donate else src

    def leafwise(fn, *trees):
        """``fn`` on one leaf of each tree at a time (each a one-leaf tree),
        its outputs' leaves -> trees shaped as ``trees[0]``: what a donating
        step holds at once is one leaf's pieces, not a tree's.  The
        strategies' group functions work leaf by leaf, so the collectives
        are the same, in the same order."""
        outs = [fn(*({"t": t} for t in leaves)) for leaves in zip(*map(tree_leaves, trees))]
        return tuple(tree_unflatten(trees[0], [o[i]["t"] for o in outs]) for i in range(len(outs[0])))

    def int8_leaf(grads, ef):
        synced, new_ef = sync_hier_int8_group(pieces(grads), pieces(ef), group)
        return unpieces(synced, grads, torch.float32), {"t": keep(ef["t"], unpieces(new_ef, ef)["t"])}

    def wan_sync(grads, ef):
        """The strategy over the pod group -> (synced grads, new error
        feedback); ``local_sgd`` sends no gradients."""
        if strategy == "local_sgd":
            return grads, ef
        if strategy == "hier_int8":
            return leafwise(int8_leaf, grads, ef)
        if strategy == "allreduce":
            synced = sync_allreduce_group(pieces(grads), group)
        elif strategy == "hier":
            synced = sync_hier_group(pieces(grads), group, num_channels=num_channels)
        else:  # ps: the push
            synced = sync_ps_group(pieces(grads), group)
        return unpieces(synced, grads, torch.float32), ef

    def pull_leaf(params):
        pulled = unpieces(pull_params_group(pieces(params), group), params)
        return ({"t": keep(params["t"], pulled["t"])},)

    def outer_leaf(params, anchor, momentum):
        """The outer step of one leaf on its pieces -> the leaf's
        parameters, anchor and momentum."""
        p, dil = outer_step_group(diloco_cfg, pieces(params),
                                  DilocoState(anchor=pieces(anchor), momentum=pieces(momentum)), group)
        return tuple({"t": keep(like["t"], unpieces(got, like)["t"])}
                     for got, like in ((p, params), (dil.anchor, anchor), (dil.momentum, momentum)))

    shapes = init_params(cfg, device="meta")
    placements = {
        "params": params_placements(shapes, mesh),
        "state": state_placements(shapes, mesh, strategy=strategy),
        "batch": None,  # from the first batch's shapes
    }

    def step(params, state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if placements["batch"] is None:
            placements["batch"] = batch_placements({k: v.to("meta") for k, v in batch.items()}, mesh)
        if lan is not None:
            lan.reset()
        if group is not None:
            group.reset()
        with lan if lan is not None else contextlib.nullcontext():
            loss, metrics, grads = grads_of(params, batch)
            new_ef, new_diloco = state.ef, state.diloco
            if group is not None:
                loss = group.mean_in_rank_order(loss)
                metrics = {k: group.mean_in_rank_order(v) for k, v in metrics.items()}
                grads, new_ef = wan_sync(grads, state.ef)
            with implicit_replication():
                new_params, new_adam, opt_metrics = adamw_update(opt_cfg, grads, state.adam, params,
                                                                 in_place=donate)
            del grads
            if group is not None and strategy == "ps":
                new_params = leafwise(pull_leaf, new_params)[0]
            if group is not None and strategy == "local_sgd":
                opt_metrics = {k: group.broadcast(v.clone(), wan=False) for k, v in opt_metrics.items()}
                if int(new_adam.step) % diloco_cfg.sync_every == 0:
                    d = state.diloco
                    new_params, anchor, momentum = leafwise(outer_leaf, new_params, d.anchor, d.momentum)
                    new_diloco = DilocoState(anchor=anchor, momentum=momentum)
        wan_rank = group_wan_bytes(strategy, group.handed, n) if group is not None else 0
        metrics = dict(metrics, loss=loss, wan_bytes=_pod_sum(wan_rank, mesh),
                       collective_s=group.wan_seconds if group is not None else 0.0, **opt_metrics)
        if lan is not None:
            metrics.update(wan_bytes_rank=wan_rank, lan_bytes=lan.lan_bytes, lan_s=lan.lan_seconds)
        return new_params, TrainState(new_adam, new_ef, new_diloco), metrics

    step.group, step.lan, step.placements = group, lan, placements
    return step


def _pod_sum(x: int, mesh) -> int:
    """The sum of an integer each rank holds over the rank's pod: its
    ``data`` and ``model`` peers (``x`` itself with one rank a pod)."""
    with host_tensors():
        t = torch.tensor(x, dtype=torch.int64)
        for group in (data_process_group(mesh), model_process_group(mesh)):
            if group is not None:
                torch.distributed.all_reduce(t, group=group)
        return int(t)


def _meta(tree):
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"), tree)


def _note(placements, key, fn, tree, mesh):
    """Fill ``placements[key]`` once, from ``tree``'s shapes: by the rules
    (``fn``) on a group mesh; every leaf ``Replicate()`` in one process,
    where the device holds everything whole."""
    from torch.distributed.tensor import Replicate

    if key in placements:
        return
    if is_group_mesh(mesh):
        placements[key] = fn(_meta(tree), mesh)
    else:
        axes = len(mesh_shape(mesh)) if mesh is not None else 1
        placements[key] = tree_map(lambda _: (Replicate(),) * axes, tree)


def _serve_placements(cfg: ModelConfig, mesh):
    """A serving step's placements: ``"params"`` now, the batch (or
    tokens) and cache filled at the first call."""
    placements = {}
    _note(placements, "params", params_placements, init_params(cfg, device="meta"), mesh)
    return placements


def _mesh_serving(mesh, device):
    """(intra-pod mesh, its LanCollectives) of a pod of several ranks, else (None, None)."""
    intra = intra_pod_mesh(mesh)
    return intra, None if intra is None else LanCollectives(device)


def _on_mesh(fn, lan, seq_axes=None):
    """``fn()`` with the model on DTensors: parameters FSDP-gathered by the
    caller, activations placed by ``ACT_AXES`` (and ``seq_axes``), the
    intra-pod collectives through ``lan``."""
    from torch.distributed.tensor.experimental import implicit_replication

    lan.reset()
    with lan, implicit_replication(), activation_sharding(ACT_AXES, seq_axes):
        return fn()


def make_prefill_step(cfg: ModelConfig, mesh, *, device: DeviceLike = "cuda", sequence_parallel: bool = False):
    """Inference prefill over ``mesh``: step(params, batch, max_len=None)
    -> (last-position logits, cache) on ``device``.  On a group mesh each
    rank prefills its pod's rows of the global batch and gets their logits
    whole; on a pod of several ranks the parameters (full tensors, which
    :func:`init_pod_params` places, or their shards) and the batch are
    DTensors placed by the rules, and the cache comes back as DTensors
    placed by ``cache_pspecs``.  ``sequence_parallel``: the residual's
    sequence over ``model`` between blocks, as the JAX dry run lowers its
    prefill (serving keeps it whole, as the JAX ``make_prefill_step``
    does).  Returns (step, placements): ``{"params", "batch", "cache"}``."""
    npods, device = _pods(mesh, None), resolve_device(device)
    group = is_group_mesh(mesh)
    rank = pod_index(mesh)
    intra, lan = _mesh_serving(mesh, device)
    placements = _serve_placements(cfg, mesh)

    def step(params, batch, max_len: Optional[int] = None):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        _note(placements, "batch", batch_placements, batch, mesh)
        if intra is None:
            logits, cache = prefill(params, _rows(batch, npods, rank) if group else batch, cfg, max_len=max_len)
            _note(placements, "cache", cache_placements, cache, mesh)
            return logits, cache

        def run():
            used = _fsdp_gather_tree(init_pod_params(params, mesh=mesh))
            logits, cache = prefill(used, place_batch(batch, mesh), cfg, max_len=max_len)
            _note(placements, "cache", cache_placements, cache, mesh)
            want = intra_placements(placements["cache"], mesh)
            cache = _redistribute_tree(cache, want)
            return full(logits), cache

        return _on_mesh(run, lan, _seq_axes(intra) if sequence_parallel else None)

    step.lan = lan
    return step, placements


def _redistribute_tree(tree, placements_tree):
    if isinstance(tree, dict):
        return {k: _redistribute_tree(v, placements_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_redistribute_tree(v, p) for v, p in zip(tree, placements_tree)]
    if tuple(tree.placements) == tuple(placements_tree):
        return tree
    return tree.redistribute(tree.device_mesh, placements_tree)


def make_decode_step(cfg: ModelConfig, mesh, *, device: DeviceLike = "cuda"):
    """One decode step over ``mesh``: step(params, tokens_t, cache,
    position) -> (logits, cache).  ``tokens_t`` holds the global batch's
    tokens; on a group mesh each rank decodes its pod's rows against its
    own cache (from :func:`make_prefill_step`), its shard of it on a pod
    of several ranks, written in place.  There the parameters are gathered
    as the forward uses them once, and kept (as long as the step lives)
    while the same tensors come back unchanged (by their version
    counters): a decode step after the first moves only activations.
    Returns (step, placements):
    ``{"params", "cache", "tokens"}``."""
    npods, device = _pods(mesh, None), resolve_device(device)
    group = is_group_mesh(mesh)
    rank = pod_index(mesh)
    intra, lan = _mesh_serving(mesh, device)
    placements = _serve_placements(cfg, mesh)
    gathered: Dict[str, Any] = {}

    def used_params(params):
        leaves = tree_leaves(params)
        versions = [(t.to_local() if is_dtensor(t) else t)._version for t in leaves]
        kept = gathered.get("leaves")
        if kept is None or len(kept) != len(leaves) or any(a is not b for a, b in zip(kept, leaves)) \
                or gathered["versions"] != versions:
            gathered.clear()  # the old gathered tree goes before the new one is made
            gathered.update(leaves=leaves, versions=versions,
                            used=_fsdp_gather_tree(init_pod_params(params, mesh=mesh)))
        return gathered["used"]

    def step(params, tokens_t, cache, position: int):
        tokens_t = torch.as_tensor(tokens_t, device=device)
        if "tokens" not in placements:
            _note(placements, "tokens", batch_placements, {"t": tokens_t}, mesh)
            placements["tokens"] = placements["tokens"]["t"]
        _note(placements, "cache", cache_placements, cache, mesh)
        if intra is None:
            if group:
                tokens_t = _rows({"t": tokens_t}, npods, rank)["t"]
            return model_decode_step(params, tokens_t, cache, cfg, position)

        def run():
            tokens = place_batch({"t": tokens_t}, mesh)["t"]
            logits, new_cache = model_decode_step(used_params(params), tokens, cache, cfg, position)
            return full(logits), new_cache

        return _on_mesh(run, lan)

    step.lan = lan
    return step, placements
