"""Sharding rules: parameter, batch and cache specs per mesh, and their DTensor placements.

Port of ``repro.distributed.sharding``, rule for rule:

* projections' input-ish dim -> ``data`` (FSDP), output-ish dim -> ``model``
  (tensor parallelism); experts -> ``model`` (expert parallelism) with the
  expert FFN width additionally FSDP-sharded over ``data``;
* parameters are REPLICATED across ``pod``: each data center holds a full
  replica, and only gradient synchronisation crosses the WAN;
* batch dims shard over ``("pod", "data")``; KV caches shard batch over
  ``data`` and kv-heads over ``model``;
* a dim is sharded only when the mesh axis divides it, else that dim falls
  back to replication (odd vocabularies, tiny smoke configs).

The JAX rule keys its MoE branch on the leaf's name and rank alone: any
rank-3 ``w_gate`` / ``w_up`` / ``w_down`` under an ``ffn`` key takes the
expert rule, so the stacked dense FFN of a ``groups`` leaf (``[L, D, F]``)
puts its layer dim on ``model``.  The port copies that, as it copies every
rule: placement changes no value, only which bytes each rank holds.

``params_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` give, for each
leaf, a tuple with one entry per tensor dim: ``None``, a mesh-axis name,
or a tuple of names (one dim over two axes) -- the content of the JAX
``PartitionSpec``, which normalises a one-name tuple to the name, as this
does.  A leaf without a rule gets ``()``, as ``P()`` is.  The ``*_placements``
forms turn the specs into DTensor placements, one per mesh dimension.

A mesh is a :class:`~repro_torch.launch.mesh.LocalMesh`, a ``DeviceMesh``,
or a plain ``{axis: size}`` dict (the rules at production sizes need no
devices).  Leaves are anything with a ``.shape``: meta tensors size a
full model for free.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..tree import tree_map

# rules keyed by parameter leaf name -> spec over the TRAILING dims.
# "F" = fsdp/data axis, "T" = tensor/model axis, "E" = expert/model axis,
# None = replicated.  Leading (stack) dims are padded with None.
_TRAILING_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings: the non-vocab dim never shards over "data" (the JAX
    # package's CPU partitioner needs that), vocab-over-model is the
    # TP-friendly layout for the LM head
    "embed": ("T", None),  # (V, D)
    "unembed": ("F", "T"),  # (D, V)
    "frontend_proj": (None, "T"),  # (frontend_dim, D)
    # attention
    "wq": ("F", "T"),
    "wk": ("F", "T"),
    "wv": ("F", "T"),
    "wo": ("T", "F"),
    "bq": ("T",),
    "bk": ("T",),
    "bv": ("T",),
    "bo": (None,),
    # dense ffn
    "w_gate": ("F", "T"),
    "w_up": ("F", "T"),
    "w_down": ("T", "F"),
    "b_up": ("T",),
    "b_down": (None,),
    # rwkv time-mix / channel-mix
    "wr": ("F", "T"),
    "wg": ("F", "T"),
    "cm_k": ("F", "T"),
    "cm_v": ("T", "F"),
    "cm_r": ("F", "T"),
    "decay_a": ("F", None),
    "decay_b": (None, "F"),
    # rg-lru
    "w_in_x": ("F", "T"),
    "w_in_g": ("F", "T"),
    "w_gate_a": ("F", "T"),
    "w_gate_x": ("F", "T"),
    "w_out": ("T", "F"),
    "conv_w": (None, "T"),
    "conv_b": ("T",),
    # moe
    "router": ("F", None),
}

# MoE expert weights carry an extra leading E dim -> expert parallelism.
_MOE_TENSORS = {"w_gate", "w_up", "w_down"}
_MOE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("E", None, "F"),  # (E, D, F)
    "w_up": ("E", None, "F"),
    "w_down": ("E", "F", None),  # (E, F, D)
}

Spec = Tuple  # one entry per tensor dim: None, an axis name, or a tuple of names


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order, of any mesh the rules take."""
    if isinstance(mesh, dict):
        return dict(mesh)
    from ..launch.mesh import mesh_shape

    return mesh_shape(mesh)


def _axis(sizes: Dict[str, int], tag: Optional[str]) -> Optional[str]:
    if tag is None:
        return None
    name = {"F": "data", "T": "model", "E": "model"}[tag]
    return name if name in sizes else None


def _walk(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree, ``names`` the keys (and list
    indices) on the way to the leaf, as the JAX rules read a key path."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, names + (i,)) for i, v in enumerate(tree))
    return fn(names, tree)


def _spec_for(names, shape, sizes: Dict[str, int]) -> Spec:
    leaf_name = names[-1] if names else None
    rank = len(shape)
    in_moe = "ffn" in names and leaf_name in _MOE_TENSORS and rank >= 3
    if in_moe:
        trailing = _MOE_RULES[leaf_name]
        e_dim = rank - 3  # (..., E, D/F, F/D)
        if "model" in sizes and shape[e_dim] % sizes["model"] != 0:
            # few-expert MoE (Mixtral's 8 experts on a 16-way model axis):
            # EP does not divide, so the FFN width shards over model and
            # data jointly, model-major
            f_axes = ("model", "data")
            if all(a in sizes for a in f_axes):
                width = sizes["model"] * sizes["data"]
                f_dim = rank - 1 if leaf_name in ("w_gate", "w_up") else rank - 2
                if shape[f_dim] % width == 0:
                    spec = [None] * rank
                    spec[f_dim] = f_axes
                    return tuple(spec)
    else:
        trailing = _TRAILING_RULES.get(leaf_name)
    if trailing is None or rank < len(trailing):
        return ()
    spec = [None] * rank
    used = set()
    for i, tag in enumerate(trailing):
        dim = rank - len(trailing) + i
        axis = _axis(sizes, tag)
        if axis is None or axis in used:
            continue
        if shape[dim] % sizes[axis] == 0 and shape[dim] > 0:
            spec[dim] = axis
            used.add(axis)
    return tuple(spec)


def expert_dim(names, rank: int) -> Optional[int]:
    """The expert dim of an MoE expert stack, ``[E, D, F]`` / ``[E, F, D]``
    (``[L, E, ...]`` under ``groups``), at key path ``names``; None for any
    other leaf, the stacked dense FFN ``[L, D, F]`` (which ``_MOE_RULES``
    also place, the quirk above) and Arctic's dense FFN beside the experts
    among them."""
    if "ffn" not in names or "dense" in names or names[-1] not in _MOE_TENSORS:
        return None
    lead = 1 if "groups" in names else 0
    return lead if rank == 3 + lead else None


def map_params(fn, params):
    """``fn(names, leaf)`` over a parameter tree, ``names`` its key path."""
    return _walk(fn, params)


def params_pspecs(params_shapes, mesh):
    """The spec of every parameter leaf."""
    sizes = mesh_sizes(mesh)
    return _walk(lambda names, leaf: _spec_for(names, tuple(leaf.shape), sizes), params_shapes)


def _batch_axes(sizes: Dict[str, int], size: int):
    """Shard a batch dim over ("pod", "data") as divisibility allows."""
    combo: Tuple[str, ...] = ()
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and size % (prod * sizes[a]) == 0:
            combo += (a,)
            prod *= sizes[a]
    if not combo:
        return None
    return combo[0] if len(combo) == 1 else combo


def batch_pspecs(batch_shapes, mesh):
    """Every batch input sharded over its leading (batch) dim."""
    sizes = mesh_sizes(mesh)

    def spec(leaf):
        shape = tuple(leaf.shape)
        b = _batch_axes(sizes, shape[0]) if shape else None
        return (b, *([None] * max(len(shape) - 1, 0)))

    return tree_map(spec, batch_shapes)


def cache_pspecs(cache_shapes, mesh):
    """KV / recurrent cache specs, per leaf after the optional group-stack dim:

    * k/v ``[B, S, KVH, hd]``: batch over data, kv-heads over model (head_dim
      over model when the kv heads do not divide);
    * pos ``[S]``: replicated;
    * wkv ``[B, H, N, N]``: batch over data, heads over model;
    * conv/h/shift ``[B, ..., D]``: batch over data, last dim over model.
    """
    sizes = mesh_sizes(mesh)

    def div(n, axis):
        return axis in sizes and n % sizes[axis] == 0

    def spec(names, leaf):
        leaf_name = names[-1]
        lead = (None,) if "groups" in names else ()
        shape = tuple(leaf.shape)[len(lead):]
        data = lambda n: "data" if div(n, "data") else None  # noqa: E731
        if leaf_name in ("k", "v") and len(shape) == 4:
            b, _, kvh, hd = shape
            if div(kvh, "model"):
                kv_spec, hd_spec = "model", None
            elif div(hd, "model"):
                kv_spec, hd_spec = None, "model"
            else:
                kv_spec, hd_spec = None, None
            return (*lead, data(b), None, kv_spec, hd_spec)
        if leaf_name == "wkv" and len(shape) == 4:
            return (*lead, data(shape[0]), "model" if div(shape[1], "model") else None, None, None)
        if leaf_name in ("h", "conv", "shift_att", "shift_ffn") and len(shape) >= 2:
            mid = [None] * (len(shape) - 2)
            return (*lead, data(shape[0]), *mid, "model" if div(shape[-1], "model") else None)
        return (*lead, *([None] * len(shape)))

    return _walk(spec, cache_shapes)


# -- DTensor placements ----------------------------------------------------------


def spec_placements(spec: Spec, axes: Tuple[str, ...], sizes: Dict[str, int]):
    """One DTensor placement per mesh axis in ``axes`` for a leaf's spec:
    ``Shard(d)`` where dim d names the axis, ``Replicate()`` where no dim
    does.  A dim over two axes in the mesh's order is ``Shard(d)`` on both;
    in the other order (the few-expert ``("model", "data")``: model-major
    over a mesh ordered data, model) the earlier mesh axis takes
    ``_StridedShard(d, split_factor=<the later axis's size>)``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    out = {a: Replicate() for a in axes}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        order = sorted(names, key=axes.index)
        if list(names) == order:
            for a in names:
                out[a] = Shard(d)
        elif len(names) == 2:
            first, second = order
            out[first] = _StridedShard(d, split_factor=sizes[second])
            out[second] = Shard(d)
        else:
            raise ValueError(f"dim {d} over {names}: no placement for that order on a mesh of {axes}")
    return tuple(out[a] for a in axes)


def map_specs(fn, specs):
    """``fn`` over a spec tree, whose leaves are the spec tuples (dicts and
    lists are its nodes)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v) for v in specs]
    return fn(specs)


def _placements(specs, mesh):
    sizes = mesh_sizes(mesh)
    axes = tuple(sizes)
    return map_specs(lambda s: spec_placements(s, axes, sizes), specs)


def params_placements(params_shapes, mesh):
    """DTensor placements of every parameter leaf, one per mesh dimension
    (``Replicate()`` over ``pod``: no rule names it)."""
    return _placements(params_pspecs(params_shapes, mesh), mesh)


def batch_placements(batch_shapes, mesh):
    return _placements(batch_pspecs(batch_shapes, mesh), mesh)


def cache_placements(cache_shapes, mesh):
    return _placements(cache_pspecs(cache_shapes, mesh), mesh)
