"""Activation-sharding hook: the activations' batch dim, and between blocks their sequence dim, over mesh axes.

Port of ``repro.distributed.act_sharding``.  A step that runs the model on
DTensors enters :func:`activation_sharding` with the mesh axes of the
activation batch dim and, for sequence parallelism, of the sequence dim;
the model calls :func:`shard_activations` on the embedding output, on
every block's output before the residual add and at every group boundary.
It is a ``redistribute`` of a DTensor ``[B, S, ...]`` onto rows over the
batch axes and, where ``S > 1`` and the sequence axes divide ``S``, onto
``Shard(1)`` over them; replicated over the other axes.  A
tensor-parallel block's output, a partial sum over ``model``, so goes to
the rank's slice of the sequence in one reduce-scatter instead of an
all-reduce, and the residual between blocks (the input of each group's
checkpoint under remat) takes ``1/model`` of the memory.  A ragged ``S``
(which GSPMD pads) and decode's ``S == 1`` keep the sequence whole.
Outside a context, or for a plain tensor, the hook returns its input, so
one-process runs are unaffected.

Every block takes the whole sequence: it calls :func:`replicate_seq` (the
all-gather of the sequence over the sequence axes) on its normed input
before the projections, the RG-LRU conv and scan, RWKV's token shift and
WKV, or the MoE router and dispatch, and the final norm's output is
gathered so before the unembedding and the vocab-parallel loss.  A dense
FFN whose weights are whole on every ``model`` rank (a stacked ``[L, D,
F]`` leaf whose rule puts L on ``model``, gathered for the forward) runs
on the rank's own positions instead (:func:`whole_over_sequence`), as
GSPMD runs it: the JAX step computes it sequence-sharded too.  Norms
and residual adds run on the sequence shards.  No DTensor view, reshape
or flatten ever takes a tensor sharded on its sequence (the card's torch,
2.11, refuses to flatten a ``Shard(1)`` ``[B, S, D]``).  The JAX step
gathers only k and v and keeps the queries on their shards; the port's
kernels mask causally from position 0 of the sequence they are handed,
so it gathers the block's input, which holds the same bytes as the
queries' for a model whose heads cover ``d_model``.

The port has no ``shard_heads``: the JAX hook lays the WKV operands'
heads on ``model`` after their gathered sequence, and
:func:`on_local_shards` already hands the kernel the rank's heads (a
column-parallel projection's output is placed so), so nothing moves there.
Placement changes no value.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple, Union

Axes = Optional[Union[str, Tuple[str, ...]]]

_SPEC: contextvars.ContextVar = contextvars.ContextVar("repro_torch_act_axes", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes: Axes, seq_axes: Axes = None):
    """Declare mesh axes for the activation batch dim and (optionally) the
    sequence dim of ``[B, S, D]`` activations."""
    token = _SPEC.set((batch_axes, seq_axes))
    try:
        yield
    finally:
        _SPEC.reset(token)


def recompute_context():
    """A context manager that re-enters the activation context active now
    (none if none is): for a checkpoint's recomputation, which autograd runs
    on the card's device thread, where a context variable the step set on
    its own thread is unset."""
    spec = _SPEC.get()
    return contextlib.nullcontext() if spec is None else activation_sharding(*spec)


def _names(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def gathered_where_shards_move(x, placements):
    """DTensor ``x`` with every mesh axis on which it is sharded on another
    dim than ``placements`` says gathered (``Replicate()``), the others as
    they are: from there ``x.redistribute(mesh, placements)`` moves no shard
    from one dim to another.  DTensor does that with an all-to-all, which
    the intra-pod collectives (:mod:`.lan`) do not have."""
    from torch.distributed.tensor import Replicate

    hop = tuple(Replicate() if p.is_shard() and w.is_shard() and p != w else p
                for p, w in zip(x.placements, placements))
    return x if hop == tuple(x.placements) else x.redistribute(x.device_mesh, hop)


def redistribute(x, placements):
    """``x.redistribute`` onto ``placements``, through
    :func:`gathered_where_shards_move`."""
    if tuple(x.placements) == tuple(placements):
        return x
    return gathered_where_shards_move(x, placements).redistribute(x.device_mesh, placements)


def shard_activations(x):
    """Activations [B, S, ...] onto the context's batch axes and, where they
    divide ``S > 1``, its sequence axes; every other mesh axis replicated;
    ``x`` as it is outside a context or for a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    spec = _SPEC.get()
    if spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows, seq = _names(spec[0]), _names(spec[1])
    pieces = math.prod(mesh.size(i) for i, a in enumerate(names) if a in seq)
    by_seq = x.ndim >= 3 and x.shape[1] > 1 and x.shape[1] % pieces == 0
    placements = tuple(  # an axis of size 1 holds the whole tensor: replicated
        Replicate() if mesh.size(i) == 1
        else Shard(0) if a in rows
        else Shard(1) if a in seq and by_seq
        else Replicate()
        for i, a in enumerate(names)
    )
    return redistribute(x, placements)


def whole_over_sequence(x, weights) -> bool:
    """Whether ``x`` is a DTensor sharded on its sequence over the context's
    sequence axes while every matrix of ``weights`` is whole on them
    (neither sharded nor partial there): then a position-wise function of
    ``x`` and ``weights`` runs on the rank's own positions
    (:func:`on_local_shards` with ``x``'s sequence as its model dim), and
    only the vectors (biases) that are not whole move."""
    from torch.distributed.tensor import DTensor

    spec = _SPEC.get()
    if spec is None or not isinstance(x, DTensor) or x.ndim < 3:
        return False
    seq = [i for i, a in enumerate(x.device_mesh.mesh_dim_names) if a in _names(spec[1])]
    if not any(x.placements[i].is_shard(1) for i in seq):
        return False
    return all(not isinstance(w, DTensor) or w.ndim < 2 or all(w.placements[i].is_replicate() for i in seq)
               for w in weights)


def replicate_seq(x):
    """A DTensor ``[B, S, ...]`` with its sequence gathered over the
    context's sequence axes (the explicit all-gather before a block), its
    other placements kept; ``x`` as it is outside a context, for a plain
    tensor, or with the sequence already whole."""
    from torch.distributed.tensor import DTensor, Replicate

    spec = _SPEC.get()
    if spec is None or not isinstance(x, DTensor) or x.ndim < 2:
        return x
    seq = _names(spec[1])
    placements = tuple(Replicate() if a in seq and p.is_shard(1) else p
                       for a, p in zip(x.device_mesh.mesh_dim_names, x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def mesh_coordinate(x, axis: str) -> int:
    """The rank's index along mesh axis ``axis`` of DTensor ``x``'s mesh:
    0 for a plain tensor or a mesh without that axis."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or axis not in (x.device_mesh.mesh_dim_names or ()):
        return 0
    return x.device_mesh.get_local_rank(axis)


def reduce_partial(x):
    """A reduction's value whole on every rank: a DTensor holding partial
    sums (a loss term summed over rows sharded over ``data``) reduced to
    ``Replicate()``, so that terms reduced in different ways can be added;
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p for p in x.placements))


def on_local_shards(fn, args, dims, out_dims, *, in_place=(), partial=()):
    """``fn`` on each rank's local shards of DTensor ``args``: its rows of
    the batch and, over ``model``, its heads (or channels, or experts: any
    dim whose pieces ``fn`` works on apart).

    ``dims[i]`` is ``(batch dim, head dim)`` of ``args[i]`` (either may be
    None), ``out_dims`` the same for each output of ``fn`` (a tuple of
    tensors, or one tensor when ``out_dims`` has one entry).  Every DTensor
    argument is redistributed onto ``Shard(batch dim)`` over ``data`` (when
    every batch size divides it) and ``Shard(head dim)`` over ``model``
    (when every head count divides it), ``Replicate()`` elsewhere;
    ``Shard`` on a mesh axis of size 1 holds the whole tensor and counts as
    ``Replicate()`` there.  ``fn`` writes into the local tensors of the
    arguments listed in ``in_place``: one placed otherwise only where the
    target is ``Replicate()`` (a decode cache whose head_dim is over
    ``model`` because its kv heads do not divide it, as ``cache_pspecs``
    lays it out) is gathered there for ``fn``, and the rank's slice of the
    result written back into its local tensor; any other placement
    raises.  A plain tensor argument with
    dims is taken as replicated (the same on every rank, as a zero initial
    state is).  The outputs come back as
    DTensors on those placements.  Without a DTensor argument this is
    ``fn(*args)``.  This is where a hand-written kernel meets DTensor: the
    kernel sees ``[B_local, ..., H_local, ...]`` tensors on the rank's device.
    An argument without a batch (head) dim, whole on ranks that split the
    rows (heads), gets its gradient back as a partial sum over them; an
    output listed in ``partial`` without a batch (head) dim is, the other
    way round, ``fn``'s sum over the rank's rows (heads) only (a count over
    the rank's tokens, the experts' combine), so it comes back as
    ``Partial()`` over the axes that split them.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    tensors = [a for a in args if isinstance(a, DTensor)]
    if not tensors:
        return fn(*args)
    mesh = tensors[0].device_mesh
    names = mesh.mesh_dim_names
    size = {a: mesh.size(i) for i, a in enumerate(names)}
    shapes = [(tuple(a.shape), d) for a, d in zip(args, dims) if a is not None]

    def divides(axis, which):
        used = [s[d[which]] for s, d in shapes if d[which] is not None]
        return axis in size and size[axis] > 1 and bool(used) and all(n % size[axis] == 0 for n in used)

    split = {"data": divides("data", 0), "model": divides("model", 1)}

    def same(have, want):  # equal but where an axis of size 1 holds the whole tensor either way
        return all(h == w or size[a] == 1 for a, h, w in zip(names, have, want))

    def placements(batch_dim, head_dim, summed=False):
        out = []
        for a in names:
            dim = {"data": batch_dim, "model": head_dim}.get(a)
            if not split.get(a):
                out.append(Replicate())
            elif dim is not None:
                out.append(Shard(dim))
            else:  # whole on the ranks that split the work: the same, or (summed) each one's part
                out.append(Partial() if summed else Replicate())
        return tuple(out)

    local, write_back = [], []
    for i, (a, (b, h)) in enumerate(zip(args, dims)):
        if a is None or (not isinstance(a, DTensor) and b is None and h is None):
            local.append(a)
            continue
        if not isinstance(a, DTensor):  # a plain tensor is the same on every rank: replicated
            a = DTensor.from_local(a, mesh, (Replicate(),) * len(names), run_check=False)
        want = placements(b, h)
        if not same(a.placements, want):
            if i in in_place:
                if any(p != w and w != Replicate() for p, w in zip(a.placements, want)):
                    raise ValueError(f"argument {i} is written in place but placed {a.placements}, not {want}")
                gathered = a.redistribute(mesh, want)
                write_back.append((a, DTensor.from_local(gathered.to_local(), mesh, want, run_check=False)))
                a = gathered
            else:
                a = a.redistribute(mesh, want)
        # an argument whole on the ranks that split the work between them
        # (rows over data, heads over model) gets a partial gradient from each
        grad = tuple(
            Partial() if (ax == "data" and split["data"] and b is None) or (ax == "model" and split["model"] and h is None)
            else p for ax, p in zip(names, a.placements)
        )
        a = a.to_local(grad_placements=grad)
        local.append(a if i in in_place else a.contiguous())
    out = fn(*local)
    for target, written in write_back:  # the rank's slice of what fn wrote: no data moves
        target.to_local().copy_(written.redistribute(mesh, target.placements).to_local())
    single = len(out_dims) == 1
    outs = (out,) if single else out
    wrapped = tuple(
        DTensor.from_local(o, mesh, placements(b, h, i in partial), run_check=False)
        for i, (o, (b, h)) in enumerate(zip(outs, out_dims))
    )
    return wrapped[0] if single else wrapped
