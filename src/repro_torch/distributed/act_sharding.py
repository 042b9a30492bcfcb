"""Activation-sharding hook: the activations' batch dim over mesh axes, as DTensor redistributes.

Port of ``repro.distributed.act_sharding``.  A step that runs the model on
DTensors enters :func:`activation_sharding` with the mesh axes of the
activation batch dim; the model calls :func:`shard_activations` on the
embedding output and at every block boundary.  It is a ``redistribute`` of
a DTensor onto rows over those axes, replicated over the others (a
tensor-parallel block's partial sums reduced there), while a context is
active, and returns its input as it is outside one or for a plain tensor,
so one-process runs are unaffected.

The JAX step also shards the residual's sequence dim over ``model``
between blocks (sequence parallelism).  Its ``replicate_seq`` gathers k
and v across the sequence before attention, and its ``shard_heads`` lays
the WKV operands' heads on ``model``; both act only on that
sequence-sharded residual.  DTensor on the card's torch (2.11) refuses to
flatten a sequence-sharded ``[B, S, D]`` for the next matmul, so the port
keeps the sequence whole and has neither hook.  The kernels take their
operands through :func:`on_local_shards`, which lays rows over ``data``
and heads (or the RG-LRU's channels, the experts, a vocab slice) over
``model``: a column-parallel projection's output is already so placed, so
nothing moves there.  Placement changes no value.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple, Union

Axes = Optional[Union[str, Tuple[str, ...]]]

_SPEC: contextvars.ContextVar = contextvars.ContextVar("repro_torch_act_axes", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes: Axes):
    """Declare mesh axes for the activation batch dim."""
    token = _SPEC.set(batch_axes)
    try:
        yield
    finally:
        _SPEC.reset(token)


def _names(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def shard_activations(x):
    """Activations [B, ...] onto the context's batch axes, every other mesh
    axis replicated; ``x`` as it is outside a context or for a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    batch_axes = _SPEC.get()
    if batch_axes is None or not isinstance(x, DTensor):
        return x
    mesh, rows = x.device_mesh, _names(batch_axes)
    placements = tuple(  # an axis of size 1 holds the whole tensor: replicated
        Shard(0) if a in rows and mesh.size(i) > 1 else Replicate()
        for i, a in enumerate(mesh.mesh_dim_names)
    )
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


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
