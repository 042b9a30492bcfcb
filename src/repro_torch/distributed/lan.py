"""Intra-pod (LAN) collectives of DTensor, run through the plain c10d API and counted.

DTensor moves data between the ranks of a pod with functional collectives
(``torch.ops._c10d_functional``): the all-gather of an FSDP-sharded
parameter, the reduce-scatter of its gradient, the all-reduce of a partial
sum.  Over gloo with CUDA tensors that path crashes the process (a
segfault in ``all_gather_into_tensor``, torch 2.11 on an H100), while the
plain ``torch.distributed`` calls of the same collectives work: gloo moves
a CUDA tensor through host memory itself.

:class:`LanCollectives` is a ``TorchDispatchMode`` that takes each
functional collective DTensor issues and performs it with the plain call
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``),
so it has completed when it returns and
``wait_tensor`` passes its tensor through.  It counts what it was handed,
per op, as LAN traffic (``handed`` bytes, ``seconds``, ``calls``, and
``shapes``: the calls by the shape of the tensor handed), apart
from the WAN counts of :class:`~repro_torch.distributed.pod_group.PodGroup`.
A functional collective it does not know raises: there is no silent
fallback onto the functional path.  On the card each counted collective
synchronises the device before and after, so its seconds hold the
transfer, not the compute queued before it.

An op with DTensor arguments is handed back (``NotImplemented``) so that
DTensor runs first and issues its collectives on plain tensors, which then
come through this mode.  Outside the mode DTensor uses its own path.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# newer torch renames the two (the old names warn); the card's torch has only the old
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")
_COLLECTIVE_WORDS = ("gather", "scatter", "reduce", "all_to_all", "broadcast")


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


class LanCollectives(TorchDispatchMode):
    """The mode; enter it around the work whose intra-pod traffic it runs
    and counts (``with lan: ...``).  :meth:`reset` clears the counts."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.reset()

    def reset(self) -> None:
        self.handed: Counter = Counter()
        self.seconds: Counter = Counter()
        self.calls: Counter = Counter()
        self.shapes: Counter = Counter()  # (op, shape of the tensor handed) -> calls
        self._counting = True

    @contextlib.contextmanager
    def uncounted(self):
        """Collectives that are not the step's traffic (its metrics, a
        checkpoint's gather) run through the mode but are not counted."""
        self._counting, before = False, self._counting
        try:
            yield
        finally:
            self._counting = before

    @property
    def lan_bytes(self) -> int:
        return int(sum(self.handed.values()))

    @property
    def lan_seconds(self) -> float:
        return float(sum(self.seconds.values()))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace not in _NAMESPACES:
            return func(*args, **kwargs)
        name = func._opname
        if name == "wait_tensor":
            return args[0]
        run = getattr(self, "_" + name.rstrip("_"), None)
        if run is None:
            if any(w in name for w in _COLLECTIVE_WORDS):
                raise NotImplementedError(f"intra-pod collective {func.namespace}.{name} has no counted form")
            return func(*args, **kwargs)
        inp = args[0].contiguous()
        if not self._counting:
            return run(inp, *args[1:], inplace=name.endswith("_"), orig=args[0])
        self._sync()
        t0 = time.perf_counter()
        out = run(inp, *args[1:], inplace=name.endswith("_"), orig=args[0])
        self._sync()
        self.seconds[name] += time.perf_counter() - t0
        self.handed[name] += inp.numel() * inp.element_size()
        self.calls[name] += 1
        self.shapes[name, tuple(inp.shape)] += 1
        return out

    # -- the collectives, each as its functional op's signature ----------------

    def _all_gather_into_tensor(self, inp, group_size, group_name, **_):
        out = inp.new_empty((group_size * inp.shape[0], *inp.shape[1:]))
        _ALL_GATHER(out, inp, group=_group(group_name))
        return out

    def _reduce_scatter_tensor(self, inp, reduce_op, group_size, group_name, **_):
        out = inp.new_empty((inp.shape[0] // group_size, *inp.shape[1:]))
        _REDUCE_SCATTER(out, inp, op=_reduce_op(reduce_op), group=_group(group_name))
        return out.div_(group_size) if reduce_op == "avg" else out

    def _all_reduce(self, inp, reduce_op, group_name, *, inplace, orig):
        out = orig if inplace and orig.is_contiguous() else inp.clone()
        dist.all_reduce(out, op=_reduce_op(reduce_op), group=_group(group_name))
        if reduce_op == "avg":
            out.div_(dist.get_world_size(_group(group_name)))
        if inplace and out is not orig:
            orig.copy_(out)
            return orig
        return out


def _reduce_op(name: str):
    """The c10d op of a functional reduce: ``avg`` is a sum divided after
    (gloo has no average)."""
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}
    if name not in ops:
        raise ValueError(f"reduce op {name!r}")
    return ops[name]
