"""One device's FLOPs, bytes, live memory and collectives over a traced step.

:class:`DeviceCounter` is a ``TorchDispatchMode`` for the dry run
(:mod:`repro_torch.launch.dryrun`), entered inside a ``FakeTensorMode``.
It hands every op with DTensor arguments back (``NotImplemented``), as
:class:`~repro_torch.distributed.lan.LanCollectives` does, so that DTensor
runs first and the mode sees the ops it issues on each rank's local
shards: the counts are one device's.  (``FlopCounterMode`` over a DTensor
program counts the global work instead: a ``[64, 1024]`` rows-over-4 by
``[1024, 1024]`` columns-over-4 product on a 4 x 4 mesh counts the whole
2 x 64 x 1024 x 1024.)  For each local op it adds:

* **FLOPs** from ``torch.utils.flop_counter``'s registry (the matrix
  products, convolutions, attention and the kernels' custom ops, whose
  formulas come from :mod:`repro_torch.kernels.costs`), by operand type;
  elementwise ops count none there, as in ``FlopCounterMode``;
* **bytes**: its tensor operands' and outputs' bytes (a broadcast dim's
  elements once), what XLA's "bytes accessed" counts op by op.  The port
  runs eagerly, so that total is its traffic, the eager elementwise work
  included; a view, an empty allocation or a query that returns no tensor
  (``prim.device``) moves nothing;
* **collectives**, counted by :mod:`.collectives` and not as bytes;
* **memory**: every storage an op makes is live until its last tensor
  goes (a weak reference's callback), rounded up to the caching
  allocator's 512-byte blocks.  The peak, and what was live at it by
  category: the step's arguments under the caller's names (parameters,
  optimizer state, inputs), ``gradients`` for the storages made while
  autograd runs a backward node (the gradients and the backward's
  temporaries), ``activations`` for the rest made in the step (the
  forward's activations, the sync's and the optimizer's temporaries).

DTensor's own bookkeeping is not the rank's work, and a fake tensor mode
sits below every other mode, so its ops would reach this one too: DTensor
derives each op's output metadata by running the op once more on fake
tensors of the *global* shapes (``ShardingPropagator``'s
``_propagate_tensor_meta*``), and a strided shard's sizes from index
tensors on the host (``_StridedShard.local_shard_size*``, which must see
real tensors: a fake one has no values to list).  While the mode is on,
those methods pause it (:data:`HOST_SIDE`): their ops are neither counted
nor live.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from collections import Counter
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import costs
from .collectives import CollectiveStats, record

BLOCK = 512  # the caching allocator rounds every block up to this many bytes
#: (module, class, method-name prefix, needs real tensors): DTensor's bookkeeping
HOST_SIDE = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator", "_propagate_tensor_meta", False),
    ("torch.distributed.tensor.placement_types", "_StridedShard", "local_shard_size", True),
)
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias",
             "_unsafe_view", "lift_fresh", "set_", "wait_tensor")


def _flop_type(args) -> str:
    """The operand type an op's FLOPs run in: its first floating input's."""
    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return "bfloat16" if a.dtype in (torch.bfloat16, torch.float16) else "float32"
    return "float32"


def local_tensors(tree) -> Iterable[torch.Tensor]:
    from torch.distributed.tensor import DTensor

    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            yield t.to_local()
        elif isinstance(t, torch.Tensor):
            yield t


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a broadcast (stride-0) dim
    reads its elements once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def storage_bytes(st) -> int:
    return -(-st.nbytes() // BLOCK) * BLOCK


class DeviceCounter(TorchDispatchMode):
    """The counts of the ops run while the mode is on; ``pod_size``: ranks
    per pod for the collectives' classification (0: no pod axis)."""

    def __init__(self, pod_size: int = 0):
        super().__init__()
        self.pod_size = pod_size
        self.flops_by_type: Counter = Counter()
        self.bytes = 0
        self.ops = 0
        self.collectives = CollectiveStats()
        self._live: Dict[int, tuple] = {}  # storage key -> (bytes, category)
        self._by_category: Counter = Counter()
        self.current = 0
        self.peak = 0
        self.peak_by_category: Dict[str, int] = {}
        self._paused = 0
        self._patched: Dict[tuple, object] = {}

    def __enter__(self):
        import importlib

        for module, owner, prefix, real in HOST_SIDE:
            cls = getattr(importlib.import_module(module), owner, None)
            for name, fn in list(vars(cls).items()) if cls is not None else ():
                if name.startswith(prefix) and callable(getattr(cls, name)):
                    self._patched[cls, name] = fn
                    setattr(cls, name, self._pausing(fn, real))
        return super().__enter__()

    def __exit__(self, *exc):
        for (cls, name), fn in self._patched.items():
            setattr(cls, name, fn)
        self._patched.clear()
        return super().__exit__(*exc)

    def _pausing(self, fn, real: bool):
        """``fn`` (a class attribute: a function, static or class method)
        pausing the mode while it runs, with real tensors if ``real``."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        kind = type(fn) if isinstance(fn, (staticmethod, classmethod)) else None
        inner = fn.__func__ if kind is not None else fn

        @functools.wraps(inner)
        def run(*args, **kwargs):
            self._paused += 1
            try:
                with unset_fake_temporarily() if real else contextlib.nullcontext():
                    return inner(*args, **kwargs)
            finally:
                self._paused -= 1
        return kind(run) if kind is not None else run

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_type.values()))

    # -- memory ----------------------------------------------------------------

    def track(self, tree, category: str) -> None:
        """Count the storages of ``tree``'s tensors (DTensors' local shards)
        as live under ``category`` if they are not yet."""
        for t in local_tensors(tree):
            self._add(t.untyped_storage(), category)

    def _add(self, st, category: str) -> None:
        key = st._cdata
        if key in self._live:
            return
        nbytes = storage_bytes(st)
        self._live[key] = (nbytes, category)
        weakref.finalize(st, self._free, key)
        self._by_category[category] += nbytes
        self.current += nbytes
        if self.current > self.peak:
            self.peak = self.current
            self.peak_by_category = {k: v for k, v in self._by_category.items() if v}

    def _free(self, key: int) -> None:
        nbytes, category = self._live.pop(key, (0, None))
        if category is not None:
            self._by_category[category] -= nbytes
            self.current -= nbytes

    def storage_keys(self, tree) -> Dict[int, int]:
        """``tree``'s distinct storages: key -> bytes."""
        return {t.untyped_storage()._cdata: storage_bytes(t.untyped_storage()) for t in local_tensors(tree)}

    # -- the mode --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:  # DTensor's run on global shapes for metadata: not the rank's work
            return out
        self.ops += 1
        if record(self.collectives, func, args, kwargs, out, pod_size=self.pod_size):
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            if packet in costs.OP_COSTS:
                for kind, n in costs.OP_COSTS[packet](*args, **kwargs)[0].items():
                    self.flops_by_type[kind] += n
            else:
                self.flops_by_type[_flop_type(args)] += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func._opname
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor) and t.device.type != "meta"]
        if outs and not func.is_view and name not in _NO_BYTES and not name.startswith("empty"):
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(distinct_bytes(t) for t in ins + outs if t.device.type != "meta")
        category = "gradients" if torch._C._current_autograd_node() is not None else "activations"
        for t in outs:  # a meta tensor (a shape for a placement rule) holds nothing
            self._add(t.untyped_storage(), category)
        return out
