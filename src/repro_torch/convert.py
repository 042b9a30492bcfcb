"""The JAX package's parameters, caches and train states, as numpy, to the
port's and back.

Trees are nested dicts (and lists, for remainder layers) of arrays with the
JAX package's keys, so a leaf keeps its ``jax.tree_util.keystr`` path.  Take
a JAX tree to numpy with ``jax.tree.map(np.asarray, tree)`` first; this
module imports neither JAX nor the JAX package.

A train state goes as ``{"adam": {"step", "m", "v"}, "ef": tree or (),
"diloco": {"anchor", "momentum"} or ()}``: the fields of the JAX
``TrainState``, ``AdamWState`` and ``DilocoState``, with the error feedback
of ``hier_int8`` as one ``[npods, ...]`` leaf per parameter (the JAX
per-pod values stacked along the pod axis).  Under ``local_sgd`` on more
than one pod the moments ``m`` and ``v`` (and the parameters the step
takes) are per-pod replicas stacked the same way; the DiLoCo anchor and
momentum are the same on every pod and have no pod axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .distributed.steps import TrainState
from .optim.adamw import AdamWState
from .optim.diloco import DilocoState
from .tree import tree_map


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 leaves come back as float32, which holds every bf16 value exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(tree, device: DeviceLike = "cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, device), tree)


def params_to_numpy(tree):
    """The port's parameters (or any tree of tensors) back to numpy."""
    return tree_map(_to_numpy, tree)


def cache_from_numpy(tree, device: DeviceLike = "cuda"):
    """A decode cache (``groups/slot0/{k,v,pos}``) from numpy to ``device``."""
    return params_from_numpy(tree, device)


def cache_to_numpy(tree):
    """A decode cache back to numpy on the host."""
    return params_to_numpy(tree)


def train_state_from_numpy(tree, device: DeviceLike = "cuda") -> TrainState:
    adam = tree["adam"]
    ef = tree.get("ef", ())
    diloco = tree.get("diloco", ())
    return TrainState(
        adam=AdamWState(
            step=_to_torch(np.asarray(adam["step"], np.int32), resolve_device(device)),
            m=params_from_numpy(adam["m"], device),
            v=params_from_numpy(adam["v"], device),
        ),
        ef=params_from_numpy(ef, device) if len(ef) else (),
        diloco=DilocoState(
            anchor=params_from_numpy(diloco["anchor"], device),
            momentum=params_from_numpy(diloco["momentum"], device),
        ) if len(diloco) else (),
    )


def train_state_to_numpy(state: TrainState):
    adam = state.adam
    return {
        "adam": {"step": _to_numpy(adam.step), "m": params_to_numpy(adam.m), "v": params_to_numpy(adam.v)},
        "ef": params_to_numpy(state.ef) if len(state.ef) else (),
        "diloco": {
            "anchor": params_to_numpy(state.diloco.anchor),
            "momentum": params_to_numpy(state.diloco.momentum),
        } if len(state.diloco) else (),
    }
