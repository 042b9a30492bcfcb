"""The JAX package's parameters and caches, as numpy, to the port's and back.

Trees are nested dicts (and lists, for remainder layers) of arrays with the
JAX package's keys, so a leaf keeps its ``jax.tree_util.keystr`` path.  Take
a JAX tree to numpy with ``jax.tree.map(np.asarray, tree)`` first; this
module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device: DeviceLike = "cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    device = resolve_device(device)
    return _map(lambda a: _to_torch(a, device), tree)


def cache_from_numpy(tree, device: DeviceLike = "cuda"):
    """A decode cache (``groups/slot0/{k,v,pos}``) from numpy to ``device``."""
    return params_from_numpy(tree, device)


def cache_to_numpy(tree):
    """A decode cache back to numpy on the host.

    bf16 leaves come back as float32, which holds every bf16 value exactly.
    """

    def one(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map(one, tree)
