"""``DecoderLM``: a thin ``nn.Module`` that owns the parameter tensors.

The core stays the plain functions of :mod:`.transformer` over the nested
parameter dict; the module registers each leaf under its path (for example
``groups/slot0/attn/wq``) so ``.to()``, ``state_dict()`` and
``named_parameters()`` see them, and rebuilds the dict as views.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike
from .config import ModelConfig
from .transformer import Params, decode_step, init_decode_cache, init_params, prefill


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, torch.Tensor):
            yield path, value
        else:
            yield from _flatten(value, path + "/")


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


class DecoderLM(nn.Module):
    """Inference wrapper around :func:`prefill` and :func:`decode_step`."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        # the dict's structure only: holding the tensors would keep them
        # alive after .to() moves the parameters
        self._structure = _skeleton(params)
        for path, t in _flatten(params):
            self.register_parameter(path, nn.Parameter(t, requires_grad=False))

    @classmethod
    def random(
        cls,
        cfg: ModelConfig,
        *,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = "cuda",
    ) -> "DecoderLM":
        return cls(cfg, init_params(cfg, generator=generator, device=device))

    def params(self) -> Params:
        """The nested parameter dict, rebuilt over this module's tensors."""
        own: Dict[str, torch.Tensor] = dict(self.named_parameters())

        def rebuild(tree, prefix: str = ""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
            if isinstance(tree, list):
                return [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return own[prefix[:-1]].data

        return rebuild(self._structure)

    def prefill(self, batch, *, max_len: Optional[int] = None):
        return prefill(self.params(), batch, self.cfg, max_len=max_len)

    def init_decode_cache(self, batch: int, max_len: int) -> Params:
        device = next(self.parameters()).device
        return init_decode_cache(self.cfg, batch, max_len, device=device)

    def decode_step(self, tokens_t, cache: Params, position: int):
        return decode_step(self.params(), tokens_t, cache, self.cfg, position)
