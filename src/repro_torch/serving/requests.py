"""Materialize a trace :class:`~repro_torch.serving.traffic.Request` as a real
model input batch.

Port of ``repro.serving.requests``: the same frontend-aware batch
construction the serving CLI uses (:mod:`repro_torch.launch.batches`), drawn
from a ``torch.Generator`` seeded with the request's trace identity, so a
given request always materializes the same prompt.  The numbers differ from
the JAX package's (another RNG); the keys, shapes and dtypes (int32 token
ids) do not.
``python -m repro_torch.examples.serve_geo`` uses it to run a traced request
through a real prefill.
"""

from __future__ import annotations

from typing import Dict

from .traffic import Request

__all__ = ["request_batch"]


def request_batch(cfg, request: Request, *, generator=None, device="cuda") -> Dict[str, object]:
    """A batch-of-one prefill input for ``request`` on ``device``,
    deterministic in ``request.rid`` unless an explicit ``generator`` is
    passed (the batch then lies on the generator's device)."""
    import torch

    from ..device import resolve_device
    from ..launch.batches import synthetic_prompt_batch

    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(request.rid)
    prompt_len = max(request.tokens, 1)
    if cfg.frontend == "patch":
        # the patch frontend needs room for its prefix tokens
        prompt_len += cfg.num_prefix_tokens
    batch = synthetic_prompt_batch(cfg, generator, 1, prompt_len)
    return {k: v.to(torch.int32) if k == "tokens" else v for k, v in batch.items()}
