"""Frontend-aware synthetic batch construction for the serving CLI.

Port of ``repro.launch.batches`` with an explicit ``torch.Generator`` and
device.  Each model frontend takes a different prompt dict: ``frame``
wants embeddings, ``patch`` a token/patch split, plain LMs tokens.  The
numbers differ from the JAX package's: the two frameworks draw different
streams from the same seed.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["decode_step_input", "synthetic_prompt_batch"]


def synthetic_prompt_batch(
    cfg, generator: torch.Generator, batch: int, prompt_len: int
) -> Dict[str, torch.Tensor]:
    """A synthetic prefill batch on ``generator``'s device."""
    kw = dict(generator=generator, device=generator.device)
    if cfg.frontend == "frame":
        return {"frame_embeds": torch.randn((batch, prompt_len, cfg.frontend_dim), **kw)}
    if cfg.frontend == "patch":
        p = cfg.num_prefix_tokens
        if prompt_len <= p:
            raise ValueError(
                f"patch frontend needs prompt_len > {p} prefix tokens, got {prompt_len}"
            )
        return {
            "tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len - p), **kw),
            "patch_embeds": torch.randn((batch, p, cfg.frontend_dim), **kw),
        }
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len), **kw)}


def decode_step_input(cfg, generator: torch.Generator, tokens: torch.Tensor, batch: int):
    """The per-step decode input: frame frontends feed fresh embeddings
    (the generator's next draw), token frontends feed back the argmax."""
    if cfg.frontend == "frame":
        return torch.randn(
            (batch, 1, cfg.frontend_dim), generator=generator, device=generator.device
        )
    return tokens
