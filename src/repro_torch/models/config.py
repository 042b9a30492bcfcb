"""Model configuration for every assigned architecture family.

Field-for-field copy of ``repro.models.config``: one :class:`ModelConfig`
describes dense GQA transformers, sliding-window/local-attention variants,
MoE (with optional parallel dense residual, as in Arctic), RWKV6 and the
RG-LRU/local-attention hybrid.  The layer stack is a repeating ``pattern``
of layer kinds plus an optional remainder.  The only difference is that
:attr:`ModelConfig.compute_dtype` returns a ``torch.dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Layer kinds appearing in ``pattern``.
ATTN = "attn"  # (self-)attention block (full / windowed per config)
LOCAL = "local_attn"  # short-window local attention (RecurrentGemma)
RECURRENT = "recurrent"  # RG-LRU recurrent block
RWKV = "rwkv"  # RWKV6 time-mix + channel-mix block
LAYER_KINDS = (ATTN, LOCAL, RECURRENT, RWKV)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the JAX configs name dtypes as strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dt


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    # Arctic: a small dense FFN runs in parallel with the MoE ("dense residual")
    parallel_dense: bool = False
    # router implementation: "einsum" (GShard dispatch/combine) or "gather"
    impl: str = "einsum"
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # layer stack: ``pattern`` repeats; remainder layers appended at the end.
    pattern: Tuple[str, ...] = (ATTN,)

    # attention
    window: Optional[int] = None  # sliding window for ATTN (None = full)
    local_window: int = 2048  # window for LOCAL layers
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm applies rotary to half the head dim
    attn_logit_softcap: Optional[float] = None
    # kept for parity with the JAX config; the port's prefill attention is
    # always the flash kernel (or its plain version on the CPU)
    attn_impl: str = "auto"
    attn_block: int = 512

    # norms / activations
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln (OLMo)
    activation: str = "swiglu"  # swiglu | geglu | gelu | relu_sq
    parallel_block: bool = False
    tie_embeddings: bool = False
    use_bias_attn: bool = False
    use_bias_mlp: bool = False

    # MoE
    moe: Optional[MoEConfig] = None

    # RWKV6 / RG-LRU
    rwkv_head_dim: int = 64
    d_rnn: Optional[int] = None
    lru_block_width: Optional[int] = None

    # stub modality frontends: "none" | "patch" | "frame"
    frontend: str = "none"
    frontend_dim: int = 1024
    num_prefix_tokens: int = 256

    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    logits_softcap: Optional[float] = None
    z_loss: float = 1e-4

    # training-time behaviour
    remat: str = "none"
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.d_rnn is None:
            object.__setattr__(self, "d_rnn", self.d_model)
        for kind in self.pattern:
            if kind not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {kind!r}")
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    # -- stack helpers -------------------------------------------------------

    @property
    def num_groups(self) -> int:
        """Number of full pattern repetitions."""
        return self.num_layers // len(self.pattern)

    @property
    def remainder(self) -> Tuple[str, ...]:
        """Layer kinds left over after the repeating groups."""
        r = self.num_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def attn_free(self) -> bool:
        return all(k in (RWKV, RECURRENT) for k in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """Every layer's state is o(seq_len)."""
        return all(
            k in (RWKV, RECURRENT, LOCAL) or (k == ATTN and self.window is not None)
            for k in self.pattern
        )

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    # -- size accounting ------------------------------------------------------

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + stacked layers + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # unembedding
        total += d  # final norm (rmsnorm scale); ok to count even if nonparam
        kinds = list(self.pattern) * self.num_groups + list(self.remainder)
        for kind in kinds:
            total += self._layer_params(kind)
        if self.frontend in ("patch", "frame"):
            total += self.frontend_dim * d  # stub projection
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        ffn = self._ffn_expert_params()
        inactive = (self.moe.num_experts - self.moe.num_experts_per_tok) * ffn
        n_moe_layers = sum(
            1 for k in (list(self.pattern) * self.num_groups + list(self.remainder)) if k == ATTN
        )
        return full - inactive * n_moe_layers

    def _ffn_expert_params(self) -> int:
        d, f = self.d_model, self.d_ff
        return 3 * d * f if self.activation in ("swiglu", "geglu") else 2 * d * f

    def _layer_params(self, kind: str) -> int:
        d, f = self.d_model, self.d_ff
        hd = self.head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        norms = 2 * d if self.norm != "nonparametric_ln" else 0
        if kind in (ATTN, LOCAL):
            attn = d * q + 2 * d * kv + q * d
            if self.moe is not None and kind == ATTN:
                ffn = self.moe.num_experts * self._ffn_expert_params()
                ffn += d * self.moe.num_experts  # router
                if self.moe.parallel_dense:
                    ffn += self._ffn_expert_params()
            else:
                ffn = self._ffn_expert_params()
            return attn + ffn + norms
        if kind == RECURRENT:
            dr = self.d_rnn
            block = 2 * d * dr + 4 * dr + 2 * dr * dr // 8 + dr
            return block + self._ffn_expert_params() + norms
        if kind == RWKV:
            tm = 5 * d * d + 2 * d * 64 + 64 * d
            cm = 2 * d * int(f) if self.activation == "relu_sq" else 2 * d * f
            return tm + cm + norms
        raise ValueError(kind)
