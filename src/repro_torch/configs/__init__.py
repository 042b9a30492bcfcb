"""Architecture registry: the ten assigned archs + the paper's own model.

The port's own copy of ``repro.configs`` (pure data), built on the port's
:class:`~repro_torch.models.config.ModelConfig`.  ``tests/test_torch_configs.py``
holds every entry field for field against the JAX registry.
``EXPECTED_PARAMS`` records the published total parameter counts.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_MODULES = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "starcoder2-7b": "starcoder2_7b",
    "chatglm3-6b": "chatglm3_6b",
    "olmo-1b": "olmo_1b",
    "yi-34b": "yi_34b",
    "arctic-480b": "arctic_480b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-7b": "rwkv6_7b",
    "musicgen-large": "musicgen_large",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "distilgpt2-82m": "distilgpt2_82m",
}

ASSIGNED_ARCHS: Tuple[str, ...] = tuple(k for k in _MODULES if k != "distilgpt2-82m")
ALL_ARCHS: Tuple[str, ...] = tuple(_MODULES)

#: Published total parameter counts (backbone scope for vlm/audio).
EXPECTED_PARAMS: Dict[str, float] = {
    "phi-3-vision-4.2b": 3.8e9,  # 4.2B minus the (stubbed) CLIP tower
    "starcoder2-7b": 7.2e9,
    "chatglm3-6b": 6.2e9,
    "olmo-1b": 1.2e9,
    "yi-34b": 34.4e9,
    "arctic-480b": 482e9,
    "mixtral-8x22b": 141e9,
    "rwkv6-7b": 7.6e9,
    "musicgen-large": 2.4e9,  # 3.3B total minus the (stubbed) T5 text encoder
    "recurrentgemma-9b": 9.4e9,
    "distilgpt2-82m": 82e6,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke_config()
