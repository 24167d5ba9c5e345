"""Architecture config registry of the port (``--arch <id>``).

The ten architectures of the JAX package, six families: four dense,
two MoE (DeepSeek-MoE-16B, Qwen3-MoE-30B-A3B), Mamba2-780m (ssm),
Zamba2-1.2B (hybrid), PaliGemma-3B (vlm) and Whisper-large-v3 (audio),
each copied value for value from the JAX package's config (``CONFIG``
the published widths, ``REDUCED`` the smoke-test variant).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-32b": "qwen3_32b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "yi-6b": "yi_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "paligemma-3b": "paligemma_3b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-1.2b": "zamba2_1_2b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG
