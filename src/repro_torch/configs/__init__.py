"""Architecture config registry of the port (``--arch <id>``).

The four dense architectures, Mamba2-780m (ssm) and Zamba2-1.2B
(hybrid), each copied value for value from the JAX package's config
(``CONFIG`` the published widths, ``REDUCED`` the smoke-test variant).
The four configs of the other families (MoE, VLM, audio) come with
their families.
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
    "yi-6b": "yi_6b",
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
