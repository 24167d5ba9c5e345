"""Pod-path models of the port: the decoder-only LM, dense and MoE
(``lm``), PaliGemma on it (``vlm``), Whisper (``encdec``), the Mamba-2 LM
(``ssm``), the Zamba2 hybrid (``hybrid``), their config schema and
primitives (``common``) and the family registry."""

from .common import ModelConfig
from .registry import (BatchSpec, ModelBundle, get_model, params_from_jax,
                       params_to_jax)

__all__ = ["BatchSpec", "ModelBundle", "ModelConfig", "get_model",
           "params_from_jax", "params_to_jax"]
