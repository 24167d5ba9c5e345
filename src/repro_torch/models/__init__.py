"""Pod-path models of the port: the dense decoder-only LM (``lm``), the
Mamba-2 LM (``ssm``), the Zamba2 hybrid (``hybrid``), their config
schema and primitives (``common``) and the family registry."""

from .common import ModelConfig
from .registry import ModelBundle, get_model

__all__ = ["ModelBundle", "ModelConfig", "get_model"]
