"""Phi-3-mini 3.8B [dense]  [arXiv:2404.14219]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='phi3-mini-3.8b',
    family='dense',
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    act='silu',
    sliding_window=8192,
    source='arXiv:2404.14219',
)

REDUCED = ModelConfig(
    arch_id='phi3-mini-3.8b-smoke',
    family='dense',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    act='silu',
    dtype='float32',
    source='arXiv:2404.14219',
)
