"""Phi-4-mini 3.8B [dense]  [arXiv:2412.08905]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='phi4-mini-3.8b',
    family='dense',
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    act='silu',
    sliding_window=8192,
    source='arXiv:2412.08905',
)

REDUCED = ModelConfig(
    arch_id='phi4-mini-3.8b-smoke',
    family='dense',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    act='silu',
    sliding_window=64,
    dtype='float32',
    source='arXiv:2412.08905',
)
