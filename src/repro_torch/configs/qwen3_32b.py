"""Qwen3-32B [dense] — qk_norm, GQA  [hf:Qwen/Qwen3-8B]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='qwen3-32b',
    family='dense',
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    act='silu',
    rope_base=1000000.0,
    sliding_window=8192,
    source='hf:Qwen/Qwen3-8B',
)

REDUCED = ModelConfig(
    arch_id='qwen3-32b-smoke',
    family='dense',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    head_dim=64,
    qk_norm=True,
    act='silu',
    dtype='float32',
    source='hf:Qwen/Qwen3-8B',
)
