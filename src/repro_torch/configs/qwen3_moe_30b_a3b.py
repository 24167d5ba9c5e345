"""Qwen3-30B-A3B [moe] — 128 experts top-8  [hf:Qwen/Qwen3-30B-A3B]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='qwen3-moe-30b-a3b',
    family='moe',
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=0,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    act='silu',
    rope_base=1000000.0,
    sliding_window=8192,
    source='hf:Qwen/Qwen3-30B-A3B',
)

REDUCED = ModelConfig(
    arch_id='qwen3-moe-30b-a3b-smoke',
    family='moe',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    head_dim=64,
    qk_norm=True,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    act='silu',
    capacity_factor=8.0,
    dtype='float32',
    source='hf:Qwen/Qwen3-30B-A3B',
)
