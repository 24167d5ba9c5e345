"""DeepSeekMoE-16B [moe] — 2 shared + 64 routed top-6, fine-grained  [arXiv:2401.06066]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='deepseek-moe-16b',
    family='moe',
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=102400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_layer_dense_ff=10944,
    act='silu',
    sliding_window=8192,
    source='arXiv:2401.06066',
)

REDUCED = ModelConfig(
    arch_id='deepseek-moe-16b-smoke',
    family='moe',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=512,
    n_experts=4,
    top_k=2,
    n_shared_experts=1,
    moe_d_ff=128,
    first_layer_dense_ff=512,
    act='silu',
    capacity_factor=8.0,
    dtype='float32',
    source='arXiv:2401.06066',
)
