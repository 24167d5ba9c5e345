"""Zamba2-1.2B [hybrid] — Mamba2 + shared attn blocks  [arXiv:2411.15242]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='zamba2-1.2b',
    family='hybrid',
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    shared_attn_every=6,
    act='gelu',
    source='arXiv:2411.15242',
)

REDUCED = ModelConfig(
    arch_id='zamba2-1.2b-smoke',
    family='hybrid',
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    shared_attn_every=2,
    act='gelu',
    dtype='float32',
    source='arXiv:2411.15242',
)
