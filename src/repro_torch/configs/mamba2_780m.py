"""Mamba2-780m [ssm] — SSD (state-space duality)  [arXiv:2405.21060]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='mamba2-780m',
    family='ssm',
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    tie_embeddings=True,
    source='arXiv:2405.21060',
)

REDUCED = ModelConfig(
    arch_id='mamba2-780m-smoke',
    family='ssm',
    n_layers=2,
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    tie_embeddings=True,
    dtype='float32',
    source='arXiv:2405.21060',
)
