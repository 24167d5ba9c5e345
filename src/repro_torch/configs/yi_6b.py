"""Yi-6B [dense] — llama-arch GQA  [arXiv:2403.04652]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='yi-6b',
    family='dense',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    act='silu',
    rope_base=5000000.0,
    sliding_window=8192,
    source='arXiv:2403.04652',
)

REDUCED = ModelConfig(
    arch_id='yi-6b-smoke',
    family='dense',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    act='silu',
    dtype='float32',
    source='arXiv:2403.04652',
)
