"""PaliGemma-3B [vlm] — SigLIP + Gemma (ViT stubbed)  [arXiv:2407.07726]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='paligemma-3b',
    family='vlm',
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    act='geglu',
    tie_embeddings=True,
    n_vision_tokens=256,
    d_vision=1152,
    prefix_lm=True,
    sliding_window=8192,
    source='arXiv:2407.07726',
)

REDUCED = ModelConfig(
    arch_id='paligemma-3b-smoke',
    family='vlm',
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab=512,
    head_dim=64,
    act='geglu',
    tie_embeddings=True,
    n_vision_tokens=16,
    d_vision=64,
    prefix_lm=True,
    dtype='float32',
    source='arXiv:2407.07726',
)
