"""Whisper-large-v3 [audio] — enc-dec; conv frontend stubbed  [arXiv:2212.04356]

Auto-structured config: CONFIG is the exact assigned architecture;
REDUCED is the same family at smoke-test scale (2 layers, d_model<=512,
<=4 experts) for CPU tests.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id='whisper-large-v3',
    family='audio',
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    act='gelu',
    rope_base=0.0,
    n_encoder_layers=32,
    n_audio_ctx=1500,
    tie_embeddings=True,
    sliding_window=8192,
    source='arXiv:2212.04356',
)

REDUCED = ModelConfig(
    arch_id='whisper-large-v3-smoke',
    family='audio',
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    act='gelu',
    rope_base=0.0,
    n_encoder_layers=2,
    n_audio_ctx=32,
    tie_embeddings=True,
    dtype='float32',
    source='arXiv:2212.04356',
)
