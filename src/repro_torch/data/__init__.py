"""Data substrate: the seeded synthetic token pipeline with packing."""

from .pipeline import PackedLMDataset, SyntheticTokenSource, make_batches

__all__ = ["PackedLMDataset", "SyntheticTokenSource", "make_batches"]
