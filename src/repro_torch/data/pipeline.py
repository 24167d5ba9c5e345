"""Synthetic-but-structured data pipeline, the port's own copy of
``repro.data.pipeline`` (numpy only): for the same seed its batches are
bit-identical to the JAX package's.

The corpus is generated: a seeded Markov token source (so the LM loss
actually decreases — uniform random tokens have no learnable signal),
packed into fixed-length documents with EOS separators, exactly the
shape a production loader would emit.

Family-aware batching: VLM batches add a vision-embedding stub, audio
batches add frame embeddings — matching ``ModelBundle.batch_shapes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.common import ModelConfig


class SyntheticTokenSource:
    """Order-1 Markov chain over the vocab: learnable structure."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 8):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.branching = branching
        # sparse transition table: each token can be followed by
        # ``branching`` successors (deterministic given the seed)
        table_rng = np.random.default_rng(seed + 1)
        self.successors = table_rng.integers(
            0, vocab, (vocab, branching), dtype=np.int32)

    def document(self, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = int(self.rng.integers(0, self.vocab))
        for i in range(length):
            out[i] = tok
            tok = int(self.successors[tok,
                                      self.rng.integers(0, self.branching)])
        return out


@dataclasses.dataclass
class PackedLMDataset:
    """Packs variable-length documents into (batch, seq) token blocks
    with next-token labels; EOS = vocab-1 separates documents; label -1
    masks the position after EOS (no cross-document prediction)."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __post_init__(self):
        self.source = SyntheticTokenSource(self.cfg.vocab - 1,
                                           seed=self.seed)
        self.doc_rng = np.random.default_rng(self.seed + 2)
        self._buffer = np.empty(0, np.int32)

    def _fill(self, n: int):
        chunks = [self._buffer]
        total = len(self._buffer)
        eos = self.cfg.vocab - 1
        while total < n:
            dl = int(self.doc_rng.integers(self.seq // 4, self.seq))
            doc = self.source.document(dl)
            chunks.extend([doc, np.array([eos], np.int32)])
            total += dl + 1
        self._buffer = np.concatenate(chunks)

    def next_batch(self) -> Dict[str, np.ndarray]:
        need = self.batch * (self.seq + 1)
        self._fill(need)
        flat = self._buffer[:need]
        self._buffer = self._buffer[need:]
        block = flat.reshape(self.batch, self.seq + 1)
        tokens = block[:, :-1].copy()
        labels = block[:, 1:].astype(np.int32).copy()
        eos = self.cfg.vocab - 1
        labels[tokens == eos] = -1         # don't predict across docs
        out = {"tokens": tokens, "labels": labels}
        cfg = self.cfg
        if cfg.family == "vlm":
            out["vision"] = self.doc_rng.normal(
                0, 1, (self.batch, cfg.n_vision_tokens, cfg.d_vision)
            ).astype(np.float32)
        elif cfg.family == "audio":
            out["frames"] = self.doc_rng.normal(
                0, 0.1, (self.batch, cfg.n_audio_ctx, cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def make_batches(cfg: ModelConfig, batch: int, seq: int, n: int,
                 seed: int = 0):
    ds = PackedLMDataset(cfg, batch, seq, seed)
    return [ds.next_batch() for _ in range(n)]
