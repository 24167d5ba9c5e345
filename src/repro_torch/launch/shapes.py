"""The assigned input shapes and each (arch, shape)'s dry-run inputs — the
port's counterpart of ``repro.launch.shapes``, shape for shape:

  train_4k       seq_len=  4,096  global_batch= 256  (training)
  prefill_32k    seq_len= 32,768  global_batch=  32  (inference prefill)
  decode_32k     seq_len= 32,768  global_batch= 128  (inference decode)
  long_500k      seq_len=524,288  global_batch=   1  (long-context decode)

Decode shapes run the serve step (one new token against a cache of
seq_len), not the train step.  long_500k needs sub-quadratic attention:
the SSM and hybrid families carry O(1) state, and every attention
architecture here has a sliding-window decode variant (a ring cache of
the window), so all ten run long_500k — the window is the cache length.

The inputs are ``BatchSpec``s (shape and dtype, ``jax.ShapeDtypeStruct``'s
counterpart) and a cache of ``meta`` tensors: nothing is allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelBundle


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """The decode cache's capacity: the whole context for decode_32k, the
    sliding window for attention architectures at long_500k (a ring)."""
    if shape.name == "long_500k" and cfg.sliding_window:
        return cfg.sliding_window
    return shape.seq_len


def input_specs(bundle: ModelBundle, shape: InputShape) -> Dict[str, Any]:
    """Every abstract input of one (arch, shape) dry run, whole (the
    global batch):

      train, prefill -> {"batch": {name: BatchSpec}}
      decode         -> {"cache": {name: meta tensor}, "tokens": BatchSpec,
                         "lengths": BatchSpec}"""
    cfg = bundle.cfg
    b, s = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        return {"batch": bundle.batch_shapes(shape.mode, b, s)}
    toks = bundle.batch_shapes("decode", b, s)
    cache = bundle.empty_cache(b, cache_len_for(cfg, shape),
                               cfg.torch_dtype(), torch.device("meta"))
    return {"cache": cache, "tokens": toks["tokens"],
            "lengths": toks["lengths"]}
