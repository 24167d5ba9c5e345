"""PaliGemma-3B backbone [arXiv:2407.07726]: a Gemma decoder reading a
SigLIP vision prefix through a linear projector, with prefix-LM masking
(bidirectional attention over the image tokens).

The port's counterpart of ``repro.models.vlm``.  The SigLIP ViT is a
stub, as there: a request carries precomputed patch embeddings
(B, n_vision_tokens, d_vision); the projector (d_vision -> d_model) and
everything after it are real.  Gemma's details: GeGLU MLP, MQA (one KV
head), RoPE, tied embeddings, token embeddings scaled by sqrt(d_model).
The parameters are an ``lm.DenseLM`` with its ``projector``; the vision
tokens take the first cache positions, so decode ``lengths`` count them.
``vlm_loss`` trains over the text positions only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import act_sharding as acts

from . import lm
from .common import ModelConfig


def vlm_prefill(model: lm.DenseLM, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None, *,
                window: Optional[int] = None, data_shards: int = 16
                ) -> Tuple[torch.Tensor, lm.Cache]:
    """batch: ``vision`` (B,P,d_vision) + ``tokens`` (B,S).  The cache
    covers the vision prefix and the prompt.  In a sharded step the
    projector's FSDP-sharded d_model dimension is gathered first."""
    xv = (batch["vision"].to(cfg.torch_dtype())
          @ acts.gathered(model).projector)
    return lm.lm_prefill(model, cfg, batch["tokens"], cache_len,
                         window=window, prefix_len=cfg.n_vision_tokens,
                         prefix_embed=xv,
                         embed_scale=math.sqrt(cfg.d_model),
                         data_shards=data_shards)


def vlm_decode(model: lm.DenseLM, cfg: ModelConfig, cache: lm.Cache,
               tokens: torch.Tensor, lengths: torch.Tensor, *,
               seq_kv: bool = False, data_shards: int = 16
               ) -> Tuple[torch.Tensor, lm.Cache]:
    """One decode step; ``lengths`` are absolute positions counting the
    vision prefix (``seq_kv`` and ``data_shards`` as in
    ``lm.lm_decode``)."""
    return lm.lm_decode(model, cfg, cache, tokens, lengths,
                        embed_scale=math.sqrt(cfg.d_model), seq_kv=seq_kv,
                        data_shards=data_shards)


def vlm_loss(model: lm.DenseLM, cfg: ModelConfig,
             batch: Dict[str, torch.Tensor], *, remat: bool = True,
             data_shards: int = 16):
    """batch: vision (B,P,d_vision), tokens (B,S), labels (B,S).  The
    projected vision prefix goes in front of the scaled token embeddings
    and attends bidirectionally; the loss is over the text positions
    only.  Returns (loss, {"ce_loss"}).  In a sharded step the projector's
    FSDP-sharded d_model dimension is gathered over the data axes and the
    prefix goes through the layers as the tokens do."""
    p = cfg.n_vision_tokens
    xt = lm.scale_embed(lm.embed_tokens(model, cfg, batch["tokens"]),
                        math.sqrt(cfg.d_model))
    xv = batch["vision"].to(xt.dtype) @ acts.gathered(model).projector
    h, _ = lm.lm_backbone(model, cfg, torch.cat([xv, xt], dim=1),
                          prefix_len=p, remat=remat, data_shards=data_shards)
    logits, comm = lm.head_logits(model, cfg, h[:, p:])
    loss = lm.masked_ce(logits, batch["labels"], comm)
    return loss, {"ce_loss": loss}
