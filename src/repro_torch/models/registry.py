"""Model registry: one uniform bundle per architecture family.

The port's counterpart of ``repro.models.registry``.  Every ported
architecture resolves to a ``ModelBundle`` exposing:

  init(generator) -> params (an ``nn.Module`` on the generator's device)
  prefill(params, batch, cache_len, window) -> (logits, cache)
  decode(params, cache, tokens, lengths, window) -> (logits, cache)
  empty_cache(batch, cache_len, dtype, device) -> cache dict

The recurrent families' ``prefill`` also takes ``ssd_impl=``, the scan
hook of ``models.ssm``.  The dense, ssm (Mamba-2) and hybrid (Zamba2)
families are ported; ``get_model`` raises ``UnsupportedFamilyError``
for moe, vlm and audio, which come with a later slice (ROADMAP queue 1,
slice 5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import hybrid, lm, ssm
from .common import ModelConfig

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode: Callable
    empty_cache: Callable


def _dense_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None):
        return lm.lm_prefill(params, cfg, batch["tokens"], cache_len,
                             window=window)

    def decode(params, cache, tokens, lengths, window=None):
        # the dense decode attends over the whole valid cache: the
        # window is not applied, as in the JAX package
        return lm.lm_decode(params, cfg, cache, tokens, lengths)

    def empty_cache(batch, cache_len, dtype, device):
        return lm.empty_cache(cfg, batch, cache_len, dtype, device)

    return ModelBundle(cfg=cfg, init=lambda gen: lm.init_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=empty_cache)


def _ssm_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None, ssd_impl=None):
        return ssm.ssm_prefill(params, cfg, batch["tokens"], cache_len,
                               ssd_impl=ssd_impl)

    def decode(params, cache, tokens, lengths, window=None):
        return ssm.ssm_decode(params, cfg, cache, tokens, lengths)

    def empty_cache(batch, cache_len, dtype, device):
        return ssm.ssm_empty_cache(cfg, batch, dtype, device)

    return ModelBundle(cfg=cfg, init=lambda gen: ssm.init_ssm_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=empty_cache)


def _hybrid_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None, ssd_impl=None):
        return hybrid.hybrid_prefill(params, cfg, batch["tokens"], cache_len,
                                     window=window, ssd_impl=ssd_impl)

    def decode(params, cache, tokens, lengths, window=None):
        # the shared block's decode attends over the whole valid cache,
        # as in the JAX package
        return hybrid.hybrid_decode(params, cfg, cache, tokens, lengths)

    def empty_cache(batch, cache_len, dtype, device):
        return hybrid.hybrid_empty_cache(cfg, batch, cache_len, dtype,
                                         device)

    return ModelBundle(cfg=cfg,
                       init=lambda gen: hybrid.init_hybrid_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=empty_cache)


_BUILDERS = {"dense": _dense_bundle, "ssm": _ssm_bundle,
             "hybrid": _hybrid_bundle}


def get_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.family not in PORTED_FAMILIES:
        # imported here: the serving package imports this module
        from repro_torch.serving.errors import UnsupportedFamilyError
        raise UnsupportedFamilyError(cfg.family, "the PyTorch port",
                                     supported=PORTED_FAMILIES)
    return _BUILDERS[cfg.family](cfg)
