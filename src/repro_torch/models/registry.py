"""Model registry: one uniform bundle per architecture family.

The port's counterpart of ``repro.models.registry``.  Every architecture
of the six families (dense, moe, ssm, hybrid, vlm, audio) resolves to a
``ModelBundle`` exposing:

  init(generator) -> params (an ``nn.Module`` on the generator's device)
  prefill(params, batch, cache_len, window) -> (logits, cache)
  decode(params, cache, tokens, lengths, window) -> (logits, cache)
  empty_cache(batch, cache_len, dtype, device) -> cache dict

MoE shares the dense bundle (``models.lm``), as in the JAX package; its
prefill reads the batch's ``n_valid``/``moe_cap`` (the capacity-stable
bucketed mode) where the engine puts them.  The vlm batch carries
``vision``, the audio one ``frames``.  The recurrent families' ``prefill``
also takes ``ssd_impl=``, the scan hook of ``models.ssm``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import encdec, hybrid, lm, ssm, vlm
from .common import ModelConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode: Callable
    empty_cache: Callable


def _kv_cache(cfg: ModelConfig):
    def empty_cache(batch, cache_len, dtype, device):
        return lm.empty_cache(cfg, batch, cache_len, dtype, device)
    return empty_cache


def _dense_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None):
        # n_valid/moe_cap: the capacity-stable bucketed-MoE scalars the
        # engine puts in the batch; absent for exact-length or dense
        return lm.lm_prefill(params, cfg, batch["tokens"], cache_len,
                             window=window, n_valid=batch.get("n_valid"),
                             moe_cap=batch.get("moe_cap"))

    def decode(params, cache, tokens, lengths, window=None):
        # the dense decode attends over the whole valid cache: the
        # window is not applied, as in the JAX package
        return lm.lm_decode(params, cfg, cache, tokens, lengths)

    return ModelBundle(cfg=cfg, init=lambda gen: lm.init_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=_kv_cache(cfg))


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


def _vlm_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None):
        return vlm.vlm_prefill(params, cfg, batch, cache_len, window=window)

    def decode(params, cache, tokens, lengths, window=None):
        return vlm.vlm_decode(params, cfg, cache, tokens, lengths)

    return ModelBundle(cfg=cfg, init=lambda gen: lm.init_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=_kv_cache(cfg))


def _audio_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None):
        return encdec.encdec_prefill(params, cfg, batch, cache_len,
                                     window=window)

    def decode(params, cache, tokens, lengths, window=None):
        return encdec.encdec_decode(params, cfg, cache, tokens, lengths)

    def empty_cache(batch, cache_len, dtype, device):
        return encdec.encdec_empty_cache(cfg, batch, cache_len, dtype,
                                         device)

    return ModelBundle(cfg=cfg,
                       init=lambda gen: encdec.init_encdec(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=empty_cache)


_BUILDERS = {"dense": _dense_bundle, "moe": _dense_bundle,
             "ssm": _ssm_bundle, "hybrid": _hybrid_bundle,
             "vlm": _vlm_bundle, "audio": _audio_bundle}


def get_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.family not in _BUILDERS:
        # imported here: the serving package imports this module
        from repro_torch.serving.errors import UnsupportedFamilyError
        raise UnsupportedFamilyError(cfg.family, "the PyTorch port",
                                     supported=FAMILIES)
    return _BUILDERS[cfg.family](cfg)


def empty_model(cfg: ModelConfig, device="cuda"):
    """The family's parameter module, built empty on ``device``."""
    cls = {"ssm": ssm.SSMLM, "hybrid": hybrid.HybridLM,
           "audio": encdec.EncDecLM}.get(cfg.family, lm.DenseLM)
    return cls(cfg, device)


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """Any family's JAX parameter tree (leaves as numpy arrays, per-layer
    leaves stacked on a leading L dim) as the port's model on
    ``device`` (the card by default), leaf for leaf."""
    return lm.load_jax_tree(empty_model(cfg, device), tree)
