"""Model registry: one uniform bundle per architecture family.

The port's counterpart of ``repro.models.registry``.  Every architecture
of the six families (dense, moe, ssm, hybrid, vlm, audio) resolves to a
``ModelBundle`` exposing:

  init(generator) -> params (an ``nn.Module`` on the generator's device)
  loss(params, batch, *, remat, data_shards) -> (loss, metrics)
  prefill(params, batch, cache_len, window) -> (logits, cache)
  decode(params, cache, tokens, lengths, window) -> (logits, cache)
    (dense, moe, vlm, hybrid: ``seq_kv=`` for a sequence-sharded cache)
  empty_cache(batch, cache_len, dtype, device) -> cache dict
  batch_shapes(mode, batch, seq) -> {name: BatchSpec(shape, dtype)}

``loss`` is the family's training loss, its metrics the JAX package's
keys (``ce_loss``; ``aux_loss`` for dense and MoE); ``make_batch``
draws concrete inputs of ``batch_shapes``' specs.

MoE shares the dense bundle (``models.lm``), as in the JAX package; its
prefill reads the batch's ``n_valid``/``moe_cap`` (the capacity-stable
bucketed mode) where the engine puts them.  The vlm batch carries
``vision``, the audio one ``frames``.  The recurrent families' ``prefill``
also takes ``ssd_impl=``, the scan hook of ``models.ssm``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import resolve_device

from . import encdec, hybrid, lm, ssm, vlm
from .common import ModelConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class BatchSpec(NamedTuple):
    """One model input's shape and dtype (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode: Callable
    empty_cache: Callable
    loss: Optional[Callable] = None
    batch_shapes: Optional[Callable] = None

    def make_batch(self, rng: np.random.Generator, mode: str, batch: int,
                   seq: int, device="cuda") -> Dict[str, torch.Tensor]:
        """Concrete random inputs matching ``batch_shapes`` on ``device``
        (the card by default), drawn from ``rng`` as the JAX package
        draws them: token ids in [0, vocab), ``lengths`` in [1, seq),
        floats from a standard normal."""
        device = resolve_device(device)
        out = {}
        for name, spec in self.batch_shapes(mode, batch, seq).items():
            if spec.dtype.is_floating_point:
                arr = rng.normal(0, 1, spec.shape)
            elif name == "lengths":
                arr = rng.integers(1, seq, spec.shape)
            else:
                arr = rng.integers(0, self.cfg.vocab, spec.shape)
            out[name] = torch.as_tensor(arr).to(device=device,
                                                dtype=spec.dtype)
        return out


def _tok_shapes(mode: str, batch: int, seq: int) -> Dict[str, BatchSpec]:
    if mode == "train":
        return {"tokens": BatchSpec((batch, seq), torch.int32),
                "labels": BatchSpec((batch, seq), torch.int32)}
    if mode == "prefill":
        return {"tokens": BatchSpec((batch, seq), torch.int32)}
    return {"tokens": BatchSpec((batch, 1), torch.int32),
            "lengths": BatchSpec((batch,), torch.int32)}


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

    def decode(params, cache, tokens, lengths, window=None, seq_kv=False):
        # the dense decode attends over the whole valid cache: the
        # window is not applied, as in the JAX package
        return lm.lm_decode(params, cfg, cache, tokens, lengths,
                            seq_kv=seq_kv)

    return ModelBundle(cfg=cfg, init=lambda gen: lm.init_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=_kv_cache(cfg),
                       loss=lambda params, batch, **kw: lm.lm_loss(
                           params, cfg, batch, **kw),
                       batch_shapes=_tok_shapes)


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
                       empty_cache=empty_cache,
                       loss=lambda params, batch, **kw: ssm.ssm_loss(
                           params, cfg, batch, **kw),
                       batch_shapes=_tok_shapes)


def _hybrid_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None, ssd_impl=None):
        return hybrid.hybrid_prefill(params, cfg, batch["tokens"], cache_len,
                                     window=window, ssd_impl=ssd_impl)

    def decode(params, cache, tokens, lengths, window=None, seq_kv=False):
        # the shared block's decode attends over the whole valid cache,
        # as in the JAX package
        return hybrid.hybrid_decode(params, cfg, cache, tokens, lengths,
                                    seq_kv=seq_kv)

    def empty_cache(batch, cache_len, dtype, device):
        return hybrid.hybrid_empty_cache(cfg, batch, cache_len, dtype,
                                         device)

    return ModelBundle(cfg=cfg,
                       init=lambda gen: hybrid.init_hybrid_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=empty_cache,
                       loss=lambda params, batch, **kw: hybrid.hybrid_loss(
                           params, cfg, batch, **kw),
                       batch_shapes=_tok_shapes)


def _vlm_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None):
        return vlm.vlm_prefill(params, cfg, batch, cache_len, window=window)

    def decode(params, cache, tokens, lengths, window=None, seq_kv=False):
        return vlm.vlm_decode(params, cfg, cache, tokens, lengths,
                              seq_kv=seq_kv)

    p, dv = cfg.n_vision_tokens, cfg.d_vision

    def batch_shapes(mode, b, s):
        base = _tok_shapes(mode, b, max(s - p, 1))
        if mode in ("train", "prefill"):
            base["vision"] = BatchSpec((b, p, dv), cfg.torch_dtype())
        return base

    return ModelBundle(cfg=cfg, init=lambda gen: lm.init_lm(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=_kv_cache(cfg),
                       loss=lambda params, batch, **kw: vlm.vlm_loss(
                           params, cfg, batch, **kw),
                       batch_shapes=batch_shapes)


def _audio_bundle(cfg: ModelConfig) -> ModelBundle:
    def prefill(params, batch, cache_len=None, window=None):
        return encdec.encdec_prefill(params, cfg, batch, cache_len,
                                     window=window)

    def decode(params, cache, tokens, lengths, window=None):
        return encdec.encdec_decode(params, cfg, cache, tokens, lengths)

    def empty_cache(batch, cache_len, dtype, device):
        return encdec.encdec_empty_cache(cfg, batch, cache_len, dtype,
                                         device)

    def batch_shapes(mode, b, s):
        base = _tok_shapes(mode, b, s)
        if mode in ("train", "prefill"):
            base["frames"] = BatchSpec((b, cfg.n_audio_ctx, cfg.d_model),
                                       cfg.torch_dtype())
        return base

    return ModelBundle(cfg=cfg,
                       init=lambda gen: encdec.init_encdec(gen, cfg),
                       prefill=prefill, decode=decode,
                       empty_cache=empty_cache,
                       loss=lambda params, batch, **kw: encdec.encdec_loss(
                           params, cfg, batch, **kw),
                       batch_shapes=batch_shapes)


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


def jax_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
    """Tensors keyed by the port's parameter names (a model's parameters,
    or its gradients or moments under the same names) as a JAX-layout
    tree of numpy arrays: nested dicts, per-layer leaves stacked on a
    leading L dim (``lm.jax_layout``).  bfloat16 comes back widened to
    float32 (exact: numpy has no bfloat16)."""
    tree: Dict = {}
    for key, (parts, stacked) in lm.jax_layout(named).items():
        arrs = [t.detach().to("cpu", torch.float32 if t.dtype ==
                              torch.bfloat16 else t.dtype).numpy()
                for t in parts]
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(arrs) if stacked else arrs[0]
    return tree


def params_to_jax(model, cfg: ModelConfig) -> Dict:
    """The inverse of ``params_from_jax``: ``model``'s parameters as the
    JAX package's parameter tree for ``cfg`` (numpy leaves,
    ``jax_tree``)."""
    if getattr(model, "cfg", cfg) != cfg:
        raise ValueError(f"the model is a {model.cfg.arch_id}, not a "
                         f"{cfg.arch_id}")
    return jax_tree(model.named_parameters())
