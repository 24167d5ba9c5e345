"""Whisper's encoder-decoder and PaliGemma's vision-prefixed decoder in
the port against the JAX package's ``encdec`` and ``vlm``, at the
reduced configs, the same weights in both (``params_from_jax``) and
numpy-seeded frames, patches and tokens: the prefill's logits and every
cache leaf (Whisper's staged cross K/V included), then a decode step
from that cache.

Tolerances are relative to the largest entry.  The JAX init draws the
stacked (L, …) leaves with fan-in L, which makes the reduced models'
attention nearly one-hot: float32 rounding of the two frameworks then
moves Whisper's caches by ~4e-5 and its decode logits by ~2e-4 of their
largest entry (measured), PaliGemma's by ~5e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model

from repro_torch.configs import get_config
from repro_torch.models import get_model, params_from_jax

# (arch, logits and cache tolerance, relative)
CASES = [("whisper-large-v3", 1e-3), ("paligemma-3b", 1e-4)]
CACHE_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread: its tensors are
    small, and with the suite's parallel workers on a shared CPU every
    extra OpenMP thread only waits for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return (np.abs(np.asarray(got, np.float32) - want).max()
            / np.abs(want).max())


def _batch(cfg, rng, s):
    batch = {"tokens": rng.integers(0, cfg.vocab - 2, (2, s))}
    if cfg.family == "vlm":
        batch["vision"] = rng.normal(
            size=(2, cfg.n_vision_tokens, cfg.d_vision)).astype(np.float32)
    else:
        batch["frames"] = rng.normal(
            size=(2, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _both(arch, dtype=None, scale=None):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jbundle = jax_get_model(jcfg)
    params = jbundle.init(jax.random.PRNGKey(0))
    if scale:
        params = jax.tree.map(lambda a: (a * scale).astype(a.dtype), params)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jbundle, params, get_model(cfg), model


@pytest.mark.parametrize("arch,tol", CASES)
def test_prefill_and_decode_match_jax(arch, tol):
    jbundle, params, bundle, model = _both(arch)
    cfg = bundle.cfg
    rng = np.random.default_rng(21)
    batch = _batch(cfg, rng, 24)
    jl, jcache = jbundle.prefill(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_len=CACHE_LEN)
    tl, cache = bundle.prefill(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        cache_len=CACHE_LEN)
    assert set(cache) == set(jcache)
    assert _rel(tl.numpy(), jl) <= tol
    for name in cache:
        assert cache[name].shape == jcache[name].shape, name
        assert _rel(cache[name].numpy(), jcache[name]) <= tol, name
    # the vision prefix counts in the decode positions
    pos = 24 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    lengths = np.full(2, pos, np.int32)
    nxt = rng.integers(0, cfg.vocab - 2, (2, 1))
    jl2, jc2 = jbundle.decode(params, jcache, jnp.asarray(nxt, jnp.int32),
                              jnp.asarray(lengths))
    tl2, c2 = bundle.decode(model, cache, torch.from_numpy(nxt),
                            torch.from_numpy(lengths))
    assert _rel(tl2.numpy(), jl2) <= tol
    assert _rel(c2["k"].numpy(), jc2["k"]) <= tol


def test_whisper_bf16_matches_jax():
    """A bfloat16 Whisper with frames in bfloat16, where the JAX package
    runs (float32 frames on a bfloat16 model stop its decoder scan; the
    port casts them to the model's dtype): the prefill's logits and
    cache leaves have the JAX package's dtypes and agree within two
    bfloat16 ulps of the largest entry (measured: one); float32 frames
    give the port the same values.  In bfloat16 the fan-in-L init's
    near one-hot attention turns one rounding into a different softmax
    winner, so both packages get the init's tree scaled by 0.2."""
    jbundle, params, bundle, model = _both("whisper-large-v3", "bfloat16",
                                           scale=0.2)
    rng = np.random.default_rng(22)
    batch = _batch(bundle.cfg, rng, 16)
    jbatch = {"tokens": jnp.asarray(batch["tokens"]),
              "frames": jnp.asarray(batch["frames"], jnp.bfloat16)}
    jl, jcache = jbundle.prefill(params, jbatch, cache_len=CACHE_LEN)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, cache = bundle.prefill(model, tbatch, cache_len=CACHE_LEN)
    assert str(tl.dtype).replace("torch.", "") == str(jl.dtype)
    assert _rel(tl.float().numpy(), jl) <= 2.0 ** -6
    for name in cache:
        assert str(cache[name].dtype).replace("torch.", "") == \
            str(jcache[name].dtype), name
        assert _rel(cache[name].float().numpy(),
                    jcache[name]) <= 2.0 ** -6, name
    tbatch["frames"] = tbatch["frames"].bfloat16()
    tl16, _ = bundle.prefill(model, tbatch, cache_len=CACHE_LEN)
    assert torch.equal(tl16, tl)
