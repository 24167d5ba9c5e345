"""The dense LM of the port against the JAX package's, on the same
weights (the JAX ``init_lm`` tree carried across by
``params_from_jax``) and the same numpy-seeded tokens, for the four
dense architectures at their reduced (float32) widths: prefill logits
and KV cache, four decode steps with the reference attention and with
the decode-attention hook, the primitives, the configs and the seeded
init."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import common as jax_common
from repro.models import lm as jax_lm

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import common, get_model, lm, params_from_jax
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import FAMILIES
from repro_torch.serving import UnsupportedFamilyError

ARCHS = ["yi-6b", "phi3-mini-3.8b", "phi4-mini-3.8b", "qwen3-32b"]

# float32 end to end.  The JAX init draws the reduced configs'
# projections with standard deviation 1/sqrt(L) (ROADMAP queue 3), so
# attention scores reach ~600,
# where one float32 ulp is 6e-5: the two frameworks' summation orders
# alone move softmax weights by ~1e-4 relative, and the layer after
# inherits it.  Measured: logits within 2e-5 of each other (their
# largest magnitude is ~1.3), K/V within 2e-5 of the largest entry.
LOGIT_TOL = 1e-4
CACHE_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread: its tensors are
    small, and with the suite's parallel workers on a shared CPU every
    extra OpenMP thread only waits for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pallas_memory_space_alias():
    """Alias ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace`` in
    newer jax) for this module's Pallas decode-attention calls only, and
    drop the kernel's jit cache afterwards so no program traced under
    the alias outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX config, JAX params, port config, port model)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch, reduced=True)
        params = jax_lm.init_lm(jax.random.PRNGKey(0), jcfg)
        cfg = get_config(arch, reduced=True)
        out[arch] = (jcfg, params, cfg, params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return out


def _pallas_decode_attention(q, k_cache, v_cache, lengths):
    return jax_ops.decode_attention(q, k_cache, v_cache, lengths,
                                    interpret=True)


def _close_cache(got, want):
    for name in ("k", "v"):
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=CACHE_RTOL * np.abs(w).max())


# the ported configs: every architecture of the JAX package
CONFIG_ARCHS = ARCHS + ["mamba2-780m", "zamba2-1.2b", "deepseek-moe-16b",
                        "qwen3-moe-30b-a3b", "paligemma-3b",
                        "whisper-large-v3"]


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_configs_equal_the_jax_package(arch):
    for reduced in (False, True):
        assert (dataclasses.asdict(get_config(arch, reduced=reduced))
                == dataclasses.asdict(jax_get_config(arch, reduced=reduced)))
    assert sorted(list_archs()) == sorted(CONFIG_ARCHS)


# (batch, prompt length, cache length): in order, and a prompt longer
# than the cache (the ring keeps its last C positions)
@pytest.mark.parametrize("b,s,c", [(2, 40, 64), (2, 80, 64)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(models, arch, b, s, c):
    jcfg, params, cfg, model = models[arch]
    toks = np.random.default_rng(s).integers(0, cfg.vocab - 2, (b, s))
    want_logits, want_cache = jax_lm.lm_prefill(
        params, jcfg, jnp.asarray(toks, jnp.int32), c,
        window=jcfg.sliding_window)
    got_logits, got_cache = lm.lm_prefill(
        model, cfg, torch.from_numpy(toks), c, window=cfg.sliding_window)
    assert got_logits.shape == want_logits.shape
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=LOGIT_TOL)
    _close_cache(got_cache, want_cache)


@pytest.mark.parametrize("hook", [False, True], ids=["reference", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(models, pallas_memory_space_alias, arch,
                                hook):
    """Four decode steps from a prefilled cache, slots at different
    lengths, one of them wrapping the ring; with ``hook`` the attention
    runs through the decode-attention hook on both sides (the port's
    plain version of K3, the JAX package's Pallas kernel)."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab - 2, (3, 40))
    jcache = jax_lm.lm_prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                               64)[1]
    cache = lm.lm_prefill(model, cfg, torch.from_numpy(toks), 64)[1]
    lengths = np.array([40, 17, 62], np.int32)
    jdecode = jax.jit(functools.partial(
        jax_lm.lm_decode, cfg=jcfg,
        attn_impl=_pallas_decode_attention if hook else None))
    kw = {"attn_impl": ops.decode_attention} if hook else {}
    for _ in range(4):
        t = rng.integers(0, cfg.vocab - 2, (3, 1))
        want, jcache = jdecode(params, cache=jcache,
                               tokens=jnp.asarray(t, jnp.int32),
                               lengths=jnp.asarray(lengths))
        got, cache = lm.lm_decode(model, cfg, cache, torch.from_numpy(t),
                                  torch.from_numpy(lengths), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)
        _close_cache(cache, jcache)
        lengths += 1


def test_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 4, 64)).astype(np.float32)
    gamma = rng.normal(1, 0.1, 64).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)),
        jax_common.rms_norm(jnp.asarray(x), jnp.asarray(gamma)),
        rtol=1e-6, atol=1e-6)
    # per-slot decode positions (B,1): each slot rotated by its own
    pos = np.array([[3], [900]], np.int32)
    cos, sin = common.rope_cos_sin(torch.from_numpy(pos), 64, 1e4)
    jcos, jsin = jax_common.rope_cos_sin(jnp.asarray(pos), 64, 1e4)
    np.testing.assert_allclose(cos, jcos, atol=1e-6)
    xq = x[:, :1]
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(xq), cos, sin),
        jax_common.apply_rope(jnp.asarray(xq), jcos, jsin),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_follows_the_jax_init_rules(arch):
    """The seeded init is reproducible, has the JAX tree's leaves (same
    count and per-layer shapes) and draws them with the JAX init's rules
    applied per layer: 1/sqrt(fan-in) with fan-in = shape[0], explicit
    scales for ``wo`` and the embeddings."""
    cfg = get_config(arch, reduced=True)
    jtree = jax_lm.init_lm(jax.random.PRNGKey(0),
                           jax_get_config(arch, reduced=True))
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    again = get_model(cfg).init(torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(jtree))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    blk = model.layers[1]
    for name, w in blk.attn.named_parameters():
        assert tuple(jtree["blocks"]["attn"][name].shape[1:]) == w.shape
    for name, w in blk.mlp.named_parameters():
        assert tuple(jtree["blocks"]["mlp"][name].shape[1:]) == w.shape
    d = cfg.d_model
    for w, std in ((blk.attn.wq, 1 / math.sqrt(d)),
                   (blk.attn.wk, 1 / math.sqrt(d)),
                   (blk.mlp.wi, 1 / math.sqrt(d)),
                   (blk.attn.wo, 1 / math.sqrt(cfg.n_heads * cfg.dh)),
                   (blk.mlp.wo, 1 / math.sqrt(cfg.d_ff)),
                   (model.embed, 0.02), (model.lm_head, 0.02)):
        assert abs(w.std().item() / std - 1) < 0.05, w.shape


def test_get_model_refuses_unported_families():
    """Every family of the JAX package is ported; a family outside them
    is refused with the typed error naming the six."""
    cfg = ModelConfig(arch_id="rnn-smoke", family="rnn", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=128)
    with pytest.raises(UnsupportedFamilyError, match="rnn") as err:
        get_model(cfg)
    assert err.value.supported == FAMILIES
    for arch in list_archs():
        assert get_model(get_config(arch)).cfg.arch_id == arch
