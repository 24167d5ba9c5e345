"""The port's ``models/attention.py`` against the JAX package's
``repro.models.attention`` on the CPU, float32, on the same weights (the
JAX ``init_attention`` dict carried across by ``attention.params_from_jax``)
and the same numpy-seeded inputs: every function within ``TOL`` of the
largest entry, at group 1 and 2, with and without ``qk_norm`` —
``attention_prefill`` causal, with ``prefix_len``, ``window`` and
``cross_kv``; ``prefill_kv`` with ``cache_len`` below and above the
prompt; ``attention_decode`` through a ring that wraps, with ``window``,
``cross_kv`` and ``cross_len``; and ``init_attention``'s shapes and
scales.  ``backend="cuda"`` is held against ``"reference"`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 29); here it
raises.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention

from repro_torch.configs import get_config
from repro_torch.models import attention

TOL = 1e-5
# name -> (arch, config fields replaced): group 1 and 2, qk_norm off / on
CONFIGS = {"g1": ("phi3-mini-3.8b", {}),
           "g1-qk": ("phi3-mini-3.8b", {"qk_norm": True}),
           "g2": ("yi-6b", {}),
           "g2-qk": ("qwen3-32b", {})}
B, S, T = 3, 24, 10
CACHE = 16
# decode positions: an empty ring, a partly filled one, the last slot,
# and two that wrap (slot 3 of the second and third pass)
LENGTHS = [0, 5, CACHE - 1, CACHE + 3]
LENGTHS_WRAP = [2 * CACHE + 3, CACHE, 7, 3 * CACHE - 1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layers():
    """name -> (JAX config, JAX params, port config, port weights)."""
    out = {}
    for name, (arch, fields) in CONFIGS.items():
        jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                                   **fields)
        cfg = dataclasses.replace(get_config(arch, reduced=True), **fields)
        params = jax_attention.init_attention(jax.random.PRNGKey(1), jcfg,
                                              jnp.float32)
        # the norms drawn away from 1, so a dropped or misplaced norm shows
        if jcfg.qk_norm:
            rng = np.random.default_rng(2)
            for k in ("q_norm", "k_norm"):
                params[k] = jnp.asarray(rng.uniform(0.5, 1.5, cfg.dh),
                                        jnp.float32)
        tree = {k: np.asarray(v) for k, v in params.items()}
        out[name] = (jcfg, params, cfg,
                     attention.params_from_jax(tree, cfg, device="cpu"))
    return out


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, label=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    top = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max()) / top
    assert err <= TOL, (label, err)


PREFILL = {"causal": {}, "prefix": {"prefix_len": 6},
           "window": {"window": 5}, "prefix+window": {"prefix_len": 4,
                                                     "window": 7}}


@pytest.mark.parametrize("kind", list(PREFILL))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_jax(layers, name, kind):
    jcfg, params, cfg, p = layers[name]
    x = _x(cfg, B, S, 3)
    want = jax_attention.attention_prefill(params, jcfg, jnp.asarray(x),
                                           **PREFILL[kind])
    got = attention.attention_prefill(p, cfg, torch.from_numpy(x),
                                      **PREFILL[kind])
    _close(got, want, (name, kind))


def _cross(cfg, seed, layout):
    """Cross K/V (B,T,KH,dh) for prefill, (B,KH,T,dh) for decode."""
    rng = np.random.default_rng(seed)
    shape = ((B, T, cfg.n_kv_heads, cfg.dh) if layout == "prefill"
             else (B, cfg.n_kv_heads, T, cfg.dh))
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cross_prefill_matches_jax(layers, name):
    jcfg, params, cfg, p = layers[name]
    x = _x(cfg, B, S, 4)
    kv = _cross(cfg, 5, "prefill")
    want = jax_attention.attention_prefill(
        params, jcfg, jnp.asarray(x), cross_kv=tuple(map(jnp.asarray, kv)))
    got = attention.attention_prefill(
        p, cfg, torch.from_numpy(x),
        cross_kv=tuple(map(torch.from_numpy, kv)))
    _close(got, want, name)


@pytest.mark.parametrize("cache_len", [S // 2, S, 2 * S])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_kv_matches_jax(layers, name, cache_len):
    jcfg, params, cfg, p = layers[name]
    x = _x(cfg, B, S, 6)
    wk, wv = jax_attention.prefill_kv(params, jcfg, jnp.asarray(x),
                                      cache_len)
    gk, gv = attention.prefill_kv(p, cfg, torch.from_numpy(x), cache_len)
    _close(gk, wk, (name, "k"))
    _close(gv, wv, (name, "v"))


def _cache(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, (B + 1, cfg.n_kv_heads, CACHE, cfg.dh)
                          ).astype(np.float32) for k in ("k", "v")}


DECODE = {"ring": (LENGTHS, {}), "wrapped": (LENGTHS_WRAP, {}),
          "window": (LENGTHS_WRAP, {"window": 6})}


@pytest.mark.parametrize("kind", list(DECODE))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_jax(layers, name, kind):
    """Two decode steps through the ring, each from the cache the last
    returned: the outputs and the caches (the one-hot blend writes slot
    ``lengths % C``, also on the wrapped passes)."""
    jcfg, params, cfg, p = layers[name]
    lengths, kw = DECODE[kind]
    cache = _cache(cfg, 7)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v) for k, v in cache.items()}
    for step in range(2):
        x = _x(cfg, B + 1, 1, 8 + step)
        lens = np.asarray(lengths, np.int32) + step
        want, jc = jax_attention.attention_decode(
            params, jcfg, jnp.asarray(x), jc, jnp.asarray(lens), **kw)
        got, tc = attention.attention_decode(
            p, cfg, torch.from_numpy(x), tc, torch.from_numpy(lens), **kw)
        _close(got, want, (name, kind, step))
        for k in ("k", "v"):
            _close(tc[k], jc[k], (name, kind, step, k))


@pytest.mark.parametrize("cross_len", [None, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cross_decode_matches_jax(layers, name, cross_len):
    jcfg, params, cfg, p = layers[name]
    x = _x(cfg, B, 1, 9)
    kv = _cross(cfg, 10, "decode")
    cache = _cache(cfg, 11)
    lens = np.asarray([1, 2, 3], np.int32)
    want, _ = jax_attention.attention_decode(
        params, jcfg, jnp.asarray(x), {k: jnp.asarray(v[:B])
                                       for k, v in cache.items()},
        jnp.asarray(lens), cross_kv=tuple(map(jnp.asarray, kv)),
        cross_len=cross_len)
    tc = {k: torch.from_numpy(v[:B]) for k, v in cache.items()}
    got, back = attention.attention_decode(
        p, cfg, torch.from_numpy(x), tc, torch.from_numpy(lens),
        cross_kv=tuple(map(torch.from_numpy, kv)), cross_len=cross_len)
    _close(got, want, (name, cross_len))
    assert back is tc


def test_fully_masked_cross_rows_give_the_uniform_mean(layers):
    """Masked logits are -1e30, as in JAX: with ``cross_len`` 0 every row
    is masked and each head gets the mean of its values, not NaN."""
    jcfg, params, cfg, p = layers["g2"]
    x = _x(cfg, B, 1, 12)
    kv = _cross(cfg, 13, "decode")
    want, _ = jax_attention.attention_decode(
        params, jcfg, jnp.asarray(x), {}, jnp.zeros(B, jnp.int32),
        cross_kv=tuple(map(jnp.asarray, kv)), cross_len=0)
    got, _ = attention.attention_decode(
        p, cfg, torch.from_numpy(x), {}, torch.zeros(B, dtype=torch.int32),
        cross_kv=tuple(map(torch.from_numpy, kv)), cross_len=0)
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_attention_follows_jax(layers, name):
    """The same leaves, shapes and dtypes as the JAX init, each drawn
    with its standard deviation (N(0, 1/sqrt(D)), ``wo``
    N(0, 1/sqrt(H·dh))), norms of ones."""
    jcfg, _, cfg, _ = layers[name]
    want = jax_attention.init_attention(jax.random.PRNGKey(0), jcfg,
                                        jnp.float32)
    got = attention.init_attention(torch.Generator().manual_seed(0), cfg)
    named = dict(got.named_parameters())
    assert set(named) == set(want)
    for k, w in want.items():
        t = named[k]
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, k
        if k.endswith("_norm"):
            assert torch.equal(t, torch.ones_like(t)), k
            continue
        fan = (cfg.n_heads * cfg.dh) if k == "wo" else cfg.d_model
        std = float(t.std())
        assert abs(std * math.sqrt(fan) - 1) < 0.05, (k, std)
        assert abs(float(np.asarray(w).std()) * math.sqrt(fan) - 1) < 0.05


def test_cuda_backend_raises_off_the_card(layers):
    """``backend="cuda"`` on CPU tensors raises (no fallback), and an
    unknown backend does too."""
    _, _, cfg, p = layers["g2"]
    x = torch.from_numpy(_x(cfg, 1, 8, 14))
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.attention_prefill(p, cfg, x, backend="cuda")
    cache = {k: torch.zeros(1, cfg.n_kv_heads, CACHE, cfg.dh)
             for k in ("k", "v")}
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.attention_decode(p, cfg, x[:, :1], cache,
                                   torch.zeros(1, dtype=torch.int32),
                                   backend="cuda")
    with pytest.raises(ValueError, match="not one of"):
        attention.attention_prefill(p, cfg, x, backend="pallas")
