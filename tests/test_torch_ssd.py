"""The SSD scan and the recurrent families' model steps on the CPU, held
against the JAX package on the same numpy-seeded inputs.

  * the port's ``ssd_ref`` (the sequential oracle) and ``ssd_scan_ref``
    (the plain version of K8, reached through ``kernels.ops.ssd_scan`` on
    a CPU tensor) against JAX ``ref.ssd_ref`` and ``ops.ssd_scan`` (the
    Pallas kernel in interpret mode) at ``tests/test_kernels.py``'s sweep
    shapes, with and without D and an initial state, within that test's
    atol 5e-4 / rtol 1e-3; chunk invariance; the padded-tail no-op;
  * ``models.ssm.ssd_chunked`` and the kernel hook ``ssd_chunked_kernel``
    against JAX ``ssd_chunked``, and the refusal of a length that is not
    a multiple of the chunk;
  * ``ssm_prefill``, ``ssm_prefill_chunk``, ``ssm_decode`` and the
    ``hybrid_*`` steps on the JAX weights carried across, reduced
    configs.

The Pallas kernel needs ``pltpu.TPUMemorySpace``, which newer jax calls
``pltpu.MemorySpace``: the alias is set for this module only, and the
kernel's jit cache is dropped on the way out."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import get_model as jax_get_model
from repro.models import hybrid as jax_hybrid
from repro.models import ssm as jax_ssm

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as K8
from repro_torch.models import get_model, hybrid, params_from_jax, ssm

# tests/test_kernels.py's bound for the SSD scan against its oracle
SSD_ATOL, SSD_RTOL = 5e-4, 1e-3
# two chunked float32 scans of the same function, summed in other orders
CHUNKED_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread (the suite's
    parallel workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _pallas_memory_space_alias():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    ssd_scan_pallas.clear_cache()


def _ssd_case(b, s, h, p, g, n, seed, h0=False):
    """tests/test_kernels.py's inputs, plus D and an initial state."""
    rng = np.random.default_rng(seed)
    case = {"x": rng.normal(0, 1, (b, s, h, p)).astype(np.float32),
            "dt": rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            "A": -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            "B": rng.normal(0, 1, (b, s, g, n)).astype(np.float32),
            "C": rng.normal(0, 1, (b, s, g, n)).astype(np.float32),
            "D": rng.normal(0, 1, (h,)).astype(np.float32)}
    case["h0"] = (rng.normal(0, 1, (b, h, p, n)).astype(np.float32)
                  if h0 else None)
    return case


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


SWEEP = [(1, 128, 2, 16, 1, 32), (2, 256, 4, 32, 2, 64),
         (1, 512, 2, 64, 1, 16)]


@pytest.mark.parametrize("h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("with_d", [True, False], ids=["D", "no-D"])
@pytest.mark.parametrize("b,s,h,p,g,n", SWEEP)
def test_ssd_plain_versions_match_jax(b, s, h, p, g, n, with_d, h0):
    c = _ssd_case(b, s, h, p, g, n, s + h, h0)
    d = c["D"] if with_d else None
    args = [c[k] for k in ("x", "dt", "A", "B", "C")]
    want_y, want_s = jax_ref.ssd_ref(*map(_j, args), _j(d), _j(c["h0"]))
    before = K8.launches
    got = ops.ssd_scan(*map(_t, args), _t(d), h0=_t(c["h0"]))
    oracle = ref.ssd_ref(*map(_t, args), _t(d), h0=_t(c["h0"]))
    assert K8.launches == before            # the CPU runs the plain version
    for (gy, gs) in (got, oracle):
        np.testing.assert_allclose(gy.numpy(), np.asarray(want_y),
                                   atol=SSD_ATOL, rtol=SSD_RTOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(want_s),
                                   atol=SSD_ATOL, rtol=SSD_RTOL)
    if not h0:      # the Pallas kernel starts from zeros
        py, ps = jax_ops.ssd_scan(*map(_j, args), _j(d), interpret=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(py),
                                   atol=SSD_ATOL, rtol=SSD_RTOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ps),
                                   atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_scan_chunk_invariance():
    """The chunked dual form is exact: chunks of 32, 64 and 128 agree, with
    and without an initial state, and with the JAX kernel at 64."""
    c = _ssd_case(1, 256, 2, 16, 1, 32, 11, h0=True)
    args = [_t(c[k]) for k in ("x", "dt", "A", "B", "C")]
    for h0 in (None, _t(c["h0"])):
        y128, s128 = ops.ssd_scan(*args, chunk=128, h0=h0)
        for chunk in (32, 64):
            y, st = ops.ssd_scan(*args, chunk=chunk, h0=h0)
            np.testing.assert_allclose(y.numpy(), y128.numpy(), atol=1e-4,
                                       rtol=1e-4)
            np.testing.assert_allclose(st.numpy(), s128.numpy(), atol=1e-4,
                                       rtol=1e-4)
    py, ps = jax_ops.ssd_scan(*[_j(c[k]) for k in ("x", "dt", "A", "B",
                                                    "C")], None, chunk=64,
                              interpret=True)
    y, st = ops.ssd_scan(*args, chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), atol=SSD_ATOL,
                               rtol=SSD_RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(ps), atol=SSD_ATOL,
                               rtol=SSD_RTOL)


def test_ssd_scan_padded_tail_is_a_no_op():
    """Rows with dt = 0 (a prompt chunk's padded tail) neither decay nor
    add: the state after 100 real rows and 28 padded ones is the state
    after the 100, and the real rows' y are unchanged."""
    c = _ssd_case(1, 128, 4, 16, 2, 16, 3, h0=True)
    c["dt"][:, 100:] = 0.0
    args = [_t(c[k]) for k in ("x", "dt", "A", "B", "C")]
    y, st = ops.ssd_scan(*args, chunk=128, h0=_t(c["h0"]))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    ry, rs = ref.ssd_ref(*[a[:, :100] for a in args[:2]], args[2],
                         *[a[:, :100] for a in args[3:]], h0=_t(c["h0"]))
    np.testing.assert_allclose(st.numpy(), rs.numpy(), atol=SSD_ATOL,
                               rtol=SSD_RTOL)
    np.testing.assert_allclose(y[:, :100].numpy(), ry.numpy(), atol=SSD_ATOL,
                               rtol=SSD_RTOL)


def test_ssd_scan_wrappers_refuse():
    c = _ssd_case(1, 64, 2, 16, 1, 16, 0)
    args = [_t(c[k]) for k in ("x", "dt", "A", "B", "C")]
    before = K8.launches
    with pytest.raises(ValueError, match="chunk 256"):
        ops.ssd_scan(*args, chunk=256)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*args, chunk=48)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K8.ssd_scan_cuda(*args, chunk=64)
    assert K8.launches == before


# (b, s, h, p, g, n, chunk): one chunk, several chunks, groups, a chunk
# larger than S (taken as S), and the reduced configs' widths
CHUNKED_CASES = [(1, 64, 4, 16, 1, 16, 128), (2, 256, 4, 16, 2, 8, 128),
                 (1, 96, 16, 32, 1, 16, 32), (2, 40, 16, 32, 1, 16, 128)]


@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "carried"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CHUNKED_CASES)
def test_ssd_chunked_and_kernel_hook_match_jax(b, s, h, p, g, n, chunk,
                                               init):
    c = _ssd_case(b, s, h, p, g, n, s + n)
    rng = np.random.default_rng(s)
    state = (rng.normal(0, 1, (b, g, h // g, p, n)).astype(np.float32)
             if init else None)
    args = [c[k] for k in ("x", "dt", "A", "B", "C")]
    wy, ws = jax_ssm.ssd_chunked(*map(_j, args), chunk=chunk,
                                 init_state=_j(state))
    for fn in (ssm.ssd_chunked, ops.ssd_chunked_kernel):
        gy, gs = fn(*map(_t, args), chunk=chunk, init_state=_t(state))
        assert gs.shape == ws.shape
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy),
                                   atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws),
                                   atol=CHUNKED_TOL, rtol=CHUNKED_TOL)


def test_ssd_chunked_refuses_what_the_reference_refuses():
    """A one-shot length that is neither at most the chunk nor a multiple
    of it: the JAX function asserts, the port's scan and its kernel hook
    raise."""
    c = _ssd_case(1, 200, 2, 16, 1, 16, 0)
    args = [c[k] for k in ("x", "dt", "A", "B", "C")]
    with pytest.raises(AssertionError):
        jax_ssm.ssd_chunked(*map(_j, args), chunk=128)
    for fn in (ssm.ssd_chunked, ops.ssd_chunked_kernel):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            fn(*map(_t, args), chunk=128)


# ---------------------------------------------------------------------------
# the model steps on the JAX weights
# ---------------------------------------------------------------------------

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
# float32 on the JAX weights.  Mamba2: logits within 1e-4, each cache
# leaf within 5e-5 of its largest entry (the JAX init draws in_proj with
# fan-in L, so activations reach ~40; measured: 1.7e-5 on the last
# layer's conv window after 256 tokens, 8e-6 on the state after 32).
# Zamba2's shared block is drawn
# by the JAX init with fan-in 1 (standard deviation 1), so its attention
# is one-hot and amplifies rounding: a relative change of 1e-7 in one
# layer's in_proj moves the port's own logits by 3.7e-4 and the cache by
# 2e-4 to 3e-4 of its largest entry.  Its bound is set above that.
TOL = {"mamba2-780m": (1e-4, 5e-5), "zamba2-1.2b": (2e-3, 2e-3)}
CACHE_LEN = 64


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port model)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch, reduced=True)
        params = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        tree = jax.tree.map(np.asarray, params)
        out[arch] = jcfg, params, cfg, params_from_jax(tree, cfg,
                                                   device="cpu")
    return out


def _close(arch, got_logits, want_logits, got_cache, want_cache):
    logit_tol, cache_rtol = TOL[arch]
    if got_logits is not None:
        np.testing.assert_allclose(got_logits.numpy(),
                                   np.asarray(want_logits), rtol=0,
                                   atol=logit_tol)
    assert sorted(got_cache) == sorted(want_cache)
    for name, w in want_cache.items():
        w = np.asarray(w)
        assert tuple(got_cache[name].shape) == w.shape, name
        np.testing.assert_allclose(got_cache[name].numpy(), w, rtol=0,
                                   atol=cache_rtol * np.abs(w).max(),
                                   err_msg=name)


def _jax_steps(cfg):
    if cfg.family == "ssm":
        return (lambda p, t, c: jax_ssm.ssm_prefill(p, cfg, t, c),
                lambda p, c, t, s, n: jax_ssm.ssm_prefill_chunk(p, cfg, c, t,
                                                                n),
                lambda p, c, t, l: jax_ssm.ssm_decode(p, cfg, c, t, l))
    return (lambda p, t, c: jax_hybrid.hybrid_prefill(p, cfg, t, c),
            lambda p, c, t, s, n: jax_hybrid.hybrid_prefill_chunk(
                p, cfg, c, t, s, n),
            lambda p, c, t, l: jax_hybrid.hybrid_decode(p, cfg, c, t, l))


def _port_steps(cfg):
    if cfg.family == "ssm":
        return (lambda m, t, c: ssm.ssm_prefill(m, cfg, t, c),
                lambda m, c, t, s, n: ssm.ssm_prefill_chunk(m, cfg, c, t, n),
                lambda m, c, t, l: ssm.ssm_decode(m, cfg, c, t, l))
    return (lambda m, t, c: hybrid.hybrid_prefill(m, cfg, t, c),
            lambda m, c, t, s, n: hybrid.hybrid_prefill_chunk(m, cfg, c, t,
                                                              s, n),
            lambda m, c, t, l: hybrid.hybrid_decode(m, cfg, c, t, l))


@pytest.mark.parametrize("b,s", [(2, 24), (1, 256)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(models, arch, b, s):
    """One-shot prefill: one chunk (24 tokens), and two chunks of 128 with
    a hybrid ring shorter than the prompt (256 tokens into 64)."""
    jcfg, params, cfg, model = models[arch]
    toks = np.random.default_rng(s).integers(0, cfg.vocab - 2, (b, s))
    want_logits, want_cache = _jax_steps(jcfg)[0](
        params, jnp.asarray(toks, jnp.int32), CACHE_LEN)
    got_logits, got_cache = _port_steps(cfg)[0](
        model, torch.from_numpy(toks), CACHE_LEN)
    _close(arch, got_logits, want_logits, got_cache, want_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode_match_jax(models, arch):
    """From a 20-token prefill: a right-padded chunk of 16 with 11 real
    tokens (carried state, its tail a no-op), then three decode steps
    with the slots at their true lengths."""
    jcfg, params, cfg, model = models[arch]
    jpre, jchunk, jdec = _jax_steps(jcfg)
    ppre, pchunk, pdec = _port_steps(cfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab - 2, (1, 20))
    chunk = rng.integers(0, cfg.vocab - 2, (1, 16))
    chunk[:, 11:] = 0
    _, jc = jpre(params, jnp.asarray(toks, jnp.int32), CACHE_LEN)
    _, pc = ppre(model, torch.from_numpy(toks), CACHE_LEN)
    jc = jchunk(params, jc, jnp.asarray(chunk, jnp.int32), jnp.int32(20),
                jnp.int32(11))
    out = pchunk(model, pc, torch.from_numpy(chunk), 20, 11)
    assert out is pc and all(out[k].data_ptr() == pc[k].data_ptr()
                             for k in pc)           # written in place
    _close(arch, None, None, pc, jc)
    length = 31
    cur = rng.integers(0, cfg.vocab - 2, (1, 1))
    for _ in range(3):
        jl, jc = jdec(params, jc, jnp.asarray(cur, jnp.int32),
                      jnp.asarray([length], jnp.int32))
        pl_, pc = pdec(model, pc, torch.from_numpy(cur),
                       torch.tensor([length], dtype=torch.int32))
        _close(arch, pl_, jl, pc, jc)
        cur = np.asarray(jl)[:, :cfg.vocab].argmax(-1)[:, None]
        length += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_one_shot(models, arch):
    """The kernel hook and the plain scan on the CPU, chunked in 8s with a
    padded tail or one-shot, give the same cache (the chunk op seeded
    from an empty cache, as the engine does)."""
    _, _, cfg, model = models[arch]
    bundle = get_model(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab - 2, (1, 30))
    _, one = bundle.prefill(model, {"tokens": torch.from_numpy(toks)},
                            cache_len=CACHE_LEN)
    for impl in (None, ops.ssd_chunked_kernel):
        cache = bundle.empty_cache(1, CACHE_LEN, torch.float32, "cpu")
        for start in range(0, 30, 8):
            piece = np.zeros((1, 8), np.int64)
            real = min(8, 30 - start)
            piece[:, :real] = toks[:, start:start + real]
            kw = {} if impl is None else {"ssd_impl": impl}
            if cfg.family == "ssm":
                ssm.ssm_prefill_chunk(model, cfg, cache,
                                      torch.from_numpy(piece), real, **kw)
            else:
                hybrid.hybrid_prefill_chunk(model, cfg, cache,
                                            torch.from_numpy(piece), start,
                                            real, **kw)
        for name in ("conv", "state"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       one[name].numpy(), rtol=0,
                                       atol=1e-4 * one[name].abs().max())


def test_configs_and_init_follow_jax():
    """The configs copy the JAX package's value for value (with the
    ``ssm_heads``/``d_inner`` properties); the seeded init keeps the JAX
    init's deterministic leaves (to float32 rounding: the two packages
    take the log in different libraries) and draws each layer's in_proj
    with its own fan-in."""
    for arch in ARCHS:
        for reduced in (False, True):
            ours = get_config(arch, reduced=reduced)
            theirs = jax_get_config(arch, reduced=reduced)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert (ours.ssm_heads, ours.d_inner) == (theirs.ssm_heads,
                                                      theirs.d_inner)
    cfg = get_config("mamba2-780m", reduced=True)
    jtree = jax.tree.map(np.asarray, jax_get_model(
        jax_get_config("mamba2-780m", reduced=True)).init(
            jax.random.PRNGKey(0)))
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    for i, blk in enumerate(model.layers):
        for name in ("dt_bias", "A_log", "D", "conv_b", "norm", "ln"):
            np.testing.assert_allclose(getattr(blk, name).numpy(),
                                       jtree["blocks"][name][i], rtol=1e-6)
        std = blk.in_proj.std().item()
        assert abs(std * np.sqrt(cfg.d_model) - 1) < 0.05
