"""Paged KV in the port against the JAX package: the ``PagedKVPool``
accounting, the paged plain version of K4 (``paged_decode_attention_ref``)
against the JAX oracle and the JAX Pallas kernel (interpret mode), the
dense ``lm_decode_paged`` step on the four reduced configs, and the
paged ``ServingEngine`` against the JAX engine under both tag chains;
then the port's own identities (paged equals contiguous, a smaller pool
gates admission, a paged checkpoint carries blocks, a slot's blocks are
untouched by the other slots' steps) and guards.  Inputs come from numpy
seeds; each check states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import repro.core.executor as jax_executor
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.models import get_model as jax_get_model
from repro.models import lm as jax_lm
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.core.executor import PagedKVPool
from repro_torch.core.schema import OpCode
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_decode_attention as K4
from repro_torch.models import get_model, lm, params_from_jax
from repro_torch.serving import Request, ServingEngine

ARCHS = ["yi-6b", "phi3-mini-3.8b", "phi4-mini-3.8b", "qwen3-32b"]
TAG_CHAINS = {("cuda", "reference"): ("pallas", "reference"),
              ("reference",): ("reference",)}
SLOTS, CACHE_LEN = 4, 64
# (prompt length, new tokens): a single-token prompt, one that decodes
# past the 64-position ring (58 + 12), one longer than the ring
WORKLOAD = [(5, 8), (12, 8), (58, 12), (1, 8), (9, 8), (70, 8), (7, 5)]
# (arch, kv_block, kv_pool_blocks) of the engine comparisons: blocks of
# 8 and 16, each with the default pool (every slot at full length) and
# with one that holds one full-length slot but not two (11 usable blocks
# of 8, 6 of 16), so admission waits for blocks; one per architecture
# keeps the JAX engines' compile time in bounds
ENGINE_CASES = [("yi-6b", 8, None), ("phi3-mini-3.8b", 16, None),
                ("phi4-mini-3.8b", 8, 12), ("qwen3-32b", 16, 7)]
# float32 plain versions: the paged one gathers the very rows of the
# contiguous one (bit-identical); against the JAX oracle and the Pallas
# kernel, float32 summation order only
ATTN_TOL = 2e-5
# the LM step, float32: relative to the largest logit or cache value
# (the JAX init's near one-hot attention amplifies summation-order
# differences, see tests/test_torch_lm.py)
LM_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's torch work on one intra-op thread: its tensors are
    small, and with the suite's parallel workers on a shared CPU every
    extra OpenMP thread only waits for a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _pallas_memory_space_alias():
    """Alias ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace`` in
    newer jax) for this module's JAX calls only, and drop the Pallas
    kernels' jit caches afterwards so no program traced under the alias
    outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()
    paged_decode_attention_pallas.clear_cache()


# ---------------------------------------------------------------------------
# the pool's accounting, against the JAX one
# ---------------------------------------------------------------------------

def _pool_trace(cls, seed):
    """A seeded sequence of reserve / map / release calls, valid and not:
    every call's result or exception type, in order."""
    rng = np.random.default_rng(seed)
    pool, held, out = cls(int(rng.integers(2, 12)), 16), [], []
    for _ in range(60):
        op = rng.integers(0, 4)
        try:
            if op == 0:
                n = int(rng.integers(-1, 5))
                pool.reserve(n)
                out.append(("reserve", n))
            elif op == 1:
                b = pool.map_block()
                held.append(b)
                out.append(("map", b))
            elif op == 2:
                k = int(rng.integers(0, len(held) + 1))
                give = held[:k] + ([int(rng.integers(0, 12))]
                                   if rng.random() < 0.2 else [])
                r = int(rng.integers(0, 3))
                pool.release(give, reserved=r)
                held = [b for b in held if b not in give]
                out.append(("release", tuple(give), r))
            else:
                out.append(("can", pool.can_reserve(int(rng.integers(0, 6)))))
        except (ValueError, RuntimeError) as e:
            out.append(type(e).__name__)
        out.append((pool.free_blocks(), pool.reserved_blocks(),
                    pool.alloc_count, pool.usable_blocks))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_pool_matches_jax(seed):
    """Same ids, same free/reserved counts and the same errors as the
    JAX ``PagedKVPool`` over a seeded call sequence."""
    assert _pool_trace(PagedKVPool, seed) == _pool_trace(
        jax_executor.PagedKVPool, seed)


def test_pool_guards():
    with pytest.raises(ValueError):
        PagedKVPool(1, 16)                  # no room for the sink
    with pytest.raises(ValueError):
        PagedKVPool(4, 0)
    pool = PagedKVPool(4, 8)
    with pytest.raises(RuntimeError):
        pool.map_block()                    # no reservation
    with pytest.raises(RuntimeError):
        pool.reserve(4)                     # only 3 usable
    pool.reserve(2)
    b = pool.map_block()
    assert b == 1                           # LIFO, ascending ids first
    with pytest.raises(ValueError):
        pool.release([PagedKVPool.GARBAGE_BLOCK])
    pool.release([b], reserved=1)
    with pytest.raises(ValueError):
        pool.release([b])                   # double release
    with pytest.raises(ValueError):
        pool.release([], reserved=1)        # over-cancel
    assert pool.free_blocks() == pool.usable_blocks == 3


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------

def _scattered(rng, b, h, kh, c, bs, d, mapped=None):
    """A contiguous (B,KH,C,D) cache and the same rows scattered into a
    permuted physical (P,KH,BS,D) pool with per-row tables; row i maps
    ``mapped[i]`` blocks, its unmapped tail pointing at block 0."""
    t = c // bs
    mapped = mapped or [t] * b
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, kh, c, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, kh, c, d)).astype(np.float32)
    n_blocks = sum(mapped) + 1
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((b, t), np.int32)
    k_pool = np.zeros((n_blocks, kh, bs, d), np.float32)
    v_pool = np.zeros((n_blocks, kh, bs, d), np.float32)
    for i in range(b):
        for j in range(mapped[i]):
            tables[i, j] = next(ids)
            k_pool[tables[i, j]] = k[i, :, j * bs:(j + 1) * bs]
            v_pool[tables[i, j]] = v[i, :, j * bs:(j + 1) * bs]
    # the contiguous view of an unmapped entry is block 0's rows
    for i in range(b):
        k[i, :, mapped[i] * bs:] = 0.0
        v[i, :, mapped[i] * bs:] = 0.0
    return q, k, v, k_pool, v_pool, tables


# (b, h, kh, c, bs, d, window)
PAGED_CASES = [(3, 4, 2, 64, 16, 32, None), (3, 4, 2, 64, 8, 32, None),
               (2, 8, 1, 128, 32, 64, None), (2, 4, 4, 128, 64, 16, None),
               (3, 4, 2, 64, 16, 32, 20), (2, 6, 3, 96, 8, 96, 33)]


def _lengths(rng, b, c, mapped, bs):
    lengths = np.array([min(int(rng.integers(1, c + 1)), m * bs)
                        for m in mapped], np.int32)
    lengths[0] = 1
    return lengths


@pytest.mark.parametrize("b,h,kh,c,bs,d,window", PAGED_CASES)
def test_paged_plain_bit_identical_to_contiguous(b, h, kh, c, bs, d,
                                                 window):
    rng = np.random.default_rng(c + bs + d)
    mapped = [c // bs] + [max(1, c // bs - i) for i in range(1, b)]
    q, k, v, k_pool, v_pool, tables = _scattered(rng, b, h, kh, c, bs, d,
                                                 mapped)
    lengths = _lengths(rng, b, c, mapped, bs)
    t = lambda a: torch.from_numpy(a)
    want = ref.decode_attention_ref(t(q), t(k), t(v), t(lengths),
                                    window=window)
    got = ops.paged_decode_attention(t(q), t(k_pool), t(v_pool), t(tables),
                                     t(lengths), window=window)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,kh,c,bs,d,window", PAGED_CASES)
def test_paged_plain_matches_jax(b, h, kh, c, bs, d, window):
    """On a permuted table with unmapped tails: within ``ATTN_TOL`` of
    the JAX ``paged_decode_attention_ref`` and of the JAX Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(7 * c + bs)
    mapped = [max(1, c // bs - i) for i in range(b)]
    q, _, _, k_pool, v_pool, tables = _scattered(rng, b, h, kh, c, bs, d,
                                                 mapped)
    lengths = _lengths(rng, b, c, mapped, bs)
    got = ops.paged_decode_attention(
        *map(torch.from_numpy, (q, k_pool, v_pool, tables, lengths)),
        window=window).numpy()
    jq = tuple(map(jnp.asarray, (q, k_pool, v_pool, tables, lengths)))
    oracle = np.asarray(jax_ref.paged_decode_attention_ref(*jq,
                                                           window=window))
    pallas = np.asarray(jax_ops.paged_decode_attention(*jq, window=window,
                                                       interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got, pallas, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_paged_plain_empty_rows_are_zero():
    """A row with no valid key outputs 0 (the JAX oracle gives NaN)."""
    rng = np.random.default_rng(3)
    q, _, _, k_pool, v_pool, tables = _scattered(rng, 2, 4, 2, 64, 16, 32)
    lengths = np.array([0, 40], np.int32)
    got = ops.paged_decode_attention(
        *map(torch.from_numpy, (q, k_pool, v_pool, tables, lengths)))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.isfinite(got).all()


def test_paged_kernel_refuses_on_any_device():
    """Block sizes K4 does not take are refused by the dispatcher on the
    CPU too; the launcher refuses CPU tensors and counts no launch."""
    q = torch.zeros(1, 2, 8)
    pool = torch.zeros(3, 1, 24, 8)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    before = K4.launches
    with pytest.raises(ValueError, match="block size 24"):
        ops.paged_decode_attention(q, pool, pool, tables, n)
    with pytest.raises(ValueError, match="CUDA"):
        K4.paged_decode_attention_cuda(q, pool[:, :, :16], pool[:, :, :16],
                                       tables, n)
    assert K4.launches == before
    for bs in (1, 2, 4, 8, 16, 32, 64, 96, 128):
        K4.check_block_size(bs)
    for bs in (0, 3, 12, 24, 48):
        with pytest.raises(ValueError):
            K4.check_block_size(bs)


# ---------------------------------------------------------------------------
# the LM's paged decode step, against the JAX package's
# ---------------------------------------------------------------------------

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


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LM_RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("bs,hook", [(8, False), (16, True)],
                         ids=["bs8-reference", "bs16-kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_paged_matches_jax(models, arch, bs, hook):
    """Four paged decode steps from the JAX prefill's cache scattered
    into a permuted pool: three slots at lengths 40, 17 (its unmapped
    tail on block 0) and 62 (wrapping the ring).  With ``hook`` the
    attention runs on both sides' K4: the port's plain version and the
    JAX Pallas kernel in interpret mode.  Logits and pools within
    ``LM_RTOL`` of their largest value."""
    jcfg, params, cfg, model = models[arch]
    rng = np.random.default_rng(bs)
    toks = rng.integers(0, cfg.vocab - 2, (3, 40))
    jcache = jax_lm.lm_prefill(params, jcfg, jnp.asarray(toks, jnp.int32),
                               CACHE_LEN)[1]
    t = CACHE_LEN // bs
    mapped = [t, -(-21 // bs), t]
    n_blocks = sum(mapped) + 1
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((3, t), np.int32)
    pool = {}
    for name in ("k", "v"):
        c = np.asarray(jcache[name])                    # (L,B,KH,C,dh)
        p = np.zeros((c.shape[0], n_blocks, c.shape[2], bs, c.shape[4]),
                     np.float32)
        pool[name] = p
    for i in range(3):
        for j in range(mapped[i]):
            tables[i, j] = next(ids)
            for name in ("k", "v"):
                pool[name][:, tables[i, j]] = np.asarray(
                    jcache[name])[:, i, :, j * bs:(j + 1) * bs]
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    lengths = np.array([40, 17, 62], np.int32)

    def jattn(q, kp, vp, tb, n):
        return jax_ops.paged_decode_attention(q, kp, vp, tb, n,
                                              interpret=True)
    jdecode = jax.jit(lambda p, pl, tb, tk, ln: jax_lm.lm_decode_paged(
        p, jcfg, pl, tb, tk, ln, attn_impl=jattn if hook else None))
    kw = {"attn_impl": ops.paged_decode_attention} if hook else {}
    for step in range(4):
        tk = rng.integers(0, cfg.vocab - 2, (3, 1))
        want, jpool = jdecode(params, jpool, jnp.asarray(tables),
                              jnp.asarray(tk, jnp.int32),
                              jnp.asarray(lengths))
        got, tpool = lm.lm_decode_paged(model, cfg, tpool,
                                        torch.from_numpy(tables),
                                        torch.from_numpy(tk),
                                        torch.from_numpy(lengths), **kw)
        _close(got.numpy(), want, f"logits, step {step}")
        for name in ("k", "v"):
            _close(tpool[name].numpy(), jpool[name], f"{name} pool")
        lengths += 1


# ---------------------------------------------------------------------------
# the paged engine, against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab - 2, n).astype(np.int32)
            for n, _ in WORKLOAD]


def _submit(eng, req_cls, vocab):
    for uid, (toks, (_, new)) in enumerate(zip(_prompts(vocab), WORKLOAD)):
        eng.submit(req_cls(uid=uid, tokens=toks, max_new_tokens=new))


def _outputs(results):
    return {uid: r.output for uid, r in results.items()}


@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
@pytest.mark.parametrize("arch,bs,n_blocks", ENGINE_CASES)
def test_paged_engine_tokens_match_jax(models, arch, bs, n_blocks, tags):
    """The paged engine's greedy tokens equal the JAX paged engine's
    (its ``("pallas", "reference")`` chain runs the Pallas K4 in
    interpret mode), every block comes back, and the pool's bytes are
    the JAX engine's arena accounting to the byte."""
    jcfg, params, cfg, model = models[arch]
    jeng = JaxServingEngine(jax_get_model(jcfg), params, max_slots=SLOTS,
                            cache_len=CACHE_LEN, tags=TAG_CHAINS[tags],
                            kv_block=bs, kv_pool_blocks=n_blocks)
    _submit(jeng, JaxRequest, cfg.vocab)
    want = _outputs(jeng.run())
    eng = ServingEngine(get_model(cfg), model, max_slots=SLOTS,
                        cache_len=CACHE_LEN, tags=tags, kv_block=bs,
                        kv_pool_blocks=n_blocks, device="cpu")
    assert eng.resolver.resolve(OpCode.SERVING_DECODE_PAGED).tag == tags[0]
    _submit(eng, Request, cfg.vocab)
    got = eng.run()
    assert _outputs(got) == want
    assert all(r.done for r in got.values())
    assert eng.pool.free_blocks() == eng.pool.usable_blocks
    assert eng.pool.alloc_count == jeng.pool.alloc_count
    assert (eng.kv_bytes, eng.arena.usage().persistent) \
        == (jeng.kv_bytes, jeng.arena.usage().persistent)


# ---------------------------------------------------------------------------
# the port's own identities
# ---------------------------------------------------------------------------

def _engine(models, arch, **kw):
    _, _, cfg, model = models[arch]
    kw.setdefault("max_slots", SLOTS)
    return ServingEngine(get_model(cfg), model, cache_len=CACHE_LEN,
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def contiguous_tokens(models):
    eng = _engine(models, "qwen3-32b")
    _submit(eng, Request, eng.cfg.vocab)
    return _outputs(eng.run())


@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_paged_equals_contiguous(models, contiguous_tokens, bs):
    eng = _engine(models, "qwen3-32b", kv_block=bs)
    ptrs = [t.data_ptr() for t in (*eng.kv_pool.values(), eng.block_tables,
                                   eng.lengths)]
    _submit(eng, Request, eng.cfg.vocab)
    while eng.step():
        assert [t.data_ptr() for t in (*eng.kv_pool.values(),
                                       eng.block_tables,
                                       eng.lengths)] == ptrs
    assert _outputs(eng.results) == contiguous_tokens
    assert eng.pool.free_blocks() == eng.pool.usable_blocks
    assert not eng.block_tables.any()


@pytest.mark.parametrize("kv", [(8, 12), (16, 7)], ids=["bs8", "bs16"])
def test_smaller_pool_gates_admission(models, contiguous_tokens, kv):
    """A pool that holds one full-length slot but not two: admission
    waits for blocks while slots are free, and the tokens stay the
    unconstrained run's."""
    eng = _engine(models, "qwen3-32b", kv_block=kv[0], kv_pool_blocks=kv[1])
    _submit(eng, Request, eng.cfg.vocab)
    gated = 0
    while eng.step():
        gated += bool(eng.queue) and not eng.active.all() and not \
            eng._paged_admissible(eng.queue[eng.policy.select(eng.queue)])
        assert eng.pool.free_blocks() >= 0
    assert gated
    assert _outputs(eng.results) == contiguous_tokens
    assert eng.pool.free_blocks() == eng.pool.usable_blocks


def test_paged_checkpoint_carries_blocks_and_they_stay_untouched(models):
    """Preempt a paged request mid-decode: its checkpoint pins block ids
    (no KV), the rows of those blocks are untouched while other slots
    decode, admit, retire and ring-write through the garbage block, and
    restoring into a DIFFERENT slot continues with the uninterrupted
    tokens."""
    rng = np.random.default_rng(13)
    vocab = get_config("qwen3-32b", reduced=True).vocab
    toks = rng.integers(0, vocab - 2, 9).astype(np.int32)
    filler = [rng.integers(0, vocab - 2, n).astype(np.int32)
              for n in (7, 20, 3)]
    solo = _engine(models, "qwen3-32b", max_slots=2, kv_block=16)
    solo.submit(Request(uid=0, tokens=toks, max_new_tokens=12))
    want = solo.run()[0].output

    eng = _engine(models, "qwen3-32b", max_slots=2, kv_block=16)
    eng.submit(Request(uid=0, tokens=toks, max_new_tokens=12))
    for _ in range(3):
        eng.step()
    assert eng.active[0] and eng.results[0].output
    ckpt = eng.snapshot_slot(0)
    assert ckpt.phase == "decode" and ckpt.cache is None
    assert ckpt.blocks and PagedKVPool.GARBAGE_BLOCK not in ckpt.blocks
    req0 = eng._evict(0)
    assert not eng.block_tables[0].any()
    pinned = {n: p[:, ckpt.blocks].clone() for n, p in eng.kv_pool.items()}
    for uid, f in enumerate(filler, start=1):
        eng.submit(Request(uid=uid, tokens=f, max_new_tokens=6))
    eng.queue.remove(req0)
    for _ in range(4):
        eng.step()
    assert eng.active[0] and eng.slot_req[0].uid == 1
    for n, p in eng.kv_pool.items():
        assert torch.equal(p[:, ckpt.blocks], pinned[n])
    while eng.active[1]:
        eng.step()
    eng._admit(req0, 1)
    assert eng._slot_blocks[1] == ckpt.blocks
    res = eng.run()
    assert res[0].output == want and res[0].preemptions == 1
    assert eng.pool.free_blocks() == eng.pool.usable_blocks


@pytest.mark.parametrize("tags", list(TAG_CHAINS), ids=["cuda", "reference"])
def test_paged_edf_preempt_restore_tokens(models, contiguous_tokens, tags):
    """A tight deadline displaces a decoding request on a paged engine;
    every request emits its uninterrupted tokens."""
    eng = _engine(models, "qwen3-32b", kv_block=16, tags=tags,
                  policy="edf", preempt="edf-displace", clock=lambda: 0)
    prompts = _prompts(eng.cfg.vocab)
    urgent = 6
    for uid, (toks, (_, new)) in enumerate(zip(prompts, WORKLOAD)):
        if uid != urgent:
            eng.submit(Request(uid=uid, tokens=toks, max_new_tokens=new))
    for _ in range(3):
        eng.step()
    eng.submit(Request(uid=urgent, tokens=prompts[urgent],
                       max_new_tokens=WORKLOAD[urgent][1], deadline_us=100))
    eng.step()
    assert sum(r.preemptions for r in eng.results.values()) == 1
    assert _outputs(eng.run()) == contiguous_tokens
    assert eng.pool.free_blocks() == eng.pool.usable_blocks


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,tags,error", [
    ({"kv_block": 24}, ("reference",), "divide cache_len"),
    ({"kv_block": 24, "cache_len": 48}, ("cuda", "reference"),
     "block size 24"),
    ({"kv_block": 8, "kv_pool_blocks": 1}, ("reference",), "garbage"),
], ids=["not-dividing", "kernel-block-size", "pool-too-small"])
def test_paged_guards(models, kw, tags, error):
    kw = {"cache_len": CACHE_LEN, **kw}
    _, _, cfg, model = models["yi-6b"]
    with pytest.raises(ValueError, match=error):
        ServingEngine(get_model(cfg), model, max_slots=1, tags=tags,
                      device="cpu", **kw)


def test_reference_chain_takes_any_dividing_block_size(models):
    """Only the kernel is bound to its block sizes: the reference chain
    serves kv_block 24 (dividing cache_len 48) like the JAX engine."""
    _, _, cfg, model = models["yi-6b"]
    eng = ServingEngine(get_model(cfg), model, max_slots=2, cache_len=48,
                        kv_block=24, tags=("reference",), device="cpu")
    eng.submit(Request(uid=0, tokens=np.arange(1, 30, dtype=np.int32),
                       max_new_tokens=4))
    assert len(eng.run()[0].output) == 4
