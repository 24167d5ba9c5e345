"""The compile-once contract of the port on the CPU.

On the card every program of the port (``CompiledPlan.execute``, the
engine's decode step, chunk step and prefill) runs as one CUDA graph per
signature; on the CPU the same ``CapturedProgram`` records its
signatures and runs eagerly, so the counts are testable here:

  * the port engine's ``capture_count(eng._decode)``, ``prefill_compiles()``
    and ``chunk_compiles()`` equal the JAX engine's ``jit_cache_size``,
    ``prefill_compiles()`` and ``chunk_compiles()`` on the same seeded
    request stream (dense with a ``BucketTable``, paged with
    ``prefill_chunk=``, Mamba2 with ``prefill_chunk=``), through an EDF
    admit → evict → restore cycle that leaves every count unchanged;
  * a CPU stand-in for capture: each step function is traced with
    ``make_fx`` at one set of input values and the traced graph run at a
    second set (another start, true token count, table row, lengths)
    equals the eager step there exactly, so no host int or data-dependent
    branch is frozen into a program;
  * an engine without buckets holds at most ``PREFILL_PROGRAMS``
    prefill programs, and a step that returns a new cache instead of
    updating the bound one raises;
  * the micro interpreter holds one program per model, and an arena
    rebinding by a second tenant drops the first tenant's program.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.fx.experimental.proxy_tensor import make_fx

from repro.configs import get_config as jax_get_config
from repro.core.executor import BucketTable as JaxBucketTable
from repro.core.executor import jit_cache_size
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine

import repro_torch.apps.models as torch_apps
from repro_torch.configs import get_config
from repro_torch.core import (AllOpsResolver, ArenaPool, MicroInterpreter,
                              MicroModel, capture_count, disable_capture,
                              export)
from repro_torch.core.executor import BucketTable
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import PREFILL_PROGRAMS

SLOTS, CACHE_LEN, CHUNK, BLOCK = 3, 64, 8, 8
# case -> (arch, engine options; bucket tables are added per package),
# the background prompt lengths (one a slot, all decoding before the
# urgent request arrives) and the urgent prompt's: every urgent prompt
# reuses a program the background already made (a hit bucket, or the
# chunk step), so the evict → restore cycle adds none
CASES = {
    "dense-bucketed": ("yi-6b", {"buckets": True}, (12, 14, 30), 10),
    "paged-chunked": ("yi-6b", {"kv_block": BLOCK, "prefill_chunk": CHUNK},
                      (5, 30, 21), 20),
    "mamba2-chunked": ("mamba2-780m", {"prefill_chunk": CHUNK},
                       (21, 13, 9), 25),
}
N_NEW = 12
URGENT = 99


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
    """Alias ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace`` in
    newer jax) for this module's JAX engines only, and drop the Pallas
    kernel's jit cache afterwards so no program traced under the alias
    outlives the module."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX bundle, JAX params, port bundle, port model on the
    JAX weights)."""
    out = {}
    for arch in ("yi-6b", "mamba2-780m"):
        jbundle = jax_get_model(jax_get_config(arch, reduced=True))
        params = jbundle.init(jax.random.PRNGKey(0))
        cfg = get_config(arch, reduced=True)
        out[arch] = (jbundle, params, get_model(cfg),
                     params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu"))
    return out


def _serve_with_displacement(eng, req_cls, vocab, lens, urgent_len):
    """The background requests, stepped until each has emitted a token,
    then a tight-deadline request that displaces a running one under
    EDF.  Returns (counts just before the urgent request, tokens by uid,
    preemptions by uid)."""
    rng = np.random.default_rng(3)
    for uid, n in enumerate(lens):
        eng.submit(req_cls(uid=uid, tokens=rng.integers(
            0, vocab - 2, n).astype(np.int32), max_new_tokens=N_NEW))
    while not all(eng.results[u].output for u in range(len(lens))):
        eng.step()
    assert eng.active.all()
    before = _counts(eng)
    eng.submit(req_cls(uid=URGENT, tokens=rng.integers(
        0, vocab - 2, urgent_len).astype(np.int32), max_new_tokens=N_NEW,
        deadline_us=100))
    res = eng.run()
    return (before, {u: r.output for u, r in res.items()},
            {u: r.preemptions for u, r in res.items()})


def _counts(eng):
    decode = (jit_cache_size(eng._decode) if isinstance(eng, JaxServingEngine)
              else capture_count(eng._decode))
    return decode, eng.prefill_compiles(), eng.chunk_compiles()


@pytest.mark.parametrize("case", list(CASES))
def test_program_counts_equal_the_jax_engines(models, case):
    """Decode 1, the chunk step 1 where chunking is on, prefill one per
    bucket (or prompt length) hit — the same counts as the JAX engine's
    on the same stream, before the displacement and after the evicted
    request was restored, and unchanged by the cycle; tokens equal."""
    arch, opts, lens, urgent_len = CASES[case]
    jbundle, params, bundle, model = models[arch]
    opts = dict(opts)
    buckets = opts.pop("buckets", False)
    common = dict(max_slots=SLOTS, cache_len=CACHE_LEN, policy="edf",
                  preempt="edf-displace", clock=lambda: 0, **opts)
    jeng = JaxServingEngine(
        jbundle, params, tags=("pallas", "reference"),
        prefill_buckets=(JaxBucketTable(min_bucket=8, max_bucket=CACHE_LEN)
                         if buckets else None), **common)
    eng = ServingEngine(
        bundle, model, tags=("cuda", "reference"), device="cpu",
        prefill_buckets=(BucketTable(min_bucket=8, max_bucket=CACHE_LEN)
                         if buckets else None), **common)
    vocab = bundle.cfg.vocab
    jbefore, jtoks, jpre = _serve_with_displacement(jeng, JaxRequest, vocab,
                                                    lens, urgent_len)
    before, toks, pre = _serve_with_displacement(eng, Request, vocab, lens,
                                                 urgent_len)
    assert toks == jtoks
    assert pre == jpre and sum(pre.values()) >= 1 and not pre[URGENT]
    assert before == jbefore
    assert _counts(eng) == _counts(jeng) == before
    decode, prefill, chunk = before
    assert decode == 1
    assert chunk == (1 if "prefill_chunk" in opts else 0)
    if buckets:
        hit = {eng.bucket_table.fit(n - 1) for n in lens}
        assert prefill == len(hit) < len(lens)


def test_disable_capture_records_no_signature(models):
    """Inside ``disable_capture()`` the programs run eagerly and record
    nothing; the engine's tokens are the same either way."""
    _, _, bundle, model = models["yi-6b"]
    runs = []
    for eager in (True, False):
        eng = ServingEngine(bundle, model, max_slots=SLOTS,
                            cache_len=CACHE_LEN, device="cpu",
                            prefill_chunk=CHUNK)
        rng = np.random.default_rng(4)
        for uid, n in enumerate((3, 20, 11)):
            eng.submit(Request(uid=uid, tokens=rng.integers(
                0, bundle.cfg.vocab - 2, n).astype(np.int32),
                max_new_tokens=N_NEW))
        if eager:
            with disable_capture():
                res = eng.run()
            assert _counts(eng) == (0, 0, 0)
        else:
            res = eng.run()
            # the short prompt's bucket is the first chunk's length
            assert _counts(eng) == (1, 1, 1)
        runs.append({u: r.output for u, r in res.items()})
    assert runs[0] == runs[1]


def test_prefill_programs_are_bounded_without_buckets(models):
    """An engine without buckets (Mamba2) makes one prefill program a
    prompt length, as ``jax.jit`` does, but holds at most
    ``PREFILL_PROGRAMS``: past it the least recently used one is dropped,
    and made again when its length returns."""
    eng = _engine(models, "mamba2-780m")
    rng = np.random.default_rng(6)
    vocab = eng.cfg.vocab

    def serve(n, uid):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, vocab - 2, n).astype(np.int32), max_new_tokens=2))
        eng.run()

    lengths = range(2, 2 + PREFILL_PROGRAMS + 4)
    for n in lengths:
        serve(n, n)
    assert _counts(eng) == (1, PREFILL_PROGRAMS, 0)
    assert eng._prefill.evictions == 4
    serve(2, 1000)                  # the first length was dropped: again
    assert _counts(eng) == (1, PREFILL_PROGRAMS, 0)
    assert eng._prefill.evictions == 5
    serve(lengths[-1], 1001)        # still held: no new program
    assert eng._prefill.evictions == 5
    assert all(r.done for r in eng.results.values())


@pytest.mark.parametrize("program", ["decode", "chunk"])
def test_a_step_that_returns_a_new_cache_raises(models, program):
    """The programs are bound to the cache's addresses: a decode or chunk
    step that returned a new cache instead of updating the bound one in
    place would lose its update, and the engine raises."""
    eng = _engine(models, "yi-6b", prefill_chunk=CHUNK)
    prog = eng.programs()[program]
    step = prog.fn

    def returns_a_copy(args):
        out = step(args)
        if isinstance(out, tuple):
            return out[0], _clone(out[1])
        return _clone(out)

    prog.fn = returns_a_copy
    eng.submit(Request(uid=0, tokens=np.arange(1, 21, dtype=np.int32),
                       max_new_tokens=4))
    with pytest.raises(RuntimeError, match="in place"):
        eng.run()


# ---------------------------------------------------------------------------
# the CPU stand-in for capture: trace at one set of values, run at another
# ---------------------------------------------------------------------------

def _fill(tensors, seed):
    """Seeded values in place (integer tensors keep theirs)."""
    g = torch.Generator().manual_seed(seed)
    for t in tensors:
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return tensors


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _traced_equals_eager(fn, first, second):
    """Trace ``fn`` at the inputs ``first``, run the trace at ``second``
    and ``fn`` eagerly at a copy of ``second``: outputs and every input
    the step writes in place are equal exactly."""
    with torch.no_grad():
        gm = make_fx(fn)(*_clone(first))
        want_in = _clone(second)
        want = fn(*want_in)
        got = gm(*second)
    for g, w in zip(_leaves(got) + _leaves(second),
                    _leaves(want) + _leaves(want_in)):
        assert torch.equal(g, w)


def _engine(models, arch, **kw):
    _, _, bundle, model = models[arch]
    return ServingEngine(bundle, model, max_slots=SLOTS, cache_len=CACHE_LEN,
                         device="cpu", **kw)


def _tokens(vocab, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab - 2, shape, generator=g)


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def test_traced_dense_chunk_step_runs_at_another_start(models):
    eng = _engine(models, "yi-6b", prefill_chunk=CHUNK)
    cfg = eng.cfg

    def step(cache, tokens, start):
        return eng._prefill_chunk.fn((eng.params, cache, tokens, start))

    def inputs(seed, start):
        cache = _fill(list(eng._empty_cache(1, CACHE_LEN).values()), seed)
        return ({"k": cache[0], "v": cache[1]},
                _tokens(cfg.vocab, (1, CHUNK), seed), _i32(start))
    _traced_equals_eager(step, inputs(1, 8), inputs(2, 40))


def test_traced_paged_chunk_step_runs_at_another_row(models):
    eng = _engine(models, "yi-6b", kv_block=BLOCK, prefill_chunk=CHUNK)
    cfg = eng.cfg
    n_table = CACHE_LEN // BLOCK

    def step(pool, row, tokens, start):
        return eng._prefill_chunk.fn((eng.params, pool, row, tokens, start))

    def inputs(seed, start):
        pool = {n: t.clone() for n, t in eng.kv_pool.items()}
        _fill(pool.values(), seed)
        rng = np.random.default_rng(seed)
        row = np.zeros(n_table, np.int32)
        row[:4] = rng.permutation(np.arange(1, eng.pool.n_blocks))[:4]
        return (pool, torch.from_numpy(row),
                _tokens(cfg.vocab, (1, CHUNK), seed), _i32(start))
    _traced_equals_eager(step, inputs(1, 0), inputs(2, 24))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_traced_recurrent_chunk_step_runs_at_another_count(models, arch):
    if arch not in models:
        cfg = get_config(arch, reduced=True)
        bundle = get_model(cfg)
        model = bundle.init(torch.Generator().manual_seed(0))
        models = {arch: (None, None, bundle, model)}
    eng = _engine(models, arch, prefill_chunk=CHUNK)
    cfg = eng.cfg

    def step(cache, tokens, start, n_real):
        return eng._prefill_chunk.fn((eng.params, cache, tokens, start,
                                      n_real))

    def inputs(seed, start, n_real):
        cache = eng._empty_cache(1, CACHE_LEN)
        _fill(cache.values(), seed)
        return (cache, _tokens(cfg.vocab, (1, CHUNK), seed), _i32(start),
                _i32(n_real))
    _traced_equals_eager(step, inputs(1, 0, CHUNK), inputs(2, 16, 5))


DECODE_CASES = {
    "dense": ("yi-6b", {}),
    "dense-paged": ("yi-6b", {"kv_block": BLOCK}),
    "dense-int8": ("yi-6b", {"weight_dtype": "int8", "kv_dtype": "int8"}),
    "ssm": ("mamba2-780m", {}),
    "hybrid": ("zamba2-1.2b", {}),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_traced_decode_step_runs_at_other_lengths(models, case):
    arch, kw = DECODE_CASES[case]
    if arch not in models:
        cfg = get_config(arch, reduced=True)
        bundle = get_model(cfg)
        models = {arch: (None, None, bundle, bundle.init(
            torch.Generator().manual_seed(0)))}
    eng = _engine(models, arch, **kw)
    cfg = eng.cfg

    def step(*state):
        return eng._decode.fn((eng.params, *state))

    def inputs(seed, lengths):
        lengths = torch.tensor(lengths, dtype=torch.int32)
        tokens = _tokens(cfg.vocab, (SLOTS, 1), seed)
        if eng.paged:
            pool = {n: t.clone() for n, t in eng.kv_pool.items()}
            _fill(pool.values(), seed)
            rng = np.random.default_rng(seed)
            tables = torch.from_numpy(rng.permutation(np.arange(
                1, eng.pool.n_blocks))[:SLOTS * eng.n_table].reshape(
                    SLOTS, eng.n_table).astype(np.int32))
            return pool, tables, tokens, lengths
        cache = {n: t.clone() for n, t in eng.cache.items()}
        _fill(cache.values(), seed)
        return cache, tokens, lengths
    _traced_equals_eager(step, inputs(1, [3, 17, 0]), inputs(2, [40, 9, 63]))


@pytest.mark.parametrize("build", ["build_fc_stack"])
def test_traced_invoke_runs_at_another_input(build):
    """``CompiledPlan``'s program for fc_stack int8, traced at one input
    and run at another, equals the eager invoke there."""
    gb = getattr(torch_apps, build)()
    model = MicroModel(export(gb, torch_apps.representative_dataset(gb),
                              quantize_int8=True))
    resolver = AllOpsResolver(tags=("cuda", "reference"))
    it = MicroInterpreter(model, resolver,
                          MicroInterpreter.required_arena_size(model,
                                                               resolver),
                          device="cpu")
    spec = it.input_spec(0)
    rng = np.random.default_rng(0)
    plan, buf = it.compiled, it.shared.take()

    def run(buf, variables, inputs):
        return plan._run(buf, variables, inputs)

    def inputs():
        x = torch.from_numpy(rng.integers(-128, 128, spec.shape).astype(
            np.int8))
        return torch.zeros_like(buf), [], [x]
    _traced_equals_eager(run, inputs(), inputs())


# ---------------------------------------------------------------------------
# the micro interpreter's program
# ---------------------------------------------------------------------------

def test_invoke_is_one_program_and_rebinding_drops_it():
    """Any number of invokes is one program; when a second tenant grows
    the shared arena pool, the first tenant's next invoke drops the
    program bound to the old buffer and makes one on the new buffer (on
    the card: captures again), with the same outputs."""
    resolver = AllOpsResolver()
    small = MicroModel(export(torch_apps.build_conv_reference()))
    large = MicroModel(export(torch_apps.build_vww(resolution=32)))
    pool = ArenaPool("cpu")
    a = MicroInterpreter(small, resolver,
                         MicroInterpreter.required_arena_size(small,
                                                              resolver),
                         shared=pool, device="cpu")
    x = np.random.default_rng(1).normal(0, 1, a.input_spec(0).shape
                                        ).astype(np.float32)
    outs = []
    for _ in range(3):
        a.set_input(0, x)
        a.invoke()
        outs.append(a.output(0))
    assert capture_count(a.compiled.program) == 1
    old = pool.buf
    b = MicroInterpreter(large, resolver,
                         MicroInterpreter.required_arena_size(large,
                                                              resolver),
                         shared=pool, device="cpu")
    b.set_input(0, np.zeros(b.input_spec(0).shape, np.float32))
    b.invoke()
    assert pool.buf is not old and pool.alloc_count == 2
    a.set_input(0, x)
    a.invoke()
    assert capture_count(a.compiled.program) == 1
    assert capture_count(b.compiled.program) == 1
    np.testing.assert_array_equal(a.output(0), outs[0])
