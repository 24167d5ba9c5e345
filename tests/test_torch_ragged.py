"""Batched and ragged micro dispatch: the port's ``InterpreterPool`` and
``RaggedInterpreterPool`` on the CPU against the JAX package's, on the
same exported blobs and the same seeded requests — the counterparts of
tests/test_executor.py's batched-invoke and arena-pool cases and
tests/test_ragged.py's lane-table cases, plus the capture counts held
equal to the JAX programs' ``jit_cache_size``.

Bars: int8 lanes bit-identical to the JAX pool's and to the port's own
single invokes (``exact=False`` included: the integer products are exact
in float64); ``exact=True`` float lanes bit-identical to the port's
single invokes and within FLOAT_TOL of the JAX pool's; ``exact=False``
float lanes within VMAP_TOL of the port's single invokes."""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.apps.models as jax_apps
import repro.core as jax_core
from repro.core.executor import jit_cache_size

import repro_torch.core as torch_core
import repro_torch.kernels  # noqa: F401  (registers the "cuda" tag)
from repro_torch.core import (AllOpsResolver, ArenaPool, InterpreterPool,
                              LaneCheckpoint, MicroInterpreter, MicroModel,
                              RaggedInterpreterPool, SharedArenaState,
                              capture_count)
from repro_torch.core.executor import (AllocationPlan, CompiledPlan,
                                       required_arena_size)

# float32 sums of one model in the two frameworks' orders
FLOAT_TOL = 1e-5
# one op over lane-stacked tensors against one lane at a time: the
# reference's bound for jax.vmap (tests/test_executor.py)
VMAP_TOL = 1e-6
# the port's tag chains: "cuda" runs the kernels' plain versions on the
# CPU through their lane rules (FC lanes folded into K1's rows)
TAGS = [("reference",), ("cuda", "reference")]
TAG_IDS = ["reference", "cuda"]
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_alias():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``
    in newer jax) for this module's tests only; the JAX pools' int8
    requant runs under it."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        yield


def _blob(name, int8, **kw):
    gb = getattr(jax_apps, name)(**kw)
    if not int8:
        return jax_core.export(gb)
    return jax_core.export(gb, jax_apps.representative_dataset(gb),
                           quantize_int8=True)


@pytest.fixture(scope="module")
def blobs():
    return {"conv": _blob("build_conv_reference", False),
            "conv_int8": _blob("build_conv_reference", True),
            "fc_int8": _blob("build_fc_stack", True),
            "hotword": _blob("build_hotword", False, n_layers=1)}


def _frames(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


def _alone(blob, frames, tags=("reference",)):
    """Each frame in turn through one fresh port MicroInterpreter — the
    bit-identity reference (fresh variable state)."""
    model = MicroModel(blob)
    res = AllOpsResolver(tags=tags)
    it = MicroInterpreter(model, res, MicroInterpreter.required_arena_size(
        model, res), device="cpu")
    outs = []
    for f in frames:
        it.set_input(0, f)
        it.invoke()
        outs.append(it.output(0).copy())
    return outs


def _jax_pool(blob, batch, exact):
    return jax_core.InterpreterPool(jax_core.MicroModel(blob),
                                    jax_core.AllOpsResolver(), batch=batch,
                                    exact=exact)


def _torch_pool(blob, batch, exact, tags=("reference",), **kw):
    return InterpreterPool(MicroModel(blob), AllOpsResolver(tags=tags),
                           batch=batch, exact=exact, **CPU, **kw)


def _invoke(pool, xs):
    for lane, x in enumerate(xs):
        pool.set_input(lane, 0, x)
    pool.invoke()
    return [np.array(pool.output(lane, 0)) for lane in range(len(xs))]


# ---------------------------------------------------------------------------
# InterpreterPool: batched invoke (tests/test_executor.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tags", TAGS, ids=TAG_IDS)
def test_batched_float_exact_bit_identical(blobs, tags):
    """exact lowering: one batched program is bit-identical to N
    sequential single invokes, float model; within FLOAT_TOL of the JAX
    pool's lanes."""
    xs = _frames((1, 16, 16, 1), 4, seed=0)
    want = [_alone(blobs["conv"], [x], tags)[0] for x in xs]
    got = _invoke(_torch_pool(blobs["conv"], 4, True, tags), xs)
    jax_got = _invoke(_jax_pool(blobs["conv"], 4, True), xs)
    for g, w, j in zip(got, want, jax_got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, j, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.parametrize("exact", [False, True], ids=["vmap", "exact"])
@pytest.mark.parametrize("tags", TAGS, ids=TAG_IDS)
def test_batched_int8_bit_identical(blobs, tags, exact):
    """int8 is integer-exact, so both lowerings give every lane the
    single invoke's bits; under the reference tags also the JAX pool's."""
    xs = _frames((1, 16, 16, 1), 4, seed=7)
    got = _invoke(_torch_pool(blobs["conv_int8"], 4, exact, tags), xs)
    want = [_alone(blobs["conv_int8"], [x], tags)[0] for x in xs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if tags == ("reference",):
        jax_got = _invoke(_jax_pool(blobs["conv_int8"], 4, exact), xs)
        for g, j in zip(got, jax_got):
            np.testing.assert_array_equal(g, j)


def test_batched_float_vmap_close(blobs):
    """The throughput lowering on float: each op runs once over the
    stacked lanes, so sums may be taken in another order — close to the
    single invokes, far below what lane cross-talk would show."""
    xs = _frames((1, 16, 16, 1), 4, seed=3)
    want = [_alone(blobs["conv"], [x])[0] for x in xs]
    got = _invoke(_torch_pool(blobs["conv"], 4, False), xs)
    jax_got = _invoke(_jax_pool(blobs["conv"], 4, False), xs)
    for g, w, j in zip(got, want, jax_got):
        np.testing.assert_allclose(g, w, atol=VMAP_TOL, rtol=VMAP_TOL)
        np.testing.assert_allclose(g, j, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "vmap"])
def test_batched_variable_state_per_lane(blobs, exact):
    """SVDF state is per lane: each lane evolves exactly like its own
    interpreter over two streaming steps (exact), or within VMAP_TOL."""
    xs = _frames((1, 40), 3, seed=11)
    want = [_alone(blobs["hotword"], [x, x])[1] for x in xs]
    pool = _torch_pool(blobs["hotword"], 3, exact)
    jpool = _jax_pool(blobs["hotword"], 3, exact)
    for _ in range(2):
        got = _invoke(pool, xs)
        jax_got = _invoke(jpool, xs)
    for g, w, j in zip(got, want, jax_got):
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=VMAP_TOL, rtol=VMAP_TOL)
        np.testing.assert_allclose(g, j, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    pool.reset_variable_tensors()
    again = _invoke(pool, xs)
    for g, x in zip(again, xs):
        np.testing.assert_allclose(g, _alone(blobs["hotword"], [x])[0],
                                   atol=VMAP_TOL, rtol=VMAP_TOL)


def test_pool_partial_inputs_raise(blobs):
    """A lane with SOME but not all inputs fails loudly; a lane with none
    is idle (zeros)."""
    pool = _torch_pool(blobs["conv"], 2, False)
    pool.set_input(0, 0, np.zeros((1, 16, 16, 1), np.float32))
    pool.invoke()                   # lane 1 idle: allowed
    pool.clear_inputs()
    assert pool._inputs == [{}, {}]
    with pytest.raises(ValueError):
        pool.set_input(0, 0, np.zeros((1, 3), np.float32))


def test_pool_programs_counted_like_jit_cache(blobs):
    """One program per (batch, exact), however many invokes: the capture
    count equals the JAX program's jit_cache_size."""
    xs = _frames((1, 16, 16, 1), 2, seed=4)
    pool = _torch_pool(blobs["conv"], 2, False)
    jpool = _jax_pool(blobs["conv"], 2, False)
    for _ in range(3):
        _invoke(pool, xs)
        _invoke(jpool, xs)
    assert capture_count(pool.program) == jit_cache_size(
        jpool.compiled.batched(2, False)) == 1
    assert list(pool.compiled._batched) == [(2, False)]


# ---------------------------------------------------------------------------
# arena pooling: the malloc-free steady state
# ---------------------------------------------------------------------------

def test_arena_pool_no_alloc_after_warmup(blobs):
    pool = _torch_pool(blobs["conv"], 4, False)
    x = np.zeros((1, 16, 16, 1), np.float32)
    _invoke(pool, [x] * 4)                          # warm-up
    allocs = pool.pool.alloc_count
    [stored] = pool.pool._batched[4]                # free list: one buffer
    ptr = stored.data_ptr()
    for _ in range(3):
        pool.invoke()
        [again] = pool.pool._batched[4]
        # the same device memory comes back every dispatch
        assert again.data_ptr() == ptr
    assert pool.pool.alloc_count == allocs
    assert capture_count(pool.program) == 1


def test_arena_pool_shared_across_batched_tenants(blobs):
    """One ArenaPool backs several batched tenants (non-concurrent), like
    the §4.5 shared arena."""
    shared = ArenaPool(**CPU)
    p1 = _torch_pool(blobs["conv"], 2, False, pool=shared)
    p2 = _torch_pool(blobs["conv"], 2, False, pool=shared)
    xs = _frames((1, 16, 16, 1), 2, seed=5)
    want = [_alone(blobs["conv"], [x])[0] for x in xs]
    got1, got2 = _invoke(p1, xs), _invoke(p2, xs)
    for g1, g2, w in zip(got1, got2, want):
        np.testing.assert_allclose(g1, w, atol=VMAP_TOL, rtol=VMAP_TOL)
        np.testing.assert_array_equal(g1, g2)
    assert shared.alloc_count == 1


def test_shared_arena_state_is_arena_pool():
    """Back-compat: SharedArenaState keeps the §4.5 take/put contract."""
    s = SharedArenaState(**CPU)
    assert isinstance(s, ArenaPool)
    s.ensure(128)
    buf = s.take()
    assert buf.shape == (128,)
    s.put(buf)


def test_arena_pool_double_buffer_free_list():
    pool = ArenaPool(depth=2, **CPU)
    pool.ensure(256)
    a = pool.take_batch(4)
    b = pool.take_batch(4)              # second in-flight buffer
    assert pool.alloc_count == 2
    pool.put_batch(a)
    pool.put_batch(b)
    # steady state: the same two physical buffers cycle, no new allocs
    for _ in range(3):
        x = pool.take_batch(4)
        y = pool.take_batch(4)
        pool.put_batch(x)
        pool.put_batch(y)
    assert pool.alloc_count == 2
    # the free list never holds more than `depth` buffers
    pool.put_batch(pool._alloc((4, pool.nbytes)))
    assert len(pool._batched[4]) == 2


# ---------------------------------------------------------------------------
# the extracted phases compose like the facade
# ---------------------------------------------------------------------------

def test_allocation_plan_and_compiled_plan_power_the_facade(blobs):
    model = MicroModel(blobs["conv"])
    res = AllOpsResolver()
    arena = torch_core.TwoStackArena(required_arena_size(model, res))
    alloc = AllocationPlan.build(model, res, arena, device="cpu")
    assert arena.frozen and alloc.plan.total_bytes > 0
    assert alloc.nonpersistent_nbytes == alloc.plan.total_bytes
    with pytest.raises(RuntimeError):
        arena.allocate_persistent(16)
    it = MicroInterpreter(model, res, required_arena_size(model, res),
                          device="cpu")
    assert isinstance(it.compiled, CompiledPlan)
    assert it.compiled.alloc is it.alloc


# ---------------------------------------------------------------------------
# RaggedInterpreterPool (tests/test_ragged.py)
# ---------------------------------------------------------------------------

def _ragged(jax_side=False):
    if jax_side:
        return jax_core.RaggedInterpreterPool()
    return RaggedInterpreterPool(**CPU)


def _add(pool, name, blob, lanes, exact=False, jax_side=False,
         tags=("reference",)):
    core = jax_core if jax_side else torch_core
    res = core.AllOpsResolver() if jax_side else AllOpsResolver(tags=tags)
    pool.add_bucket(name, core.MicroModel(blob), res, lanes=lanes,
                    exact=exact)


@pytest.mark.parametrize("tags", TAGS, ids=TAG_IDS)
def test_retire_midflight_bit_identity_int8(blobs, tags):
    """Lanes retired mid-flight: the remaining lanes' outputs stay
    bit-identical to each request alone, and to the JAX pool's lanes run
    through the same admissions and retirements."""
    xs = _frames((1, 16, 16, 1), 6, seed=0)
    want = [_alone(blobs["conv_int8"], [x], tags)[0] for x in xs]
    runs = []
    for jax_side in ((False, True) if tags == ("reference",) else (False,)):
        pool = _ragged(jax_side)
        _add(pool, "conv", blobs["conv_int8"], 4, jax_side=jax_side,
             tags=tags)
        slots = {i: pool.admit("conv", uid=i) for i in range(4)}
        got = {}
        for wave in range(2):
            for i, slot in slots.items():
                pool.set_input("conv", slot, 0, xs[i])
            pool.dispatch()
            for i, slot in slots.items():
                got[(wave, i)] = np.array(pool.output("conv", slot, 0))
                np.testing.assert_array_equal(got[(wave, i)], want[i])
            if wave == 0:
                for i in (0, 2):
                    pool.retire("conv", slots.pop(i))
                slots[4] = pool.admit("conv", uid=4)
                slots[5] = pool.admit("conv", uid=5)
        runs.append(got)
    for key in runs[0]:
        np.testing.assert_array_equal(runs[0][key], runs[-1][key])


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "vmap"])
def test_ragged_streaming_continuation(blobs, exact):
    """Ragged request lengths (1/2/3 frames) with per-lane continuation
    state: every lane matches its own interpreter at every step, also
    after neighbours retired mid-flight (bit-identical with exact)."""
    rng = np.random.default_rng(1)
    reqs = {uid: [rng.normal(0, 1, (1, 40)).astype(np.float32)
                  for _ in range(n)]
            for uid, n in enumerate((1, 2, 3))}
    want = {uid: _alone(blobs["hotword"], frames)
            for uid, frames in reqs.items()}
    pool = _ragged()
    _add(pool, "hw", blobs["hotword"], 3, exact=exact)
    live = {uid: pool.admit("hw", uid=uid) for uid in reqs}
    step = 0
    while live:
        for uid, slot in live.items():
            pool.set_input("hw", slot, 0, reqs[uid][step])
        pool.dispatch()
        for uid, slot in list(live.items()):
            got = pool.output("hw", slot, 0)
            if exact:
                np.testing.assert_array_equal(got, want[uid][step])
            else:
                np.testing.assert_allclose(got, want[uid][step],
                                           atol=VMAP_TOL, rtol=VMAP_TOL)
            if step + 1 == len(reqs[uid]):
                pool.retire("hw", slot)     # mid-flight retirement
                del live[uid]
        step += 1
    assert pool.occupancy() == 0.0
    assert capture_count(pool.program("hw")) == 1


def test_lane_state_isolated_from_retired_neighbour(blobs):
    """A lane admitted into a retired slot starts from FRESH variable
    state; a surviving lane's continuation is unaffected by the churn, and
    an inactive lane keeps its state while others advance."""
    rng = np.random.default_rng(2)
    a = [rng.normal(0, 1, (1, 40)).astype(np.float32) for _ in range(3)]
    b = rng.normal(0, 1, (1, 40)).astype(np.float32)
    c = rng.normal(0, 1, (1, 40)).astype(np.float32)
    pool = _ragged()
    _add(pool, "hw", blobs["hotword"], 2, exact=True)
    sa = pool.admit("hw", uid=0)
    sb = pool.admit("hw", uid=1)
    pool.set_input("hw", sa, 0, a[0])
    pool.set_input("hw", sb, 0, b)
    pool.dispatch()
    pool.retire("hw", sb)
    held = [v[sb].clone() for v in pool._buckets["hw"].variables]
    pool.set_input("hw", sa, 0, a[1])
    pool.dispatch()                         # sb inactive: state held
    for v, h in zip(pool._buckets["hw"].variables, held):
        assert torch.equal(v[sb], h)
    sc = pool.admit("hw", uid=2)            # reuses slot sb, fresh state
    assert sc == sb
    pool.set_input("hw", sa, 0, a[2])
    pool.set_input("hw", sc, 0, c)
    pool.dispatch()
    np.testing.assert_array_equal(pool.output("hw", sa, 0),
                                  _alone(blobs["hotword"], a)[2])
    np.testing.assert_array_equal(pool.output("hw", sc, 0),
                                  _alone(blobs["hotword"], [c])[0])


def test_admission_retirement_never_captures_again(blobs):
    """Occupancy 1, 3, 2, 4 of one bucket: one masked program covers all
    of them, in both packages — capture_count == jit_cache_size == 1."""
    counts = []
    for jax_side in (False, True):
        rng = np.random.default_rng(3)
        pool = _ragged(jax_side)
        _add(pool, "fc", blobs["fc_int8"], 4, jax_side=jax_side)
        bucket = pool._buckets["fc"]
        outs = []
        for occupancy in (1, 3, 2, 4):
            slots = [pool.admit("fc") for _ in range(occupancy)]
            for slot in slots:
                pool.set_input("fc", slot, 0, rng.normal(
                    0, 1, (1, 64)).astype(np.float32))
            pool.dispatch()
            outs.append(np.array(pool.outputs("fc", 0))[slots])
            for slot in slots:
                pool.retire("fc", slot)
        assert len(bucket.compiled._batched) == 1
        assert bucket.dispatch_count == 4
        prog = bucket.compiled.masked_batched(4, False)
        counts.append(jit_cache_size(prog) if jax_side
                      else capture_count(prog))
        if jax_side:
            for o, w in zip(outs, torch_outs):
                np.testing.assert_array_equal(o, w)
        torch_outs = outs
    assert counts == [1, 1]


def test_snapshot_restore_bit_identical_and_no_recapture(blobs):
    """Preempt a streaming lane mid-request, run unrelated work, restore
    it into a DIFFERENT lane: every output after the resume equals the
    uninterrupted run's bits (and the JAX pool's within FLOAT_TOL), with
    the capture count equal to the JAX program's jit_cache_size."""
    frames = _frames((1, 40), 4, seed=1)
    other = _frames((1, 40), 3, seed=2)
    want = _alone(blobs["hotword"], frames)
    runs, counts = [], []
    for jax_side in (False, True):
        pool = _ragged(jax_side)
        _add(pool, "hw", blobs["hotword"], 3, exact=True, jax_side=jax_side)
        slot = pool.admit("hw", uid=7)
        got = []
        for f in frames[:2]:
            pool.set_input("hw", slot, 0, f)
            pool.dispatch()
            got.append(np.array(pool.output("hw", slot, 0)))
        ckpt = pool.snapshot_lane("hw", slot)
        assert ckpt.step == 2 and ckpt.uid == 7
        assert all(isinstance(v, np.ndarray) for v in ckpt.variables)
        pool.retire("hw", slot)
        tmp = pool.admit("hw", uid=99)
        assert tmp == slot
        for f in other:
            pool.set_input("hw", tmp, 0, f)
            pool.dispatch()
        pool.retire("hw", tmp)
        restored = pool.restore_lane(ckpt, slot=2)
        assert restored == 2 and pool.lanes("hw")[2].step == 2
        for f in frames[2:]:
            pool.set_input("hw", restored, 0, f)
            pool.dispatch()
            got.append(np.array(pool.output("hw", restored, 0)))
        runs.append(got)
        prog = pool._buckets["hw"].compiled.masked_batched(3, True)
        counts.append(jit_cache_size(prog) if jax_side
                      else capture_count(prog))
        if not jax_side:
            assert isinstance(ckpt, LaneCheckpoint)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for g, j in zip(*runs):
        np.testing.assert_allclose(g, j, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    assert counts == [1, 1]


def test_snapshot_restore_guards(blobs):
    pool = _ragged()
    _add(pool, "hw", blobs["hotword"], 2)
    with pytest.raises(RuntimeError):
        pool.snapshot_lane("hw", 0)         # lane not active
    slot = pool.admit("hw", uid=1)
    ckpt = pool.snapshot_lane("hw", slot)
    with pytest.raises(RuntimeError):
        pool.restore_lane(ckpt, slot=slot)  # lane occupied
    pool.admit("hw", uid=2)
    with pytest.raises(RuntimeError):
        pool.restore_lane(ckpt)             # no free lane


def test_lane_table_tracks_buckets_steps_lifecycle(blobs):
    rng = np.random.default_rng(4)
    pool = _ragged()
    _add(pool, "fc", blobs["fc_int8"], 2)
    _add(pool, "hw", blobs["hotword"], 2, exact=True)
    assert len(pool.lane_table) == 4
    s = pool.admit("fc", uid=7)
    h = pool.admit("hw", uid=8)
    pool.set_input("fc", s, 0, rng.normal(0, 1, (1, 64)).astype(np.float32))
    pool.set_input("hw", h, 0, rng.normal(0, 1, (1, 40)).astype(np.float32))
    assert pool.dispatch() == 2             # one lane per bucket advanced
    lane = pool.lanes("fc")[s]
    assert (lane.bucket, lane.uid, lane.step, lane.active) == \
        ("fc", 7, 1, True)
    assert pool.occupancy() == 0.5
    pool.retire("fc", s)
    assert not pool.lanes("fc")[s].active
    assert pool.free_lanes("fc") == [0, 1]


def test_dispatch_atomic_across_buckets(blobs):
    """A staging error in ANY bucket aborts the whole dispatch with no
    lane advanced and no inputs consumed — restage and retry."""
    rng = np.random.default_rng(9)
    pool = _ragged()
    _add(pool, "fc", blobs["fc_int8"], 2)
    _add(pool, "hw", blobs["hotword"], 2, exact=True)
    sf = pool.admit("fc", uid=0)
    sh = pool.admit("hw", uid=1)
    x = rng.normal(0, 1, (1, 64)).astype(np.float32)
    f = rng.normal(0, 1, (1, 40)).astype(np.float32)
    pool.set_input("fc", sf, 0, x)          # "hw" lane left unstaged
    with pytest.raises(RuntimeError):
        pool.dispatch()
    assert pool.lanes("fc")[sf].step == 0   # nothing advanced
    assert pool.lanes("hw")[sh].step == 0
    assert pool._buckets["fc"].dispatch_count == 0
    pool.set_input("hw", sh, 0, f)          # fc's staged input survived
    assert pool.dispatch() == 2
    np.testing.assert_array_equal(pool.output("fc", sf, 0),
                                  _alone(blobs["fc_int8"], [x])[0])
    np.testing.assert_array_equal(pool.output("hw", sh, 0),
                                  _alone(blobs["hotword"], [f])[0])


def test_ragged_pool_input_contract(blobs):
    pool = _ragged()
    _add(pool, "fc", blobs["fc_int8"], 2)
    with pytest.raises(RuntimeError):       # inactive lane
        pool.set_input("fc", 0, 0, np.zeros((1, 64), np.float32))
    slot = pool.admit("fc")
    with pytest.raises(ValueError):         # wrong shape
        pool.set_input("fc", slot, 0, np.zeros((1, 3), np.float32))
    with pytest.raises(RuntimeError):       # active lane missing inputs
        pool.dispatch()
    pool.admit("fc")
    with pytest.raises(RuntimeError):       # bucket full
        pool.admit("fc")
    with pytest.raises(ValueError):         # duplicate bucket
        _add(pool, "fc", blobs["fc_int8"], 2)


def test_ragged_dispatch_steady_state(blobs):
    """After the first wave, waves of three buckets (two of one lane
    count, sharing the pool's buffer) allocate no arena buffer, capture
    nothing, and read each bucket's outputs once."""
    rng = np.random.default_rng(5)
    pool = _ragged()
    _add(pool, "fc", blobs["fc_int8"], 4)
    _add(pool, "conv", blobs["conv_int8"], 4)
    _add(pool, "hw", blobs["hotword"], 2, exact=True)
    slots = {"fc": [pool.admit("fc") for _ in range(2)],
             "conv": [pool.admit("conv")], "hw": [pool.admit("hw")]}
    shapes = {"fc": (1, 64), "conv": (1, 16, 16, 1), "hw": (1, 40)}

    def wave():
        for name, ss in slots.items():
            for slot in ss:
                pool.set_input(name, slot, 0, rng.normal(
                    0, 1, shapes[name]).astype(np.float32))
        pool.dispatch()
        for name in slots:
            pool.outputs(name, 0)
            assert pool._buckets[name].outs_host is not None

    wave()                                  # warm-up
    allocs = pool.pool.alloc_count
    assert allocs == 2                      # one buffer per lane count
    for _ in range(4):
        wave()
    assert pool.pool.alloc_count == allocs
    for name in slots:
        assert capture_count(pool.program(name)) == 1


@pytest.mark.parametrize("entry", ["InterpreterPool", "RaggedInterpreterPool",
                                   "ArenaPool"])
def test_pools_default_to_the_card(blobs, entry):
    """The batched entry points default to ``device="cuda"``, and raise
    without a card rather than plan or allocate on the CPU."""
    import inspect

    cls = {"InterpreterPool": InterpreterPool, "ArenaPool": ArenaPool,
           "RaggedInterpreterPool": RaggedInterpreterPool}[entry]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    make = {"InterpreterPool": lambda: InterpreterPool(
                MicroModel(blobs["conv"]), AllOpsResolver(), batch=2),
            "RaggedInterpreterPool": RaggedInterpreterPool,
            "ArenaPool": ArenaPool}[entry]
    if torch.cuda.is_available():
        made = make()
        pool = made if isinstance(made, ArenaPool) else made.pool
        assert pool.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_lane_rules_take_lanes_one_by_one_when_an_operand_is_not_shared():
    """The ``"cuda"`` FC and ATTENTION lane rules fold the lanes into one
    kernel call only when the weight (or K and V) is shared by every lane;
    an FC whose weight is a model input and an ATTENTION over const K/V
    take each lane in turn, bit-identical to single invokes."""
    rng = np.random.default_rng(12)
    gb = torch_core.GraphBuilder("lanes")
    x = gb.input("x", (2, 8))
    w = gb.input("w", (4, 8))
    q = gb.input("q", (1, 2, 5, 8))
    kv = [gb.const(rng.normal(0, 1, (1, 2, 5, 8)).astype(np.float32), n)
          for n in "kv"]
    gb.mark_output(gb.fully_connected(x, w))
    gb.mark_output(gb.attention(q, *kv))
    model = MicroModel(torch_core.export(gb))
    res = AllOpsResolver(tags=("cuda", "reference"))
    feeds = [[rng.normal(0, 1, s).astype(np.float32)
              for s in ((2, 8), (4, 8), (1, 2, 5, 8))] for _ in range(3)]
    it = MicroInterpreter(model, res, MicroInterpreter.required_arena_size(
        model, res), device="cpu")
    pool = InterpreterPool(model, res, batch=3, **CPU)
    for lane, f in enumerate(feeds):
        for pos, v in enumerate(f):
            pool.set_input(lane, pos, v)
    pool.invoke()
    for lane, f in enumerate(feeds):
        for pos, v in enumerate(f):
            it.set_input(pos, v)
        it.invoke()
        for k in range(2):
            np.testing.assert_array_equal(pool.output(lane, k),
                                          it.output(k))
