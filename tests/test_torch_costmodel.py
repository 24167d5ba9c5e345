"""The port's calibration cost model (core/costmodel.py) on the CPU, held
against the JAX package's (repro.core.costmodel): every case of
tests/test_costmodel.py in the port's terms, then parity — with the same
injected measurements the port's ``calibrate`` writes the JAX profile key
for key (``meta`` aside), the solvers agree on hypothesis-drawn costs,
``BucketTable``'s layout methods agree, and ``from_profile`` /
``MultiTenantHost(profile=)`` give the JAX engine's tables, chunk sizes,
program counts and greedy tokens on the reduced qwen3-32b.  A profile is
keyed by the device it was measured on: the committed JAX profile loads
and is refused, and a card profile never configures a CPU engine.  Real
CPU calibrations through ``EngineMeasurer`` and ``MicroMeasurer`` add one
capture per measurement and serve the default engine's tokens."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

import repro.apps.models as jax_apps
import repro.core as jax_core
import repro.core.costmodel as jcm
import repro.serving as jax_serving
from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models import get_model as jax_get_model

import repro_torch.core.costmodel as costmodel
from repro_torch.configs import get_config
from repro_torch.core import (AllOpsResolver, BucketCost, BucketTable,
                              CalibrationProfile, ChunkCost, DecodeCost,
                              EngineMeasurer, InterpreterPool, LaneCost,
                              MicroInterpreter, MicroMeasurer, MicroModel,
                              calibrate, capture_count, profile_model_key,
                              solve, solve_block_size, solve_lanes,
                              solve_replicas)
from repro_torch.core.costmodel import (BlockCost, QuantCost,
                                        solve_precision)
from repro_torch.core.profiler import CompileStepTiming
from repro_torch.models import get_model, params_from_jax
from repro_torch.serving import MultiTenantHost, Request, ServingEngine
from repro_torch.serving.errors import UnsupportedFamilyError

ROOT = Path(__file__).resolve().parents[1]
JAX_PROFILE = (ROOT / "benchmarks" / "results" / "profiles"
               / "dense__qwen3-32b-smoke__L64.json")
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_aliases():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``)
    and ``pltpu.TPUMemorySpace`` (renamed ``pltpu.MemorySpace``) in newer
    jax, for this module's JAX engines and interpreters only; drop the
    Pallas kernel's jit cache afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        if not hasattr(pltpu, "TPUMemorySpace"):
            mp.setattr(pltpu, "TPUMemorySpace", pltpu.MemorySpace,
                       raising=False)
        yield
    decode_attention_pallas.clear_cache()


@pytest.fixture(autouse=True)
def _empty_profile_cache(tmp_path, monkeypatch):
    """Every test sees an empty cache of its own: ``from_profile`` with no
    profile consults it."""
    monkeypatch.setattr(costmodel, "DEFAULT_PROFILE_DIR",
                        tmp_path / "profiles")


class _Cfg:
    family = "dense"
    arch_id = "toy"
    vocab = 32


class _Bundle:
    cfg = _Cfg()


def synthetic_measure(compile_us=2000.0, step_per_tok=2.0,
                      chunk_overhead=1.2, timing=CompileStepTiming):
    """A deterministic stand-in for EngineMeasurer (the JAX test's):
    compile cost is flat, step cost linear in the padded length, chunk
    steps carry a small per-dispatch overhead factor."""
    def measure(kind, size):
        if kind == "prefill":
            return timing(compile_us=compile_us + step_per_tok * size,
                          step_us=step_per_tok * size, iters=5)
        return timing(
            compile_us=compile_us + chunk_overhead * step_per_tok * size,
            step_us=chunk_overhead * step_per_tok * size, iters=5)
    return measure


def lane_measure(fixed_us=80.0, per_lane_us=10.0, compile_us=3000.0,
                 timing=CompileStepTiming):
    """Pooled-dispatch cost stand-in: a fixed overhead plus a per-lane
    term (sublinear batching)."""
    def measure(kind, size):
        assert kind == "micro", kind
        step = fixed_us + per_lane_us * size
        return timing(compile_us=compile_us + step, step_us=step, iters=5)
    return measure


LENGTHS = [5] * 8 + [9] * 6 + [17] * 4 + [41] * 2


def _cal(bundle, lengths=LENGTHS, **kw):
    kw.setdefault("measure", synthetic_measure())
    return calibrate(bundle, None, lengths, **kw, **CPU)


# ---------------------------------------------------------------------------
# BucketTable edges (profile-constructed tables included)
# ---------------------------------------------------------------------------

def test_bucket_table_default_is_pow2_ladder():
    t = BucketTable(min_bucket=8, max_bucket=64)
    assert t.levels == [8, 16, 32, 64]
    assert t.fit(1) == 8 and t.fit(9) == 16 and t.fit(64) == 64


def test_bucket_table_over_cap_prompt():
    t = BucketTable(min_bucket=8, max_bucket=64)
    assert t.fit(65) is None            # probe records nothing
    assert t.hits == {}
    with pytest.raises(ValueError):     # commit stays loud
        t.bucket(65)


def test_bucket_table_single_element():
    t = BucketTable.from_levels([32])
    assert t.min_bucket == t.max_bucket == 32
    assert t.fit(1) == 32 and t.fit(32) == 32 and t.fit(33) is None
    assert t.bucket(7) == 32 and t.hits == {32: 1}


def test_bucket_table_min_equals_max():
    t = BucketTable(min_bucket=16, max_bucket=16)
    assert t.levels == [16]
    assert t == BucketTable.from_levels([16])


def test_bucket_table_granularity():
    t = BucketTable(min_bucket=4, max_bucket=64, granularity=4)
    assert t.levels == [4, 16, 64]
    with pytest.raises(ValueError):
        BucketTable(min_bucket=4, max_bucket=64, granularity=1)
    with pytest.raises(ValueError):     # silently truncating 2.9 -> 2
        BucketTable(min_bucket=4, max_bucket=64, granularity=2.9)


def test_bucket_table_rejects_bad_levels():
    for bad in ([], [8, 8], [16, 8], [0, 8]):
        with pytest.raises(ValueError):
            BucketTable.from_levels(bad)
    with pytest.raises(ValueError):     # contradictory mixed forms
        BucketTable(min_bucket=8, max_bucket=64, levels=[4, 8])


def test_bucket_table_is_hashable_consistently_with_eq():
    a = BucketTable(min_bucket=8, max_bucket=64)
    b = BucketTable.from_levels([8, 16, 32, 64])
    assert a == b and hash(a) == hash(b)
    assert len({a, b}) == 1             # usable as dict/set member
    b.bucket(9)                         # hits do not count
    assert a == b and hash(a) == hash(b)
    assert a != BucketTable.from_levels([8, 64])


def test_profile_table_matches_hand_constructed_bit_identically():
    hand = BucketTable.from_levels([8, 24, 48])
    rebuilt = BucketTable.from_spec(hand.spec())
    assert rebuilt == hand and rebuilt.levels == [8, 24, 48]
    for n in range(1, 49):
        assert rebuilt.fit(n) == hand.fit(n), n
        assert rebuilt.bucket(n) == hand.bucket(n), n
    assert rebuilt.hits == hand.hits
    assert BucketTable(8, 64) == BucketTable.from_levels([8, 16, 32, 64])


@pytest.mark.parametrize("kw", [{"levels": [3, 10, 40]},
                                {"min_bucket": 8, "max_bucket": 64},
                                {"min_bucket": 4, "max_bucket": 256,
                                 "granularity": 4}])
def test_bucket_table_layout_methods_equal_jax(kw):
    """``from_levels``, ``spec``/``from_spec``, ``buckets`` after the same
    hits, and equality/hash by layout, against the JAX table."""
    ours = BucketTable(**kw)
    theirs = jax_core.BucketTable(**kw)
    assert ours.spec() == theirs.spec()
    assert json.dumps(ours.spec()) == json.dumps(theirs.spec())
    assert BucketTable.from_spec(theirs.spec()) == ours
    assert BucketTable.from_levels(theirs.levels) == ours
    assert hash(ours) == hash(theirs)       # both hash the level tuple
    for n in (1, 3, 9, 11, 40, 3):
        if theirs.fit(n) is not None:
            assert ours.bucket(n) == theirs.bucket(n)
    assert ours.buckets() == theirs.buckets()
    assert ours.hits == theirs.hits


# ---------------------------------------------------------------------------
# calibration determinism + profile round-trip
# ---------------------------------------------------------------------------

def test_calibration_is_deterministic():
    kw = dict(cache_len=64, seed=3, chunk_candidates=(0, 8))
    a = _cal(_Bundle(), **kw)
    b = _cal(_Bundle(), **kw)
    assert a.to_json() == b.to_json()   # byte-identical profiles
    assert a.model_key == profile_model_key(_Cfg(), 64)
    # nothing volatile: the meta block is the torch version and the
    # device the profile was measured on
    assert a.meta == {"torch": torch.__version__, "device": "cpu"}


def test_profile_round_trip(tmp_path):
    p = _cal(_Bundle(), cache_len=64, seed=0)
    path = p.save(str(tmp_path / "profile.json"))
    q = CalibrationProfile.load(path)
    assert q.to_json() == p.to_json()
    assert q.bucket_table() == p.bucket_table()
    assert q.prefill_chunk == p.prefill_chunk
    assert q.bucket_costs == p.bucket_costs
    assert q.chunk_costs == p.chunk_costs
    assert q.matches_device("cpu")


def test_profile_version_guard():
    p = _cal(_Bundle(), cache_len=64)
    bad = p.to_json().replace('"version": 1', '"version": 99')
    with pytest.raises(ValueError, match="version"):
        CalibrationProfile.from_json(bad)


def test_calibrate_family_gate():
    """Every family with a bucketed OR chunked fast path calibrates (ssm
    through its chunked prefill); one with neither (audio) is refused
    with the typed UnsupportedFamilyError, as in the JAX package."""
    class SsmCfg:
        family = "ssm"
        arch_id = "s"
        vocab = 8

    class SsmBundle:
        cfg = SsmCfg()

    assert _cal(SsmBundle(), cache_len=64).bucket_levels

    class AudioCfg:
        family = "audio"
        arch_id = "a"
        vocab = 8

    class AudioBundle:
        cfg = AudioCfg()

    with pytest.raises(UnsupportedFamilyError, match="audio"):
        _cal(AudioBundle(), cache_len=64)
    with pytest.raises(jax_serving.UnsupportedFamilyError, match="audio"):
        jcm.calibrate(AudioBundle(), None, LENGTHS, cache_len=64,
                      measure=synthetic_measure(
                          timing=jax_core.CompileStepTiming))


# ---------------------------------------------------------------------------
# the port's calibrate against the JAX package's, injected measurements
# ---------------------------------------------------------------------------

class _VlmCfg:
    family = "vlm"
    arch_id = "v"
    vocab = 8
    n_vision_tokens = 16


class _VlmBundle:
    cfg = _VlmCfg()


class _SsmCfg:
    family = "ssm"
    arch_id = "s"
    vocab = 8


class _SsmBundle:
    cfg = _SsmCfg()


def _decode_side(timing):
    """Decode-side kinds for the parity cases: decode and paged steps
    grow with slots/blocks, quantized ones with the precision, micro as
    ``lane_measure``; ``hbm_bytes`` reports a footprint per precision."""
    base = synthetic_measure(timing=timing)
    lanes = lane_measure(timing=timing)
    bits = {"fp32": 32, "int8": 8, "int4": 4}

    class Measure:
        def __call__(self, kind, size):
            if kind == "micro":
                return lanes(kind, size)
            if kind == "decode":
                return timing(compile_us=5000.0 + 7 * size,
                              step_us=100.0 + 7.0 * size, iters=5)
            if kind == "decode_paged":
                return timing(compile_us=6000.0, step_us=90.0 + 400.0 / size,
                              iters=5)
            if kind.startswith("decode_q:"):
                _, wd, kd = kind.split(":")
                step = 50.0 + 2.0 * bits[wd] + bits[kd] + size
                return timing(compile_us=9000.0 + step, step_us=step,
                              iters=5)
            return base(kind, size)

        def hbm_bytes(self, kind, size):
            _, wd, kd = kind.split(":")
            return 1000 * bits[wd] + 10 * bits[kd] * size

    return Measure()


PARITY_CASES = {
    "prefill-only": dict(cache_len=64, seed=1, chunk_candidates=(0, 8)),
    "explicit levels and bound": dict(
        cache_len=64, candidate_levels=(8, 16, 40, 64),
        chunk_candidates=(0, 8, 16), max_dispatch_us=60.0),
    "decode": dict(cache_len=64, decode_slots=(1, 2, 4)),
    "paged": dict(cache_len=64, decode_slots=(2,),
                  block_candidates=(4, 8, 16, 24, 32), new_tokens=8),
    "lanes": dict(cache_len=64, lane_candidates=(1, 2, 4, 8),
                  lane_demand=[8, 3, 1, 5]),
    "replicas": dict(cache_len=64, decode_slots=(1, 4),
                     replica_candidates=(1, 2, 4),
                     target_tokens_per_us=0.05),
    "quantized": dict(cache_len=64, decode_slots=(2, 4),
                      quant_candidates=(("fp32", "fp32"), ("int8", "int8"),
                                        ("int4", "int8"), ("int8", "int8"))),
    "vlm": dict(cache_len=64, chunk_candidates=(0, 8), bundle=_VlmBundle),
    "ssm": dict(cache_len=128, chunk_candidates=(0, 16),
                lengths=[3] * 5 + [30] * 5 + [100] * 3, bundle=_SsmBundle),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_calibrate_equals_jax(case):
    """With the same injected measurements the port's profile JSON equals
    the JAX package's key for key, ``meta`` excluded."""
    kw = dict(PARITY_CASES[case])
    bundle = kw.pop("bundle", _Bundle)()
    lengths = kw.pop("lengths", LENGTHS)
    ours = calibrate(bundle, None, lengths,
                     measure=_decode_side(CompileStepTiming), **kw, **CPU)
    theirs = jcm.calibrate(bundle, None, lengths,
                           measure=_decode_side(jax_core.CompileStepTiming),
                           **kw)
    a, b = json.loads(ours.to_json()), json.loads(theirs.to_json())
    assert a.pop("meta") == {"torch": torch.__version__, "device": "cpu"}
    assert set(b.pop("meta")) == {"jax", "backend"}
    assert a == b
    assert ours.bucket_table() == BucketTable.from_spec(
        theirs.bucket_table().spec())


# ---------------------------------------------------------------------------
# solver semantics on synthetic cost landscapes
# ---------------------------------------------------------------------------

def _costs(lengths, measure):
    return [BucketCost(length=L,
                       compile_us=measure("prefill", L).compile_us,
                       step_us=measure("prefill", L).step_us)
            for L in lengths]


def test_solver_merges_buckets_when_compile_dominates():
    m = synthetic_measure(compile_us=1e6, step_per_tok=1.0)
    r = solve(LENGTHS, _costs([8, 16, 32, 64], m), [], cache_len=64)
    assert r.levels == [64] and r.predicted_compiles == 1


def test_solver_keeps_fine_buckets_when_padding_dominates():
    m = synthetic_measure(compile_us=0.0, step_per_tok=100.0)
    r = solve(LENGTHS, _costs([8, 16, 32, 64], m), [], cache_len=64)
    assert r.levels == [8, 16, 64] and r.predicted_compiles == 3


def test_solver_objective_counts_trace_overhead_once_per_level():
    m = synthetic_measure(compile_us=500.0, step_per_tok=1.0)
    r = solve([9, 9, 9], _costs([8, 16], m), [], cache_len=64)
    assert r.levels == [8]
    assert r.expected_us == pytest.approx(3 * 8.0 + 500.0)


def test_head_of_line_bound_forces_chunking():
    m = synthetic_measure(compile_us=100.0, step_per_tok=10.0,
                          chunk_overhead=2.0)
    bc = _costs([8, 16, 32, 64], m)
    cc = [ChunkCost(chunk=8, compile_us=m("chunk", 8).compile_us,
                    step_us=m("chunk", 8).step_us)]
    free = solve(LENGTHS, bc, cc, cache_len=64)
    bound = solve(LENGTHS, bc, cc, cache_len=64, max_dispatch_us=200.0)
    assert free.chunk == 0
    assert bound.chunk == 8 and bound.feasible
    assert bound.max_dispatch_us <= 200.0


def test_solver_chunk_fit_counts_vlm_vision_tokens():
    m = synthetic_measure(compile_us=2000.0, step_per_tok=2.0,
                          chunk_overhead=0.9)
    bc = _costs([56], m)
    cc = [ChunkCost(chunk=8, compile_us=m("chunk", 8).compile_us,
                    step_us=m("chunk", 8).step_us)]
    reqs = [57] * 20
    dense = solve(reqs, bc, cc, cache_len=64, vis_tokens=0)
    vlm = solve(reqs, bc, cc, cache_len=64, vis_tokens=16)
    assert dense.chunk == 8
    assert vlm.chunk == 0 and vlm.levels == [56]


def test_first_chunk_prefill_trace_dedupes_against_hit_bucket():
    """The first chunk runs through the prefill program at (1, chunk) and
    shares the capture of a hit level of that length: one prefill program,
    not two; when nothing else hits it, the extra capture is charged."""
    m = synthetic_measure(compile_us=50.0, step_per_tok=10.0,
                          chunk_overhead=0.5)
    bc = _costs([8, 64], m)
    cc = [ChunkCost(chunk=8, compile_us=m("chunk", 8).compile_us,
                    step_us=m("chunk", 8).step_us)]
    shared = solve([5] * 10 + [41] * 10, bc, cc, cache_len=64)
    assert shared.chunk == 8 and shared.levels == [8]
    assert shared.predicted_compiles == 1
    alone = solve([41] * 10, bc, cc, cache_len=64)
    assert alone.chunk == 8 and alone.predicted_compiles == 1
    first = next(c for c in bc if c.length == 8)
    want = (10 * (first.step_us + 4 * cc[0].step_us)
            + cc[0].trace_overhead_us + first.trace_overhead_us)
    assert alone.expected_us == pytest.approx(want)


def test_explicit_candidates_beyond_room_fail_loudly():
    class VlmCfg:
        family = "vlm"
        arch_id = "v"
        vocab = 8
        n_vision_tokens = 48

    class VlmBundle:
        cfg = VlmCfg()

    with pytest.raises(ValueError, match="cache room"):
        _cal(VlmBundle(), cache_len=64, candidate_levels=(32, 64))


def test_infeasible_bound_is_flagged_not_hidden():
    m = synthetic_measure(compile_us=0.0, step_per_tok=10.0)
    r = solve([41], _costs([64], m), [], cache_len=64, max_dispatch_us=1.0)
    assert not r.feasible


def test_default_comparison_is_priced_from_measurements():
    p = _cal(_Bundle(), [25] * 4, cache_len=64, seed=0,
             candidate_levels=(40, 64),
             measure=synthetic_measure(compile_us=2000.0, step_per_tok=2.0))
    assert 32 in {c.length for c in p.bucket_costs}
    assert p.default_expected_us == pytest.approx(4 * 64.0 + 2000.0)
    assert all(l in (40, 64) for l in p.bucket_levels)


def test_calibrate_keeps_a_capacity_guard_level():
    p = _cal(_Bundle(), [9] * 10, cache_len=64, seed=0,
             candidate_levels=(8, 16, 64),
             measure=synthetic_measure(compile_us=1e6))
    assert p.bucket_levels[-1] == 64
    assert p.bucket_table().fit(63) == 64
    assert p.predicted_compiles == 1


def test_single_token_prompts_need_no_calibration():
    with pytest.raises(ValueError, match="multi-token"):
        _cal(_Bundle(), [1, 1], cache_len=64)


# ---------------------------------------------------------------------------
# batched-dispatch calibration: lane widths and replica counts
# ---------------------------------------------------------------------------

def test_lane_solver_amortizes_fixed_dispatch_overhead():
    costs = [LaneCost(lanes=B, compile_us=0.0, step_us=80.0 + 10.0 * B)
             for B in (1, 2, 4, 8)]
    wide = solve_lanes([8] * 10, costs)
    assert wide.lanes == 8 and wide.feasible
    bound = solve_lanes([8] * 10, costs, max_dispatch_us=110.0)
    assert bound.lanes == 2 and bound.feasible
    assert bound.max_dispatch_us <= 110.0
    hopeless = solve_lanes([8] * 10, costs, max_dispatch_us=10.0)
    assert not hopeless.feasible and hopeless.lanes == 1


def test_lane_solver_counts_padding_waste():
    costs = [LaneCost(lanes=B, compile_us=0.0, step_us=80.0 + 10.0 * B)
             for B in (1, 8)]
    assert solve_lanes([1] * 20, costs).lanes == 1


def test_lane_solver_rejects_empty_inputs():
    costs = [LaneCost(lanes=1, compile_us=0.0, step_us=1.0)]
    with pytest.raises(ValueError, match="micro jobs"):
        solve_lanes([0, 0], costs)
    with pytest.raises(ValueError, match="LaneCost"):
        solve_lanes([1], [])


def test_replica_solver_sizes_for_throughput_target():
    d = DecodeCost(slots=2, compile_us=5000.0, step_us=100.0)
    r = solve_replicas(0.05, d)
    assert r.replicas == 4 and r.feasible
    assert r.tokens_per_us == pytest.approx(0.08)
    bad = solve_replicas(1.0, d, candidates=(1, 2))
    assert bad.replicas == 2 and not bad.feasible
    with pytest.raises(ValueError, match="positive"):
        solve_replicas(0.0, d)
    with pytest.raises(ValueError, match="positive count"):
        solve_replicas(0.1, d, candidates=())


def test_lane_and_replica_calibration_deterministic_round_trip(tmp_path):
    def measure(kind, size):
        if kind == "micro":
            return lane_measure()(kind, size)
        return synthetic_measure()(kind, size)
    kw = dict(cache_len=64, seed=7, measure=measure,
              lane_candidates=(1, 2, 4), lane_demand=[4, 4, 1],
              decode_slots=(2,), replica_candidates=(1, 2, 4),
              target_tokens_per_us=0.01)
    a = _cal(_Bundle(), **kw)
    b = _cal(_Bundle(), **kw)
    assert a.to_json() == b.to_json()
    assert a.micro_lanes in (1, 2, 4)
    assert len(a.lane_costs) == 3
    assert a.replicas >= 1 and len(a.replica_costs) == 3
    q = CalibrationProfile.load(a.save(str(tmp_path / "p.json")))
    assert q.to_json() == a.to_json()
    assert (q.lane_costs, q.replica_costs, q.micro_lanes, q.replicas) == \
        (a.lane_costs, a.replica_costs, a.micro_lanes, a.replicas)


def test_profile_without_batched_dispatch_fields_still_loads():
    p = _cal(_Bundle(), cache_len=64)
    d = json.loads(p.to_json())
    for k in ("micro_lanes", "lane_costs", "replicas", "replica_costs",
              "quant_costs", "kv_block", "decode_costs", "block_costs"):
        del d[k]
    q = CalibrationProfile.from_json(json.dumps(d))
    assert q.micro_lanes == 0 and q.lane_costs == []
    assert q.replicas == 0 and q.replica_costs == []
    assert q.kv_block == 0 and q.quant_costs == []
    assert q.bucket_levels == p.bucket_levels


def test_lane_calibration_requires_micro_or_injected_measure():
    with pytest.raises(ValueError, match="micro="):
        calibrate(_Bundle(), None, LENGTHS, cache_len=64,
                  lane_candidates=(1, 2), **CPU)


def test_replica_calibration_requires_measured_decode():
    with pytest.raises(ValueError, match="decode_slots"):
        _cal(_Bundle(), cache_len=64, replica_candidates=(1, 2))


# ---------------------------------------------------------------------------
# the solvers against the JAX package's, on hypothesis-drawn costs
# ---------------------------------------------------------------------------

_us = st.floats(min_value=0.0, max_value=1e5, allow_nan=False,
                allow_infinity=False)


def _fields(x):
    return dataclasses.asdict(x)


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(1, 64), min_size=1, max_size=30),
       levels=st.lists(st.integers(1, 64), min_size=1, max_size=8,
                       unique=True),
       chunks=st.lists(st.integers(1, 32), max_size=3, unique=True),
       costs=st.lists(st.tuples(_us, _us), min_size=12, max_size=12),
       bound=st.one_of(st.none(), _us),
       vis=st.sampled_from([0, 8]))
def test_solve_equals_jax(lengths, levels, chunks, costs, bound, vis):
    def both(cls_p, cls_j, name, values):
        return ([cls_p(**{name: v, "compile_us": c + s, "step_us": s})
                 for v, (c, s) in zip(values, costs)],
                [cls_j(**{name: v, "compile_us": c + s, "step_us": s})
                 for v, (c, s) in zip(values, costs)])
    bp, bj = both(BucketCost, jcm.BucketCost, "length", levels)
    cp, cj = both(ChunkCost, jcm.ChunkCost, "chunk", chunks)
    kw = dict(cache_len=64, max_dispatch_us=bound, vis_tokens=vis)
    try:
        want = jcm.solve(lengths, bj, cj, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="covers"):
            solve(lengths, bp, cp, **kw)
        assert "covers" in str(e)
        return
    assert _fields(solve(lengths, bp, cp, **kw)) == _fields(want)


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(1, 128), min_size=1, max_size=30),
       blocks=st.lists(st.integers(1, 64), min_size=1, max_size=6,
                       unique=True),
       steps=st.lists(_us, min_size=6, max_size=6),
       slots=st.integers(1, 4), new=st.integers(0, 32),
       vis=st.sampled_from([0, 8]))
def test_solve_block_size_equals_jax(lengths, blocks, steps, slots, new,
                                     vis):
    kw = dict(cache_len=128, slots=slots, new_tokens=new, vis_tokens=vis)
    ours = [BlockCost(block=b, compile_us=1.0, step_us=s)
            for b, s in zip(blocks, steps)]
    theirs = [jcm.BlockCost(block=b, compile_us=1.0, step_us=s)
              for b, s in zip(blocks, steps)]
    try:
        want = jcm.solve_block_size(lengths, theirs, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            solve_block_size(lengths, ours, **kw)
        return
    assert _fields(solve_block_size(lengths, ours, **kw)) == _fields(want)


@settings(max_examples=60, deadline=None)
@given(demand=st.lists(st.integers(0, 20), min_size=1, max_size=20),
       lanes=st.lists(st.integers(1, 16), min_size=1, max_size=5,
                      unique=True),
       costs=st.lists(st.tuples(_us, _us), min_size=5, max_size=5),
       bound=st.one_of(st.none(), _us))
def test_solve_lanes_equals_jax(demand, lanes, costs, bound):
    ours = [LaneCost(lanes=b, compile_us=c + s, step_us=s)
            for b, (c, s) in zip(lanes, costs)]
    theirs = [jcm.LaneCost(lanes=b, compile_us=c + s, step_us=s)
              for b, (c, s) in zip(lanes, costs)]
    try:
        want = jcm.solve_lanes(demand, theirs, max_dispatch_us=bound)
    except ValueError:
        with pytest.raises(ValueError):
            solve_lanes(demand, ours, max_dispatch_us=bound)
        return
    assert _fields(solve_lanes(demand, ours, max_dispatch_us=bound)) == \
        _fields(want)


@settings(max_examples=60, deadline=None)
@given(target=st.floats(0.0, 1.0), slots=st.integers(1, 8),
       step=st.floats(1.0, 1e4),
       cands=st.lists(st.integers(-1, 16), max_size=5))
def test_solve_replicas_equals_jax(target, slots, step, cands):
    ours = DecodeCost(slots=slots, compile_us=0.0, step_us=step)
    theirs = jcm.DecodeCost(slots=slots, compile_us=0.0, step_us=step)
    try:
        want = jcm.solve_replicas(target, theirs, candidates=cands)
    except ValueError:
        with pytest.raises(ValueError):
            solve_replicas(target, ours, candidates=cands)
        return
    assert _fields(solve_replicas(target, ours, candidates=cands)) == \
        _fields(want)


_PAIRS = [("fp32", "fp32"), ("int8", "fp32"), ("int8", "int8"),
          ("int4", "int8"), ("int4", "fp32")]


@settings(max_examples=60, deadline=None)
@given(rows=st.lists(st.tuples(st.sampled_from(_PAIRS), _us,
                               st.integers(0, 10 ** 10)), max_size=5),
       max_step=st.one_of(st.none(), _us),
       budget=st.one_of(st.none(), st.integers(0, 10 ** 10)))
def test_solve_precision_equals_jax(rows, max_step, budget):
    ours = [QuantCost(weight_dtype=w, kv_dtype=k, slots=4, compile_us=0.0,
                      step_us=s, hbm_bytes=h) for (w, k), s, h in rows]
    theirs = [jcm.QuantCost(weight_dtype=w, kv_dtype=k, slots=4,
                            compile_us=0.0, step_us=s, hbm_bytes=h)
              for (w, k), s, h in rows]
    kw = dict(max_step_us=max_step, hbm_budget_bytes=budget)
    try:
        want = jcm.solve_precision(theirs, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            solve_precision(ours, **kw)
        return
    assert _fields(solve_precision(ours, **kw)) == _fields(want)


# ---------------------------------------------------------------------------
# a profile is keyed by the device it was measured on
# ---------------------------------------------------------------------------

def _card(profile, name="NVIDIA H100 80GB HBM3"):
    """``profile`` as if measured on a card named ``name``."""
    return dataclasses.replace(profile, meta={
        "torch": torch.__version__, "device": "cuda", "device_name": name})


def test_committed_jax_profile_loads_and_is_refused(lm):
    """The JAX package's committed profile loads through the port (same
    layout, version 1), but it records a backend, not a device: it
    matches no device, and ``from_profile`` refuses it — its
    ``"backend": "cpu"`` is not a torch CPU measurement."""
    prof = CalibrationProfile.load(str(JAX_PROFILE))
    assert prof.model_key == "dense/qwen3-32b-smoke/L64"
    assert prof.meta.get("backend") == "cpu" and prof.kv_block
    written, read = json.loads(JAX_PROFILE.read_text()), json.loads(
        prof.to_json())
    assert {k: read[k] for k in written} == written   # the rest defaulted
    assert prof.micro_lanes == prof.replicas == 0 and not prof.quant_costs
    assert prof.measured_on() == {} and not prof.matches_device("cpu")
    _, _, bundle, model = lm
    assert prof.matches(bundle.cfg, 64)
    with pytest.raises(ValueError, match="measured on"):
        ServingEngine.from_profile(bundle, model, prof, max_slots=2, **CPU)
    with pytest.raises(ValueError, match="measured on"):
        MultiTenantHost(64 << 20, profile=prof, **CPU)


def test_card_profile_never_configures_a_cpu_engine(lm):
    _, _, bundle, model = lm
    prof = _profile_for(bundle)
    assert prof.matches_device("cpu")
    for card in (_card(prof), _card(prof, "NVIDIA A100-SXM4-80GB")):
        assert not card.matches_device("cpu")
        with pytest.raises(ValueError, match="device_name"):
            ServingEngine.from_profile(bundle, model, card, max_slots=2,
                                       **CPU)
    no_torch = dataclasses.replace(prof, meta={"device": "cpu"})
    assert not no_torch.matches_device("cpu")


def test_the_profile_cache_is_the_ports_own(lm, tmp_path):
    """The port's cache is under build/ (never the JAX results folder);
    ``from_profile`` with no profile applies a cached one measured here
    and quietly ignores one measured on another device."""
    assert costmodel.DEFAULT_PROFILE_DIR == tmp_path / "profiles"
    real = (Path(costmodel.__file__).resolve().parents[3] / "build"
            / "profiles")
    assert real.parent.name == "build" and "benchmarks" not in real.parts
    _, _, bundle, model = lm
    prof = _profile_for(bundle, chunk_candidates=(0, 8))
    path = costmodel.save_cached_profile(prof)
    assert Path(path).parent == tmp_path / "profiles"
    assert costmodel.load_cached_profile(prof.model_key).to_json() == \
        prof.to_json()
    eng = ServingEngine.from_profile(bundle, model, max_slots=2,
                                     cache_len=64, **CPU)
    assert eng.bucket_table == prof.bucket_table()
    costmodel.save_cached_profile(_card(prof))
    eng = ServingEngine.from_profile(bundle, model, max_slots=2,
                                     cache_len=64, **CPU)
    assert eng.bucket_table == BucketTable(min_bucket=8, max_bucket=64)
    assert costmodel.load_cached_profile("dense/none/L1") is None


# ---------------------------------------------------------------------------
# engine / host plumbing: profile in, defaults as fallback, JAX parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """(JAX bundle, JAX params, port bundle, port model) of the reduced
    qwen3-32b, the port's weights converted from the JAX init."""
    jbundle = jax_get_model(jax_get_config("qwen3-32b", reduced=True))
    params = jbundle.init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3-32b", reduced=True)
    return jbundle, params, get_model(cfg), params_from_jax(
        jax.tree.map(np.asarray, params), cfg, **CPU)


def _profile_for(bundle, measure=None, **kw):
    kw.setdefault("cache_len", 64)
    kw.setdefault("candidate_levels", (8, 16, 40, 64))
    return calibrate(bundle, None, LENGTHS,
                     measure=measure or synthetic_measure(), **kw, **CPU)


def _jax_profile_for(bundle, **kw):
    kw.setdefault("cache_len", 64)
    kw.setdefault("candidate_levels", (8, 16, 40, 64))
    return jcm.calibrate(bundle, None, LENGTHS, measure=synthetic_measure(
        timing=jax_core.CompileStepTiming), **kw)


def test_from_profile_configures_the_engine(lm, tmp_path):
    jbundle, params, bundle, model = lm
    prof = _profile_for(bundle, decode_slots=(2,),
                        block_candidates=(8, 16),
                        measure=_decode_side(CompileStepTiming))
    loaded = CalibrationProfile.load(prof.save(str(tmp_path / "p.json")))
    eng = ServingEngine.from_profile(bundle, model, loaded, max_slots=2,
                                     **CPU)
    jprof = _jax_profile_for(jbundle, decode_slots=(2,),
                             block_candidates=(8, 16))
    jeng = jax_serving.ServingEngine.from_profile(jbundle, params, jprof,
                                                  max_slots=2)
    assert eng.cache_len == prof.cache_len == jeng.cache_len
    assert eng.bucket_table == prof.bucket_table()
    assert eng.bucket_table.levels == jeng.bucket_table.levels
    assert eng.chunk_tokens == prof.prefill_chunk == jeng.chunk_tokens
    assert eng.kv_block == prof.kv_block == jeng.kv_block > 0
    # explicit overrides beat the profile
    eng2 = ServingEngine.from_profile(bundle, model, loaded, max_slots=2,
                                      prefill_buckets=False, kv_block=0,
                                      **CPU)
    assert eng2.bucket_table is None and not eng2.paged


def test_from_profile_rejects_foreign_model(lm):
    _, _, bundle, model = lm
    prof = _profile_for(bundle)
    prof.model_key = "dense/someone-else/L64"
    with pytest.raises(ValueError, match="calibrated for"):
        ServingEngine.from_profile(bundle, model, prof, max_slots=2, **CPU)
    with pytest.raises(ValueError, match="calibrated for"):
        ServingEngine.from_profile(bundle, model, _profile_for(bundle),
                                   max_slots=2, cache_len=32, **CPU)


def test_from_profile_rejects_foreign_device(lm):
    """Costs are hardware facts: a profile measured on another device is
    refused like a foreign model_key (the JAX package's backend check,
    keyed by the engine's device)."""
    _, _, bundle, model = lm
    prof = _profile_for(bundle)
    assert prof.matches_device("cpu")
    prof.meta["device"] = "tpu"
    assert not prof.matches_device("cpu")
    with pytest.raises(ValueError, match="measured on"):
        ServingEngine.from_profile(bundle, model, prof, max_slots=2, **CPU)


def test_no_profile_fallback_is_todays_default(lm):
    _, _, bundle, model = lm
    eng = ServingEngine.from_profile(bundle, model, max_slots=2,
                                     cache_len=64, **CPU)
    assert eng.bucket_table == BucketTable(min_bucket=8, max_bucket=64)
    assert eng.chunk_tokens == 0 and not eng.paged
    host = MultiTenantHost(arena_bytes=64 << 20, **CPU)
    assert host.profile is None
    heng = host.add_model("lm", bundle, model, cache_len=64)
    assert heng.bucket_table is host.prompt_buckets
    assert heng.bucket_table == BucketTable(min_bucket=8, max_bucket=4096)
    assert heng.chunk_tokens == 0


def test_host_shares_one_profile_across_tenants(lm):
    jbundle, params, bundle, model = lm
    prof = _profile_for(bundle, chunk_candidates=(0, 8),
                        max_dispatch_us=60.0)
    jprof = _jax_profile_for(jbundle, chunk_candidates=(0, 8),
                             max_dispatch_us=60.0)
    assert prof.prefill_chunk == jprof.prefill_chunk == 8
    host = MultiTenantHost(arena_bytes=128 << 20, profile=prof, **CPU)
    jhost = jax_serving.MultiTenantHost(arena_bytes=128 << 20,
                                        profile=jprof)
    for h, b, p in ((host, bundle, model), (jhost, jbundle, params)):
        a = h.add_model("a", b, p, cache_len=64)
        c = h.add_model("b", b, p, cache_len=64)
        assert a.bucket_table is h.prompt_buckets
        assert c.bucket_table is h.prompt_buckets     # ONE shared table
        assert a.chunk_tokens == c.chunk_tokens == 8
    assert host.prompt_buckets == prof.bucket_table()
    assert host.prompt_buckets.levels == jhost.prompt_buckets.levels


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 2, L).astype(np.int32) for L in lengths]


def _serve(eng, prompts, req, new=3):
    for uid, toks in enumerate(prompts):
        eng.submit(req(uid=uid, tokens=toks, max_new_tokens=new))
    eng.run()
    return {u: list(map(int, r.output)) for u, r in eng.results.items()}


def test_from_profile_serves_the_jax_engines_tokens(lm):
    """One profile, solved with chunking on, through both packages'
    ``from_profile``: the same table and chunk, the same greedy tokens,
    prefill programs equal to ``predicted_compiles`` and one chunk
    program (a request was chunked)."""
    jbundle, params, bundle, model = lm
    kw = dict(chunk_candidates=(0, 8), max_dispatch_us=60.0)
    prof, jprof = _profile_for(bundle, **kw), _jax_profile_for(jbundle, **kw)
    assert prof.prefill_chunk == 8
    prompts = _prompts(bundle.cfg.vocab, LENGTHS)
    eng = ServingEngine.from_profile(bundle, model, prof, max_slots=2,
                                     **CPU)
    jeng = jax_serving.ServingEngine.from_profile(jbundle, params, jprof,
                                                  max_slots=2)
    assert eng.bucket_table.levels == jeng.bucket_table.levels
    got = _serve(eng, prompts, Request)
    assert got == _serve(jeng, prompts, jax_serving.Request)
    assert eng.prefill_compiles() == jeng.prefill_compiles() \
        == prof.predicted_compiles
    assert eng.chunk_compiles() == jeng.chunk_compiles() == 1
    assert eng.bucket_table.buckets() == jeng.bucket_table.buckets()


def test_host_profile_serves_the_jax_hosts_tokens(lm, blobs):
    """``MultiTenantHost(profile=)`` with an LM tenant and an int8
    fc_stack tenant, each package's host fed its own profile of the same
    injected measurements: the same tokens, program counts and micro
    outputs."""
    jbundle, params, bundle, model = lm
    kw = dict(chunk_candidates=(0, 8), max_dispatch_us=60.0)
    prof, jprof = _profile_for(bundle, **kw), _jax_profile_for(jbundle, **kw)
    prompts = _prompts(bundle.cfg.vocab, LENGTHS[::2], seed=1)
    xs = [np.random.default_rng(3).normal(0, 1, (1, 64)).astype(np.float32)
          for _ in range(3)]
    outs, engines = [], []
    for host, b, p, req, core in (
            (MultiTenantHost(128 << 20, profile=prof, **CPU), bundle, model,
             Request, None),
            (jax_serving.MultiTenantHost(128 << 20, profile=jprof), jbundle,
             params, jax_serving.Request, jax_core)):
        eng = host.add_model("lm", b, p, max_slots=2, cache_len=64,
                             max_prompt=64)
        if core is None:
            host.add_ragged_micro("fc", MicroModel(blobs), AllOpsResolver(),
                                  lanes=2)
        else:
            host.add_ragged_micro("fc", core.MicroModel(blobs),
                                  core.AllOpsResolver(), lanes=2)
        for uid, x in enumerate(xs):
            host.submit_micro("fc", uid, [[x]])
        for uid, toks in enumerate(prompts):
            host.submit("lm", req(uid=uid, tokens=toks, max_new_tokens=3))
        res = host.run_all()
        outs.append(({u: list(map(int, r.output))
                      for u, r in res["lm"].items()},
                     [np.asarray(host.micro_results["fc"][u].outputs[0])
                      for u in range(len(xs))]))
        engines.append(eng)
    (tokens, micro), (jtokens, jmicro) = outs
    assert tokens == jtokens
    for a, b in zip(micro, jmicro):
        np.testing.assert_array_equal(a, b)
    eng, jeng = engines
    assert eng.chunk_tokens == jeng.chunk_tokens == prof.prefill_chunk
    assert eng.prefill_compiles() == jeng.prefill_compiles()
    assert eng.chunk_compiles() == jeng.chunk_compiles()


def test_quantized_tenant_on_a_chunked_profile_is_refused_like_jax(lm):
    """A quantized tenant on a host whose profile chunks: both hosts hand
    the engine the chunk size, and both engines refuse it (the chunk ops
    write float KV rows)."""
    jbundle, params, bundle, model = lm
    kw = dict(chunk_candidates=(0, 8), max_dispatch_us=60.0)
    prof, jprof = _profile_for(bundle, **kw), _jax_profile_for(jbundle, **kw)
    assert prof.prefill_chunk == jprof.prefill_chunk == 8
    refusal = "prefill_chunk does not compose with quantized serving"
    with pytest.raises(ValueError, match=refusal):
        MultiTenantHost(128 << 20, profile=prof, **CPU).add_model(
            "q", bundle, model, cache_len=64, weight_dtype="int8")
    with pytest.raises(ValueError, match=refusal):
        jax_serving.MultiTenantHost(128 << 20, profile=jprof).add_model(
            "q", jbundle, params, cache_len=64, weight_dtype="int8")


@pytest.fixture(scope="module")
def blobs():
    """fc_stack exported int8 by the JAX package."""
    gb = jax_apps.build_fc_stack()
    return jax_core.export(gb, jax_apps.representative_dataset(gb),
                           quantize_int8=True)


# ---------------------------------------------------------------------------
# real measurement on the CPU: the default measurers
# ---------------------------------------------------------------------------

def test_real_calibration_beats_defaults_and_stays_bit_identical(lm):
    """The acceptance loop with REAL measurements through the port's
    EngineMeasurer: the from-profile engine captures exactly the
    predicted prefill programs (fewer than the default table on this
    clustered mix) and serves the default engine's tokens."""
    _, _, bundle, model = lm
    lengths = [5] * 6 + [7] * 4 + [9] * 4 + [41] * 2
    prof = calibrate(bundle, model, lengths, cache_len=64, seed=0,
                     candidate_levels=(8, 16, 40, 64),
                     chunk_candidates=(0, 8), iters=2, **CPU)
    assert all(c.step_us > 0 and c.compile_us > 0
               for c in prof.bucket_costs + prof.chunk_costs)
    prompts = _prompts(bundle.cfg.vocab, lengths)
    default = ServingEngine(bundle, model, max_slots=2, cache_len=64, **CPU)
    tuned = ServingEngine.from_profile(bundle, model, prof, max_slots=2,
                                       **CPU)
    assert _serve(tuned, prompts, Request) == _serve(default, prompts,
                                                     Request)
    assert tuned.prefill_compiles() == prof.predicted_compiles
    assert tuned.prefill_compiles() <= default.prefill_compiles()
    assert tuned.chunk_compiles() == int(
        prof.prefill_chunk > 0 and any(
            L - 1 > prof.prefill_chunk for L in lengths))


def test_measurer_adds_one_capture_per_measurement(lm):
    """Each measurement times the program through the engine's own bound
    buffers: exactly one new signature on the program it times (a fresh
    tensor per call would add one per call), on engines sharing one
    weight module; ``close()`` releases them."""
    _, _, bundle, model = lm
    m = EngineMeasurer(bundle, model, 64, seed=0, iters=3, **CPU)
    for L in (8, 16):
        t = m("prefill", L)
        assert t.iters == 3 and t.step_us > 0
    assert capture_count(m._engine(0)._prefill) == 2
    with pytest.raises(RuntimeError, match="added 0 captures"):
        m("prefill", 8)                 # already captured: not a cold call
    m("chunk", 8)
    m("decode", 2)
    m("decode_paged", 8)
    m("decode_q:int8:int8", 2)
    eng = m._engine(8)
    assert capture_count(eng._prefill_chunk) == 1
    for kind, size in (("decode", 2), ("decode_paged", 8),
                       ("decode_q:int8:int8", 2)):
        aux = m._aux(kind, size)
        assert capture_count(aux._decode) == 1
    assert all(e.params is model for e in m._engines.values())
    assert m._aux("decode", 2).params is model
    assert m._aux("decode_q:int8:int8", 2).params is not model
    assert m.hbm_bytes("decode_q:int8:int8", 2) < m.hbm_bytes("decode", 2)
    with pytest.raises(ValueError, match="unknown measurement"):
        m("bogus", 1)
    m.close()
    assert not m._engines and not m._aux_engines


def test_default_measurer_builds_vlm_prefill_batches():
    """A vlm (a BUCKETED family) is measured with its vision prefix staged
    through the engine's extras buffer."""
    cfg = get_config("paligemma-3b", reduced=True)
    bundle = get_model(cfg)
    model = bundle.init(torch.Generator("cpu").manual_seed(0))
    p = calibrate(bundle, model, [6] * 4, cache_len=64, seed=0,
                  candidate_levels=(8,), chunk_candidates=(), iters=1,
                  **CPU)
    assert p.model_key == profile_model_key(cfg, 64)
    assert p.bucket_levels == [8]
    assert all(c.step_us > 0 for c in p.bucket_costs)


def test_recurrent_calibration_keeps_the_one_shot_contract():
    """A recurrent prefill is one-shot at its exact length, so a measured
    level must keep ``S % min(128, S) == 0`` (ROADMAP queue 3): the port
    raises on a level off the contract, as the JAX package does (its
    ``ssd_chunked`` asserts); on the contract's levels it calibrates, and
    the from-profile engine serves the hand-configured one's tokens with
    the profile's chunk."""
    jcfg = jax_get_config("mamba2-780m", reduced=True)
    jbundle = jax_get_model(jcfg)
    params = jbundle.init(jax.random.PRNGKey(0))
    cfg = get_config("mamba2-780m", reduced=True)
    bundle = get_model(cfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, **CPU)
    off = dict(cache_len=512, candidate_levels=(200,), chunk_candidates=(),
               iters=1)
    with pytest.raises(ValueError, match="multiple"):
        calibrate(bundle, model, [150], **off, **CPU)
    with pytest.raises(AssertionError):
        jcm.calibrate(jbundle, params, [150], **off)
    lengths = [65] * 3 + [129, 257, 300]
    prof = calibrate(bundle, model, lengths, cache_len=512, seed=0,
                     candidate_levels=(128, 256, 512),
                     chunk_candidates=(0, 128), iters=1, **CPU)
    assert {c.length for c in prof.bucket_costs} <= {8, 16, 32, 64, 128,
                                                     256, 512}
    eng = ServingEngine.from_profile(bundle, model, prof, max_slots=2,
                                     **CPU)
    assert eng.bucket_table is None
    assert eng.chunk_tokens == prof.prefill_chunk
    hand = ServingEngine(bundle, model, max_slots=2, cache_len=512,
                         prefill_chunk=prof.prefill_chunk or None, **CPU)
    prompts = _prompts(cfg.vocab, [65, 129, 257] if not prof.prefill_chunk
                       else [65, 129, 300])
    assert _serve(eng, prompts, Request) == _serve(hand, prompts, Request)


def test_micro_measurer_prices_real_pooled_dispatch(lm, blobs):
    """MicroMeasurer times a REAL InterpreterPool.invoke at each lane
    width (one capture of the pool's program each); a real calibration
    with ``micro=`` fc_stack int8 picks a width whose pool gives each lane
    the interpreter's own int8 outputs, bit for bit."""
    model, res = MicroModel(blobs), AllOpsResolver()
    m = MicroMeasurer(model, res, seed=0, iters=1, **CPU)
    for lanes in (1, 2):
        t = m("micro", lanes)
        assert t.compile_us > 0 and t.step_us > 0
    with pytest.raises(ValueError, match="micro"):
        m("prefill", 8)
    _, _, bundle, lm_model = lm
    prof = calibrate(bundle, lm_model, [5, 9], cache_len=16,
                     candidate_levels=(8,), chunk_candidates=(),
                     lane_candidates=(1, 2, 4), lane_demand=[4, 2],
                     micro=(model, res), iters=1, **CPU)
    assert [c.lanes for c in prof.lane_costs] == [1, 2, 4]
    lanes = prof.micro_lanes
    assert lanes in (1, 2, 4)
    pool = InterpreterPool(model, res, lanes, **CPU)
    rng = np.random.default_rng(5)
    xs = [rng.normal(0, 1, (1, 64)).astype(np.float32) for _ in range(lanes)]
    for lane, x in enumerate(xs):
        pool.set_input(lane, 0, x)
    pool.invoke()
    assert capture_count(pool.program) == 1
    it = MicroInterpreter(model, res, MicroInterpreter.required_arena_size(
        model, res), **CPU)
    for lane, x in enumerate(xs):
        it.set_input(0, x)
        it.invoke()
        np.testing.assert_array_equal(pool.output(lane, 0), it.output(0))
