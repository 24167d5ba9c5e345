"""The µFB blob is the contract between the JAX package and its PyTorch
port: both readers parse the same bytes into the same model, both
planners lay out the same arena, and both exporters write the same float
blob (int8 blobs agree up to float32 rounding of calibrated scales)."""

import numpy as np
import pytest

import repro.apps.models as jax_apps
import repro.core as jax_core
from repro.core.executor import AllocationPlan as JaxAllocationPlan

import repro_torch.apps.models as torch_apps
import repro_torch.core as torch_core
from repro_torch.core.executor import AllocationPlan as TorchAllocationPlan

# (app builder, kwargs, int8 supported): hotword's SVDF has no int8 path
APPS = {
    "conv_reference": ("build_conv_reference", {}, True),
    "hotword": ("build_hotword", {}, False),
    "vww": ("build_vww", {}, True),
    "fc_stack": ("build_fc_stack", {}, True),
}
CASES = [(app, q) for app, (_, _, int8) in APPS.items()
         for q in ((False, True) if int8 else (False,))]
IDS = [f"{a}-{'int8' if q else 'float'}" for a, q in CASES]

# Float calibration ranges are float32 sums taken in another order by
# each framework; the activation scales they give differ by a few float32
# ulps (at most 7.1e-7 relative on these models).
SCALE_RTOL = 1e-5


def _export(apps, core, app, int8):
    name, kw, _ = APPS[app]
    gb = getattr(apps, name)(**kw)
    if not int8:
        return core.export(gb)
    return core.export(gb, representative_dataset=apps.representative_dataset(
        gb), quantize_int8=True)


@pytest.fixture(scope="module")
def blobs():
    """(jax blob, port blob) per case, exported once per module."""
    return {(a, q): (_export(jax_apps, jax_core, a, q),
                     _export(torch_apps, torch_core, a, q))
            for a, q in CASES}


def _same_quant(qa, qb, exact=True):
    assert qa.zero_point == qb.zero_point
    assert qa.quantized_dimension == qb.quantized_dimension
    if exact:
        assert qa.scale == qb.scale
    else:
        np.testing.assert_allclose(qb.scale, qa.scale, rtol=SCALE_RTOL)
    assert (qa.channel_scales is None) == (qb.channel_scales is None)
    if qa.channel_scales is not None:
        np.testing.assert_array_equal(qa.channel_scales, qb.channel_scales)


@pytest.mark.parametrize("app,int8", CASES, ids=IDS)
def test_same_blob_parses_identically(blobs, app, int8):
    blob = blobs[(app, int8)][0]
    mj, mt = jax_core.MicroModel(blob), torch_core.MicroModel(blob)
    assert (mj.inputs, mj.outputs) == (mt.inputs, mt.outputs)
    assert mj.metadata == mt.metadata
    assert len(mj.tensors) == len(mt.tensors)
    for i, (a, b) in enumerate(zip(mj.tensors, mt.tensors)):
        assert (a.name, a.shape, a.dtype, a.flags) == \
            (b.name, b.shape, b.dtype, b.flags)
        assert (a.buffer_offset, a.buffer_nbytes) == \
            (b.buffer_offset, b.buffer_nbytes)
        _same_quant(a.quant, b.quant)
        if a.is_const:
            assert mj.const_data(i).tobytes() == mt.const_data(i).tobytes()
    assert [(o.opcode, o.inputs, o.outputs, o.params)
            for o in mj.operators] == \
        [(o.opcode, o.inputs, o.outputs, o.params) for o in mt.operators]


@pytest.mark.parametrize("app,int8", CASES, ids=IDS)
def test_arena_size_and_planner_offsets_match(blobs, app, int8):
    blob = blobs[(app, int8)][0]
    mj, mt = jax_core.MicroModel(blob), torch_core.MicroModel(blob)
    rj, rt = jax_core.AllOpsResolver(), torch_core.AllOpsResolver()
    assert jax_core.MicroInterpreter.required_arena_size(mj, rj) == \
        torch_core.MicroInterpreter.required_arena_size(mt, rt)
    pj = JaxAllocationPlan.build(mj, rj, jax_core.TwoStackArena(1 << 30))
    pt = TorchAllocationPlan.build(mt, rt, torch_core.TwoStackArena(1 << 30),
                                   device="cpu")
    assert pj.tensor_offset == pt.tensor_offset
    assert pj.plan.total_bytes == pt.plan.total_bytes
    assert pj.scratch_bytes == pt.scratch_bytes
    assert vars(pj.arena.usage()) == vars(pt.arena.usage())


def test_vww_arena_sizes_are_the_papers_model():
    """MobileNet-v1 0.25x at 96x96x1 needs the same arena in both
    packages: 312,160 B float and 168,848 B int8 (default 1 KiB slack)."""
    gb = torch_apps.build_vww()
    r = torch_core.AllOpsResolver()
    size = torch_core.MicroInterpreter.required_arena_size
    assert size(torch_core.MicroModel(torch_core.export(gb)), r) == 312_160
    q = torch_core.export(gb, torch_apps.representative_dataset(gb),
                          quantize_int8=True)
    assert size(torch_core.MicroModel(q), r) == 168_848


@pytest.mark.parametrize("app", list(APPS))
def test_float_blob_byte_identical(blobs, app):
    jb, tb = blobs[(app, False)]
    assert jb == tb


@pytest.mark.parametrize("app", [a for a, (_, _, q) in APPS.items() if q])
def test_int8_blob_same_weights_close_scales(blobs, app):
    jb, tb = blobs[(app, True)]
    assert len(jb) == len(tb)
    mj, mt = jax_core.MicroModel(jb), torch_core.MicroModel(tb)
    assert [(o.opcode, o.inputs, o.outputs) for o in mj.operators] == \
        [(o.opcode, o.inputs, o.outputs) for o in mt.operators]
    for i, (a, b) in enumerate(zip(mj.tensors, mt.tensors)):
        assert (a.name, a.shape, a.dtype, a.flags) == \
            (b.name, b.shape, b.dtype, b.flags)
        _same_quant(a.quant, b.quant, exact=False)
        if a.is_const:                          # int8 weights, int32 biases
            np.testing.assert_array_equal(mj.const_data(i),
                                          mt.const_data(i))


def test_offline_plan_metadata_identical():
    gj = jax_apps.build_conv_reference()
    gt = torch_apps.build_conv_reference()
    assert jax_core.export(gj, offline_plan=True) == \
        torch_core.export(gt, offline_plan=True)


def test_model_to_source_round_trips():
    blob = torch_core.export(torch_apps.build_fc_stack())
    ns = {}
    exec(torch_core.model_to_source(blob), ns)
    assert ns["g_model"] == blob and ns["g_model_len"] == len(blob)
