"""Whole graphs over the micro ops the §5 models do not reach, in both
packages: a decoder block at Yi-6B's reduced widths and the op-coverage
graph (``repro_torch.apps.graphs``), each built by each package's
GraphBuilder from the same seed, exported by each package's exporter and
invoked by each package's interpreter on the same requests.

Bars: float blobs byte-equal; int8 blobs byte-equal given the same
calibration ranges (each package calibrates in float32 sums of its own
order, so its ranges may differ in the last ulps: RANGE_TOL); int8
outputs bit-equal; float outputs within FLOAT_TOL."""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.kernels.ops  # noqa: F401  (registers the "pallas" tag)
from repro.core import exporter as jax_exporter

import repro_torch.core as torch_core
import repro_torch.kernels  # noqa: F401  (registers the "cuda" tag)
from repro_torch.apps.graphs import build_decoder_block, build_op_coverage
from repro_torch.apps.models import representative_dataset
from repro_torch.configs import yi_6b
from repro_torch.core import exporter as torch_exporter

# float32 sums of the same graph taken in each framework's order (the
# block's matmuls over d_model and d_ff; the transcendental ops agree to
# a few ulps, tests/test_torch_micro_ops.py)
FLOAT_TOL = 1e-5
# a calibrated range's ends: the same float32 sums in another order
RANGE_TOL = 1e-6
SEQ = 16
N_REQUESTS = 3
TAG_PAIRS = [(("reference",), ("reference",)),
             (("pallas", "reference"), ("cuda", "reference"))]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_alias():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``
    in newer jax) for this module's tests only; the JAX int8 requant runs
    under it."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        yield


GRAPHS = {
    "block": lambda b: build_decoder_block(yi_6b.REDUCED, SEQ, builder=b),
    "coverage": lambda b: build_op_coverage(32, builder=b),
    "coverage-int8": lambda b: build_op_coverage(32, True, builder=b),
}


def _both(name):
    return (GRAPHS[name](jax_core.GraphBuilder),
            GRAPHS[name](torch_core.GraphBuilder))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_float_blobs_byte_equal(name):
    """The exporter's passes and serialization, and ``build()`` (which
    keeps IDENTITY and DROPOUT), write the same bytes in both packages."""
    gj, gt = _both(name)
    assert jax_core.export(gj) == torch_core.export(gt)
    assert gj.build() == gt.build()


def test_int8_blob_byte_equal_given_the_same_ranges(monkeypatch):
    """The int8 export of a graph using every quantizable op: the ranges
    each package calibrates agree within RANGE_TOL, and from the same
    ranges the two quantization passes write the same bytes."""
    gj, gt = _both("coverage-int8")
    ds = representative_dataset(gt)
    want = jax_exporter.calibrate(jax_exporter.strip_training_ops(gj), ds)
    got = torch_exporter.calibrate(torch_exporter.strip_training_ops(gt), ds)
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=RANGE_TOL,
                                   atol=RANGE_TOL)
    monkeypatch.setattr(torch_exporter, "calibrate",
                        lambda gb, dataset: want)
    blob = torch_core.export(gt, ds, quantize_int8=True)
    assert blob == jax_core.export(gj, ds, quantize_int8=True)
    opcodes = {op.opcode for op in torch_core.MicroModel(blob).operators}
    quantizable = torch_exporter._QUANTIZABLE
    assert opcodes - quantizable == {torch_core.OpCode.QUANTIZE,
                                     torch_core.OpCode.DEQUANTIZE}
    O = torch_core.OpCode
    assert {O.ADD, O.SUB, O.MUL, O.AVERAGE_POOL_2D, O.RELU, O.RELU6,
            O.LOGISTIC, O.TANH, O.CONCATENATION, O.PAD,
            O.TRANSPOSE} <= opcodes


def _requests(model, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(N_REQUESTS):
        feeds = []
        for t in model.inputs:
            spec = model.tensor(t)
            if spec.dtype == "int32":       # token ids of a 50+ row table
                feeds.append(rng.integers(0, 50, spec.shape).astype(
                    np.int32))
            else:
                feeds.append(rng.normal(0, 1, spec.shape).astype(
                    np.float32))
        reqs.append(feeds)
    return reqs


def _serve(it, requests, n_out):
    outs = []
    for feeds in requests:
        for pos, x in enumerate(feeds):
            it.set_input(pos, x)
        it.invoke()
        outs.append([np.array(it.output(k)) for k in range(n_out)])
    return outs


def _blob(name):
    gj = GRAPHS[name](jax_core.GraphBuilder)
    if name == "coverage-int8":
        return jax_core.export(gj, representative_dataset(gj),
                               quantize_int8=True)
    # build(): IDENTITY and DROPOUT reach the interpreters
    return gj.build() if name == "coverage" else jax_core.export(gj)


@pytest.mark.parametrize("tags", TAG_PAIRS, ids=["reference", "cuda"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_interpreters_agree(name, tags):
    """The same blob through each package's interpreter: int8 outputs
    bit-equal, float within FLOAT_TOL, arena accounting identical."""
    blob = _blob(name)
    jtags, ttags = tags
    mj, mt = jax_core.MicroModel(blob), torch_core.MicroModel(blob)
    rj = jax_core.AllOpsResolver(tags=jtags)
    rt = torch_core.AllOpsResolver(tags=ttags)
    itj = jax_core.MicroInterpreter(
        mj, rj, jax_core.MicroInterpreter.required_arena_size(mj, rj))
    itt = torch_core.MicroInterpreter(
        mt, rt, torch_core.MicroInterpreter.required_arena_size(mt, rt),
        device="cpu")
    reqs = _requests(mt, seed=len(name))
    n_out = len(mt.outputs)
    for want, got in zip(_serve(itj, reqs, n_out), _serve(itt, reqs, n_out)):
        for w, g in zip(want, got):
            assert g.shape == w.shape and np.isfinite(g).all()
            if name == "coverage-int8":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=FLOAT_TOL,
                                           rtol=FLOAT_TOL)
    assert itt.arena_used_bytes() == itj.arena_used_bytes()


def test_dropout_stripped_and_constants_folded():
    """tests/test_system.py's ``traindebris`` graph in the port: DROPOUT
    and IDENTITY are stripped, the ADD of two consts folds into one
    const, and the folded model computes softmax(x @ (a + b)^T)."""
    rng = np.random.default_rng(2)
    gb = torch_core.GraphBuilder("traindebris")
    x = gb.input("x", (1, 8))
    a = gb.const(rng.normal(0, 1, (4, 8)).astype(np.float32), "a")
    b = gb.const(rng.normal(0, 1, (4, 8)).astype(np.float32), "b")
    h = gb.fully_connected(x, gb.add(a, b))
    h = gb.identity(gb.dropout(h, rate=0.5))
    gb.mark_output(gb.softmax(h))
    n_ops_before = len(gb.ops)
    model = torch_core.MicroModel(torch_core.export(gb))
    opcodes = [op.opcode for op in model.operators]
    O = torch_core.OpCode
    assert O.DROPOUT not in opcodes and O.IDENTITY not in opcodes
    assert O.ADD not in opcodes                     # folded
    assert len(opcodes) == n_ops_before - 3
    w = model.const_data(model.operators[0].inputs[1])
    np.testing.assert_array_equal(w, gb.const_data[a.index]
                                  + gb.const_data[b.index])
    res = torch_core.AllOpsResolver()
    it = torch_core.MicroInterpreter(
        model, res, torch_core.MicroInterpreter.required_arena_size(
            model, res), device="cpu")
    xin = rng.normal(0, 1, (1, 8)).astype(np.float32)
    it.set_input(0, xin)
    it.invoke()
    want = torch.softmax(torch.from_numpy(xin) @ torch.tensor(w).T,
                         dim=-1).numpy()
    np.testing.assert_allclose(it.output(0), want, rtol=1e-5, atol=1e-6)
