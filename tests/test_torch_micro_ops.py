"""Each of the port's reference ops (every micro opcode the JAX package
registers) against the JAX package's op of the same opcode: the same
single-op graph, built with each package's GraphBuilder, prepared by
each package's prepare() and evaluated by each package's eval() on the
same seeded inputs.  int8 results must be identical; float results
agree within FLOAT_TOL."""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
from repro.core import quantize as JQ
from repro.core.executor import EvalContext as JaxEvalContext
from repro.core.graph_builder import _BuilderPrepareCtx as JaxPrepCtx
from repro.core.op_resolver import resolve_chain as jax_resolve

import repro_torch.core as torch_core
from repro_torch.core.executor import EvalContext as TorchEvalContext
from repro_torch.core.graph_builder import _BuilderPrepareCtx as TorchPrepCtx
from repro_torch.core.op_resolver import resolve_chain as torch_resolve

# float32 results of the same formula differ only in summation order and
# in the transcendental's last ulp; outputs here are O(1).  GELU, ROPE,
# RSQRT, EXP, LOGISTIC, TANH and the matmuls agree within 5e-7 on these
# inputs (a few ulps), so one bound serves every op.
FLOAT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_alias():
    """Alias ``jax.experimental.enable_x64`` (moved to ``jax.enable_x64``
    in newer jax) for this module's tests only; a no-op where it exists."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        yield


def _run_jax(gb, feeds):
    op = gb.ops[-1]
    reg = jax_resolve(op.opcode, ("reference",))
    prep = reg.prepare(JaxPrepCtx(gb), op)
    ectx = JaxEvalContext(prep.op_data, prep.output_specs,
                          [gb.tensors[t].quant for t in op.outputs])
    vals = [None if t < 0 else jnp.asarray(
        gb.const_data[t] if t in gb.const_data else feeds[t])
        for t in op.inputs]
    with JQ.x64_scope():
        return [np.asarray(o) for o in reg.eval(ectx, op, vals)]


def _run_torch(gb, feeds):
    op = gb.ops[-1]
    reg = torch_resolve(op.opcode, ("reference",))
    prep = reg.prepare(TorchPrepCtx(gb), op)
    ectx = TorchEvalContext(prep.op_data, prep.output_specs,
                            [gb.tensors[t].quant for t in op.outputs])
    vals = [None if t < 0 else torch.from_numpy(np.array(
        gb.const_data[t] if t in gb.const_data else feeds[t]))
        for t in op.inputs]
    return [o.numpy() for o in reg.eval(ectx, op, vals)]


def _int8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _f32(rng, shape, sd=1.0):
    return rng.normal(0, sd, shape).astype(np.float32)


# -- single-op graphs: each builder takes a package's ``core`` and a seeded
#    rng, and returns (graph, {tensor index: input value}) ----------------

def _conv(core, rng, int8, stride, padding, act, dilation=1):
    gb = core.GraphBuilder("conv")
    if int8:
        x = gb.input("x", (1, 9, 9, 3), "int8", core.QuantParams(0.05, 3))
        w = gb.const(_int8(rng, (4, 3, 3, 3)), "w", core.QuantParams(
            0.0, 0, rng.uniform(1e-3, 1e-2, 4).astype(np.float32), 0))
        b = gb.const(rng.integers(-2000, 2000, 4).astype(np.int32), "b")
        out_q = core.QuantParams(0.08, -7)
        feeds = {x.index: _int8(rng, (1, 9, 9, 3))}
    else:
        x = gb.input("x", (1, 9, 9, 3))
        w = gb.const(_f32(rng, (4, 3, 3, 3), 0.4), "w")
        b = gb.const(_f32(rng, (4,), 0.1), "b")
        out_q = None
        feeds = {x.index: _f32(rng, (1, 9, 9, 3))}
    gb.conv2d(x, w, b, stride=stride, padding=padding, activation=act,
              dilation=dilation, out_quant=out_q)
    return gb, feeds


def _depthwise(core, rng, int8, stride, padding, act, mult=1):
    gb = core.GraphBuilder("dw")
    c = 5
    if int8:
        x = gb.input("x", (1, 8, 8, c), "int8", core.QuantParams(0.04, -10))
        w = gb.const(_int8(rng, (1, 3, 3, c * mult)), "w", core.QuantParams(
            0.0, 0, rng.uniform(1e-3, 1e-2, c * mult).astype(np.float32), 3))
        b = gb.const(rng.integers(-500, 500, c * mult).astype(np.int32), "b")
        out_q = core.QuantParams(0.03, 5)
        feeds = {x.index: _int8(rng, (1, 8, 8, c))}
    else:
        x = gb.input("x", (1, 8, 8, c))
        w = gb.const(_f32(rng, (1, 3, 3, c * mult), 0.3), "w")
        b = gb.const(_f32(rng, (c * mult,), 0.1), "b")
        out_q = None
        feeds = {x.index: _f32(rng, (1, 8, 8, c))}
    gb.depthwise_conv2d(x, w, b, stride=stride, padding=padding,
                        activation=act, depth_multiplier=mult,
                        out_quant=out_q)
    return gb, feeds


def _fc(core, rng, int8, act):
    gb = core.GraphBuilder("fc")
    if int8:
        x = gb.input("x", (3, 40), "int8", core.QuantParams(0.02, 12))
        w = gb.const(_int8(rng, (24, 40)), "w", core.QuantParams(
            0.0, 0, rng.uniform(1e-3, 1e-2, 24).astype(np.float32), 0))
        b = gb.const(rng.integers(-3000, 3000, 24).astype(np.int32), "b")
        out_q = core.QuantParams(0.05, -3)
        feeds = {x.index: _int8(rng, (3, 40))}
    else:
        x = gb.input("x", (3, 40))
        w = gb.const(_f32(rng, (24, 40), 0.2), "w")
        b = gb.const(_f32(rng, (24,), 0.1), "b")
        out_q = None
        feeds = {x.index: _f32(rng, (3, 40))}
    gb.fully_connected(x, w, b, activation=act, out_quant=out_q)
    return gb, feeds


def _unary(method, **params):
    def build(core, rng, int8):
        gb = core.GraphBuilder(method)
        shape = (2, 6, 6, 4)
        if int8:
            x = gb.input("x", shape, "int8", core.QuantParams(0.07, -20))
            feeds = {x.index: _int8(rng, shape)}
            params_q = dict(params, out_quant=core.QuantParams(0.02, 9))
        else:
            x = gb.input("x", shape)
            feeds = {x.index: _f32(rng, shape)}
            params_q = params
        getattr(gb, method)(x, **params_q)
        return gb, feeds
    return build


def _softmax(core, rng, int8):
    gb = core.GraphBuilder("softmax")
    if int8:
        x = gb.input("x", (4, 10), "int8", core.QuantParams(0.1, 4))
        feeds = {x.index: _int8(rng, (4, 10))}
        gb.softmax(x, beta=0.7, out_quant=core.QuantParams(1 / 256, -128))
    else:
        x = gb.input("x", (4, 10))
        feeds = {x.index: _f32(rng, (4, 10), 3.0)}
        gb.softmax(x, beta=0.7)
    return gb, feeds


def _quantize_op(core, rng, int8):
    gb = core.GraphBuilder("quantize")
    x = gb.input("x", (5, 33))
    gb.quantize(x, 0.013, -6)
    return gb, {x.index: _f32(rng, (5, 33), 1.5)}


def _dequantize_op(core, rng, int8):
    gb = core.GraphBuilder("dequantize")
    x = gb.input("x", (5, 33), "int8", core.QuantParams(0.013, -6))
    gb.dequantize(x)
    return gb, {x.index: _int8(rng, (5, 33))}


def _svdf(core, rng, int8, bias=True):
    gb = core.GraphBuilder("svdf")
    f, units, rank, mem = 12, 6, 2, 5
    nf = units * rank
    x = gb.input("x", (2, f))
    wf = gb.const(_f32(rng, (nf, f), 0.3), "wf")
    wt = gb.const(_f32(rng, (nf, mem), 0.3), "wt")
    b = gb.const(_f32(rng, (units,), 0.1), "b") if bias else None
    st = gb.variable("state", (2, nf * mem))
    gb.svdf(x, wf, wt, b, st, rank=rank, activation="relu")
    return gb, {x.index: _f32(rng, (2, f)),
                st.index: _f32(rng, (2, nf * mem))}


def _attention(core, rng, int8, causal):
    gb = core.GraphBuilder("attn")
    shape = (2, 3, 16, 8)
    q, k, v = (gb.input(n, shape) for n in "qkv")
    gb.attention(q, k, v, causal=causal)
    return gb, {t.index: _f32(rng, shape) for t in (q, k, v)}



# -- the ops of ROADMAP item 1 ------------------------------------------------

SHAPE = (2, 6, 6, 4)


def _graph(shapes, make, positive=False):
    """A graph of one op over model inputs of ``shapes`` (int8 inputs with
    distinct quant params, or float32), added by ``make(gb, core, xs,
    out_quant)``; ``positive`` feeds float values in [0.1, 3)."""
    def build(core, rng, int8):
        gb = core.GraphBuilder("op")
        xs, feeds = [], {}
        for i, shape in enumerate(shapes):
            if int8:
                x = gb.input(f"x{i}", shape, "int8",
                             core.QuantParams(0.07 - 0.02 * i, 13 * i - 20))
                feeds[x.index] = _int8(rng, shape)
            else:
                x = gb.input(f"x{i}", shape)
                feeds[x.index] = (rng.uniform(0.1, 3.0, shape).astype(
                    np.float32) if positive else _f32(rng, shape))
            xs.append(x)
        make(gb, core, xs, core.QuantParams(0.09, -3) if int8 else None)
        return gb, feeds
    return build


def _raw(opcode, n_out=1, quant=True, **params):
    """An op through the builder's ``_infer_and_add``, as the reference
    builds the ops that have no sugar."""
    def make(gb, core, xs, oq):
        kw = {"out_quant": oq} if quant else {}
        return gb._infer_and_add(getattr(core.OpCode, opcode),
                                 [x.index for x in xs], params,
                                 n_outputs=n_out, **kw)
    return make


def _sugar(method, quant=True, **params):
    def make(gb, core, xs, oq):
        kw = {"out_quant": oq} if quant else {}
        return getattr(gb, method)(*xs, **params, **kw)
    return make


def _unary_op(opcode, positive=False):
    return _graph([SHAPE], lambda gb, core, xs, oq: gb.unary(
        getattr(core.OpCode, opcode), xs[0], out_quant=oq),
        positive=positive)


def _with_consts(shapes, consts, make):
    """A float graph of one op over inputs of ``shapes`` then seeded float
    consts of ``consts`` shapes."""
    def build(core, rng, int8):
        gb = core.GraphBuilder("op")
        xs = [gb.input(f"x{i}", s) for i, s in enumerate(shapes)]
        feeds = {x.index: _f32(rng, s) for x, s in zip(xs, shapes)}
        cs = [gb.const(_f32(rng, s, 0.5), f"c{i}")
              for i, s in enumerate(consts)]
        make(gb, xs + cs)
        return gb, feeds
    return build


def _embedding(core, rng, int8):
    gb = core.GraphBuilder("embedding")
    ids = gb.input("ids", (2, 7), "int32")
    table = gb.const(_f32(rng, (50, 16)), "table")
    gb.embedding(ids, table)
    return gb, {ids.index: rng.integers(0, 50, (2, 7)).astype(np.int32)}


NEW_INT8_OPS = {
    "add": _graph([SHAPE, SHAPE], _sugar("add")),
    "add-relu-broadcast": _graph([SHAPE, (4,)], _sugar("add",
                                                       activation="relu")),
    "sub": _graph([SHAPE, SHAPE], _sugar("sub")),
    "mul": _graph([SHAPE, SHAPE], _sugar("mul")),
    "mul-broadcast": _graph([SHAPE, (1, 6, 1, 4)], _sugar("mul")),
    "minimum": _graph([SHAPE, SHAPE], _raw("MINIMUM")),
    "maximum": _graph([SHAPE, SHAPE], _raw("MAXIMUM")),
    "squared_difference": _graph([SHAPE, SHAPE],
                                 _raw("SQUARED_DIFFERENCE")),
    "avg_pool-valid": _unary("avg_pool2d", k=2),
    "avg_pool-same-k3-s2": _unary("avg_pool2d", k=3, stride=2,
                                  padding="SAME"),
    "transpose": _graph([SHAPE], _sugar("transpose", quant=False,
                                        perm=[0, 3, 1, 2])),
    "concat": _graph([SHAPE, (2, 6, 6, 3)], lambda gb, core, xs, oq:
                     gb.concat(xs, out_quant=oq)),
    "concat-axis1": _graph([SHAPE, (2, 2, 6, 4)], lambda gb, core, xs, oq:
                           gb.concat(xs, axis=1, out_quant=oq)),
    "pad": _graph([SHAPE], _raw("PAD", paddings=[[0, 0], [1, 2], [2, 1],
                                                 [0, 0]])),
    "strided_slice": _graph([SHAPE], _raw("STRIDED_SLICE",
                                          begin=[0, 1, 0, 1],
                                          end=[2, 6, 5, 4],
                                          strides=[1, 2, 2, 1])),
    "split": _graph([SHAPE], _raw("SPLIT", n_out=2, axis=-1)),
    "relu": _unary_op("RELU"),
    "relu6": _unary_op("RELU6"),
    "logistic": _unary_op("LOGISTIC"),
    "tanh": _unary_op("TANH"),
    "neg": _unary_op("NEG"),
    "leaky_relu": _unary_op("LEAKY_RELU"),
}
NEW_FLOAT_OPS = {
    "silu": _unary_op("SILU"),
    "gelu": _unary_op("GELU"),
    "rsqrt": _unary_op("RSQRT", positive=True),
    "exp": _unary_op("EXP"),
    "identity": _graph([SHAPE], _sugar("identity", quant=False)),
    "dropout": _graph([SHAPE], _sugar("dropout", quant=False)),
    "matmul": _with_consts([(2, 3, 5, 8)], [(8, 6)],
                           lambda gb, t: gb.matmul(*t)),
    "matmul-tb-batched": _with_consts([(2, 3, 5, 8)], [(3, 6, 8)],
                                      lambda gb, t: gb.matmul(
                                          *t, transpose_b=True)),
    "batch_matmul": _graph([(2, 5, 8), (2, 8, 6)], _raw("BATCH_MATMUL",
                                                        quant=False)),
    "rms_norm": _with_consts([(2, 6, 16)], [(16,)],
                             lambda gb, t: gb.rms_norm(*t)),
    "layer_norm": _with_consts([(2, 6, 16)], [(16,), (16,)],
                               lambda gb, t: gb.layer_norm(*t)),
    "rope": _graph([(2, 8, 3, 16)], _sugar("rope", quant=False)),
    "rope-base5e6": _graph([(1, 33, 2, 32)], _sugar("rope", quant=False,
                                                    base=5e6)),
    "embedding": _embedding,
}

OPS = {
    "conv2d-same-s2-relu6": lambda c, r, q: _conv(c, r, q, 2, "SAME",
                                                  "relu6"),
    "conv2d-valid-dil2-relu": lambda c, r, q: _conv(c, r, q, 1, "VALID",
                                                    "relu", dilation=2),
    "depthwise-same-s2-relu6": lambda c, r, q: _depthwise(c, r, q, 2,
                                                          "SAME", "relu6"),
    "depthwise-valid-mult2": lambda c, r, q: _depthwise(c, r, q, 1, "VALID",
                                                        "none", mult=2),
    "fc-relu": lambda c, r, q: _fc(c, r, q, "relu"),
    "fc-none": lambda c, r, q: _fc(c, r, q, "none"),
    "reshape": _unary("reshape", new_shape=[2, -1, 4]),
    "max_pool-valid": _unary("max_pool2d", k=2),
    "max_pool-same-k3-s2": _unary("max_pool2d", k=3, stride=2,
                                  padding="SAME"),
    "mean-hw": _unary("mean", axes=[1, 2]),
    "mean-keepdims": _unary("mean", axes=[2], keepdims=True),
    "softmax": _softmax,
}
OPS.update(NEW_INT8_OPS)
INT8_OPS = list(OPS)
OPS.update(NEW_FLOAT_OPS)
FLOAT_OPS = list(OPS) + ["svdf", "svdf-no-bias", "attention-causal",
                         "attention-full"]
OPS.update({
    "svdf": _svdf,
    "svdf-no-bias": lambda c, r, q: _svdf(c, r, q, bias=False),
    "attention-causal": lambda c, r, q: _attention(c, r, q, True),
    "attention-full": lambda c, r, q: _attention(c, r, q, False),
})


def _both(name, int8, seed=0):
    gj, feeds = OPS[name](jax_core, np.random.default_rng(seed), int8)
    gt, feeds_t = OPS[name](torch_core, np.random.default_rng(seed), int8)
    assert gj.tensors[-1].shape == gt.tensors[-1].shape
    for t in feeds:
        np.testing.assert_array_equal(feeds[t], feeds_t[t])
    return _run_jax(gj, feeds), _run_torch(gt, feeds)


@pytest.mark.parametrize("name", INT8_OPS)
def test_int8_op_identical(name):
    want, got = _both(name, int8=True)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == np.int8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", FLOAT_OPS)
def test_float_op_close(name):
    want, got = _both(name, int8=False)
    assert len(want) == len(got)        # SVDF also returns its new state
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.parametrize("name", ["quantize", "dequantize"])
def test_quantize_dequantize_identical(name):
    build = _quantize_op if name == "quantize" else _dequantize_op
    gj, feeds = build(jax_core, np.random.default_rng(5), True)
    gt, _ = build(torch_core, np.random.default_rng(5), True)
    (want,), (got,) = _run_jax(gj, feeds), _run_torch(gt, feeds)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["conv2d-same-s2-relu6",
                                  "depthwise-same-s2-relu6", "fc-relu",
                                  "max_pool-same-k3-s2", "mean-hw"]
                         + list(NEW_INT8_OPS) + list(NEW_FLOAT_OPS))
def test_prepare_accounting_identical(name):
    """Output specs, scratch and persistent bytes drive the arena plan, so
    they must match the JAX package exactly."""
    for int8 in (False, True):
        gj, _ = OPS[name](jax_core, np.random.default_rng(1), int8)
        gt, _ = OPS[name](torch_core, np.random.default_rng(1), int8)
        op = gj.ops[-1]
        pj = jax_resolve(op.opcode, ("reference",)).prepare(JaxPrepCtx(gj),
                                                            op)
        pt = torch_resolve(op.opcode, ("reference",)).prepare(
            TorchPrepCtx(gt), gt.ops[-1])
        assert [(s.shape, s.dtype) for s in pj.output_specs] == \
            [(s.shape, s.dtype) for s in pt.output_specs]
        assert pj.scratch_nbytes == pt.scratch_nbytes
        assert pj.persistent_nbytes == pt.persistent_nbytes


def test_all_ops_resolvers_link_the_same_opcodes():
    """Every micro opcode the JAX package registers is registered in the
    port, and each package's AllOpsResolver links the same set, under the
    reference tags and under the vendor tag chains."""
    import repro.kernels.ops  # noqa: F401  (the "pallas" tag)
    import repro_torch.kernels  # noqa: F401  (the "cuda" tag)

    def linked(core, tags):
        return {r.opcode for r in core.AllOpsResolver(tags=tags).linked_ops}
    want = linked(jax_core, ("reference",))
    assert len(want) == 41
    assert linked(torch_core, ("reference",)) == want
    assert linked(torch_core, ("cuda", "reference")) == \
        linked(jax_core, ("pallas", "reference")) == want


def test_embedding_out_of_range_ids_like_jnp_take():
    """Ids outside [0, V): -V..-1 count from the end and the rest give a
    NaN row, as the reference's ``jnp.take`` does, instead of an index
    error on the CPU or a fault on the card."""
    def build(core, rng, int8):
        gb = core.GraphBuilder("embedding")
        ids = gb.input("ids", (2, 4), "int32")
        gb.embedding(ids, gb.const(_f32(rng, (5, 3)), "table"))
        return gb, {ids.index: np.array([[0, 4, 5, -1], [-5, -6, 99, 2]],
                                        np.int32)}
    gj, feeds = build(jax_core, np.random.default_rng(0), False)
    gt, _ = build(torch_core, np.random.default_rng(0), False)
    (want,), (got,) = _run_jax(gj, feeds), _run_torch(gt, feeds)
    assert np.isnan(got[0, 2]).all() and not np.isnan(got[0, 3]).any()
    np.testing.assert_array_equal(got, want)
