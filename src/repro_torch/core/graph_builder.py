"""GraphBuilder — the model-authoring front end feeding the exporter.

Plays the role of the TensorFlow/Keras training environment output in
Figure 1: users describe a model as a toposorted op graph; the exporter
(exporter.py) then applies conversion passes (constant folding, dropout
removal, post-training quantization) and serializes to µFB.

The port's copy of ``repro.core.graph_builder``: the same numpy graph and
the same serialization, so the same builder calls give the same blob.
Output shapes come from the port's reference ``prepare()`` functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .memory_planner import (GreedyMemoryPlanner, OfflineMemoryPlanner,
                             lifetimes_from_graph)
from .op_resolver import TensorSpec
from .schema import (MicroModel, OpCode, OpDef, QuantParams, TensorDef,
                     TensorFlags, dtype_itemsize, serialize_model)


@dataclass(frozen=True)
class TensorRef:
    """Lightweight handle to a tensor being built: its index in the
    graph plus a back-reference for shape/dtype lookups."""

    index: int
    builder: "GraphBuilder" = field(repr=False, compare=False, hash=False)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.builder.tensors[self.index].shape

    @property
    def dtype(self) -> str:
        return self.builder.tensors[self.index].dtype


class GraphBuilder:
    """Python-side model authoring API: declare inputs/consts/variables,
    chain ops (conv2d, fully_connected, svdf, ...), mark outputs — then
    ``build()`` serializes the graph into the µFB blob the interpreter
    loads."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.tensors: List[TensorDef] = []
        self.ops: List[OpDef] = []
        self.const_data: Dict[int, np.ndarray] = {}
        self.inputs: List[int] = []
        self.outputs: List[int] = []
        self.metadata: Dict[str, bytes] = {}

    # ------------------------------------------------------------------
    def _add_tensor(self, name, shape, dtype, flags=TensorFlags.NONE,
                    quant: Optional[QuantParams] = None) -> TensorRef:
        t = TensorDef(name, tuple(int(d) for d in shape), dtype, flags,
                      quant or QuantParams())
        self.tensors.append(t)
        return TensorRef(len(self.tensors) - 1, self)

    def input(self, name: str, shape, dtype="float32",
              quant: Optional[QuantParams] = None) -> TensorRef:
        r = self._add_tensor(name, shape, dtype,
                             TensorFlags.IS_MODEL_INPUT, quant)
        self.inputs.append(r.index)
        return r

    def const(self, data: np.ndarray, name: str = "const",
              quant: Optional[QuantParams] = None) -> TensorRef:
        data = np.asarray(data)
        r = self._add_tensor(name, data.shape, data.dtype.name,
                             TensorFlags.IS_CONST, quant)
        self.const_data[r.index] = data
        return r

    def variable(self, name: str, shape, dtype="float32") -> TensorRef:
        return self._add_tensor(name, shape, dtype, TensorFlags.IS_VARIABLE)

    def mark_output(self, ref: TensorRef) -> TensorRef:
        self.tensors[ref.index].flags |= TensorFlags.IS_MODEL_OUTPUT
        self.outputs.append(ref.index)
        return ref

    # ------------------------------------------------------------------
    def _infer_and_add(self, opcode: int, inputs: Sequence[int],
                       params: Dict[str, Any], n_outputs: int = 1,
                       out_dtype: Optional[str] = None,
                       out_quant: Optional[QuantParams] = None
                       ) -> Union[TensorRef, List[TensorRef]]:
        """Run the registered prepare() to infer output shapes, then add
        the op + its output tensors."""
        reg = _shape_inference_resolver().resolve(opcode)
        prep = reg.prepare(_BuilderPrepareCtx(self), _FakeOp(
            opcode, tuple(inputs), tuple([-2] * n_outputs), params))
        outs = []
        for k, spec in enumerate(prep.output_specs):
            dt = out_dtype or spec.dtype
            r = self._add_tensor(f"{reg.name}.{len(self.ops)}.{k}",
                                 spec.shape, dt, quant=out_quant)
            outs.append(r)
        self.ops.append(OpDef(opcode, tuple(inputs),
                              tuple(r.index for r in outs), dict(params)))
        return outs[0] if n_outputs == 1 else outs

    # -- op sugar ---------------------------------------------------------
    def conv2d(self, x, w, b=None, stride=1, padding="SAME",
               dilation=1, activation="none", out_quant=None):
        s = (stride, stride) if isinstance(stride, int) else stride
        d = (dilation, dilation) if isinstance(dilation, int) else dilation
        ins = [x.index, w.index] + ([b.index] if b is not None else [])
        return self._infer_and_add(
            OpCode.CONV_2D, ins,
            dict(stride_h=s[0], stride_w=s[1], dilation_h=d[0],
                 dilation_w=d[1], padding=padding, activation=activation),
            out_quant=out_quant)

    def depthwise_conv2d(self, x, w, b=None, stride=1, padding="SAME",
                         activation="none", depth_multiplier=1,
                         out_quant=None):
        s = (stride, stride) if isinstance(stride, int) else stride
        ins = [x.index, w.index] + ([b.index] if b is not None else [])
        return self._infer_and_add(
            OpCode.DEPTHWISE_CONV_2D, ins,
            dict(stride_h=s[0], stride_w=s[1], padding=padding,
                 activation=activation, depth_multiplier=depth_multiplier),
            out_quant=out_quant)

    def fully_connected(self, x, w, b=None, activation="none",
                        out_quant=None):
        ins = [x.index, w.index] + ([b.index] if b is not None else [])
        return self._infer_and_add(OpCode.FULLY_CONNECTED, ins,
                                   dict(activation=activation),
                                   out_quant=out_quant)

    def svdf(self, x, w_feature, w_time, bias, state, rank=1,
             activation="relu"):
        ins = [x.index, w_feature.index, w_time.index,
               bias.index if bias is not None else -1, state.index]
        return self._infer_and_add(OpCode.SVDF, ins,
                                   dict(rank=rank, activation=activation))

    def add(self, a, b, activation="none", out_quant=None):
        return self._infer_and_add(OpCode.ADD, [a.index, b.index],
                                   dict(activation=activation),
                                   out_quant=out_quant)

    def mul(self, a, b, out_quant=None):
        return self._infer_and_add(OpCode.MUL, [a.index, b.index], {},
                                   out_quant=out_quant)

    def sub(self, a, b, out_quant=None):
        return self._infer_and_add(OpCode.SUB, [a.index, b.index], {},
                                   out_quant=out_quant)

    def max_pool2d(self, x, k=2, stride=None, padding="VALID",
                   out_quant=None):
        stride = stride or k
        return self._infer_and_add(
            OpCode.MAX_POOL_2D, [x.index],
            dict(filter_h=k, filter_w=k, stride_h=stride, stride_w=stride,
                 padding=padding), out_quant=out_quant)

    def avg_pool2d(self, x, k=2, stride=None, padding="VALID",
                   out_quant=None):
        stride = stride or k
        return self._infer_and_add(
            OpCode.AVERAGE_POOL_2D, [x.index],
            dict(filter_h=k, filter_w=k, stride_h=stride, stride_w=stride,
                 padding=padding), out_quant=out_quant)

    def reshape(self, x, new_shape, out_quant=None):
        return self._infer_and_add(OpCode.RESHAPE, [x.index],
                                   dict(new_shape=list(new_shape)),
                                   out_quant=out_quant)

    def transpose(self, x, perm):
        return self._infer_and_add(OpCode.TRANSPOSE, [x.index],
                                   dict(perm=list(perm)))

    def concat(self, xs, axis=-1, out_quant=None):
        return self._infer_and_add(OpCode.CONCATENATION,
                                   [x.index for x in xs], dict(axis=axis),
                                   out_quant=out_quant)

    def mean(self, x, axes, keepdims=False, out_quant=None):
        return self._infer_and_add(OpCode.MEAN, [x.index],
                                   dict(axes=list(axes), keepdims=keepdims),
                                   out_quant=out_quant)

    def softmax(self, x, beta=1.0, out_quant=None):
        return self._infer_and_add(OpCode.SOFTMAX, [x.index],
                                   dict(beta=beta), out_quant=out_quant)

    def unary(self, opcode, x, out_quant=None, **params):
        return self._infer_and_add(opcode, [x.index], params,
                                   out_quant=out_quant)

    def relu(self, x, out_quant=None):
        return self.unary(OpCode.RELU, x, out_quant)

    def dropout(self, x, rate=0.5):
        return self._infer_and_add(OpCode.DROPOUT, [x.index],
                                   dict(rate=rate))

    def identity(self, x):
        return self._infer_and_add(OpCode.IDENTITY, [x.index], {})

    def quantize(self, x, scale, zero_point):
        q = QuantParams(scale, zero_point)
        return self._infer_and_add(OpCode.QUANTIZE, [x.index], {},
                                   out_dtype="int8", out_quant=q)

    def dequantize(self, x):
        return self._infer_and_add(OpCode.DEQUANTIZE, [x.index], {},
                                   out_dtype="float32")

    def matmul(self, a, b, transpose_b=False):
        return self._infer_and_add(OpCode.MATMUL, [a.index, b.index],
                                   dict(transpose_b=transpose_b))

    def rms_norm(self, x, gamma, eps=1e-6):
        return self._infer_and_add(OpCode.RMS_NORM, [x.index, gamma.index],
                                   dict(eps=eps))

    def layer_norm(self, x, gamma, beta, eps=1e-5):
        return self._infer_and_add(
            OpCode.LAYER_NORM, [x.index, gamma.index, beta.index],
            dict(eps=eps))

    def gelu(self, x):
        return self.unary(OpCode.GELU, x)

    def silu(self, x):
        return self.unary(OpCode.SILU, x)

    def rope(self, x, base=10000.0):
        return self._infer_and_add(OpCode.ROPE, [x.index], dict(base=base))

    def attention(self, q, k, v, causal=True):
        return self._infer_and_add(
            OpCode.ATTENTION, [q.index, k.index, v.index],
            dict(causal=causal))

    def embedding(self, ids, table):
        return self._infer_and_add(OpCode.EMBEDDING_LOOKUP,
                                   [ids.index, table.index], {})

    # ------------------------------------------------------------------
    def build(self, offline_plan: bool = False) -> bytes:
        """Serialize to µFB.  With ``offline_plan=True``, a host-side
        memory plan is embedded as metadata (§4.4.2 offline-planned
        allocation)."""
        metadata = dict(self.metadata)
        if offline_plan:
            nbytes = {}
            for i, t in enumerate(self.tensors):
                if not t.is_const and not t.is_variable:
                    n = 1
                    for d in t.shape:
                        n *= d
                    nbytes[i] = n * dtype_itemsize(t.dtype)
            # scratch is op-local and planned online even under an
            # offline tensor plan (TFLM), so the offline plan omits it
            requests, _ = lifetimes_from_graph(
                len(self.ops), [op.inputs for op in self.ops],
                [op.outputs for op in self.ops], nbytes,
                self.inputs, self.outputs, None)
            plan = GreedyMemoryPlanner().plan(requests)
            metadata[OfflineMemoryPlanner.METADATA_KEY] = plan.to_metadata()
        return serialize_model(self.tensors, self.ops, self.inputs,
                               self.outputs, self.const_data, metadata)

    def build_model(self, **kw) -> MicroModel:
        return MicroModel(self.build(**kw))


# ---------------------------------------------------------------------------
# shape-inference plumbing reusing the reference kernels' prepare()
# ---------------------------------------------------------------------------

@dataclass
class _FakeOp:
    opcode: int
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    params: Dict[str, Any]


class _BuilderPrepareCtx:
    """Prepare context over a graph being built.  The exporter also runs
    the reference ops through it (constant folding, calibration), always
    on the CPU."""

    device = "cpu"

    def __init__(self, gb: GraphBuilder):
        self._gb = gb

    def tensor_spec(self, idx: int) -> TensorSpec:
        t = self._gb.tensors[idx]
        return TensorSpec(t.shape, t.dtype)

    def quant(self, idx: int) -> QuantParams:
        if idx == -2:
            return QuantParams(1.0, 0)       # placeholder for outputs
        return self._gb.tensors[idx].quant

    def const_value(self, idx: int):
        return self._gb.const_data.get(idx)

    def is_const(self, idx: int) -> bool:
        return idx in self._gb.const_data


_CACHED_RESOLVER = None


def _shape_inference_resolver():
    global _CACHED_RESOLVER
    if _CACHED_RESOLVER is None:
        from . import micro_ops  # noqa: F401  (registers reference ops)
        from .op_resolver import AllOpsResolver
        _CACHED_RESOLVER = AllOpsResolver()
    return _CACHED_RESOLVER
