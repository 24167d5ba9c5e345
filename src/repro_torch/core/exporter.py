"""Exporter — the Figure-1 conversion pipeline (the TFLite-converter
analogue).

Takes a GraphBuilder model (the "trained TensorFlow model" stand-in) and
produces a deployable µFB blob, applying the passes the paper attributes
to the TensorFlow Lite toolchain (§3.3):

  * ``strip_training_ops``  — removes DROPOUT / IDENTITY ("removing
    dropout and similar operations that are only useful during training"),
  * ``fold_constants``      — "folding constant expressions into fixed
    values",
  * ``quantize``            — post-training INT8 quantization with a
    representative dataset (Krishnamoorthi 2018), per-channel weights,
    int32 biases, calibrated activation ranges,
  * optional offline memory planning embedded as metadata (§4.4.2).

The exporter is the offline toolchain: constant folding and calibration
run the port's reference ops on the CPU, whatever device the exported
model later runs on.  Float calibration ranges may differ from the JAX
exporter's by float rounding; the float blob is byte-identical.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import quantize as Q
from .executor import EvalContext
from .graph_builder import (GraphBuilder, _BuilderPrepareCtx,
                            _shape_inference_resolver)
from .schema import OpCode, OpDef, QuantParams, TensorDef, TensorFlags

_PASSTHROUGH_OPS = {OpCode.DROPOUT, OpCode.IDENTITY}

# ops whose int8 path exists in the reference kernels
_QUANTIZABLE = {
    OpCode.CONV_2D, OpCode.DEPTHWISE_CONV_2D, OpCode.FULLY_CONNECTED,
    OpCode.ADD, OpCode.MUL, OpCode.SUB, OpCode.MAX_POOL_2D,
    OpCode.AVERAGE_POOL_2D, OpCode.RESHAPE, OpCode.MEAN, OpCode.SOFTMAX,
    OpCode.RELU, OpCode.RELU6, OpCode.LOGISTIC, OpCode.TANH,
    OpCode.CONCATENATION, OpCode.PAD, OpCode.TRANSPOSE,
}


def _run_reference_op(gb: GraphBuilder, op: OpDef, values):
    """Prepare and evaluate one op on CPU tensors; returns the prepare
    result and the op's output tensors (outputs, then variable updates)."""
    reg = _shape_inference_resolver().resolve(op.opcode)
    prep = reg.prepare(_BuilderPrepareCtx(gb), op)
    ectx = EvalContext(prep.op_data, prep.output_specs,
                       [gb.tensors[t].quant for t in op.outputs])
    ins = [None if v is None else torch.from_numpy(np.array(v))
           for v in values]
    return prep, reg.eval(ectx, op, ins)


# ---------------------------------------------------------------------------
# pass: strip training-only ops
# ---------------------------------------------------------------------------

def strip_training_ops(gb: GraphBuilder) -> GraphBuilder:
    """Remove DROPOUT/IDENTITY by rewiring consumers to the op's input."""
    alias: Dict[int, int] = {}

    def resolve(t: int) -> int:
        while t in alias:
            t = alias[t]
        return t

    new_ops: List[OpDef] = []
    for op in gb.ops:
        if op.opcode in _PASSTHROUGH_OPS:
            alias[op.outputs[0]] = op.inputs[0]
            continue
        new_ops.append(OpDef(
            op.opcode,
            tuple(resolve(t) if t >= 0 else t for t in op.inputs),
            op.outputs, dict(op.params)))
    gb2 = _clone(gb)
    gb2.ops = new_ops
    gb2.outputs = [resolve(t) for t in gb.outputs]
    for t in gb2.outputs:
        gb2.tensors[t].flags |= TensorFlags.IS_MODEL_OUTPUT
    return _garbage_collect(gb2)


# ---------------------------------------------------------------------------
# pass: constant folding
# ---------------------------------------------------------------------------

def fold_constants(gb: GraphBuilder) -> GraphBuilder:
    """Evaluate ops whose inputs are all const; bake results as consts."""
    gb2 = _clone(gb)
    changed = True
    while changed:
        changed = False
        remaining: List[OpDef] = []
        for op in gb2.ops:
            ins = [t for t in op.inputs if t >= 0]
            if ins and all(t in gb2.const_data for t in ins) \
                    and not any(gb2.tensors[t].is_variable for t in ins) \
                    and op.opcode != OpCode.QUANTIZE:
                _, outs = _run_reference_op(
                    gb2, op, [gb2.const_data[t] if t >= 0 else None
                              for t in op.inputs])
                for t, v in zip(op.outputs, outs[:len(op.outputs)]):
                    gb2.const_data[t] = v.numpy()
                    gb2.tensors[t].flags |= TensorFlags.IS_CONST
                changed = True
            else:
                remaining.append(op)
        gb2.ops = remaining
    return _garbage_collect(gb2)


# ---------------------------------------------------------------------------
# pass: post-training INT8 quantization
# ---------------------------------------------------------------------------

def calibrate(gb: GraphBuilder,
              representative_dataset: Iterable[Sequence[np.ndarray]],
              ) -> Dict[int, Tuple[float, float]]:
    """Run the float graph over a representative dataset, recording
    min/max per tensor (the TFLite calibration step)."""
    ranges: Dict[int, Tuple[float, float]] = {}

    def note(t: int, v) -> None:
        v = np.asarray(v, np.float32)
        lo, hi = float(v.min()), float(v.max())
        if t in ranges:
            plo, phi = ranges[t]
            ranges[t] = (min(lo, plo), max(hi, phi))
        else:
            ranges[t] = (lo, hi)

    for sample in representative_dataset:
        env: Dict[int, np.ndarray] = dict(gb.const_data)
        var_env: Dict[int, np.ndarray] = {
            i: np.zeros(t.shape, np.float32)
            for i, t in enumerate(gb.tensors) if t.is_variable}
        for pos, t in enumerate(gb.inputs):
            env[t] = np.asarray(sample[pos], np.float32)
            note(t, env[t])
        for op in gb.ops:
            vals = [None if t < 0 else var_env[t] if t in var_env
                    else env[t] for t in op.inputs]
            prep, outs = _run_reference_op(gb, op, vals)
            for t, v in zip(op.outputs, outs[:len(op.outputs)]):
                env[t] = v.numpy()
                note(t, env[t])
            for t, v in zip(prep.variable_updates,
                            outs[len(op.outputs):]):
                var_env[t] = v.numpy()
    return ranges


def quantize(gb: GraphBuilder,
             representative_dataset: Iterable[Sequence[np.ndarray]],
             float_io: bool = True) -> GraphBuilder:
    """Whole-graph post-training INT8 quantization."""
    for op in gb.ops:
        if op.opcode not in _QUANTIZABLE:
            raise NotImplementedError(
                f"op {op.name} has no int8 path; the exporter would need "
                f"a float fallback island (TFLite selective quantization)")
    ranges = calibrate(gb, representative_dataset)

    q = GraphBuilder(gb.name + "_int8")
    q.metadata = dict(gb.metadata)
    tmap: Dict[int, int] = {}

    def act_quant(t: int) -> QuantParams:
        if gb.ops and _producer_opcode(gb, t) == OpCode.SOFTMAX:
            return QuantParams(1.0 / 256.0, -128)    # TFLite convention
        lo, hi = ranges.get(t, (-1.0, 1.0))
        s, z = Q.choose_quant_params(lo, hi)
        return QuantParams(s, z)

    # tensors
    for i, t in enumerate(gb.tensors):
        if t.is_const:
            continue                                  # handled per-use
        q.tensors.append(TensorDef(t.name, t.shape, "int8", t.flags,
                                   act_quant(i)))
        tmap[i] = len(q.tensors) - 1

    # weights/bias per consuming op (per-channel for conv/fc kernels)
    for op in gb.ops:
        new_ins: List[int] = []
        if op.opcode in (OpCode.CONV_2D, OpCode.DEPTHWISE_CONV_2D,
                         OpCode.FULLY_CONNECTED):
            x_t, w_t = op.inputs[0], op.inputs[1]
            b_t = op.inputs[2] if len(op.inputs) > 2 else None
            w = gb.const_data[w_t]
            ch_axis = (3 if op.opcode == OpCode.DEPTHWISE_CONV_2D else 0)
            wq, wscales = Q.quantize_weights_per_channel(w, ch_axis)
            q.tensors.append(TensorDef(gb.tensors[w_t].name, w.shape, "int8",
                                       TensorFlags.IS_CONST,
                                       QuantParams(0.0, 0, wscales,
                                                   ch_axis)))
            wq_idx = len(q.tensors) - 1
            q.const_data[wq_idx] = wq
            new_ins = [tmap[x_t], wq_idx]
            if b_t is not None and b_t >= 0:
                x_scale = q.tensors[tmap[x_t]].quant.scale
                bq = Q.quantize_bias(gb.const_data[b_t], x_scale, wscales)
                q.tensors.append(TensorDef(gb.tensors[b_t].name, bq.shape,
                                           "int32", TensorFlags.IS_CONST,
                                           QuantParams()))
                q.const_data[len(q.tensors) - 1] = bq
                new_ins.append(len(q.tensors) - 1)
        else:
            for t in op.inputs:
                if t < 0:
                    new_ins.append(t)
                elif t in gb.const_data:
                    c = gb.const_data[t]
                    s, z = Q.choose_quant_params(float(c.min()),
                                                 float(c.max()))
                    q.tensors.append(TensorDef(gb.tensors[t].name, c.shape,
                                               "int8", TensorFlags.IS_CONST,
                                               QuantParams(s, z)))
                    q.const_data[len(q.tensors) - 1] = \
                        Q.quantize_array(c, s, z)
                    new_ins.append(len(q.tensors) - 1)
                else:
                    new_ins.append(tmap[t])
        q.ops.append(OpDef(op.opcode, tuple(new_ins),
                           tuple(tmap[t] for t in op.outputs),
                           dict(op.params)))

    q.inputs = [tmap[t] for t in gb.inputs]
    q.outputs = [tmap[t] for t in gb.outputs]

    if float_io:
        _wrap_float_io(q)
    return q


def _wrap_float_io(q: GraphBuilder) -> None:
    """Insert QUANTIZE after float inputs and DEQUANTIZE before outputs,
    keeping the application ABI in float (TFLite float_io converters)."""
    new_inputs = []
    pre_ops: List[OpDef] = []
    for t in q.inputs:
        spec = q.tensors[t]
        q.tensors.append(TensorDef(spec.name + "_f", spec.shape, "float32",
                                   TensorFlags.IS_MODEL_INPUT))
        fidx = len(q.tensors) - 1
        pre_ops.append(OpDef(OpCode.QUANTIZE, (fidx,), (t,), {}))
        q.tensors[t].flags &= ~TensorFlags.IS_MODEL_INPUT
        new_inputs.append(fidx)
    post_ops: List[OpDef] = []
    new_outputs = []
    for t in q.outputs:
        spec = q.tensors[t]
        q.tensors.append(TensorDef(spec.name + "_f", spec.shape, "float32",
                                   TensorFlags.IS_MODEL_OUTPUT))
        fidx = len(q.tensors) - 1
        post_ops.append(OpDef(OpCode.DEQUANTIZE, (t,), (fidx,), {}))
        q.tensors[t].flags &= ~TensorFlags.IS_MODEL_OUTPUT
        new_outputs.append(fidx)
    q.ops = pre_ops + q.ops + post_ops
    q.inputs = new_inputs
    q.outputs = new_outputs


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------

def _producer_opcode(gb: GraphBuilder, t: int) -> Optional[int]:
    for op in gb.ops:
        if t in op.outputs:
            return op.opcode
    return None


def _clone(gb: GraphBuilder) -> GraphBuilder:
    gb2 = GraphBuilder(gb.name)
    gb2.tensors = [TensorDef(t.name, t.shape, t.dtype, t.flags, t.quant)
                   for t in gb.tensors]
    gb2.ops = [OpDef(o.opcode, o.inputs, o.outputs, dict(o.params))
               for o in gb.ops]
    gb2.const_data = dict(gb.const_data)
    gb2.inputs = list(gb.inputs)
    gb2.outputs = list(gb.outputs)
    gb2.metadata = dict(gb.metadata)
    return gb2


def _garbage_collect(gb: GraphBuilder) -> GraphBuilder:
    """Drop unreferenced tensors and reindex (keeps blobs small)."""
    live = set(gb.inputs) | set(gb.outputs)
    for op in gb.ops:
        live |= {t for t in op.inputs if t >= 0}
        live |= set(op.outputs)
    order = sorted(live)
    remap = {old: new for new, old in enumerate(order)}
    gb2 = GraphBuilder(gb.name)
    gb2.metadata = dict(gb.metadata)
    gb2.tensors = [gb.tensors[t] for t in order]
    gb2.const_data = {remap[t]: d for t, d in gb.const_data.items()
                      if t in remap}
    gb2.ops = [OpDef(o.opcode,
                     tuple(remap[t] if t >= 0 else t for t in o.inputs),
                     tuple(remap[t] for t in o.outputs), dict(o.params))
               for o in gb.ops]
    gb2.inputs = [remap[t] for t in gb.inputs]
    gb2.outputs = [remap[t] for t in gb.outputs]
    return gb2


# ---------------------------------------------------------------------------
# one-call export
# ---------------------------------------------------------------------------

def export(gb: GraphBuilder,
           representative_dataset=None,
           quantize_int8: bool = False,
           offline_plan: bool = False) -> bytes:
    """Figure-1 end-to-end: passes + serialization -> deployable blob."""
    gb = strip_training_ops(gb)
    gb = fold_constants(gb)
    if quantize_int8:
        if representative_dataset is None:
            raise ValueError("int8 export needs a representative dataset")
        gb = quantize(gb, representative_dataset)
    return gb.build(offline_plan=offline_plan)
