"""µFB — the µFlow portable model serialization format.

The PyTorch package's own copy of ``repro.core.schema``: the blob layout
is the contract between the two packages, so this reader parses the
JAX exporter's bytes unchanged and the port's exporter writes the same
bytes.  It is the analogue of the TFLite FlatBuffer schema used by
TF Micro (paper §4.3).  Design goals copied from the paper:

  * a model is ONE contiguous binary blob ("memory-mapped representation"),
  * the accessor code reads tensor/op tables and constant buffers as
    zero-copy ``np.frombuffer`` views — no unpacking step,
  * operations are stored as a *topologically sorted list*, not a graph,
    so execution is "looping through the operation list in order",
  * the blob can be embedded as a Python source module (the paper converts
    FlatBuffers to C arrays for file-system-less targets),
  * arbitrary metadata (e.g. an offline memory plan, §4.4.2) rides along
    in a key/value metadata section.

Layout (little-endian):

    [Header][input idx table][output idx table][tensor table]
    [op table][string table][metadata table][buffer section (16B aligned)]

Operator *parameters* are stored as compact JSON bytes per op.  The paper
notes the serialized representation "requires a few code lines executed at
run time to convert from the serialized representation to the structure in
the underlying implementation" — the JSON decode at prepare time is exactly
that conversion cost, paid once at init, never during invoke.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"UFB1"
VERSION = 3
BUFFER_ALIGN = 16
MAX_RANK = 8

# ---------------------------------------------------------------------------
# dtype coding
# ---------------------------------------------------------------------------

_DTYPE_CODES: Dict[str, int] = {
    "float32": 0,
    "int8": 1,
    "int32": 2,
    "uint8": 3,
    "bool": 4,
    "int16": 5,
    "float16": 6,
    "bfloat16": 7,
    "int64": 8,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def dtype_code(dtype) -> int:
    name = np.dtype(dtype).name if str(dtype) != "bfloat16" else "bfloat16"
    if str(dtype) == "bfloat16":
        name = "bfloat16"
    try:
        return _DTYPE_CODES[name]
    except KeyError:
        raise ValueError(f"unsupported µFB dtype: {dtype!r}")


def code_dtype(code: int) -> str:
    return _CODE_DTYPES[code]


def dtype_itemsize(name: str) -> int:
    if name == "bfloat16":
        return 2
    return np.dtype(name).itemsize


# ---------------------------------------------------------------------------
# Opcodes (the subset of TFLite ops TF Micro-class models need, plus the
# transformer ops the pod path shares with the micro path)
# ---------------------------------------------------------------------------

class OpCode:
    """The serialized operator vocabulary (TFLite builtin-op analogue),
    including the pod-scale SERVING_* macro-ops."""

    CONV_2D = 0
    DEPTHWISE_CONV_2D = 1
    FULLY_CONNECTED = 2
    ADD = 3
    MUL = 4
    SUB = 5
    MAX_POOL_2D = 6
    AVERAGE_POOL_2D = 7
    RESHAPE = 8
    SOFTMAX = 9
    RELU = 10
    RELU6 = 11
    LOGISTIC = 12
    TANH = 13
    CONCATENATION = 14
    PAD = 15
    MEAN = 16
    QUANTIZE = 17
    DEQUANTIZE = 18
    SVDF = 19
    IDENTITY = 20
    DROPOUT = 21          # training-only; stripped by the exporter (§3.3)
    TRANSPOSE = 22
    MATMUL = 23
    RMS_NORM = 24
    LAYER_NORM = 25
    GELU = 26
    ROPE = 27
    ATTENTION = 28        # fused SDPA (micro-path transformer demo)
    SILU = 29
    EMBEDDING_LOOKUP = 30
    STRIDED_SLICE = 31
    SPLIT = 32
    BATCH_MATMUL = 33
    LEAKY_RELU = 34
    SQUARED_DIFFERENCE = 35
    RSQRT = 36
    EXP = 37
    NEG = 38
    MINIMUM = 39
    MAXIMUM = 40
    # serving macro-ops: the pod-scale engine resolves its compiled
    # prefill/decode steps through the same vendor-tag registry as the
    # micro kernels (§4.7–4.8), so TAGS=("pallas", "reference") swaps
    # optimized serving kernels in with no engine changes
    SERVING_PREFILL = 41
    SERVING_DECODE = 42
    SERVING_PREFILL_CHUNK = 43
    # paged-KV variants: same macro-ops over a physical block pool and
    # per-slot block tables instead of contiguous per-slot cache rows
    SERVING_DECODE_PAGED = 44
    SERVING_PREFILL_CHUNK_PAGED = 45
    # recurrent-state chunked prefill: the SSM/hybrid variant of
    # SERVING_PREFILL_CHUNK — a chunk boundary is a recurrent-state
    # checkpoint, so the carried (conv, ssd) state is a traced argument
    # alongside the chunk tokens and the true (unpadded) chunk length
    SERVING_PREFILL_CHUNK_STATE = 46
    # quantized serving: the same prefill/decode macro-ops over an
    # int8/int4 weight tree (and optionally an int8 KV cache) — the
    # quantization layout (weight dtype, KV dtype, paged-ness) rides
    # the OpDef params, so two opcodes cover the whole quantized matrix
    SERVING_PREFILL_Q = 47
    SERVING_DECODE_Q = 48


# Pod-scale macro-ops: resolvable through the tag chain but never part
# of a µFB graph, so AllOpsResolver must not link them (they would
# distort the Table-2 code-size accounting depending on import order).
SERVING_OPCODES = frozenset({OpCode.SERVING_PREFILL,
                             OpCode.SERVING_DECODE,
                             OpCode.SERVING_PREFILL_CHUNK,
                             OpCode.SERVING_DECODE_PAGED,
                             OpCode.SERVING_PREFILL_CHUNK_PAGED,
                             OpCode.SERVING_PREFILL_CHUNK_STATE,
                             OpCode.SERVING_PREFILL_Q,
                             OpCode.SERVING_DECODE_Q})


OP_NAMES = {v: k for k, v in vars(OpCode).items() if not k.startswith("_")}


# ---------------------------------------------------------------------------
# Tensor flags
# ---------------------------------------------------------------------------

class TensorFlags:
    """Bit flags classifying a tensor's storage class: const (flash),
    variable (persistent state), model input/output."""

    NONE = 0
    IS_CONST = 1          # weights/bias: data lives in the model blob (flash)
    IS_VARIABLE = 2       # persistent state (e.g. SVDF activation state)
    IS_MODEL_INPUT = 4
    IS_MODEL_OUTPUT = 8


@dataclass
class QuantParams:
    """TFLM-style quantization parameters (symmetric per-channel weights,
    asymmetric per-tensor activations)."""
    scale: float = 0.0
    zero_point: int = 0
    channel_scales: Optional[np.ndarray] = None   # float32[C] or None
    quantized_dimension: int = 0

    @property
    def is_quantized(self) -> bool:
        return self.scale != 0.0 or self.channel_scales is not None

    @property
    def is_per_channel(self) -> bool:
        return self.channel_scales is not None


@dataclass
class TensorDef:
    """Serialized tensor record: name, shape, dtype, storage-class
    flags, and quantization parameters."""

    name: str
    shape: Tuple[int, ...]
    dtype: str                       # numpy-style name, or "bfloat16"
    flags: int = TensorFlags.NONE
    quant: QuantParams = field(default_factory=QuantParams)
    # Filled by serialization for const tensors:
    buffer_offset: int = 0
    buffer_nbytes: int = 0

    @property
    def is_const(self) -> bool:
        return bool(self.flags & TensorFlags.IS_CONST)

    @property
    def is_variable(self) -> bool:
        return bool(self.flags & TensorFlags.IS_VARIABLE)

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * dtype_itemsize(self.dtype)


@dataclass
class OpDef:
    """Serialized operator record: opcode, input/output tensor indices
    (-1 marks an optional absent input), and builtin params."""

    opcode: int
    inputs: Tuple[int, ...]          # tensor indices; -1 == optional-absent
    outputs: Tuple[int, ...]
    params: Dict[str, Any] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return OP_NAMES.get(self.opcode, f"OP_{self.opcode}")


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

_HEADER = struct.Struct(
    "<4sI"     # magic, version
    "IIII"     # n_tensors, n_ops, n_inputs, n_outputs
    "QQQQQQ"   # off: tensor_tbl, op_tbl, string_tbl, metadata_tbl, buffers, total
)

# fixed-size tensor record:
#   dtype u8 | rank u8 | flags u16 | quant_dim i32
#   shape i32[MAX_RANK]
#   buffer_offset u64 | buffer_nbytes u64
#   scale f64 | zero_point i32 | n_channel_scales u32
#   channel_scales_offset u64
#   name_offset u32 | name_len u32
_TENSOR_REC = struct.Struct("<BBHi" + "i" * MAX_RANK + "QQdiIQII")


def _align(n: int, a: int = BUFFER_ALIGN) -> int:
    return (n + a - 1) & ~(a - 1)


class ModelBuilderBuffers:
    """Accumulates the const-buffer section with alignment."""

    def __init__(self) -> None:
        self._chunks: List[bytes] = []
        self._size = 0

    def add(self, data: bytes) -> Tuple[int, int]:
        pad = _align(self._size) - self._size
        if pad:
            self._chunks.append(b"\0" * pad)
            self._size += pad
        off = self._size
        self._chunks.append(data)
        self._size += len(data)
        return off, len(data)

    def blob(self) -> bytes:
        return b"".join(self._chunks)


def serialize_model(
    tensors: Sequence[TensorDef],
    ops: Sequence[OpDef],
    inputs: Sequence[int],
    outputs: Sequence[int],
    const_data: Dict[int, np.ndarray],
    metadata: Optional[Dict[str, bytes]] = None,
) -> bytes:
    """Pack a model into a single µFB blob."""
    metadata = dict(metadata or {})
    bufs = ModelBuilderBuffers()

    # --- const buffers + per-channel scales ---
    tensor_channel_scale_off: Dict[int, int] = {}
    tensors = [TensorDef(t.name, tuple(int(d) for d in t.shape), t.dtype,
                         t.flags, t.quant, 0, 0) for t in tensors]
    for idx, t in enumerate(tensors):
        if idx in const_data:
            arr = const_data[idx]
            raw = np.ascontiguousarray(arr)
            if t.dtype == "bfloat16":
                raw = raw.view(np.uint8)
            off, n = bufs.add(raw.tobytes())
            t.buffer_offset, t.buffer_nbytes = off, n
            t.flags |= TensorFlags.IS_CONST
        if t.quant.channel_scales is not None:
            cs = np.asarray(t.quant.channel_scales, np.float32)
            off, _ = bufs.add(cs.tobytes())
            tensor_channel_scale_off[idx] = off

    # --- string table ---
    strings = bytearray()
    name_pos: List[Tuple[int, int]] = []
    for t in tensors:
        b = t.name.encode()
        name_pos.append((len(strings), len(b)))
        strings += b

    # --- op table (variable records) ---
    op_blob = bytearray()
    for op in ops:
        pbytes = json.dumps(op.params, sort_keys=True,
                            separators=(",", ":")).encode()
        op_blob += struct.pack("<HBBI", op.opcode, len(op.inputs),
                               len(op.outputs), len(pbytes))
        op_blob += struct.pack(f"<{len(op.inputs)}i", *op.inputs)
        op_blob += struct.pack(f"<{len(op.outputs)}i", *op.outputs)
        op_blob += pbytes

    # --- metadata table ---
    md_blob = bytearray()
    md_blob += struct.pack("<I", len(metadata))
    for k, v in sorted(metadata.items()):
        kb = k.encode()
        md_blob += struct.pack("<II", len(kb), len(v)) + kb + v

    # --- tensor table ---
    t_blob = bytearray()
    for idx, t in enumerate(tensors):
        shape = list(t.shape) + [0] * (MAX_RANK - len(t.shape))
        ncs = (len(t.quant.channel_scales)
               if t.quant.channel_scales is not None else 0)
        t_blob += _TENSOR_REC.pack(
            dtype_code(t.dtype), len(t.shape), t.flags,
            t.quant.quantized_dimension, *shape,
            t.buffer_offset, t.buffer_nbytes,
            float(t.quant.scale), int(t.quant.zero_point), ncs,
            tensor_channel_scale_off.get(idx, 0),
            name_pos[idx][0], name_pos[idx][1],
        )

    # --- assemble ---
    io_blob = struct.pack(f"<{len(inputs)}i", *inputs)
    io_blob += struct.pack(f"<{len(outputs)}i", *outputs)

    pos = _HEADER.size
    pos += len(io_blob)
    tensor_tbl_off = pos
    pos += len(t_blob)
    op_tbl_off = pos
    pos += len(op_blob)
    string_tbl_off = pos
    pos += len(strings)
    metadata_tbl_off = pos
    pos += len(md_blob)
    buffers_off = _align(pos)
    pad = buffers_off - pos
    buffer_blob = bufs.blob()
    total = buffers_off + len(buffer_blob)

    header = _HEADER.pack(
        MAGIC, VERSION, len(tensors), len(ops), len(inputs), len(outputs),
        tensor_tbl_off, op_tbl_off, string_tbl_off, metadata_tbl_off,
        buffers_off, total,
    )
    blob = b"".join([header, io_blob, bytes(t_blob), bytes(op_blob),
                     bytes(strings), bytes(md_blob), b"\0" * pad,
                     buffer_blob])
    assert len(blob) == total
    return blob


# ---------------------------------------------------------------------------
# Zero-copy model accessor
# ---------------------------------------------------------------------------

class MicroModel:
    """Zero-copy accessor over a µFB blob.

    Constant tensor data is exposed as ``np.frombuffer`` views into the blob
    — the analogue of TF Micro reading weights directly out of the
    memory-mapped FlatBuffer in flash, with no unpacking.
    """

    def __init__(self, blob: bytes):
        self._blob = blob
        (magic, version, n_tensors, n_ops, n_inputs, n_outputs,
         t_off, o_off, s_off, m_off, b_off, total) = _HEADER.unpack_from(blob, 0)
        if magic != MAGIC:
            raise ValueError("not a µFB model (bad magic)")
        if version != VERSION:
            raise ValueError(f"µFB version mismatch: {version} != {VERSION}")
        if total != len(blob):
            raise ValueError("truncated µFB blob")
        self.version = version
        pos = _HEADER.size
        self.inputs: Tuple[int, ...] = struct.unpack_from(
            f"<{n_inputs}i", blob, pos)
        pos += 4 * n_inputs
        self.outputs: Tuple[int, ...] = struct.unpack_from(
            f"<{n_outputs}i", blob, pos)
        self._t_off, self._o_off, self._s_off = t_off, o_off, m_off and s_off
        self._m_off, self._b_off = m_off, b_off
        self._n_tensors, self._n_ops = n_tensors, n_ops
        self._tensors: List[TensorDef] = []
        self._ops: List[OpDef] = []
        self._parse_tensors(s_off)
        self._parse_ops(o_off)
        self.metadata = self._parse_metadata(m_off)

    # -- parsing (init-phase only; invoke never touches the blob again) ----

    def _parse_tensors(self, s_off: int) -> None:
        blob = self._blob
        for i in range(self._n_tensors):
            rec = _TENSOR_REC.unpack_from(blob, self._t_off + i * _TENSOR_REC.size)
            (dcode, rank, flags, qdim) = rec[0:4]
            shape = tuple(rec[4:4 + rank])
            buffer_offset, buffer_nbytes = rec[4 + MAX_RANK: 6 + MAX_RANK]
            scale, zp, ncs, cs_off, name_off, name_len = rec[6 + MAX_RANK:]
            name = blob[s_off + name_off: s_off + name_off + name_len].decode()
            channel_scales = None
            if ncs:
                channel_scales = np.frombuffer(
                    blob, np.float32, count=ncs, offset=self._b_off + cs_off)
            q = QuantParams(scale, zp, channel_scales, qdim)
            self._tensors.append(TensorDef(
                name, shape, code_dtype(dcode), flags, q,
                buffer_offset, buffer_nbytes))

    def _parse_ops(self, o_off: int) -> None:
        blob, pos = self._blob, o_off
        for _ in range(self._n_ops):
            opcode, n_in, n_out, plen = struct.unpack_from("<HBBI", blob, pos)
            pos += 8
            ins = struct.unpack_from(f"<{n_in}i", blob, pos)
            pos += 4 * n_in
            outs = struct.unpack_from(f"<{n_out}i", blob, pos)
            pos += 4 * n_out
            params = json.loads(blob[pos:pos + plen].decode()) if plen else {}
            pos += plen
            self._ops.append(OpDef(opcode, ins, outs, params))

    def _parse_metadata(self, m_off: int) -> Dict[str, bytes]:
        blob, pos = self._blob, m_off
        (n,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        md = {}
        for _ in range(n):
            klen, vlen = struct.unpack_from("<II", blob, pos)
            pos += 8
            k = blob[pos:pos + klen].decode()
            pos += klen
            md[k] = blob[pos:pos + vlen]
            pos += vlen
        return md

    # -- accessors ----------------------------------------------------------

    @property
    def tensors(self) -> List[TensorDef]:
        return self._tensors

    @property
    def operators(self) -> List[OpDef]:
        return self._ops

    def tensor(self, i: int) -> TensorDef:
        return self._tensors[i]

    def const_data(self, i: int) -> np.ndarray:
        """Zero-copy view of a const tensor's data inside the blob.

        numpy has no bfloat16, so a bfloat16 tensor comes back as its
        raw ``uint16`` container; ``torch.Tensor.view(torch.bfloat16)``
        reinterprets it."""
        t = self._tensors[i]
        if not t.is_const:
            raise ValueError(f"tensor {i} ({t.name}) is not const")
        if t.dtype == "bfloat16":
            raw = np.frombuffer(self._blob, np.uint16,
                                count=t.buffer_nbytes // 2,
                                offset=self._b_off + t.buffer_offset)
            return raw.reshape(t.shape)
        arr = np.frombuffer(self._blob, np.dtype(t.dtype),
                            count=t.nbytes // dtype_itemsize(t.dtype),
                            offset=self._b_off + t.buffer_offset)
        return arr.reshape(t.shape)

    @property
    def blob(self) -> bytes:
        return self._blob

    def nbytes(self) -> int:
        return len(self._blob)

    def summary(self) -> str:
        lines = [f"µFB model: {self._n_tensors} tensors, {self._n_ops} ops, "
                 f"{len(self._blob)} bytes"]
        for i, op in enumerate(self._ops):
            lines.append(f"  [{i:3d}] {op.name:<18s} in={list(op.inputs)} "
                         f"out={list(op.outputs)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# "C array" embedding (paper §4.3.1: convert model files into compilable
# source for file-system-less targets)
# ---------------------------------------------------------------------------

def model_to_source(blob: bytes, var_name: str = "g_model") -> str:
    """Render a µFB blob as an importable Python source module, the analogue
    of TFLM's xxd-style C-array embedding."""
    import base64

    b64 = base64.b64encode(blob).decode()
    chunks = [b64[i:i + 76] for i in range(0, len(b64), 76)]
    body = "\n".join(f'    "{c}"' for c in chunks)
    return (
        "# Auto-generated µFB model (paper §4.3.1 'C array' analogue).\n"
        "import base64\n\n"
        f"{var_name}_len = {len(blob)}\n"
        f"{var_name} = base64.b64decode(\n{body}\n)\n"
    )
