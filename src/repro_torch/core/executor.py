"""Plan-once/execute-many execution layer (paper §4.1–4.2), micro half.

The paper's discipline — pay ALL planning cost at init so that
steady-state invoke is pure dispatch — as a pipeline of phases:

  1. **AllocationPlan** (plan): walk the op list once, run each
     kernel's prepare(), derive tensor lifetimes, bin-pack the
     nonpersistent arena section with the memory planner, freeze the
     two-stack arena, and move the model's const tensors (its weights)
     from the blob onto the device once.  Nothing is planned after this.

  2. **CompiledPlan** (execute): the arena read/dispatch/write loop over
     the topologically sorted op list, one ``CapturedProgram`` per model:
     on the card one CUDA graph per input signature, captured after one
     eager call and replayed from then on.  The arena is ONE
     preallocated ``torch.uint8`` tensor on the device; every planned
     tensor is a ``.view(dtype).view(shape)`` of it at its planned byte
     offset (``DEFAULT_ALIGN = 16`` keeps every view aligned), and each
     op's result is copied into its output's slot.

  3. **dispatch**: ``MicroInterpreter`` (the paper's application API)
     feeds inputs in and reads outputs back.

**Compile once.**  ``CapturedProgram`` is the port's counterpart of
``jax.jit``: a function run as one CUDA graph per signature (the shapes,
dtypes and addresses of its tensor inputs), and ``capture_count`` the
counterpart of ``jit_cache_size``.  ``disable_capture()`` is the
counterpart of ``jax.disable_jit()``.

**Arena pooling.**  ``ArenaPool`` owns the physical nonpersistent byte
buffer that interpreters sharing an arena (§4.5) recycle between
non-concurrent invocations.  It allocates during warm-up only, which
``alloc_count`` makes observable and testable.

**Length bucketing.**  ``BucketTable`` quantizes ragged sizes to a few
levels; the serving engine pads prompts to them (bucketed prefill).

**Paged KV accounting.**  ``PagedKVPool`` hands out the physical blocks
of the serving engine's paged KV pool (reserve at admission, map on
growth, release at retirement).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .arena import TwoStackArena, align_up
from .memory_planner import MemoryPlan, plan_nonpersistent, select_planner
from .op_resolver import MicroMutableOpResolver, TensorSpec
from .schema import MicroModel, QuantParams

# TFLM persistent-arena runtime records (TfLiteTensor ≈ 64 B, node ≈ 48 B);
# accounted the same way as the JAX package so arena sizes are identical.
TENSOR_RUNTIME_NBYTES = 64
NODE_RUNTIME_NBYTES = 48

_TORCH_DTYPES = {
    "float32": torch.float32, "int8": torch.int8, "int32": torch.int32,
    "uint8": torch.uint8, "bool": torch.bool, "int16": torch.int16,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64,
}


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def _spec_nbytes(spec: TensorSpec) -> int:
    n = 1
    for d in spec.shape:
        n *= int(d)
    return n * _itemsize(spec.dtype)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` with no card raises:
    nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain reference path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # the card tensors land on, so devices compare equal to theirs
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def const_to_device(arr: np.ndarray, dtype: str,
                    device: torch.device) -> torch.Tensor:
    """One const tensor from its (read-only) blob view onto ``device``."""
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


# ---------------------------------------------------------------------------
# contexts handed to kernel prepare()/eval() (the TFLM C-API analogue)
# ---------------------------------------------------------------------------

class PrepareContext:
    """Init-phase context handed to each kernel's ``prepare()`` — the
    analogue of TFLM's ``TfLiteContext`` during AllocateTensors: tensor
    specs, quantization params, const values (numpy, read-only), and the
    device that baked constants must live on."""

    def __init__(self, model: MicroModel, specs: List[TensorSpec],
                 device: torch.device):
        self._model = model
        self._specs = specs
        self.device = device

    def tensor_spec(self, idx: int) -> TensorSpec:
        return self._specs[idx]

    def quant(self, idx: int) -> QuantParams:
        return self._model.tensor(idx).quant

    def const_value(self, idx: int) -> Optional[np.ndarray]:
        t = self._model.tensor(idx)
        return self._model.const_data(idx) if t.is_const else None

    def is_const(self, idx: int) -> bool:
        return self._model.tensor(idx).is_const


class EvalContext:
    """Invoke-phase context handed to each kernel's ``eval()``: the
    ``op_data`` its prepare() baked plus output specs/quant params, all
    fixed at init."""

    __slots__ = ("op_data", "_out_specs", "_out_quants")

    def __init__(self, op_data, out_specs, out_quants):
        self.op_data = op_data
        self._out_specs = out_specs
        self._out_quants = out_quants

    def output_shape(self, k: int) -> Tuple[int, ...]:
        return self._out_specs[k].shape

    def quant_of_output(self, k: int) -> QuantParams:
        return self._out_quants[k]


@dataclass
class OpPlan:
    """One prepared op: its definition, resolved kernel registration,
    prepare() result, and the EvalContext eval() will receive."""

    op: Any                               # schema.OpDef
    registration: Any                     # OpRegistration
    prep: Any                             # PrepareResult
    eval_ctx: EvalContext


# ---------------------------------------------------------------------------
# phase 1: AllocationPlan
# ---------------------------------------------------------------------------

class AllocationPlan:
    """Everything the init phase decides: prepared ops, tensor specs,
    frozen arena layout, the memory plan, and the model's const tensors
    on the device.  Immutable after build()."""

    def __init__(self) -> None:
        self.model: MicroModel = None           # type: ignore[assignment]
        self.resolver: MicroMutableOpResolver = None  # type: ignore
        self.arena: TwoStackArena = None        # type: ignore[assignment]
        self.device = torch.device("cpu")
        self.specs: List[TensorSpec] = []
        self.const_pos: Dict[int, int] = {}
        self.var_pos: Dict[int, int] = {}
        self.tensor_offset: Dict[int, int] = {}
        self.consts: List[torch.Tensor] = []
        self.var_specs: List[TensorSpec] = []
        self.op_plans: List[OpPlan] = []
        self.plan: MemoryPlan = None            # type: ignore[assignment]
        self.scratch_bytes = 0
        self.planner_name = ""

    @classmethod
    def build(cls, model: MicroModel, resolver: MicroMutableOpResolver,
              arena: TwoStackArena, planner: Optional[object] = None,
              prefer_offline_plan: bool = True,
              device="cuda") -> "AllocationPlan":
        self = cls()
        self.model, self.resolver, self.arena = model, resolver, arena
        self.device = resolve_device(device)
        m = model

        # 0. initial specs from the serialized model
        for t in m.tensors:
            self.specs.append(TensorSpec(t.shape, t.dtype))

        # 1. persistent runtime records (tensor structs + node structs)
        arena.allocate_persistent(
            TENSOR_RUNTIME_NBYTES * len(m.tensors), "tensor_structs")
        arena.allocate_persistent(
            NODE_RUNTIME_NBYTES * len(m.operators), "node_structs")

        # 2. const tensors -> the device, once; variables -> tail
        for i, t in enumerate(m.tensors):
            if t.is_const:
                self.const_pos[i] = len(self.consts)
                self.consts.append(
                    const_to_device(m.const_data(i), t.dtype, self.device))
            elif t.is_variable:
                self.var_pos[i] = len(self.var_specs)
                arena.allocate_persistent(t.nbytes, f"variable{i}")
                self.var_specs.append(TensorSpec(t.shape, t.dtype))

        # 3. prepare each op in topological order
        pctx = PrepareContext(m, self.specs, self.device)
        scratch: Dict[int, List[int]] = {}
        for oi, op in enumerate(m.operators):
            reg = resolver.resolve(op.opcode)
            # planning-time temp (paper: the between-stack temp region)
            arena.allocate_temp(256)
            prep = reg.prepare(pctx, op)
            arena.reset_temp()
            if prep.persistent_nbytes:
                arena.allocate_persistent(
                    prep.persistent_nbytes, f"opdata{oi}")
            if len(prep.output_specs) != len(op.outputs):
                raise ValueError(
                    f"{reg.name}: prepare produced {len(prep.output_specs)}"
                    f" specs for {len(op.outputs)} outputs")
            for t, spec in zip(op.outputs, prep.output_specs):
                declared = self.specs[t]
                if tuple(declared.shape) != tuple(spec.shape):
                    raise ValueError(
                        f"op {oi} ({reg.name}): computed output shape "
                        f"{spec.shape} != serialized {declared.shape}")
                self.specs[t] = spec
            if prep.scratch_nbytes:
                scratch[oi] = list(prep.scratch_nbytes)
            out_quants = [m.tensor(t).quant for t in op.outputs]
            ectx = EvalContext(prep.op_data,
                               [self.specs[t] for t in op.outputs],
                               out_quants)
            self.op_plans.append(OpPlan(op, reg, prep, ectx))

        # 4. lifetimes + memory plan for the nonpersistent section
        planned_nbytes = {
            i: _spec_nbytes(self.specs[i])
            for i, t in enumerate(m.tensors)
            if not t.is_const and not t.is_variable}
        planner = select_planner(m.metadata, planner, prefer_offline_plan)
        self.planner_name = getattr(planner, "name", type(planner).__name__)
        self.plan, self.tensor_offset, self.scratch_bytes = \
            plan_nonpersistent(
                [op.inputs for op in m.operators],
                [op.outputs for op in m.operators],
                planned_nbytes, m.inputs, m.outputs, scratch, planner)

        # 5. reserve the planned section on the head stack and freeze
        arena.reserve_nonpersistent_section(
            self.plan.total_bytes + self.scratch_bytes)
        arena.freeze()
        return self

    @property
    def nonpersistent_nbytes(self) -> int:
        """Physical bytes the pooled arena buffer must provide."""
        return self.plan.total_bytes

    def zero_variables(self) -> List[torch.Tensor]:
        """Fresh zero-initialised variable tensors on the device."""
        return [torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                            device=self.device) for s in self.var_specs]


def required_arena_size(model: MicroModel,
                        resolver: MicroMutableOpResolver,
                        slack: int = 1024) -> int:
    """Probe build on a throwaway oversized arena to size the real one
    (every prepare() runs on the CPU)."""
    probe = TwoStackArena(1 << 30)
    AllocationPlan.build(model, resolver, probe, device="cpu")
    return align_up(probe.usage().total + slack)


def plan_model(model: MicroModel, resolver: MicroMutableOpResolver,
               arena_size_bytes: Optional[int] = None,
               planner: Optional[object] = None,
               prefer_offline_plan: bool = True,
               host_arena: Optional[TwoStackArena] = None,
               device="cuda") -> AllocationPlan:
    """Build an AllocationPlan in a fresh self-sized arena, or — when
    ``host_arena`` is given — as a tenant of a shared arena (§4.5):
    persistents stack under the host's, the nonpersistent head section
    is shared (fork, build, absorb).  ``device`` defaults to ``"cuda"``
    and raises with no card, as ``MicroInterpreter`` does."""
    device = resolve_device(device)
    if host_arena is not None:
        arena = host_arena.fork_tenant()
    else:
        if arena_size_bytes is None:
            arena_size_bytes = required_arena_size(model, resolver)
        arena = TwoStackArena(arena_size_bytes)
    alloc = AllocationPlan.build(model, resolver, arena, planner,
                                 prefer_offline_plan, device)
    if host_arena is not None:
        host_arena.absorb_tenant(arena)
    return alloc


# ---------------------------------------------------------------------------
# compile once: one CUDA-graph capture per program signature
# ---------------------------------------------------------------------------

_capture_disabled = 0


class disable_capture:
    """The counterpart of ``jax.disable_jit()``, a context manager (like
    ``torch.no_grad``, reusable): inside the block every
    ``CapturedProgram`` runs its function eagerly, op by op, and records
    no signature.  The eager side of a replay-against-eager comparison
    runs here."""

    def __enter__(self) -> "disable_capture":
        global _capture_disabled
        _capture_disabled += 1
        return self

    def __exit__(self, *exc) -> None:
        global _capture_disabled
        _capture_disabled -= 1


def _leaf_key(leaf) -> Any:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device,
                tuple(leaf.stride()), leaf.data_ptr())
    return leaf


def _add_launches(counts: Dict[str, int], sign: int = 1) -> None:
    """Add ``counts`` to the kernels' launch counts (``kernels._build``;
    imported here, as the kernel package imports this one)."""
    from repro_torch.kernels import _build
    for name, n in counts.items():
        _build.launches[name] += sign * n


class GraphPool:
    """One CUDA-graph memory pool and the side stream its programs warm
    up and capture on.  The programs of one pool share its memory: a
    capture reuses the blocks the earlier captures freed, so the pool
    holds the largest program's temporaries, not their sum.  That is
    safe because replays run one at a time on the caller's stream and a
    program's outputs are copied out of the pool (``CapturedProgram``),
    so no replay reads what another left in the pool.  One pool serves
    one owner (a serving engine, an interpreter)."""

    def __init__(self) -> None:
        self.handle = None
        self.stream = None

    def bind(self, device: torch.device) -> "GraphPool":
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.handle = torch.cuda.graph_pool_handle()
        return self


@dataclass
class _Graph:
    graph: Any                  # torch.cuda.CUDAGraph
    outputs: Any                # what a replay returns
    launches: Dict[str, int]    # kernel launches a replay makes


class CapturedProgram:
    """``fn`` as one program per signature — the port's ``jax.jit``.

    A signature is the argument structure and, for each tensor
    argument, its shape, dtype, strides, device and address; any other
    argument (a model, a flag) counts by its hash: value, or identity for
    a module.  Every tensor is a *bound buffer*: the program reads and
    writes it in place at its address, so a caller keeps its inputs at
    fixed addresses (static staging tensors it copies new values into)
    and gets one program however many calls it makes.

    On the card, the first call of a signature runs ``fn`` once eagerly
    on the pool's side stream (the call's result; it also builds the
    kernels, allocates their lasting buffers and warms the libraries, as
    torch's capture recipe asks), then captures ``fn`` into a
    ``torch.cuda.CUDAGraph`` (the capture runs nothing); every later call
    replays the graph.  On the CPU nothing is captured: each call runs
    ``fn`` eagerly and the signature is recorded all the same, so
    ``capture_count`` keeps its meaning there.  A failed capture or
    replay raises; nothing falls back to eager.  Inside
    ``disable_capture()`` every call runs eagerly and records nothing.

    Memory: the graphs live in ``pool`` (a ``GraphPool``, the program's
    own unless the owner shares one among its programs).  An output that
    is not an input (the bound buffers a step updates in place) is copied
    at the end of the graph into a buffer the program owns, one per
    output position and shape, shared by its signatures: a replay returns
    those buffers, valid until the next call of the program, so read or
    copy them first.  Nothing of a graph stays allocated in the pool, and
    a new signature adds no device memory once its output shapes were
    seen.  ``max_signatures`` bounds the graphs held: past it the least
    recently used one is dropped (``evictions``) and captured again if
    its signature returns.  ``clear()`` drops every graph (its buffers
    were rebound); ``captures`` counts every capture made, recaptures
    included, and ``capture_s`` the seconds they took, warm-up included.

    Launch counts: the capture's calls of the kernel wrappers launch
    nothing, so their counts are taken back, and each replay adds the
    launches its capture recorded."""

    def __init__(self, fn: Callable, name: str = "",
                 pool: Optional[GraphPool] = None,
                 max_signatures: Optional[int] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "program")
        self.pool = pool if pool is not None else GraphPool()
        self.max_signatures = max_signatures
        self._graphs: "OrderedDict[Any, Optional[_Graph]]" = OrderedDict()
        self._outs: Dict[Any, torch.Tensor] = {}
        self.captures = 0
        self.evictions = 0
        self.capture_s = 0.0

    def __repr__(self) -> str:
        return (f"CapturedProgram({self.name!r}, "
                f"{len(self._graphs)} signatures)")

    def clear(self) -> None:
        """Drop every signature and its graph."""
        self._graphs.clear()

    def __call__(self, *args):
        if _capture_disabled:
            return self.fn(*args)
        flat, spec = tree_flatten(args)
        key = (str(spec), tuple(_leaf_key(x) for x in flat))
        if key in self._graphs:
            self._graphs.move_to_end(key)
            entry = self._graphs[key]
            if entry is None:                       # the CPU: eager
                return self.fn(*args)
            entry.graph.replay()
            _add_launches(entry.launches)
            return entry.outputs
        device = next((x.device for x in flat
                       if isinstance(x, torch.Tensor)
                       and x.device.type == "cuda"), None)
        if device is None:
            self._hold(key, None)
            return self.fn(*args)
        return self._capture(key, args, flat, device)

    def _hold(self, key, entry: Optional[_Graph]) -> None:
        self._graphs[key] = entry
        if self.max_signatures and len(self._graphs) > self.max_signatures:
            self._graphs.popitem(last=False)
            self.evictions += 1

    def _capture(self, key, args, flat, device: torch.device):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        pool = self.pool.bind(device)
        current = torch.cuda.current_stream(device)
        pool.stream.wait_stream(current)
        with torch.cuda.stream(pool.stream):
            out = self.fn(*args)                    # the eager warm-up
        current.wait_stream(pool.stream)
        # the outputs that are no input go to the program's own buffers
        bound = {x.untyped_storage().data_ptr() for x in flat
                 if isinstance(x, torch.Tensor)}
        static, out_spec = tree_flatten(out)
        copied = [i for i, x in enumerate(static)
                  if isinstance(x, torch.Tensor)
                  and x.untyped_storage().data_ptr() not in bound]
        for i in copied:
            x = static[i]
            okey = (i, tuple(x.shape), x.dtype, tuple(x.stride()))
            if okey not in self._outs:
                self._outs[okey] = torch.empty_like(x)
            static[i] = self._outs[okey]
        before = dict(_build.launches)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream):
            res, _ = tree_flatten(self.fn(*args))
            for i in copied:
                static[i].copy_(res[i])
            del res
        recorded = {k: n - before[k] for k, n in _build.launches.items()
                    if n != before[k]}
        _add_launches(recorded, -1)
        self._hold(key, _Graph(graph, tree_unflatten(static, out_spec),
                               recorded))
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out


def capture_count(program: CapturedProgram) -> int:
    """How many distinct signatures ``program`` holds — the counterpart
    of the JAX package's ``jit_cache_size``: one CUDA graph per
    signature on the card, one recorded signature per eager signature on
    the CPU.  A compile-once contract reads ``capture_count(fn) == 1``
    however many calls were made."""
    return len(program._graphs)


# ---------------------------------------------------------------------------
# phase 2: CompiledPlan
# ---------------------------------------------------------------------------

class CompiledPlan:
    """The invoke body over a frozen AllocationPlan: one request per call,
    the op loop over the arena buffer's views run as one
    ``CapturedProgram`` (``program``) — one CUDA graph per (model, input
    shapes) on the card, bound to the arena buffer, the variable tensors
    and the caller's static input tensors.  When the arena pool hands
    out a new buffer, the graphs bound to the old one are dropped and the
    next call captures again."""

    def __init__(self, alloc: AllocationPlan):
        self.alloc = alloc
        self._bound: Optional[torch.Tensor] = None
        self._views: Dict[int, torch.Tensor] = {}
        self.program = CapturedProgram(self._run, name="invoke")

    def views(self, buf: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Typed, shaped views of every planned tensor inside ``buf``.
        Made once per physical buffer and reused while it stays the
        pool's buffer; a new buffer drops the programs bound to the old
        one."""
        if buf is not self._bound:
            views = {}
            for tid, off in self.alloc.tensor_offset.items():
                spec = self.alloc.specs[tid]
                raw = buf[off:off + _spec_nbytes(spec)]
                views[tid] = raw.view(torch_dtype(spec.dtype)).view(
                    spec.shape)
            if self._bound is not None:
                self.program.clear()
            self._bound, self._views = buf, views
        return self._views

    def execute(self, buf: torch.Tensor, variables: Sequence[torch.Tensor],
                inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Run every op once: on the card, replay the graph of this
        signature (captured at its first call).  ``inputs`` are copied
        into the arena inside the program, so pass tensors at fixed
        addresses; variable tensors are updated in place.  Returns the
        arena views of the model outputs."""
        self.views(buf)
        return self.program(buf, list(variables), list(inputs))

    def _run(self, buf: torch.Tensor, variables: List[torch.Tensor],
             inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        alloc = self.alloc
        views = self.views(buf)
        for pos, tid in enumerate(alloc.model.inputs):
            views[tid].copy_(inputs[pos])
        for opp in alloc.op_plans:
            op = opp.op
            in_tensors = []
            for t in op.inputs:
                if t < 0:
                    in_tensors.append(None)
                elif t in alloc.const_pos:
                    in_tensors.append(alloc.consts[alloc.const_pos[t]])
                elif t in alloc.var_pos:
                    in_tensors.append(variables[alloc.var_pos[t]])
                else:
                    in_tensors.append(views[t])
            outs = opp.registration.eval(opp.eval_ctx, op, in_tensors)
            n_out = len(op.outputs)
            for t, o in zip(op.outputs, outs[:n_out]):
                views[t].copy_(o.reshape(views[t].shape))
            for t, v in zip(opp.prep.variable_updates, outs[n_out:]):
                variables[alloc.var_pos[t]].copy_(v)
        return [views[t] for t in alloc.model.outputs]


# ---------------------------------------------------------------------------
# arena buffer pooling (§4.5: one physical buffer, many invocations)
# ---------------------------------------------------------------------------

class ArenaPool:
    """Owns the physical nonpersistent byte buffer that interpreters
    sharing an arena recycle between non-concurrent invocations.

    ``ensure`` grows the size every tenant needs; the buffer itself is
    made lazily on the first ``take`` after that, so after warm-up
    ``alloc_count`` stays constant — the malloc-free steady state,
    observable."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.nbytes = 0
        self.buf: Optional[torch.Tensor] = None
        self._taken = False
        self.alloc_count = 0

    def ensure(self, nbytes: int) -> None:
        """Grow the pooled buffer size (a smaller buffer is dropped, and
        each tenant's ``CompiledPlan`` drops the graphs bound to it at its
        next invoke)."""
        if nbytes > self.nbytes:
            self.nbytes = int(nbytes)
            self.buf = None

    def take(self) -> torch.Tensor:
        if self.nbytes <= 0:
            raise RuntimeError("ArenaPool.ensure() before take()")
        if self._taken:
            raise RuntimeError("arena buffer already taken "
                               "(concurrent invoke?)")
        self._taken = True
        if self.buf is None:
            self.alloc_count += 1
            self.buf = torch.zeros(self.nbytes, dtype=torch.uint8,
                                   device=self.device)
        return self.buf

    def put(self, buf: torch.Tensor) -> None:
        self._taken = False
        self.buf = buf


# ---------------------------------------------------------------------------
# length bucketing (a bounded set of shapes across ragged sizes)
# ---------------------------------------------------------------------------

class BucketTable:
    """Size quantization for every surface that must see few distinct
    shapes across ragged sizes (a copy of the JAX package's table).

    ``bucket(n)`` maps a size to the smallest table *level* that holds
    it, so the set of distinct shapes is O(#levels) instead of
    O(#sizes).  The level layout comes from one of two places:

      * **geometric** (the default): levels are ``min_bucket``
        multiplied by ``granularity`` (default 2 — power-of-two
        buckets) until ``max_bucket``;
      * **explicit** (``levels=``): an arbitrary ascending level list,
        such as a calibration cost model solves for from measured
        per-bucket costs (the cost model's layout methods come with
        it, ROADMAP queue 1, slice 7).

    Its consumer in the port is bucketed prefill: ``ServingEngine``
    pads each prompt to its bucket, so prefill runs at O(#levels)
    distinct shapes instead of one per prompt length (see
    docs/SCHEDULING.md for why padded rows cannot leak into decoded
    tokens).

    ``hits`` counts how many times each bucket was actually chosen by
    ``bucket()``.  Callers that may still reject the
    bucket (e.g. it does not fit their cache) probe with ``fit()``
    first, so a fallback never records a phantom bucket.  A size above
    ``max_bucket`` raises ``ValueError`` from ``bucket()``: capacity
    errors stay loud and immediate, like arena overflow.
    """

    def __init__(self, min_bucket: int = 16, max_bucket: int = 4096,
                 granularity: int = 2,
                 levels: Optional[Sequence[int]] = None):
        if levels is not None:
            if (min_bucket, max_bucket, granularity) != (16, 4096, 2):
                raise ValueError(
                    "pass either explicit levels or the geometric "
                    "(min_bucket, max_bucket, granularity) "
                    "parameters, not both — levels fully determine "
                    "the table")
            lv = [int(x) for x in levels]
            if not lv or sorted(set(lv)) != lv or lv[0] < 1:
                raise ValueError(
                    f"levels must be a non-empty strictly ascending "
                    f"sequence of positive ints, got {levels!r}")
        else:
            if min_bucket < 1 or max_bucket < min_bucket:
                raise ValueError((min_bucket, max_bucket))
            if granularity < 2 or int(granularity) != granularity:
                raise ValueError(
                    f"granularity must be an integer >= 2, got "
                    f"{granularity!r}")
            lv, b = [], int(min_bucket)
            while b <= max_bucket:
                lv.append(b)
                b *= int(granularity)
        self.levels: List[int] = lv
        self.min_bucket = lv[0]
        self.max_bucket = lv[-1]
        self.hits: Dict[int, int] = {}

    def __repr__(self) -> str:
        return f"BucketTable(levels={self.levels})"

    def fit(self, n: int) -> Optional[int]:
        """Smallest table bucket holding ``n``, or None when ``n``
        exceeds ``max_bucket`` — records nothing."""
        if n < 1:
            raise ValueError(f"size must be >= 1, got {n}")
        for b in self.levels:
            if b >= n:
                return b
        return None

    def bucket(self, n: int) -> int:
        """Smallest table bucket holding ``n`` (and count the hit)."""
        b = self.fit(n)
        if b is None:
            raise ValueError(
                f"size {n} exceeds max_bucket {self.max_bucket}")
        self.hits[b] = self.hits.get(b, 0) + 1
        return b


# ---------------------------------------------------------------------------
# paged KV block accounting (host side)
# ---------------------------------------------------------------------------

class PagedKVPool:
    """Host-side allocator for a pool of fixed-size physical KV blocks,
    a copy of the JAX package's (pure Python, no device state).

    The device tensors live elsewhere (the serving engine owns one
    ``(L, n_blocks, KH, block_size, dh)`` pool per K/V); this class
    owns only the *accounting*: which physical blocks are free, which
    are mapped into some slot's block table, and how many are
    **reserved** for admitted requests that have not grown into them
    yet.  The two-phase reserve/map split keeps mid-decode growth
    infallible: admission calls ``reserve(n)`` for the worst case the
    request can reach (prompt + decode budget, capped at the logical
    capacity), and every later ``map_block()`` debits that reservation,
    so once a request is admitted its decode loop can never die of pool
    exhaustion, and admission control is a single ``can_reserve``
    check.

    Block 0 is the **garbage sink**: it is never handed out, and every
    unmapped block-table entry points at it, so the decode step's
    unconditional ring write for inactive or mid-chunk slots lands in a
    block nothing reads under a positive weight.  The free list is LIFO.
    ``alloc_count`` counts map events."""

    GARBAGE_BLOCK = 0

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"need >= 2 physical blocks (one is the garbage "
                f"sink), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # LIFO free list, block 0 (garbage) excluded; popping yields
        # ascending ids first for deterministic layouts in tests
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._reserved = 0
        self.alloc_count = 0

    @property
    def usable_blocks(self) -> int:
        """Physical blocks that can ever be mapped (garbage excluded)."""
        return self.n_blocks - 1

    def free_blocks(self) -> int:
        """Blocks neither mapped nor promised to a reservation."""
        return len(self._free) - self._reserved

    def reserved_blocks(self) -> int:
        """Outstanding (reserved but not yet mapped) block count."""
        return self._reserved

    def can_reserve(self, n: int) -> bool:
        """Whether ``n`` more blocks can be promised right now — THE
        admission-control predicate."""
        return int(n) <= self.free_blocks()

    def reserve(self, n: int) -> None:
        """Promise ``n`` blocks to an admitted request.  Raises when
        the promise cannot be kept — callers gate on ``can_reserve``,
        so a failure here is an accounting bug, not load."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        if not self.can_reserve(n):
            raise RuntimeError(
                f"reserve({n}): only {self.free_blocks()} of "
                f"{self.usable_blocks} usable blocks are unpromised")
        self._reserved += n

    def map_block(self) -> int:
        """Hand out one physical block against an existing reservation
        (infallible by the reserve/map contract).  Returns its id."""
        if self._reserved < 1:
            raise RuntimeError(
                "map_block() without a reservation — admission must "
                "reserve() the request's worst-case block count first")
        self._reserved -= 1
        self.alloc_count += 1
        return self._free.pop()

    def release(self, blocks: Sequence[int], *, reserved: int = 0) -> None:
        """Return mapped ``blocks`` to the free list and cancel
        ``reserved`` unused promises (a finished request rarely grew
        into its full worst case)."""
        reserved = int(reserved)
        if reserved < 0 or reserved > self._reserved:
            raise ValueError(
                f"release: {reserved} reserved vs {self._reserved} "
                f"outstanding")
        for b in blocks:
            b = int(b)
            if b == self.GARBAGE_BLOCK or not (0 < b < self.n_blocks):
                raise ValueError(f"release of invalid block id {b}")
            if b in self._free:
                raise ValueError(f"double release of block {b}")
            self._free.append(b)
        self._reserved -= reserved
        if len(self._free) > self.usable_blocks:
            raise RuntimeError("pool accounting corrupted")
