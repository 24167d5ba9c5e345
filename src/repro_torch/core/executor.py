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
     feeds inputs in and reads outputs back; ``InterpreterPool`` advances
     B requests of one model in one program, and
     ``RaggedInterpreterPool`` advances lanes of several models, each at
     its own step, admitted and retired between dispatches.

**Batched dispatch.**  ``CompiledPlan.batched(B, exact)`` is one
program over B lanes: the arena buffer is ``(B, nbytes)`` and the
variable and input tensors carry a leading lane axis.  ``exact=True``
runs the op loop once per lane on that lane's views, the same kernels at
the same shapes as a single invoke, so every lane is bit-identical to
one.  ``exact=False`` runs each op once on the lane-stacked tensors:
through the op's own ``eval_lanes`` rule where it registers one (the
``"cuda"`` FULLY_CONNECTED folds the lanes into K1's rows, the
``"cuda"`` ATTENTION into K2's batch), and otherwise through
``torch.func.vmap`` of its ``eval``, which sees one lane's shapes, so
axis parameters (TRANSPOSE's perm, CONCATENATION's axis, RESHAPE's
shape, SVDF's state) need no shifting.  int8 lanes stay bit-exact (the
integer products are exact in float64); float lanes may differ from a
single invoke in the last ulps, as ``jax.vmap``'s do.
``masked_batched`` adds an active-lane mask, a device tensor input, so
admitting or retiring a lane changes its value and never the program.

**Compile once.**  ``CapturedProgram`` is the port's counterpart of
``jax.jit``: a function run as one CUDA graph per signature (the shapes,
dtypes and addresses of its tensor inputs), and ``capture_count`` the
counterpart of ``jit_cache_size``.  ``disable_capture()`` is the
counterpart of ``jax.disable_jit()``.

**Arena pooling.**  ``ArenaPool`` owns the physical nonpersistent byte
buffers that interpreters sharing an arena (§4.5) and batched pools
recycle between non-concurrent invocations.  It allocates during
warm-up only, which ``alloc_count`` makes observable and testable.

**Length bucketing.**  ``BucketTable`` quantizes ragged sizes to a few
levels; the serving engine pads prompts to them (bucketed prefill).

**Paged KV accounting.**  ``PagedKVPool`` hands out the physical blocks
of the serving engine's paged KV pool (reserve at admission, map on
growth, release at retirement).

**Deferred readback.**  ``InflightStep`` is a dispatched decode step the
host has not read yet, and ``TokenReadback`` the two pinned host buffers
its tokens come back through, in turn — the overlapped serving loop's
(``ServingEngine(overlap=True)``).
"""

from __future__ import annotations

import functools
import gc
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


def setup_device(device: torch.device) -> None:
    """Float convolutions and matmuls on the card run in true float32:
    cuDNN's default TF32 keeps about three decimal digits and would break
    float parity with the reference, so TF32 is switched off here, for
    the process, before any op runs on the card."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


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
        # no cyclic collection during the capture: a program that only a
        # reference cycle still holds would have its graph freed by it,
        # and freeing a graph while another is captured invalidates that
        # capture (the cycle goes at the next collection after it)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool.handle,
                                  stream=pool.stream):
                res, _ = tree_flatten(self.fn(*args))
                for i in copied:
                    static[i].copy_(res[i])
                del res
        finally:
            if collecting:
                gc.enable()
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
    """The invoke body over a frozen AllocationPlan: the op loop over the
    arena buffer's views run as one ``CapturedProgram`` — one CUDA graph
    per (model, input shapes) on the card, bound to the arena buffer, the
    variable tensors and the caller's static input tensors.  ``program``
    runs one request per call; ``batched`` and ``masked_batched`` give
    the programs over B lanes (the module docstring).  When the arena
    pool hands out a new buffer, the programs bound to the old one are
    dropped and the next call captures again."""

    def __init__(self, alloc: AllocationPlan):
        self.alloc = alloc
        self._bound: Optional[torch.Tensor] = None
        self._views: Dict[int, torch.Tensor] = {}
        self.program = CapturedProgram(self._run, name="invoke")
        # (batch, exact[, "masked"]) -> its program; the batch buffer
        # each batch size is bound to, with its views
        self._batched: Dict[tuple, CapturedProgram] = {}
        self._lane_bound: Dict[int, Tuple[torch.Tensor, Any]] = {}

    def _typed_views(self, buf: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Typed, shaped views of every planned tensor inside ``buf``, a
        ``(nbytes,)`` buffer or a ``(B, nbytes)`` one (views then carry
        the lane axis first)."""
        lead = tuple(buf.shape[:-1])
        views = {}
        for tid, off in self.alloc.tensor_offset.items():
            spec = self.alloc.specs[tid]
            raw = buf[..., off:off + _spec_nbytes(spec)]
            views[tid] = raw.view(torch_dtype(spec.dtype)).view(
                lead + tuple(spec.shape))
        return views

    def views(self, buf: torch.Tensor) -> Dict[int, torch.Tensor]:
        """The views of ``buf``, made once per physical buffer and reused
        while it stays the pool's buffer; a new buffer drops the programs
        bound to the old one."""
        if buf is not self._bound:
            if self._bound is not None:
                self.program.clear()
            self._bound, self._views = buf, self._typed_views(buf)
        return self._views

    def lane_views(self, buf: torch.Tensor):
        """(stacked views, each lane's views) of a ``(B, nbytes)`` buffer,
        made once per buffer of a batch size; a new buffer of that size
        drops the batched programs bound to the old one."""
        batch = int(buf.shape[0])
        bound = self._lane_bound.get(batch)
        if bound is None or bound[0] is not buf:
            if bound is not None:
                for key, prog in self._batched.items():
                    if key[0] == batch:
                        prog.clear()
            stacked = self._typed_views(buf)
            lanes = [{t: v[i] for t, v in stacked.items()}
                     for i in range(batch)]
            bound = self._lane_bound[batch] = (buf, (stacked, lanes))
        return bound[1]

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
        return self._body(self.views(buf), variables, inputs, _eval_one)

    def _body(self, views: Dict[int, torch.Tensor],
              variables: Sequence[torch.Tensor],
              inputs: Sequence[torch.Tensor],
              eval_op: Callable) -> List[torch.Tensor]:
        """The op loop over one set of arena views: inputs copied in, each
        op evaluated by ``eval_op(op_plan, inputs, in_dims)`` (``in_dims``
        is 0 for an input read from the arena or the variables, None for
        a const or an absent one), its outputs copied into their views and
        its variable updates into the variables.  Returns the views of
        the model outputs."""
        alloc = self.alloc
        for pos, tid in enumerate(alloc.model.inputs):
            views[tid].copy_(inputs[pos])
        for opp in alloc.op_plans:
            op = opp.op
            in_tensors, in_dims = [], []
            for t in op.inputs:
                if t < 0:
                    in_tensors.append(None)
                elif t in alloc.const_pos:
                    in_tensors.append(alloc.consts[alloc.const_pos[t]])
                elif t in alloc.var_pos:
                    in_tensors.append(variables[alloc.var_pos[t]])
                else:
                    in_tensors.append(views[t])
                in_dims.append(0 if t >= 0 and t not in alloc.const_pos
                               else None)
            outs = eval_op(opp, in_tensors, in_dims)
            n_out = len(op.outputs)
            for t, o in zip(op.outputs, outs[:n_out]):
                views[t].copy_(o.reshape(views[t].shape))
            for t, v in zip(opp.prep.variable_updates, outs[n_out:]):
                variables[alloc.var_pos[t]].copy_(v)
        return [views[t] for t in alloc.model.outputs]

    # -- B lanes in one program -----------------------------------------

    def batched(self, batch: int, exact: bool = False) -> CapturedProgram:
        """The program advancing ``batch`` independent requests:
        ``(buf (B, nbytes), variables (B, ...), inputs (B, ...)) ->
        outputs (B, ...)``, the variables updated in place.  Consts are
        shared by every lane.  ``exact=True`` unrolls the lane body (every
        lane bit-identical to a single invoke, any dtype); ``exact=False``
        runs each op once on the lane-stacked tensors (int8 bit-exact,
        float within the last ulps).  Call it through
        ``execute_batched``."""
        key = (batch, exact)
        if key not in self._batched:
            self._batched[key] = CapturedProgram(
                functools.partial(self._lanes, exact=exact),
                name=f"invoke[{batch}{', exact' if exact else ''}]")
        return self._batched[key]

    def masked_batched(self, batch: int,
                       exact: bool = False) -> CapturedProgram:
        """The ragged lowering: ``batched(batch, exact)`` plus an
        active-lane mask, ``(buf, variables, inputs, mask) -> outputs``
        with ``mask`` a ``(B,)`` bool device tensor.  Every lane's math
        runs every dispatch, but an inactive lane's variables are held
        (``where(mask, new, old)``).  The mask is an input of the program,
        not a constant of it, so admitting or retiring lanes changes only
        its value: one program per (batch, exact) covers every occupancy.
        Active lanes are bit-identical to ``batched``'s."""
        key = (batch, exact, "masked")
        if key not in self._batched:
            self._batched[key] = CapturedProgram(
                functools.partial(self._masked_lanes, exact=exact),
                name=f"invoke[{batch}{', exact' if exact else ''}, masked]")
        return self._batched[key]

    def execute_batched(self, buf: torch.Tensor,
                        variables: Sequence[torch.Tensor],
                        inputs: Sequence[torch.Tensor], exact: bool = False,
                        mask: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
        """Advance the ``buf.shape[0]`` lanes once through ``batched`` (or
        ``masked_batched`` when a mask is given), binding the programs to
        ``buf``.  Returns the model outputs with the lane axis first, in
        tensors the program owns (valid until its next call)."""
        batch = int(buf.shape[0])
        self.lane_views(buf)
        if mask is None:
            return self.batched(batch, exact)(buf, list(variables),
                                              list(inputs))
        return self.masked_batched(batch, exact)(buf, list(variables),
                                                 list(inputs), mask)

    def _lanes(self, buf, variables, inputs, exact):
        stacked, lanes = self.lane_views(buf)
        if exact:
            for i, views in enumerate(lanes):
                self._body(views, [v[i] for v in variables],
                           [x[i] for x in inputs], _eval_one)
        else:
            self._body(stacked, variables, inputs, _eval_stacked)
        return [stacked[t].clone() for t in self.alloc.model.outputs]

    def _masked_lanes(self, buf, variables, inputs, mask, exact):
        held = [v.clone() for v in variables]
        outs = self._lanes(buf, variables, inputs, exact)
        for v, old in zip(variables, held):
            m = mask.view((-1,) + (1,) * (v.dim() - 1))
            v.copy_(torch.where(m, v, old))
        return outs


def _eval_one(opp: OpPlan, inputs, in_dims) -> List[torch.Tensor]:
    return opp.registration.eval(opp.eval_ctx, opp.op, inputs)


def _eval_stacked(opp: OpPlan, inputs, in_dims) -> List[torch.Tensor]:
    """One op on lane-stacked inputs: its ``eval_lanes`` rule, or its
    ``eval`` mapped over the lanes by ``torch.func.vmap``."""
    reg = opp.registration
    if reg.eval_lanes is not None:
        return reg.eval_lanes(opp.eval_ctx, opp.op, inputs, in_dims)
    return torch.func.vmap(
        lambda *xs: reg.eval(opp.eval_ctx, opp.op, list(xs)),
        in_dims=tuple(in_dims))(*inputs)


def eval_each_lane(eval_fn: Callable, ctx, op, inputs,
                   in_dims) -> List[torch.Tensor]:
    """An ``eval_lanes`` rule's last resort: ``eval_fn`` once per lane,
    its outputs stacked."""
    lanes = next(x.shape[0] for x, d in zip(inputs, in_dims)
                 if d is not None)
    per_lane = [eval_fn(ctx, op, [x if d is None else x[i]
                                  for x, d in zip(inputs, in_dims)])
                for i in range(lanes)]
    return [torch.stack(outs) for outs in zip(*per_lane)]


# ---------------------------------------------------------------------------
# arena buffer pooling (§4.5 grown up: one pool, many invocations)
# ---------------------------------------------------------------------------

class ArenaPool:
    """Owns the physical nonpersistent byte buffers that interpreters and
    batched pools sharing an arena recycle between non-concurrent
    invocations: one single-request buffer, and a free list of stacked
    ``(B, nbytes)`` buffers per batch size.

    ``ensure`` grows the size every tenant needs (to a multiple of 16,
    so each lane's views stay aligned); the buffers are made lazily on
    the first take after that, so after warm-up ``alloc_count`` stays
    constant — the malloc-free steady state, observable.

    The free list is at most ``depth`` buffers deep (default 2), the
    double buffer of the JAX package's pool.  Dispatches here take and
    put back in turn on one stream, so a batch size's free list hands out
    the same buffer every time, and the programs bound to it keep their
    one capture."""

    def __init__(self, device="cuda", depth: int = 2) -> None:
        self.device = resolve_device(device)
        self.nbytes = 0
        self.depth = max(1, int(depth))
        self.buf: Optional[torch.Tensor] = None
        self._taken = False
        self._batched: Dict[int, List[torch.Tensor]] = {}
        self.alloc_count = 0

    def _alloc(self, shape) -> torch.Tensor:
        self.alloc_count += 1
        return torch.zeros(shape, dtype=torch.uint8, device=self.device)

    def ensure(self, nbytes: int) -> None:
        """Grow the pooled buffer size (smaller buffers are dropped, and
        each tenant's ``CompiledPlan`` drops the programs bound to them at
        its next invoke)."""
        if nbytes > self.nbytes:
            self.nbytes = align_up(int(nbytes))
            self.buf = None
            self._batched.clear()

    # -- single-request buffer (the §4.5 shared-arena contract) ---------
    def take(self) -> torch.Tensor:
        if self.nbytes <= 0:
            raise RuntimeError("ArenaPool.ensure() before take()")
        if self._taken:
            raise RuntimeError("arena buffer already taken "
                               "(concurrent invoke?)")
        self._taken = True
        if self.buf is None:
            self.buf = self._alloc(self.nbytes)
        return self.buf

    def put(self, buf: torch.Tensor) -> None:
        self._taken = False
        self.buf = buf

    # -- batched buffers (free list = the double buffer) -----------------
    def take_batch(self, batch: int) -> torch.Tensor:
        if self.nbytes <= 0:
            raise RuntimeError("ArenaPool.ensure() before take_batch()")
        free = self._batched.get(batch)
        if free:
            return free.pop()
        return self._alloc((batch, self.nbytes))

    def put_batch(self, buf: torch.Tensor) -> None:
        free = self._batched.setdefault(int(buf.shape[0]), [])
        if len(free) < self.depth:
            free.append(buf)


class SharedArenaState(ArenaPool):
    """Back-compat name: the single-buffer view of ArenaPool (§4.5)."""


# ---------------------------------------------------------------------------
# phase 3 (batched dispatch): InterpreterPool
# ---------------------------------------------------------------------------

class _LaneInputs:
    """The lane-stacked input tensors a batched program reads at fixed
    addresses (and, for a ragged bucket, its active-lane mask), with the
    pinned host tensors they are uploaded from in one asynchronous copy
    each; a later upload waits for the earlier one's copies."""

    def __init__(self, alloc: AllocationPlan, lanes: int,
                 mask: bool = False):
        dev = alloc.device
        specs = [alloc.specs[t] for t in alloc.model.inputs]
        self.tensors = [torch.zeros((lanes,) + tuple(s.shape),
                                    dtype=torch_dtype(s.dtype), device=dev)
                        for s in specs]
        self.mask = (torch.zeros(lanes, dtype=torch.bool, device=dev)
                     if mask else None)
        on_card = dev.type == "cuda"
        staged = self.tensors + ([self.mask] if mask else [])
        self._host = ([torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
                       for t in staged] if on_card else staged)
        self._device = staged if on_card else []
        self._copied: Optional[torch.cuda.Event] = None

    def upload(self, per_lane: Sequence[Dict[int, np.ndarray]],
               active: Optional[np.ndarray] = None) -> None:
        """Lane i's staged values (zeros for a position it has none of)
        and the mask ``active``, onto the device."""
        if self._copied is not None:
            self._copied.synchronize()
        for pos, host in enumerate(self._host[:len(self.tensors)]):
            rows = host.numpy()
            for lane, staged in enumerate(per_lane):
                if pos in staged:
                    rows[lane] = staged[pos]
                else:
                    rows[lane] = 0
        if active is not None:
            self._host[-1].numpy()[:] = active
        if self._device:
            for dst, src in zip(self._device, self._host):
                dst.copy_(src, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()


def _lane_variables(alloc: AllocationPlan, lanes: int) -> List[torch.Tensor]:
    return [torch.zeros((lanes,) + tuple(s.shape), dtype=torch_dtype(s.dtype),
                        device=alloc.device) for s in alloc.var_specs]


def _checked_value(alloc: AllocationPlan, pos: int, value,
                   where: str) -> np.ndarray:
    spec = alloc.specs[alloc.model.inputs[pos]]
    value = np.asarray(value)
    if tuple(value.shape) != tuple(spec.shape):
        raise ValueError(f"{where} input {pos}: shape {value.shape} != "
                         f"{spec.shape}")
    return value.astype(spec.dtype)


class InterpreterPool:
    """B independent requests of ONE model advanced by one program.

    All lanes share one AllocationPlan (weights, op_data, memory plan)
    and one CompiledPlan; per-lane state is the lane axis of the pooled
    arena buffer and of the variable tensors.  ``device`` defaults to
    ``"cuda"`` (the pool's, when one is given)."""

    def __init__(self, model: MicroModel,
                 op_resolver: MicroMutableOpResolver, batch: int,
                 arena_size_bytes: Optional[int] = None,
                 planner: Optional[object] = None,
                 prefer_offline_plan: bool = True,
                 host_arena: Optional[TwoStackArena] = None,
                 pool: Optional[ArenaPool] = None, exact: bool = False,
                 device="cuda"):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.batch = batch
        self.exact = exact
        self.pool = pool if pool is not None else ArenaPool(device)
        setup_device(self.pool.device)
        self.alloc = plan_model(model, op_resolver, arena_size_bytes,
                                planner, prefer_offline_plan, host_arena,
                                self.pool.device)
        self.compiled = CompiledPlan(self.alloc)
        self.pool.ensure(self.alloc.nonpersistent_nbytes)
        self._variables = _lane_variables(self.alloc, batch)
        self._inputs: List[Dict[int, np.ndarray]] = [
            {} for _ in range(batch)]
        self._staged = _LaneInputs(self.alloc, batch)
        self._outs: Optional[List[np.ndarray]] = None
        self._invoke_count = 0

    @property
    def program(self) -> CapturedProgram:
        """The batched program this pool dispatches."""
        return self.compiled.batched(self.batch, self.exact)

    def set_input(self, lane: int, pos: int, value: np.ndarray) -> None:
        self._inputs[lane][pos] = _checked_value(self.alloc, pos, value,
                                                 f"lane {lane}")

    def clear_inputs(self) -> None:
        self._inputs = [{} for _ in range(self.batch)]

    def invoke(self) -> None:
        """Advance every lane by one invocation — ONE program; a lane
        with no inputs at all is idle and runs on zeros.  Blocks until
        the outputs are on the host."""
        n_in = len(self.alloc.model.inputs)
        for lane, staged in enumerate(self._inputs):
            # same contract as MicroInterpreter.invoke(), per lane
            if staged and len(staged) != n_in:
                raise RuntimeError(f"lane {lane}: not all inputs set")
        self._staged.upload(self._inputs)
        buf = self.pool.take_batch(self.batch)
        try:
            outs = self.compiled.execute_batched(
                buf, self._variables, self._staged.tensors, self.exact)
            self._outs = [o.to("cpu", copy=True).numpy() for o in outs]
        finally:
            self.pool.put_batch(buf)
        self._invoke_count += 1

    def output(self, lane: int, pos: int) -> np.ndarray:
        return self.outputs(pos)[lane]

    def outputs(self, pos: int) -> np.ndarray:
        """All lanes' outputs, stacked on axis 0."""
        if self._outs is None:
            raise RuntimeError("invoke() first")
        return self._outs[pos]

    def reset_variable_tensors(self) -> None:
        for v in self._variables:
            v.zero_()


# ---------------------------------------------------------------------------
# phase 3 (ragged dispatch): lane table + RaggedInterpreterPool
# ---------------------------------------------------------------------------

@dataclass
class LaneState:
    """One row of the ragged pool's lane table.

    ``bucket`` names the model family the lane belongs to, ``slot`` is
    its index on that bucket's lane axis, ``uid`` identifies the request
    currently occupying the lane (None = free), ``step`` counts
    dispatches completed for that request (the continuation counter),
    and ``active`` is the lane's bit in the dispatch mask.
    """

    bucket: str
    slot: int
    uid: Optional[int] = None
    step: int = 0
    active: bool = False


@dataclass
class LaneCheckpoint:
    """A lane's continuation state, captured on the host so the lane can
    be freed and the request re-admitted later — the preemption
    primitive.

    ``variables`` holds one numpy copy of each variable tensor's lane row
    (the recurrent continuation state), ``step`` the dispatch counter,
    ``bucket``/``uid`` where it came from.  Snapshotting and restoring
    move values between the host and the lane-stacked device tensors;
    the masked program, its mask and every shape stay what the first
    dispatch captured, so a preempt/resume cycle never captures again."""

    bucket: str
    uid: Optional[int]
    step: int
    variables: Tuple[np.ndarray, ...]


class _RaggedBucket:
    """Per-model-family state of a RaggedInterpreterPool: one shared
    AllocationPlan/CompiledPlan, the lane-stacked variable state, inputs
    staged for the next wave, and that family's lane-table rows."""

    def __init__(self, name: str, alloc: AllocationPlan,
                 compiled: CompiledPlan, lanes: int, exact: bool):
        self.name = name
        self.alloc = alloc
        self.compiled = compiled
        self.lanes = lanes
        self.exact = exact
        self.table = [LaneState(bucket=name, slot=i) for i in range(lanes)]
        self.variables = _lane_variables(alloc, lanes)
        self.inputs: List[Dict[int, np.ndarray]] = [{} for _ in range(lanes)]
        self.staged = _LaneInputs(alloc, lanes, mask=True)
        self.outs: Optional[List[torch.Tensor]] = None
        self.outs_host: Optional[List[np.ndarray]] = None
        self.dispatch_count = 0

    def check_staged(self) -> None:
        n_in = len(self.alloc.model.inputs)
        for lane in self.table:
            if lane.active and len(self.inputs[lane.slot]) != n_in:
                raise RuntimeError(
                    f"bucket {self.name!r} lane {lane.slot}: not all "
                    f"inputs set for this wave")


class RaggedInterpreterPool:
    """Lanes at different models, steps, and lifecycles — one masked
    program per model-family bucket.

    The lockstep ``InterpreterPool`` requires every lane to run the same
    model and start/finish together.  Here a *lane table* relaxes that:

      * **different models** — each bucket plans its model once; buckets
        draw lane-stacked arena buffers from ONE shared ``ArenaPool``
        (sized to the largest requirement, §4.5 style);
      * **different steps** — every lane carries its own variable-tensor
        continuation state and step counter, so a lane on step 7 of a
        streaming request rides in the same dispatch as a lane on step 0;
      * **different lifecycles** — ``admit``/``retire`` flip the lane's
        bit in the active mask between dispatches.  The mask is an input
        of ``CompiledPlan.masked_batched``, so occupancy changes never
        capture a program again.

    ``dispatch()`` enqueues each bucket's program without waiting for the
    device; ``output()``/``outputs()`` read a bucket's outputs to the
    host, once per wave.  ``device`` defaults to ``"cuda"`` (the pool's,
    when one is given).
    """

    def __init__(self, pool: Optional[ArenaPool] = None, depth: int = 2,
                 device="cuda"):
        self.pool = pool if pool is not None else ArenaPool(device, depth)
        setup_device(self.pool.device)
        self._buckets: Dict[str, _RaggedBucket] = {}

    # -- bucket construction (init-time; all planning happens here) -----

    def add_bucket(self, name: str, model: MicroModel,
                   resolver: MicroMutableOpResolver, lanes: int, *,
                   exact: bool = False,
                   arena_size_bytes: Optional[int] = None,
                   planner: Optional[object] = None,
                   prefer_offline_plan: bool = True,
                   host_arena: Optional[TwoStackArena] = None,
                   lane_buckets: Optional["BucketTable"] = None) -> None:
        """Admit a model family with ``lanes`` lane slots; plans exactly
        once — admission and retirement later touch only the lane table.

        ``lane_buckets`` (optional) rounds ``lanes`` up through a shared
        ``BucketTable`` so model buckets with nearby lane counts draw from
        the ``ArenaPool`` free list of the SAME stacked batch size; the
        extra lanes are ordinary free lanes."""
        if name in self._buckets:
            raise ValueError(f"bucket {name!r} already exists")
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if lane_buckets is not None:
            lanes = lane_buckets.bucket(lanes)
        alloc = plan_model(model, resolver, arena_size_bytes, planner,
                           prefer_offline_plan, host_arena, self.pool.device)
        self.pool.ensure(alloc.nonpersistent_nbytes)
        self._buckets[name] = _RaggedBucket(
            name, alloc, CompiledPlan(alloc), lanes, exact)

    # -- lane-table views ------------------------------------------------

    @property
    def lane_table(self) -> List[LaneState]:
        """Every lane of every bucket — the global lane table."""
        return [lane for b in self._buckets.values() for lane in b.table]

    def lanes(self, bucket: str) -> List[LaneState]:
        return self._buckets[bucket].table

    def free_lanes(self, bucket: str) -> List[int]:
        return [lane.slot for lane in self._buckets[bucket].table
                if not lane.active]

    def occupancy(self) -> float:
        table = self.lane_table
        if not table:
            return 0.0
        return sum(lane.active for lane in table) / len(table)

    def program(self, bucket: str) -> CapturedProgram:
        """The masked program of ``bucket`` (``capture_count`` reads it)."""
        b = self._buckets[bucket]
        return b.compiled.masked_batched(b.lanes, b.exact)

    # -- admission / retirement (between dispatches; never captures) ----

    def admit(self, bucket: str, uid: Optional[int] = None) -> int:
        """Claim a free lane for a new request: reset its continuation
        state to the model's initial (zero) variable values, zero its step
        counter, and set its mask bit.  Returns the lane slot."""
        b = self._buckets[bucket]
        for lane in b.table:
            if not lane.active:
                break
        else:
            raise RuntimeError(f"bucket {bucket!r}: no free lane")
        lane.active, lane.uid, lane.step = True, uid, 0
        for v in b.variables:
            v[lane.slot].zero_()
        b.inputs[lane.slot] = {}
        return lane.slot

    def retire(self, bucket: str, slot: int) -> LaneState:
        """Free a lane mid-flight: clear its mask bit and staged inputs.
        The other lanes' continuation state is untouched and the next
        dispatch replays the same program."""
        b = self._buckets[bucket]
        lane = b.table[slot]
        lane.active = False
        lane.uid = None
        b.inputs[slot] = {}
        return lane

    # -- preemption: checkpoint / restore (host side, never captures) ---

    def snapshot_lane(self, bucket: str, slot: int) -> LaneCheckpoint:
        """Copy an active lane's continuation state (variable rows + step
        counter) to a host-side ``LaneCheckpoint``.  The lane itself is
        untouched — pair with ``retire`` to preempt.  Waits for the
        lane's variable rows (a device-to-host copy), the checkpoint's
        whole cost."""
        b = self._buckets[bucket]
        lane = b.table[slot]
        if not lane.active:
            raise RuntimeError(
                f"bucket {bucket!r} lane {slot} is not active")
        rows = tuple(v[slot].to("cpu", copy=True).numpy()
                     for v in b.variables)
        return LaneCheckpoint(bucket=bucket, uid=lane.uid,
                              step=lane.step, variables=rows)

    def restore_lane(self, ckpt: LaneCheckpoint,
                     slot: Optional[int] = None) -> int:
        """Re-admit a checkpointed continuation into a free lane of its
        bucket (any free lane by default, or ``slot``).  The lane's
        variable rows are set to the checkpoint's values and its step
        counter resumes where the snapshot left off, so the next
        dispatches are bit-identical to an uninterrupted run: lanes are
        independent, so the slot and the other lanes cannot perturb the
        math.  Only the lane table and the rows' values change."""
        b = self._buckets[ckpt.bucket]
        if slot is None:
            free = self.free_lanes(ckpt.bucket)
            if not free:
                raise RuntimeError(
                    f"bucket {ckpt.bucket!r}: no free lane to restore")
            slot = free[0]
        lane = b.table[slot]
        if lane.active:
            raise RuntimeError(
                f"bucket {ckpt.bucket!r} lane {slot} is occupied")
        lane.active, lane.uid, lane.step = True, ckpt.uid, ckpt.step
        for v, row in zip(b.variables, ckpt.variables):
            v[slot].copy_(torch.from_numpy(np.asarray(row)))
        b.inputs[slot] = {}
        return slot

    # -- per-wave input staging -----------------------------------------

    def set_input(self, bucket: str, slot: int, pos: int,
                  value: np.ndarray) -> None:
        b = self._buckets[bucket]
        if not b.table[slot].active:
            raise RuntimeError(
                f"bucket {bucket!r} lane {slot} is not active")
        b.inputs[slot][pos] = _checked_value(
            b.alloc, pos, value, f"bucket {bucket!r} lane {slot}")

    # -- the ragged dispatch --------------------------------------------

    def dispatch(self) -> int:
        """Advance every bucket that has at least one active lane by one
        step — ONE masked program per such bucket.  Returns the number of
        lanes advanced; inputs staged for this wave are consumed.

        Staging is validated for EVERY bucket before ANY bucket runs, so
        a staging error raises with no lane advanced — dispatch is
        atomic across buckets and safe to retry after restaging."""
        waves = []
        for b in self._buckets.values():
            mask = np.array([lane.active for lane in b.table])
            if mask.any():
                b.check_staged()
                waves.append((b, mask))
        advanced = 0
        for b, mask in waves:
            b.staged.upload(b.inputs, mask)
            buf = self.pool.take_batch(b.lanes)
            try:
                b.outs = b.compiled.execute_batched(
                    buf, b.variables, b.staged.tensors, b.exact,
                    mask=b.staged.mask)
            finally:
                self.pool.put_batch(buf)
            b.outs_host = None
            b.dispatch_count += 1
            b.inputs = [{} for _ in range(b.lanes)]
            for lane in b.table:
                if lane.active:
                    lane.step += 1
                    advanced += 1
        return advanced

    def output(self, bucket: str, slot: int, pos: int) -> np.ndarray:
        """Lane ``slot``'s model output ``pos`` from the last dispatch.
        The bucket's outputs come to the host ONCE per wave (cached), so
        reading every active lane costs one copy, not one per lane."""
        return self.outputs(bucket, pos)[slot]

    def outputs(self, bucket: str, pos: int) -> np.ndarray:
        """All lanes' output ``pos`` from the last dispatch, stacked on
        axis 0 (inactive lanes hold garbage — consult the lane table)."""
        b = self._buckets[bucket]
        if b.outs is None:
            raise RuntimeError("dispatch() first")
        if b.outs_host is None:
            b.outs_host = [o.to("cpu", copy=True).numpy() for o in b.outs]
        return b.outs_host[pos]


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
        such as the calibration cost model (``core/costmodel.py``)
        solves for from measured per-bucket costs.

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

    @classmethod
    def from_levels(cls, levels: Sequence[int]) -> "BucketTable":
        """A table with exactly these ascending levels — the layout a
        calibration profile's solver emits."""
        return cls(levels=levels)

    def spec(self) -> Dict[str, Any]:
        """JSON-serializable layout (``from_spec`` round-trips it
        bit-identically) — how a ``CalibrationProfile`` persists the
        solved table."""
        return {"levels": list(self.levels)}

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "BucketTable":
        """Rebuild a table from ``spec()`` output (e.g. loaded from a
        calibration profile JSON)."""
        return cls(levels=spec["levels"])

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BucketTable):
            return NotImplemented
        return self.levels == other.levels

    def __hash__(self) -> int:
        # levels are fixed at construction (only `hits` mutates), so
        # hashing by layout keeps tables usable as dict/set members
        # consistently with the layout equality above
        return hash(tuple(self.levels))

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

    def buckets(self) -> List[int]:
        """Buckets hit so far, ascending — the table's live layout."""
        return sorted(self.hits)


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


# ---------------------------------------------------------------------------
# overlapped decode: a dispatched step whose tokens the host has not read
# ---------------------------------------------------------------------------

@dataclass
class InflightStep:
    """One dispatched-but-unread decode step — the deferred-readback
    record behind the overlapped serving loop (docs/STREAMING.md).

    Launches are asynchronous: a replayed step returns while the card
    works.  An ``InflightStep`` pins what the host needs to interpret the
    step LATER: the device token tensor, the pinned host buffer a
    non-blocking copy of those tokens lands in, the CUDA event recorded
    after that copy on the stream the step ran on, and the dispatch-time
    ``(slot, result, request)`` snapshot — slot bookkeeping may change
    between dispatch and readback (a slot retires, a request is
    admitted), and the tokens belong to the slots as they were at
    dispatch.  On the CPU there is no event: the copy is done when it
    returns.

    ``host_fetch`` is the single blocking point: it waits for the event
    and reads the buffer, at which moment the step is no longer in
    flight."""

    tokens: torch.Tensor                # device tokens, one per slot
    slots: List[Tuple[int, Any, Any]]   # (slot, result, request) at dispatch
    host: torch.Tensor                  # pinned host copy of ``tokens``
    event: Optional[Any] = None         # torch.cuda.Event after the copy
    dispatch_s: float = 0.0             # host-side dispatch cost (timings)

    def host_fetch(self) -> np.ndarray:
        """Wait until the step's tokens are in host memory and return a
        numpy copy of them."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


class TokenReadback:
    """The host side of overlapped decode's readback: two pinned host
    buffers of ``n`` tokens, each with its CUDA event, used in turn.

    Two steps are alive at once — step i+1 is dispatched before step i is
    read — so step i+1's copy must land in the other buffer than step
    i's, or it could overwrite step i's tokens before the host reads
    them.  A buffer is written again two launches later, after waiting
    for its own event, so no buffer is rewritten while a non-blocking
    copy into it may still be pending.  On the CPU the buffers are plain
    tensors and the copy is synchronous.  Making the pinned buffers or
    the events raises where the card cannot; nothing falls back."""

    def __init__(self, n: int, dtype: torch.dtype, device: torch.device):
        card = device.type == "cuda"
        self._host = [torch.zeros(n, dtype=dtype, pin_memory=card)
                      for _ in range(2)]
        self._events = [torch.cuda.Event() if card else None
                        for _ in range(2)]
        self._next = 0

    def launch(self, tokens: torch.Tensor,
               slots: List[Tuple[int, Any, Any]],
               dispatch_s: float = 0.0) -> InflightStep:
        """Copy ``tokens`` into the next buffer behind the work already
        on the current stream, record its event, and return the step."""
        i, self._next = self._next, self._next ^ 1
        host, event = self._host[i], self._events[i]
        if event is not None:
            event.synchronize()         # the copy of two launches ago
        host.copy_(tokens.reshape(-1), non_blocking=event is not None)
        if event is not None:
            event.record()
        return InflightStep(tokens, slots, host, event, dispatch_s)
