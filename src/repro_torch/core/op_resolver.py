"""Operator resolution (paper §4.1 OpResolver, §4.7–4.8 kernel specialization).

The PyTorch package keeps its own registry: nothing registered here ever
enters ``repro.core.op_resolver.GLOBAL_REGISTRY``, whose footprint feeds
the JAX package's Table-2 accounting.  Two TFLM mechanisms are
reproduced exactly:

1. **Selective linking.**  ``MicroMutableOpResolver`` starts empty; the
   application registers only the ops its model needs.  Unregistered ops
   are absent and resolving them raises; ``code_nbytes`` counts the
   bytecode of the registered implementations (the code-size analogue).

2. **Platform tags.**  Each opcode may have several implementations keyed
   by tag — ``"reference"`` (readable plain-torch ops, the paper's
   reference kernels) and ``"cuda"`` (hand-written Hopper kernels, the
   CMSIS-NN analogue, registered by importing ``repro_torch.kernels.ops``).
   ``resolve(opcode)`` walks the tag priority list, so swapping in an
   optimized kernel requires no interpreter changes (§4.8).

Every kernel is a (prepare, eval) pair.  ``prepare(ctx, op)`` runs once at
init — it checks shapes/dtypes, computes output specs, precomputes requant
constants on the interpreter's device, and requests scratch.
``eval(ctx, op, inputs)`` runs inside invoke and returns new tensors; it
never writes to its inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .schema import OP_NAMES, SERVING_OPCODES

REFERENCE_TAG = "reference"


@dataclass
class TensorSpec:
    """Shape + dtype of one tensor as the prepare phase resolves it."""

    shape: Tuple[int, ...]
    dtype: str


@dataclass
class PrepareResult:
    """What a kernel's prepare() tells the interpreter (TFLM: communicated
    through the context during the preparation phase, §4.1)."""
    output_specs: List[TensorSpec]
    scratch_nbytes: List[int] = field(default_factory=list)
    persistent_nbytes: int = 0          # requant tables etc. (tail stack)
    op_data: Any = None                 # opaque per-op baked constants
    variable_updates: List[int] = field(default_factory=list)
    # ^ tensor indices of variable tensors this op updates (e.g. SVDF
    #   state); eval returns their new values after its outputs.


@dataclass(frozen=True)
class OpRegistration:
    """One kernel implementation of one opcode under one vendor tag:
    its prepare/eval pair plus a code-size estimate."""

    opcode: int
    tag: str
    prepare: Callable[..., PrepareResult]
    eval: Callable[..., Sequence[Any]]
    code_nbytes: int = 0
    # the op's own rule for lane-stacked inputs (``eval_lanes``), or
    # None: the batched executor then maps ``eval`` over the lanes
    eval_lanes: Optional[Callable[..., Sequence[Any]]] = None

    @property
    def name(self) -> str:
        return f"{OP_NAMES.get(self.opcode, self.opcode)}[{self.tag}]"


class _Registry:
    """Registry that kernel libraries populate at import time (the
    analogue of dropping a CMSIS-NN subfolder into kernels/)."""

    def __init__(self) -> None:
        self._impls: Dict[Tuple[int, str], OpRegistration] = {}

    def register(self, opcode: int, tag: str, prepare: Callable,
                 eval_fn: Callable,
                 eval_lanes: Optional[Callable] = None) -> OpRegistration:
        code = 0
        for fn in (prepare, eval_fn):
            co = getattr(fn, "__code__", None)
            if co is not None:
                code += len(co.co_code) + 4 * len(co.co_consts or ())
        reg = OpRegistration(opcode, tag, prepare, eval_fn, code, eval_lanes)
        self._impls[(opcode, tag)] = reg
        return reg

    def lookup(self, opcode: int, tag: str) -> Optional[OpRegistration]:
        return self._impls.get((opcode, tag))

    def tags_for(self, opcode: int) -> List[str]:
        return [t for (oc, t) in self._impls if oc == opcode]

    def opcodes(self) -> List[int]:
        return sorted({oc for (oc, _) in self._impls})


GLOBAL_REGISTRY = _Registry()


def register_op(opcode: int, tag: str = REFERENCE_TAG):
    """Decorator used by kernel libraries::

        @register_op(OpCode.FULLY_CONNECTED, tag="cuda")
        class CudaFullyConnected:
            @staticmethod
            def prepare(ctx, op): ...
            @staticmethod
            def eval(ctx, op, inputs): ...

    A class may also give ``eval_lanes(ctx, op, inputs, in_dims)``: its
    rule for inputs that carry a leading lane axis (``in_dims[i]`` is 0
    for those, None for the rest), used by the batched executor in place
    of mapping ``eval`` over the lanes (``core.executor``).
    """
    def wrap(impl):
        GLOBAL_REGISTRY.register(opcode, tag, impl.prepare, impl.eval,
                                 getattr(impl, "eval_lanes", None))
        return impl
    return wrap


class OpResolutionError(KeyError):
    """No registration for an opcode under the requested tag chain —
    the op was never linked in (TFLM's unresolved-op error)."""


def resolve_chain(opcode: int, tags: Sequence[str]) -> OpRegistration:
    """Walk the tag priority chain for one opcode (the §4.8 build-tag
    mechanism)."""
    for tag in tags:
        reg = GLOBAL_REGISTRY.lookup(opcode, tag)
        if reg is not None:
            return reg
    raise OpResolutionError(
        f"no implementation of {OP_NAMES.get(opcode, opcode)} for "
        f"tags {tuple(tags)}; available tags: "
        f"{GLOBAL_REGISTRY.tags_for(opcode)}")


class MicroMutableOpResolver:
    """The application-facing resolver: register exactly what you need.

    ``tags`` is the build-tag priority list, e.g. ``("cuda", "reference")``
    — the TFLM ``TAGS="cmsis-nn"`` analogue: optimized implementations
    shadow reference ones per kernel, falling back where a platform does
    not provide one.
    """

    def __init__(self, tags: Sequence[str] = (REFERENCE_TAG,)):
        self.tags = tuple(tags)
        self._linked: Dict[int, OpRegistration] = {}

    def add(self, opcode: int) -> "MicroMutableOpResolver":
        self._linked[opcode] = resolve_chain(opcode, self.tags)
        return self

    def add_many(self, opcodes: Sequence[int]) -> "MicroMutableOpResolver":
        for oc in opcodes:
            self.add(oc)
        return self

    def resolve(self, opcode: int) -> OpRegistration:
        try:
            return self._linked[opcode]
        except KeyError:
            raise OpResolutionError(
                f"operator {OP_NAMES.get(opcode, opcode)} was not registered "
                f"with this resolver (TFLM: op not linked into the binary)")

    @property
    def linked_ops(self) -> List[OpRegistration]:
        return list(self._linked.values())

    def code_nbytes(self) -> int:
        """Registration footprint: the Table-2 'code size' analogue."""
        return sum(r.code_nbytes for r in self._linked.values())


class AllOpsResolver(MicroMutableOpResolver):
    """Convenience resolver linking every registered op (TFLM's
    ``AllOpsResolver`` — larger footprint, zero configuration)."""

    def __init__(self, tags: Sequence[str] = (REFERENCE_TAG,)):
        super().__init__(tags)
        for oc in GLOBAL_REGISTRY.opcodes():
            if oc in SERVING_OPCODES:
                continue        # pod-scale macro-ops: not micro kernels
            if any(GLOBAL_REGISTRY.lookup(oc, t) for t in tags):
                self.add(oc)
