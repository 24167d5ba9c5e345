"""repro_torch.core — the paper's contribution in PyTorch: the
TF-Micro-style interpreter, arena, memory planner, op resolver,
quantization, and export toolchain."""

from . import micro_ops  # registers the reference kernels on import
from . import quantize  # keep the module visible as repro_torch.core.quantize
from .arena import ArenaOverflowError, TwoStackArena
from .costmodel import (BlockCost, BlockSolveResult, BucketCost,
                        CalibrationProfile, ChunkCost, DecodeCost,
                        EngineMeasurer, LaneCost, LaneSolveResult,
                        MicroMeasurer, ReplicaCost, ReplicaSolveResult,
                        SolveResult, calibrate, load_cached_profile,
                        profile_cache_path, profile_model_key,
                        save_cached_profile, solve, solve_block_size,
                        solve_lanes, solve_replicas)
from .executor import (AllocationPlan, ArenaPool, BucketTable,
                       CapturedProgram, CompiledPlan, GraphPool,
                       InflightStep, InterpreterPool, LaneCheckpoint,
                       LaneState,
                       PagedKVPool, RaggedInterpreterPool, SharedArenaState,
                       TokenReadback, capture_count, disable_capture,
                       plan_model, required_arena_size)
from .exporter import export, fold_constants, strip_training_ops
from .exporter import quantize as quantize_graph
from .graph_builder import GraphBuilder
from .interpreter import MicroInterpreter
from .memory_planner import (BufferRequest, GreedyMemoryPlanner,
                             LinearMemoryPlanner, MemoryPlan,
                             OfflineMemoryPlanner)
from .op_resolver import (AllOpsResolver, MicroMutableOpResolver,
                          OpResolutionError, register_op)
from .schema import (MicroModel, OpCode, QuantParams, TensorDef,
                     TensorFlags, model_to_source, serialize_model)

__all__ = [
    "ArenaOverflowError", "TwoStackArena", "export", "fold_constants",
    "quantize", "quantize_graph", "strip_training_ops", "GraphBuilder",
    "MicroInterpreter", "AllocationPlan", "ArenaPool", "BucketTable",
    "CapturedProgram", "CompiledPlan", "GraphPool", "InflightStep",
    "InterpreterPool", "LaneCheckpoint", "LaneState", "PagedKVPool",
    "RaggedInterpreterPool", "SharedArenaState", "TokenReadback",
    "capture_count", "disable_capture",
    "plan_model", "required_arena_size", "BufferRequest",
    "GreedyMemoryPlanner", "LinearMemoryPlanner", "MemoryPlan",
    "OfflineMemoryPlanner", "AllOpsResolver", "MicroMutableOpResolver",
    "OpResolutionError", "register_op", "MicroModel", "OpCode",
    "QuantParams", "TensorDef", "TensorFlags", "model_to_source",
    "serialize_model",
    "BucketCost", "CalibrationProfile", "ChunkCost", "EngineMeasurer",
    "SolveResult", "calibrate", "profile_model_key", "solve",
    "BlockCost", "BlockSolveResult", "DecodeCost", "solve_block_size",
    "LaneCost", "LaneSolveResult", "MicroMeasurer", "ReplicaCost",
    "ReplicaSolveResult", "solve_lanes", "solve_replicas",
    "load_cached_profile", "profile_cache_path", "save_cached_profile",
]
