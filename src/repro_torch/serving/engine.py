"""Batched serving engine — the pod-scale analogue of the TF Micro
invoke loop (paper §4.1), ported to PyTorch with the same allocation
discipline:

  * the KV cache — one contiguous ring of ``cache_len`` positions per
    decode slot, (L, max_slots, KH, C, dh) for K and for V, or with
    ``kv_block=`` a shared pool of physical blocks (L, P, KH, BS, dh)
    plus one block table (max_slots, C/BS) int32 — and the slot
    bookkeeping (lengths, current tokens) are allocated on the device at
    construction.  A decode step writes them in place: these tensors
    keep their addresses for the engine's life, and nothing a step
    allocates outlives it;
  * cache capacity is budgeted through the SAME ``TwoStackArena`` the
    micro interpreter uses: KV is a persistent (interpreter-lifetime)
    allocation, exactly as the JAX engine accounts it;
  * continuous batching: fixed decode slots, requests admitted as slots
    free up, one fused decode step advances every slot;
  * prefill and decode resolve through the op-registry tag chain
    (``("cuda", "reference")`` by default, §4.7–4.8): the ``"cuda"``
    ``SERVING_DECODE`` and ``SERVING_DECODE_PAGED`` run every layer's
    attention on the decode_attention and paged_decode_attention
    kernels, and shadow the reference decode with no engine change —
    the micro interpreter's ``TAGS=`` mechanism.

Compile once: the decode step, the chunk step and prefill are each a
``CapturedProgram`` (``core.executor``), the counterpart of the JAX
engine's ``jax.jit`` programs.  On the card each program shape runs as
one CUDA graph, captured after one eager call and replayed from then on:
decode is one program per engine, the chunk step one per chunk length,
and prefill one per bucket on a bucketed engine (one per prompt length
without buckets, as ``jax.jit`` retraces; at most ``PREFILL_PROGRAMS``
held).  ``capture_count(eng._decode)``,
``prefill_compiles()`` and ``chunk_compiles()`` count them as
``jit_cache_size`` counts the JAX engine's.  The programs read the cache
or pool, the block table, ``cur_tokens`` and ``lengths`` at their fixed
addresses, and their other inputs from static staging tensors the host
writes between steps (a chunking slot's batch=1 cache is copied into one
static cache and back around each chunk); ``disable_capture()`` runs
them eagerly.  A step never reads a device value on the host and takes
no branch on one; the host reads back only the sampled tokens, outside
the graphs.  Sampling is greedy (argmax over the true vocab, first
maximum on ties; EOS is ``vocab - 1``), as in the JAX engine.

Host-side degrees of freedom ride on top (docs/SCHEDULING.md,
docs/PREEMPTION.md):

  * **admission order is policy-driven** — a ``SchedulingPolicy``
    (FIFO / priority-with-aging / EDF / per-tenant WFQ) picks which
    queued request takes a free slot.  Policies reorder the Python
    queue only.
  * **bucketed prefill** (dense, vlm, moe) — prompt lengths are
    quantized to power-of-two buckets (``BucketTable``): the prompt is
    right-padded to its bucket.  Decode masks the cache by per-slot
    length and the first decode steps overwrite the padded rows, so
    decoded tokens are those of the exact-length path (bit for bit where
    a matmul's rounding does not depend on its row count, as on the CPU;
    in bf16 on the card the padded shapes may round otherwise); a moe prefill
    also carries the true length and its expert capacity as int32
    tensors in static buffers (``lm.moe_dispatch``'s masked mode), so the
    routing is the true length's and one program serves a bucket.
  * **preemption** (``preempt=``) — when every slot is busy and the
    queue holds a tighter request, a ``PreemptionPolicy`` picks a
    running victim; its KV rows and (length, next token, budget) are
    checkpointed to host memory in a ``SlotCheckpoint``, the request is
    re-queued, and the urgent one takes the slot.  Restoring later, into
    any slot, continues with exactly the tokens of an uninterrupted run.
  * **chunked prefill** (``prefill_chunk=``) — a prompt longer than one
    chunk is integrated one chunk per ``step()``, interleaved with the
    decode steps of the other slots; a slot mid-prefill can be
    preempted and resumes where it stopped.
  * **paged KV** (``kv_block=``, ``kv_pool_blocks=``) — each slot maps
    blocks of the shared pool on demand (``PagedKVPool``: block 0 is
    the garbage sink, admission reserves a request's worst case so
    growth never fails, and a smaller pool gates admission); a
    preempted slot's checkpoint carries its block ids, not its KV.
  * **quantized serving** (``weight_dtype=``, ``kv_dtype=``) — int8 or
    packed-int4 weights, quantized once at construction (the resident
    model is the quantized one; every family but audio), and/or an int8
    KV cache with one float32 scale per head vector, contiguous or paged
    (dense, moe, vlm); prefill and decode resolve ``SERVING_PREFILL_Q``
    / ``SERVING_DECODE_Q``.  Not with ``prefill_chunk`` (the chunk steps
    write float KV rows).
  * **recurrent families** (ssm: Mamba-2, hybrid: Zamba2) — the slot
    cache is the conv window and SSD state (plus hybrid's shared-attention
    KV), batch on axis 1, written in place by the decode step; prefill is
    exact-length (no buckets), and ``prefill_chunk=`` carries the state
    from chunk to chunk through ``SERVING_PREFILL_CHUNK_STATE``, the first
    chunk seeded from an empty cache.  The ``"cuda"`` prefill ops run the
    SSD scan on K8.  Not paged; quantized weight-only.
  * **vlm and audio** — a request's ``extras`` (PaliGemma's ``vision``
    patch embeddings, Whisper's ``frames``) go to its prefill through
    static buffers.  The vision prefix takes the first cache positions
    of the slot (its ``room`` is left out of the buckets and the
    chunks); Whisper's cache carries the cross K/V its prefill staged,
    so a checkpoint restores it with the rings.

A last one overlaps the host with the device (docs/STREAMING.md):

  * **overlapped decode** (``overlap=True``; every family but audio,
    ``STREAMING_FAMILIES``) — readback is deferred ONE step: the engine
    dispatches decode step i+1 before it reads step i's tokens, so the
    host's bookkeeping for step i runs while step i+1 computes.  Greedy
    sampling moves onto the device (``_argmax``, a program of its own
    that writes ``cur_tokens`` in place), so step i+1's input tokens
    never pass through the host; step i's tokens come back through a
    non-blocking copy into one of two pinned host buffers and an event
    (``TokenReadback``).  The decode program is the one sync mode runs,
    and the tokens are the same.  Every ``on_token`` event is emitted in
    order and exactly once, across preemption and restore too, because
    every snapshot path drains the step in flight first.

    The stream-ordering rule that keeps this right: the engine updates
    the cache or pool, the block table, ``lengths`` and ``cur_tokens`` IN
    PLACE (the JAX engine's functional updates act on the in-flight
    step's output instead).  The decode replay, the argmax, every host
    write to a program input (admission, a prefill's insert or scatter, a
    block-table entry, a restore) and the token copy with its event all
    go on the caller's current stream, in program order, so each write
    lands after the step in flight, as JAX's data flow orders it: a slot
    that retires one step late and is admitted again gets its prefilled
    rows after that step's wasted write for the retired request.  Moving
    the decode onto a side stream would need every such writer to wait
    on it.  Block-table growth at dispatch writes single entries (no
    host-to-device copy, which would wait for the step in flight).

The JAX engine's families refuse the same fast paths here, with the
same ``UnsupportedFamilyError``.

Mesh sharding (``mesh=make_serving_mesh(N)``, ``SHARDED_FAMILIES``): one
engine per rank of a ``torch.distributed`` world, every rank running
this same loop on its shards (docs/ARCHITECTURE.md §9).  At
construction the weights become this rank's slices
(``distributed.sharding.shard_params``) and the arena — the contiguous
rings or the paged pool, and the batch=1 chunk cache — is allocated at
this rank's shapes (``engine_shardings``); the bookkeeping (block
tables, lengths, current tokens) is whole on every rank, so every host
write lands in the bound local buffers as on one device, and the
programs are the same programs (one decode, one chunk, a prefill per
bucket, nothing new across evict and restore), their collectives inside
them.  Where the KV cache's rows are split (the policy's ``sequence``
mode) the decode and chunk ops get ``seq_kv``; a prefill emits every
row, and the engine keeps this rank's.  The ranks take every scheduling
decision alike: the queue and the tokens are the same on every rank,
and the clock a decision reads (an arrival stamp, an admission's
``now``) is the ``model`` axis's rank 0's, broadcast to the others
(``Mesh.broadcast_host``), so ranks whose clocks differ neither diverge
nor wait on each other's collectives.  Quantized serving is refused on
a mesh, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.arena import TwoStackArena, align_up
from repro_torch.core.executor import (BucketTable, CapturedProgram,
                                       GraphPool, InflightStep, PagedKVPool,
                                       TokenReadback, capture_count,
                                       resolve_device)
from repro_torch.core.interpreter import setup_device
from repro_torch.core.op_resolver import MicroMutableOpResolver
from repro_torch.core.schema import OpCode, OpDef
from repro_torch.distributed.sharding import (KV_LEAVES, SHARDED_FAMILIES,
                                              cache_sharding,
                                              engine_shardings, shard_params)
from repro_torch.kernels import ops as _vendor_kernels  # noqa: F401 (tag "cuda")
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm, lm_quant
from repro_torch.models.registry import ModelBundle, empty_model

from . import ops as serving_ops  # registers tag="reference" serving ops
from .errors import UnsupportedFamilyError
from .ops import (CHUNKED_FAMILIES, KV_QUANT_FAMILIES, PAGED_FAMILIES,
                  RECURRENT_FAMILIES, WEIGHT_QUANT_FAMILIES)
from .scheduling import (PreemptionPolicy, SchedulingPolicy, get_policy,
                         get_preemption)

DEFAULT_TAGS = ("cuda", "reference")

# prefill programs an engine holds at once, the least recently used
# dropped past it: a bucketed engine sees one per bucket, an engine
# without buckets (the recurrent families) one per prompt length
PREFILL_PROGRAMS = 16

# BUCKETED: decode masks the KV cache by per-slot length, so
# right-padded (bucketed) prefill gives the tokens of exact-length
# prefill; moe qualifies through the capacity-stable masked dispatch.
# Not ssm/hybrid: their state integrates every position, padded or not.
BUCKETED_FAMILIES = ("dense", "vlm", "moe")
# STREAMING: families qualified for the overlapped decode loop
# (``overlap=True``).  Not "audio": the encoder-decoder path (cross K/V
# staged at admission) has not been qualified for deferred readback, as
# in the JAX engine.
STREAMING_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")

def default_clock() -> int:
    """Host time in µs — the clock policies age/deadline against."""
    return time.monotonic_ns() // 1000


@dataclasses.dataclass
class Request:
    """One pod-scale generation request: a prompt plus decode budget,
    and the scheduling fields admission policies key on (``priority``:
    lower admits first; ``deadline_us``: absolute host µs for EDF;
    ``arrival_us``: stamped at submit() when not provided)."""

    uid: int
    tokens: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 32
    priority: int = 0                   # lower = more urgent
    deadline_us: Optional[int] = None   # absolute host time, EDF key
    arrival_us: Optional[int] = None    # stamped at submit()
    tenant: str = ""                    # WFQ quota label
    extras: Optional[Dict[str, np.ndarray]] = None   # vision / frames


@dataclasses.dataclass
class RequestResult:
    """Accumulated outcome of a Request: emitted tokens and timings
    (``prefill_s`` up to the prefill's completion on the device,
    ``decode_s`` the decode steps it took part in, each up to its
    tokens on the host).  ``preemptions`` counts evictions;
    ``first_token_us`` is the engine-clock stamp of the first token."""

    uid: int
    prompt_len: int
    output: List[int] = dataclasses.field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    done: bool = False
    preemptions: int = 0
    first_token_us: Optional[int] = None


@dataclasses.dataclass
class StreamEvent:
    """One streamed token, delivered through the engine's ``on_token``
    callback the moment the host learns it: per ``uid`` in order, with
    no gaps and no repeats (across preemption/restore too), and
    ``token == results[uid].output[index]``.  ``final`` is True on
    exactly the request's last event; ``t_us`` is the engine clock."""

    uid: int
    index: int      # position in the request's output (0-based)
    token: int
    t_us: int       # engine clock at emission
    final: bool     # True on the request's last token


@dataclasses.dataclass
class SlotCheckpoint:
    """A preempted request's continuation state, in host memory.

    ``phase`` records where the request was interrupted: ``"decode"``
    checkpoints the slot's KV rows plus the (length, next token,
    remaining budget) triple the decode step is a pure function of;
    ``"prefill"`` checkpoints a chunked prefill in flight (its batch=1
    cache and how many prompt tokens it has integrated).  Restoring
    either into any slot continues the run with exactly its
    uninterrupted tokens.

    On a paged engine the checkpoint carries no KV: ``cache`` is None
    and ``blocks`` pins the slot's physical block ids (plus its unspent
    worst-case ``reserved`` count); the rows stay in the pool, and a
    restore writes the ids into the new slot's block-table row."""

    phase: str                          # "decode" | "prefill"
    cache: Any                          # batch=1 cache dict (CPU tensors)
    length: int = 0                     # absolute position (decode)
    cur_token: int = 0                  # next token to feed (decode)
    budget: int = 0                     # remaining new tokens (decode)
    done_tokens: int = 0                # prompt tokens integrated (prefill)
    blocks: Optional[List[int]] = None  # paged: pinned physical block ids
    reserved: int = 0                   # paged: unspent reservation


@dataclasses.dataclass
class _ChunkState:
    """A slot mid-chunked-prefill: the request, its private batch=1
    cache (None on a paged engine: the chunks write the pool), and how
    many prompt tokens have been integrated so far."""

    req: Request
    cache1: Any
    done: int


def _greedy(vocab: int, logits: torch.Tensor,
            cur: torch.Tensor) -> torch.Tensor:
    """The ``_argmax`` program: ``ServingEngine._sample``'s tokens (the
    true ``vocab``, float32, first maximum on ties), written into ``cur``
    (the engine's ``cur_tokens``) on the device."""
    cur.copy_(logits[:, :vocab].float().argmax(dim=-1, keepdim=True))
    return cur


def _cache_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _model_tensors(model: torch.nn.Module):
    """(name, tensor) of a model's parameters and buffers: a quantized
    model keeps its weights in buffers."""
    yield from model.named_parameters()
    yield from model.named_buffers()


class ServingEngine:
    """One model, ``max_slots`` concurrent sequences, on ``device``
    (``"cuda"`` by default; raises without a card — pass ``"cpu"`` for
    the plain reference path on the CPU).  ``params`` is the model
    module from ``bundle.init`` or ``models.params_from_jax``, on that
    device.

    ``prefill_chunk``: None/False/0 = off, True = the bucket table's
    smallest bucket (8 without one), an int = that many tokens per
    chunk.  ``kv_block``: None/0 = contiguous per-slot rings, an int =
    paged KV with blocks of that many positions (it must divide
    ``cache_len``); ``kv_pool_blocks`` sizes the pool, by default every
    slot at full length plus the garbage block.  ``weight_dtype``:
    None, ``"int8"`` or ``"int4"`` (the model is quantized once, here;
    ``params`` itself is left as it was); ``kv_dtype``: None or
    ``"int8"``.  ``overlap``: the overlapped decode loop (the module
    docstring); ``on_token``: a ``StreamEvent`` callback, called for each
    emitted token in both modes.  ``mesh``: a ``launch.mesh`` serving
    mesh; ``params`` is then the whole model (or one already sharded for
    this mesh, ``shard_params``) and this engine serves this rank's
    share (the module docstring)."""

    def __init__(self, bundle: ModelBundle, params: torch.nn.Module, *,
                 max_slots: int = 4, cache_len: int = 256,
                 arena: Optional[TwoStackArena] = None,
                 arena_bytes: Optional[int] = None,
                 tags: Sequence[str] = DEFAULT_TAGS,
                 policy: Any = None, clock=None,
                 prefill_buckets: Any = None,
                 prefill_chunk: Any = None, preempt: Any = None,
                 kv_block: Any = None,
                 kv_pool_blocks: Optional[int] = None,
                 weight_dtype: Any = None, kv_dtype: Any = None,
                 mesh: Any = None, overlap: bool = False,
                 on_token: Any = None, device="cuda"):
        self.device = resolve_device(device)
        setup_device(self.device)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        for name, t in _model_tensors(params):
            if t.device != self.device:
                raise ValueError(f"model tensor {name} is on {t.device}, "
                                 f"the engine on {self.device}")
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.policy: SchedulingPolicy = get_policy(policy)
        self.preempt: Optional[PreemptionPolicy] = get_preemption(preempt)
        self.clock = clock if clock is not None else default_clock
        self.overlap = bool(overlap)
        if self.overlap and self.cfg.family not in STREAMING_FAMILIES:
            raise UnsupportedFamilyError(self.cfg.family,
                                         "overlapped (async) decode",
                                         supported=STREAMING_FAMILIES)
        self.on_token = on_token
        self._inflight: Optional[InflightStep] = None
        # prefill_buckets: None/True = auto (on for length-masked-decode
        # families, when the cache holds at least the smallest bucket),
        # False = off, or a BucketTable
        self.bucket_table: Optional[BucketTable] = None
        if prefill_buckets is None or prefill_buckets is True:
            if self.cfg.family in BUCKETED_FAMILIES and cache_len >= 8:
                self.bucket_table = BucketTable(min_bucket=8,
                                                max_bucket=cache_len)
        elif prefill_buckets is not False:
            if not isinstance(prefill_buckets, BucketTable):
                raise TypeError(
                    f"prefill_buckets must be a BucketTable, True, "
                    f"False, or None, got {prefill_buckets!r}")
            if self.cfg.family not in BUCKETED_FAMILIES:
                raise UnsupportedFamilyError(
                    self.cfg.family, "bucketed prefill",
                    supported=BUCKETED_FAMILIES)
            self.bucket_table = prefill_buckets
        # capacity-stable MoE bucketing: every prefill of a bucketed moe
        # engine carries the true length and its capacity (static int32
        # buffers, so a bucket stays one program)
        self._moe_masked = (self.cfg.family == "moe"
                            and self.bucket_table is not None)
        self.chunk_tokens = 0
        self._recurrent_chunk = False
        if prefill_chunk:
            if self.cfg.family not in CHUNKED_FAMILIES:
                raise UnsupportedFamilyError(self.cfg.family,
                                             "chunked prefill",
                                             supported=CHUNKED_FAMILIES)
            self._recurrent_chunk = self.cfg.family in RECURRENT_FAMILIES
            if prefill_chunk is True:
                self.chunk_tokens = (self.bucket_table.min_bucket
                                     if self.bucket_table else 8)
            else:
                if int(prefill_chunk) < 1:
                    raise ValueError(
                        f"prefill_chunk must be >= 1, got {prefill_chunk}")
                self.chunk_tokens = int(prefill_chunk)
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype
        self.quantized = bool(weight_dtype or kv_dtype)
        if self.quantized:
            if weight_dtype is not None \
                    and weight_dtype not in lm_quant.WEIGHT_DTYPES:
                raise ValueError(
                    f"weight_dtype must be one of {lm_quant.WEIGHT_DTYPES} "
                    f"or None, got {weight_dtype!r}")
            if kv_dtype is not None and kv_dtype not in lm_quant.KV_DTYPES:
                raise ValueError(
                    f"kv_dtype must be one of {lm_quant.KV_DTYPES} or None, "
                    f"got {kv_dtype!r}")
            if self.cfg.family not in WEIGHT_QUANT_FAMILIES:
                raise UnsupportedFamilyError(
                    self.cfg.family, "quantized serving (SERVING_*_Q)",
                    supported=WEIGHT_QUANT_FAMILIES)
            if kv_dtype and self.cfg.family not in KV_QUANT_FAMILIES:
                raise UnsupportedFamilyError(
                    self.cfg.family, "int8 KV cache (requires a dense "
                                     "(KH, C, dh) cache layout)",
                    supported=KV_QUANT_FAMILIES)
            if self.chunk_tokens:
                raise ValueError(
                    "prefill_chunk does not compose with quantized "
                    "serving (the chunk ops write float KV rows)")
            if mesh is not None:
                raise ValueError(
                    "mesh does not compose with quantized serving (the "
                    "quantized weights and scales have no partition "
                    "specs)")
            if weight_dtype:
                self.params = params = lm_quant.quantize_lm_params(
                    params, self.cfg, weight_dtype)
        self.kv_block = int(kv_block) if kv_block else 0
        self.paged = bool(self.kv_block)
        if self.paged:
            if self.cfg.family not in PAGED_FAMILIES:
                raise UnsupportedFamilyError(self.cfg.family,
                                             serving_ops.PAGED_FEATURE,
                                             supported=PAGED_FAMILIES)
            if self.kv_block < 1 or cache_len % self.kv_block:
                raise ValueError(
                    f"kv_block must divide cache_len, got "
                    f"{self.kv_block} vs {cache_len}")
            self.n_table = cache_len // self.kv_block
        # --- mesh sharding: this rank's weights and arena shapes, before
        # anything is allocated (the family gate first, as the JAX engine)
        self.mesh = mesh
        self._shard: Optional[Dict[str, Any]] = None
        self._seq_kv = False
        if mesh is not None:
            if self.cfg.family not in SHARDED_FAMILIES:
                raise UnsupportedFamilyError(self.cfg.family,
                                             "mesh-sharded serving",
                                             supported=SHARDED_FAMILIES)
            if not isinstance(mesh, Mesh) or mesh.abstract \
                    or "model" not in mesh.axis_names:
                raise TypeError(f"mesh={mesh!r}: a serving mesh of this "
                                f"process's ranks is needed "
                                f"(launch.mesh.make_serving_mesh)")
            dtype = self.cfg.torch_dtype()
            n_blocks = (int(kv_pool_blocks) if kv_pool_blocks
                        else max_slots * self.n_table + 1) if self.paged \
                else max_slots
            self._shard = engine_shardings(
                self.cfg, mesh, empty_model(self.cfg, "meta"),
                bundle.empty_cache(n_blocks, self.kv_block or cache_len,
                                   dtype, "meta"),
                global_batch=n_blocks,
                cache1_tree=bundle.empty_cache(1, cache_len, dtype, "meta"))
            self.params = params = shard_params(params, mesh,
                                                fsdp=False)
            # the KV cache's rows split over the ranks (sequence mode)
            self._seq_kv = any(
                name in KV_LEAVES and len(sh.spec) > 3
                and sh.spec[3] == "model"
                for name, sh in self._shard["cache"].items())
        # resident weight bytes (a quantized model's payload and scales)
        # and KV bytes: the HBM footprint (this rank's on a mesh)
        self.param_bytes = _cache_bytes(t for _, t in _model_tensors(params))

        # --- the KV cache or pool: allocated once, interpreter-lifetime
        if self.paged:
            n_blocks = (int(kv_pool_blocks) if kv_pool_blocks
                        else max_slots * self.n_table + 1)
            self.pool = PagedKVPool(n_blocks, self.kv_block)
            self.kv_pool = self._empty_cache(n_blocks, self.kv_block)
            self.block_tables = torch.zeros(
                (max_slots, self.n_table), dtype=torch.int32,
                device=self.device)
            self._slot_blocks: List[List[int]] = [[] for _ in
                                                  range(max_slots)]
            self._slot_reserved: List[int] = [0] * max_slots
            self.cache = None
            self.kv_bytes = _cache_bytes(self.kv_pool.values())
        else:
            self.cache = self._empty_cache(max_slots, cache_len)
            self.kv_bytes = _cache_bytes(self.cache.values())
        if arena is None:
            arena = TwoStackArena(arena_bytes or align_up(
                self.kv_bytes + (64 << 10)) * 2)
        self.arena = arena
        arena.allocate_persistent(self.kv_bytes, tag="kv_cache")

        # --- slot bookkeeping: device tensors the decode step reads,
        # and their host mirrors (the host never reads the device ones)
        self.slot_req: List[Optional[RequestResult]] = [None] * max_slots
        self.slot_meta: List[Optional[Request]] = [None] * max_slots
        self.slot_budget = np.zeros(max_slots, np.int64)
        self.lengths = torch.zeros(max_slots, dtype=torch.int32,
                                   device=self.device)
        self.cur_tokens = torch.zeros((max_slots, 1), dtype=torch.int64,
                                      device=self.device)
        self._len_host = np.zeros(max_slots, np.int64)
        self._cur_host = np.zeros((max_slots, 1), np.int64)
        self.active = np.zeros(max_slots, bool)
        self.queue: List[Request] = []
        self.results: Dict[int, RequestResult] = {}
        self._chunking: Dict[int, _ChunkState] = {}
        self._ckpt: Dict[int, SlotCheckpoint] = {}
        # what the last step() did: prefill token counts, chunk
        # dispatches, decode dispatch, tokens emitted
        self.last_step: Dict[str, Any] = {"prefill_tokens": [],
                                          "chunks": 0, "decoded": False,
                                          "processed": 0}

        # --- steps resolved at init, like interpreter prepare ----------
        prefill_code = OpCode.SERVING_PREFILL
        decode_code = (OpCode.SERVING_DECODE_PAGED if self.paged
                       else OpCode.SERVING_DECODE)
        qparams: Dict[str, Any] = {}
        if self.quantized:
            # two opcodes cover the quantized matrix: paged-ness, KV quant
            # and the weight dtype ride the op params
            prefill_code = OpCode.SERVING_PREFILL_Q
            decode_code = OpCode.SERVING_DECODE_Q
            qparams = {"paged": self.paged, "kv_q": bool(kv_dtype),
                       "weight_dtype": weight_dtype}
        if self.paged:
            chunk_code = OpCode.SERVING_PREFILL_CHUNK_PAGED
        elif self._recurrent_chunk:
            chunk_code = OpCode.SERVING_PREFILL_CHUNK_STATE
        else:
            chunk_code = OpCode.SERVING_PREFILL_CHUNK
        opcodes = [prefill_code, decode_code]
        if self.chunk_tokens:
            opcodes.append(chunk_code)
        self.resolver = MicroMutableOpResolver(tags).add_many(opcodes)
        window = self.cfg.sliding_window
        decode_params = {"window": window, **qparams}
        if self.paged:
            decode_params["kv_block"] = self.kv_block
        seq = {"seq_kv": True} if self._seq_kv else {}
        decode_params.update(seq)
        # the programs share one graph pool: each replay's outputs are
        # read or copied before the next replay
        self.graph_pool = GraphPool()
        self._prefill = CapturedProgram(
            self._bind(prefill_code, {"cache_len": cache_len,
                                      "window": window, **qparams}),
            name="prefill", pool=self.graph_pool,
            max_signatures=PREFILL_PROGRAMS)
        self._decode = CapturedProgram(self._bind(decode_code, decode_params),
                                       name="decode", pool=self.graph_pool)
        # overlap mode's device-side greedy sampler: a program of its own,
        # so the decode program stays the one sync mode runs
        # (capture_count(self._decode) == 1 either way).  It reads the
        # decode's logits from a static buffer (made at the first
        # overlapped step: the decode program's first call returns its
        # eager result, later calls its own output buffers) and writes
        # cur_tokens in place.  Its function holds the vocab, not the
        # engine: a program that references its engine would put the
        # engine in a reference cycle, freed by the cyclic collector at
        # any later allocation, and a graph freed while another is being
        # captured invalidates that capture
        self._argmax = CapturedProgram(
            functools.partial(_greedy, self.cfg.vocab), name="argmax",
            pool=self.graph_pool)
        self._logits: Optional[torch.Tensor] = None
        self._readback = (TokenReadback(max_slots, torch.int64, self.device)
                          if self.overlap else None)
        self._prefill_chunk = (CapturedProgram(
            self._bind(chunk_code, {"window": window, **seq}), name="chunk",
            pool=self.graph_pool) if self.chunk_tokens else None)
        # static inputs of the programs: prefill's tokens (a prompt of S
        # tokens is the first S of one buffer); the chunk step's tokens,
        # start, true token count and table row, and (contiguous and
        # recurrent) the batch=1 cache a chunking slot's cache is copied
        # into and out of
        self._prefill_tokens = torch.zeros((1, cache_len), dtype=torch.int64,
                                           device=self.device)
        # a request's extras, each in a static buffer per (name, shape,
        # dtype); a bucketed moe prefill's true length and capacity
        self._extras: Dict[Any, torch.Tensor] = {}
        if self._moe_masked:
            self._n_valid = torch.zeros((), dtype=torch.int32,
                                        device=self.device)
            self._moe_cap = torch.zeros((), dtype=torch.int32,
                                        device=self.device)
        if self.chunk_tokens:
            self._chunk_tokens = torch.zeros((1, self.chunk_tokens),
                                             dtype=torch.int64,
                                             device=self.device)
            self._chunk_start = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
            self._chunk_real = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
            if self.paged:
                self._chunk_row = torch.zeros(self.n_table, dtype=torch.int32,
                                              device=self.device)
            else:
                self._chunk_cache = self._empty_cache(1, cache_len)

    @classmethod
    def from_profile(cls, bundle: ModelBundle, params: torch.nn.Module,
                     profile: Any = None, **kw) -> "ServingEngine":
        """Construct an engine from a ``CalibrationProfile``
        (``repro_torch.core.costmodel``) instead of hand-picked constants:
        the profile's solved bucket levels become the engine's
        ``BucketTable``, its solved ``prefill_chunk`` the chunk size and
        its ``kv_block`` the paged-KV block size, with no re-measurement.
        ``cache_len`` defaults to the capacity the profile was calibrated
        at.

        The profile must match this model and cache capacity
        (``profile.matches``) AND the device this engine runs on
        (``profile.matches_device``; ``device=`` as for the constructor,
        the card by default): a profile measured on another model, on the
        CPU or on another card model is someone else's cost landscape and
        is refused with a ``ValueError`` naming it.  Explicit keyword
        arguments win over the profile (pass ``prefill_buckets=`` /
        ``prefill_chunk=`` / ``kv_block=`` to pin them).

        With ``profile=None`` the port's profile cache
        (``costmodel.DEFAULT_PROFILE_DIR``, under ``build/``) is
        consulted: a profile saved there for this model and cache_len
        (``save_cached_profile``) is applied; none, or one measured on
        another device, quietly falls back to the ordinary constructor
        (a cache miss is not an error, unlike an explicitly passed
        stale profile)."""
        from repro_torch.core.costmodel import (device_identity,
                                                load_cached_profile,
                                                profile_model_key)
        device = kw.get("device", "cuda")
        if profile is None:
            key = profile_model_key(bundle.cfg, kw.get("cache_len", 256))
            profile = load_cached_profile(key)
            if profile is not None and not profile.matches_device(device):
                profile = None
            if profile is None:
                return cls(bundle, params, **kw)
        kw.setdefault("cache_len", profile.cache_len)
        if not profile.matches(bundle.cfg, kw["cache_len"]):
            raise ValueError(
                f"profile was calibrated for {profile.model_key!r}, "
                f"not {profile_model_key(bundle.cfg, kw['cache_len'])!r}"
                f" — re-calibrate (or share deliberately through "
                f"MultiTenantHost(profile=...))")
        if not profile.matches_device(device):
            raise ValueError(
                f"profile was measured on {profile.measured_on()!r}, but "
                f"this engine runs on {device_identity(device)!r} — costs "
                f"are hardware facts; re-calibrate on this device")
        # each solved knob applies only where the family supports the
        # fast path it drives (a profile calibrated on a bucketing
        # family must not force buckets onto an ssm engine)
        if bundle.cfg.family in BUCKETED_FAMILIES:
            kw.setdefault("prefill_buckets", profile.bucket_table())
        if bundle.cfg.family in CHUNKED_FAMILIES:
            kw.setdefault("prefill_chunk", profile.prefill_chunk or None)
        if profile.kv_block and bundle.cfg.family in PAGED_FAMILIES:
            kw.setdefault("kv_block", profile.kv_block)
        return cls(bundle, params, **kw)

    def _bind(self, code: OpCode, params: Dict[str, Any]):
        """Resolve ``code`` through the tag chain, run its prepare() once
        and return its eval bound to the prepared context and the op."""
        op = OpDef(code, (), (), params=params)
        reg = self.resolver.resolve(code)
        ctx = serving_ops.ServingContext(
            self.bundle, reg.prepare(serving_ops.ServingContext(self.bundle),
                                     op).op_data)
        return functools.partial(reg.eval, ctx, op)

    def prefill_compiles(self) -> int:
        """How many distinct prefill programs were captured — the
        trace-count hook.  With bucketing on, this is the number of
        buckets HIT, independent of how many prompt lengths arrived;
        at most ``PREFILL_PROGRAMS`` are held."""
        return capture_count(self._prefill)

    def chunk_compiles(self) -> int:
        """How many distinct chunk-prefill programs were captured — must
        stay 1 however many prompts/chunks ran (the start offset and the
        true token count are int32 tensors, never shapes)."""
        return (capture_count(self._prefill_chunk)
                if self._prefill_chunk is not None else 0)

    def programs(self) -> Dict[str, CapturedProgram]:
        """The engine's programs by name (decode, prefill, chunk, and
        argmax on an overlapped engine)."""
        progs = {"decode": self._decode, "prefill": self._prefill}
        if self._prefill_chunk is not None:
            progs["chunk"] = self._prefill_chunk
        if self.overlap:
            progs["argmax"] = self._argmax
        return progs

    @staticmethod
    def _check_in_place(returned: Dict[str, torch.Tensor],
                        bound: Dict[str, torch.Tensor]) -> None:
        """A step updates the cache or pool it was given in place (the
        programs are bound to its addresses): the one it returns must be
        that one, or the update would be lost."""
        if any(returned[name].data_ptr() != t.data_ptr()
               for name, t in bound.items()):
            raise RuntimeError("a step returned a new cache or pool instead "
                               "of updating the bound one in place")

    def _run_prefill(self, prompt: np.ndarray, extras=None,
                     true_len: Optional[int] = None):
        """One prefill of ``prompt`` (host tokens) through the program of
        its length, its inputs staged by ``_stage_prefill``.  The
        returned cache is valid until the next prefill."""
        return self._prefill((self.params, self._stage_prefill(
            prompt, extras, true_len)))

    def _stage_prefill(self, prompt: np.ndarray, extras=None,
                       true_len: Optional[int] = None) -> Dict[str, Any]:
        """The prefill program's batch for ``prompt`` (host tokens): the
        tokens written into the first ``len(prompt)`` of the static token
        buffer (grown, and the prefill programs dropped, for a prompt
        longer than the cache), a request's ``extras`` into their static
        buffers, and on a bucketed moe engine the true length
        ``true_len`` (by default the prompt's) and its expert capacity
        into theirs."""
        s = len(prompt)
        if s > self._prefill_tokens.shape[1]:
            self._prefill.clear()
            self._prefill_tokens = torch.zeros(
                (1, s), dtype=torch.int64, device=self.device)
        toks = self._prefill_tokens[:, :s]
        toks.copy_(torch.from_numpy(prompt[None].astype(np.int64)))
        batch = {"tokens": toks}
        if self._moe_masked:
            true_len = s if true_len is None else true_len
            self._n_valid.fill_(true_len)
            self._moe_cap.fill_(lm.moe_capacity(self.cfg, true_len))
            batch["n_valid"], batch["moe_cap"] = self._n_valid, self._moe_cap
        for name, value in (extras or {}).items():
            value = torch.from_numpy(np.asarray(value)[None])
            key = (name, tuple(value.shape), value.dtype)
            if key not in self._extras:
                self._extras[key] = torch.empty(value.shape,
                                                dtype=value.dtype,
                                                device=self.device)
            batch[name] = self._extras[key]
            batch[name].copy_(value)
        return batch

    # ------------------------------------------------------------------
    def _now(self) -> int:
        """The clock a scheduling decision reads: ``clock()``, on a mesh
        the ``model`` axis's rank 0's (every rank calls this at the same
        points, so every rank decides alike)."""
        now = self.clock()
        return now if self.mesh is None else self.mesh.broadcast_host(now)

    def submit(self, req: Request) -> None:
        if req.arrival_us is None:
            req.arrival_us = self._now()
        self.queue.append(req)
        self.results[req.uid] = RequestResult(uid=req.uid,
                                              prompt_len=len(req.tokens))

    def _empty_cache(self, batch: int, length: int,
                     every_row: bool = False) -> Dict[str, torch.Tensor]:
        """The family's zeroed cache for ``batch`` sequences: {k, v} of
        (L, batch, KH, length, dh) for the dense family — the slot rings, a
        batch=1 cache, or (batch = blocks, length = BS) the pool; with an
        int8 KV cache the quantized {k, v, k_scale, v_scale} layout (int8
        zeros, scales 1.0) — or the recurrent {conv, state} (+ hybrid's
        {attn_k, attn_v} of ``length`` positions).  On a mesh, this
        rank's share of it (``cache_sharding``); with ``every_row``, with
        every KV row, as a prefill emits it."""
        if self.mesh is not None:
            full = self.bundle.empty_cache(batch, length,
                                           self.cfg.torch_dtype(), "meta")
            shard = cache_sharding(self.cfg, self.mesh, full, batch)
            out = {}
            for name, t in full.items():
                shape = list(shard[name].local_shape(t.shape))
                if every_row and name in KV_LEAVES:
                    shape[3] = t.shape[3]
                out[name] = torch.zeros(shape, dtype=t.dtype,
                                        device=self.device)
            return out
        cache = self.bundle.empty_cache(batch, length,
                                        self.cfg.torch_dtype(), self.device)
        if self.kv_dtype:
            cache = lm_quant.quantize_cache(cache)
        return cache

    def insert_slot_state(self, slot: int,
                          new_cache: Dict[str, torch.Tensor]) -> None:
        """Copy a batch=1 cache (on any device) into slot ``slot`` in
        place — the state-INSERTION hook, inverse of
        ``extract_slot_state``.  Every family's leaves (KV rings, or the
        recurrent conv window, SSD state and shared-attention KV) keep the
        batch on axis 1.  The slot index is a host-side offset, so a
        checkpoint restores into ANY slot."""
        for name, full in self.cache.items():
            full[:, slot:slot + 1].copy_(new_cache[name])

    def extract_slot_state(self, slot: int) -> Dict[str, torch.Tensor]:
        """Slot ``slot``'s cache rows (KV, or the recurrent state exactly
        as the decode step left it) as a batch=1 cache of CPU copies — the
        state-EXTRACTION hook a ``SlotCheckpoint`` carries.  Drains the
        step in flight first."""
        self.drain()
        return {name: full[:, slot:slot + 1].to("cpu", copy=True)
                for name, full in self.cache.items()}

    def _padded_prompt(self, tokens: np.ndarray) -> np.ndarray:
        """Right-pad the prefill prompt to its power-of-two bucket.
        Padded positions produce KV rows the length-masked decode never
        attends to (and the first decode steps overwrite them ring slot
        by ring slot).  Prompts longer than the largest bucket that fits
        the cache stay at exact length (the ring-wrap case)."""
        s = len(tokens)
        padded = self.bucket_table.fit(s)
        if padded is None or padded > self.cache_len - self._vis():
            return tokens                   # over-cap: exact length
        self.bucket_table.bucket(s)         # committed: count the hit
        if padded == s:
            return tokens
        return np.concatenate([tokens, np.zeros(padded - s, tokens.dtype)])

    def _local_rows(self, cache1: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A prefill's batch=1 cache (every row) as this rank holds one:
        where the KV rows are split (``seq_kv``), this rank's rows of each
        KV leaf, copied; otherwise the cache as it is."""
        if not self._seq_kv:
            return cache1
        return {name: self._shard["cache1"][name].local(t)
                if name in KV_LEAVES else t for name, t in cache1.items()}

    def _vis(self) -> int:
        """Cache positions the vision prefix takes (vlm only)."""
        return self.cfg.n_vision_tokens if self.cfg.family == "vlm" else 0

    # -- paged KV: block accounting --------------------------------------

    def _blocks_needed(self, req: Request) -> int:
        """Worst-case blocks for ``req``: prompt + full decode budget (at
        least the one row activation maps), capped at the ring capacity.
        Reserved (not mapped) at admission so on-demand growth can never
        fail mid-decode."""
        rows = min(self._vis() + len(req.tokens) - 1
                   + max(req.max_new_tokens, 1), self.cache_len)
        return max(1, -(-rows // self.kv_block))

    def _paged_admissible(self, req: Request) -> bool:
        """Can ``req`` take a slot right now?  A checkpointed request's
        blocks are already pinned in its checkpoint; a fresh one needs
        its worst case reservable from the pool."""
        return (req.uid in self._ckpt
                or self.pool.can_reserve(self._blocks_needed(req)))

    def _ensure_blocks(self, slot: int, upto_pos: int) -> None:
        """Map blocks (debiting the slot's reservation) until the slot's
        table covers cache position ``upto_pos``.  Host bookkeeping only;
        ``_sync_table_row`` publishes the row to the device table."""
        blocks = self._slot_blocks[slot]
        while (len(blocks) * self.kv_block <= upto_pos
               and len(blocks) < self.n_table):
            blocks.append(self.pool.map_block())
            self._slot_reserved[slot] -= 1

    def _table_row(self, slot: int) -> np.ndarray:
        """The slot's block-table row from host bookkeeping: mapped
        blocks in logical order, the garbage block for the unmapped
        tail."""
        row = np.zeros(self.n_table, np.int32)
        blocks = self._slot_blocks[slot]
        row[:len(blocks)] = blocks
        return row

    def _sync_table_row(self, slot: int) -> None:
        """Publish the slot's row into the DECODE block table, in place.
        Only a decoding slot's row may be live there: the decode step
        ring-writes EVERY slot row, so a slot that is inactive or
        mid-chunked-prefill keeps its decode row on the garbage block
        (its chunk dispatches carry ``_table_row`` directly) or stale
        decode writes would corrupt its blocks."""
        self.block_tables[slot].copy_(torch.from_numpy(self._table_row(slot)))

    def _scatter_slot_cache(self, slot: int,
                            cache1: Dict[str, torch.Tensor]) -> None:
        """Scatter a contiguous batch=1 cache (L,1,KH,C,dh) — and, with an
        int8 KV cache, its scales (L,1,KH,C) — into the slot's mapped
        blocks, in place: one-shot prefill lands contiguous, then pages
        in.  Unmapped table entries point at the garbage block, which
        absorbs the tail of the scatter.  Where the pool holds this
        rank's rows of each block (``seq_kv``), those rows of each
        block."""
        row = torch.from_numpy(self._table_row(slot)).long().to(self.device)
        t, bs = self.n_table, self.kv_block
        for name, pool in self.kv_pool.items():
            l, _, kh, held = pool.shape[:4]
            src = cache1[name][:, 0].reshape(l, kh, t, bs, *pool.shape[4:])
            if held < bs:
                src = src.narrow(3, self.mesh.coords["model"] * held, held)
            pool[:, row] = src.transpose(1, 2).to(pool.dtype)

    def _release_slot_blocks(self, slot: int) -> None:
        """Return a finished slot's blocks and unspent reservation to the
        pool and point its table row back at the garbage block."""
        self.pool.release(self._slot_blocks[slot],
                          reserved=max(self._slot_reserved[slot], 0))
        self._slot_blocks[slot] = []
        self._slot_reserved[slot] = 0
        self.block_tables[slot].zero_()

    def _activate_slot(self, req: Request, slot: int,
                       cache1: Optional[Dict[str, torch.Tensor]] = None, *,
                       length: Optional[int] = None,
                       cur_token: Optional[int] = None,
                       budget: Optional[int] = None) -> None:
        """Hand a prefilled (or restored) request to the decode loop:
        write its cache rows and the slot bookkeeping the decode step
        reads.  The keyword overrides are the restore path."""
        last_pos = (len(req.tokens) - 1 + self._vis() if length is None
                    else length)
        tok = int(req.tokens[-1]) if cur_token is None else cur_token
        if self.paged:
            # cover everything written so far PLUS the position the next
            # decode step writes, then go live in the decode block table
            self._ensure_blocks(slot, min(last_pos, self.cache_len - 1))
            self._sync_table_row(slot)
        if cache1 is not None:
            if self.paged:
                self._scatter_slot_cache(slot, cache1)
            else:
                self.insert_slot_state(slot, cache1)
        self.slot_req[slot] = self.results[req.uid]
        self.slot_meta[slot] = req
        self.slot_budget[slot] = (req.max_new_tokens if budget is None
                                  else budget)
        self.active[slot] = True
        self._len_host[slot] = last_pos
        self._cur_host[slot, 0] = tok
        self.lengths[slot] = last_pos
        self.cur_tokens[slot, 0] = tok

    def _prefill_one(self, req: Request, slot: int) -> None:
        """Prefill tokens[:-1], then hand the LAST prompt token to the
        decode loop: the first decode step writes its KV and emits the
        first new token."""
        t0 = time.perf_counter()
        if len(req.tokens) >= 2:
            prompt = np.asarray(req.tokens[:-1])
            if self.bucket_table is not None:
                prompt = self._padded_prompt(prompt)
            _, cache1 = self._run_prefill(prompt, req.extras,
                                          len(req.tokens) - 1)
            if not self.paged:
                cache1 = self._local_rows(cache1)
            self.last_step["prefill_tokens"].append(len(prompt))
            self.policy.charge(req.tenant, 1.0)
        else:   # single-token prompt: the slot starts from a fresh cache
            cache1 = self._empty_cache(1, self.cache_len,
                                       every_row=self.paged)
        self._activate_slot(req, slot, cache1)
        self._settle()
        self.results[req.uid].prefill_s += time.perf_counter() - t0

    def _settle(self) -> None:
        """Wait for the device, so a prefill's time runs to completion."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- chunked prefill (one chunk per engine step) --------------------

    def _chunk_eligible(self, req: Request) -> bool:
        """Chunk when chunking is on, the prompt spans more than one
        chunk, and the padded last chunk still fits the cache without
        ring wrap (past that, fall back to one-shot exact prefill)."""
        if not self.chunk_tokens:
            return False
        m = len(req.tokens) - 1
        if m <= self.chunk_tokens:
            return False
        return (self._vis() + -(-m // self.chunk_tokens) * self.chunk_tokens
                <= self.cache_len)

    def _start_chunked(self, req: Request, slot: int) -> None:
        """Admit a long prompt into a slot in PREFILLING state: run the
        FIRST chunk through the ordinary prefill step, keep its batch=1
        cache (paged: page it into the pool) in a ``_ChunkState``, and
        let the following ``step()`` calls advance one chunk each.

        Recurrent families skip the prefill step: the carried-state chunk
        op is seeded with an EMPTY cache (a zero conv window is the zero
        left padding ``_causal_conv`` assumes, a zero state no history),
        and every chunk, the first included, goes through it."""
        if self._recurrent_chunk:
            self._chunking[slot] = _ChunkState(
                req, self._empty_cache(1, self.cache_len), 0)
            self._advance_chunk(slot)
            return
        t0 = time.perf_counter()
        first = np.asarray(req.tokens[:self.chunk_tokens])
        _, cache1 = self._run_prefill(first, req.extras)
        self.last_step["prefill_tokens"].append(len(first))
        self.policy.charge(req.tenant, 1.0)
        if self.paged:
            # page the first chunk in now; later chunks write the pool
            # directly through the paged chunk op
            self._ensure_blocks(slot, min(self._vis() + len(first) - 1,
                                          self.cache_len - 1))
            self._scatter_slot_cache(slot, cache1)
            cache1 = None
        else:
            # the slot's own copy: the prefill program's output is
            # overwritten by its next replay
            cache1 = {name: t.clone()
                      for name, t in self._local_rows(cache1).items()}
        self._chunking[slot] = _ChunkState(req, cache1, len(first))
        self._settle()
        self.results[req.uid].prefill_s += time.perf_counter() - t0

    def _chunk_args(self):
        """The chunk program's arguments, all at fixed addresses: the
        model, the pool and the table row (paged) or the static batch=1
        cache, the chunk's tokens and start, and (recurrent) its true
        token count."""
        if self.paged:
            return (self.params, self.kv_pool, self._chunk_row,
                    self._chunk_tokens, self._chunk_start)
        if self._recurrent_chunk:
            return (self.params, self._chunk_cache, self._chunk_tokens,
                    self._chunk_start, self._chunk_real)
        return (self.params, self._chunk_cache, self._chunk_tokens,
                self._chunk_start)

    def _advance_chunk(self, slot: int) -> None:
        """Advance a PREFILLING slot by ONE chunk, one replay of the chunk
        program: the tokens, the offset ``start`` and the true token
        count go through static tensors (the offset checked here, on the
        host); the final partial chunk is right-padded (its rows sit past
        the prompt, so the length-masked decode never attends to them and
        the first decode steps overwrite them).  A contiguous or
        recurrent slot's batch=1 cache is copied into the program's
        static cache and back.  When the last prompt token's predecessor
        lands, the slot turns to decoding."""
        cs = self._chunking[slot]
        res = self.results[cs.req.uid]
        t0 = time.perf_counter()
        prompt = np.asarray(cs.req.tokens[:-1])
        tok = prompt[cs.done:cs.done + self.chunk_tokens]
        real = len(tok)
        if real < self.chunk_tokens:
            tok = np.concatenate(
                [tok, np.zeros(self.chunk_tokens - real, tok.dtype)])
        start = cs.done + self._vis()
        lm.check_chunk_fits(start, self.chunk_tokens, self.cache_len)
        self._chunk_tokens.copy_(torch.from_numpy(tok[None].astype(np.int64)))
        self._chunk_start.fill_(start)
        if self.paged:
            # map the blocks of the chunk's REAL rows only: the padded
            # tail of a final chunk is not in the reservation, and its
            # rows past the mapped blocks land on the garbage block (no
            # real query attends to them)
            self._ensure_blocks(slot, min(start + real - 1,
                                          self.cache_len - 1))
            self._chunk_row.copy_(torch.from_numpy(self._table_row(slot)))
            out = self._prefill_chunk(self._chunk_args())
            self._check_in_place(out, self.kv_pool)
        else:
            stage = self._chunk_cache
            for name, t in stage.items():
                t.copy_(cs.cache1[name])
            if self._recurrent_chunk:
                # the chunk's true token count rides along: the padded
                # tail of a final chunk is an exact state no-op
                self._chunk_real.fill_(real)
            out = self._prefill_chunk(self._chunk_args())
            self._check_in_place(out, stage)
            for name, t in cs.cache1.items():
                t.copy_(stage[name])
        cs.done += real
        self.last_step["chunks"] += 1
        self.policy.charge(cs.req.tenant, 1.0)
        self._settle()
        res.prefill_s += time.perf_counter() - t0
        if cs.done >= len(prompt):
            del self._chunking[slot]
            self._activate_slot(cs.req, slot, cs.cache1)

    # -- preemption: slot checkpoint / evict / restore ------------------

    def snapshot_slot(self, slot: int) -> SlotCheckpoint:
        """Capture a running slot's continuation state host-side: the
        chunked-prefill cache + progress for a PREFILLING slot, the KV
        rows + (length, next token, budget) for a DECODING one; on a
        paged engine the block ids instead of any KV.  The slot itself
        is untouched — pair with ``_evict``.  On an overlapped engine the
        step in flight is drained first, so the captured (length, token,
        budget) triple is the one after its emission."""
        self.drain()
        if slot in self._chunking:
            cs = self._chunking[slot]
            if self.paged:
                return SlotCheckpoint(
                    phase="prefill", cache=None, done_tokens=cs.done,
                    blocks=list(self._slot_blocks[slot]),
                    reserved=self._slot_reserved[slot])
            return SlotCheckpoint(
                phase="prefill", done_tokens=cs.done,
                cache={name: t.to("cpu", copy=True)
                       for name, t in cs.cache1.items()})
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not running")
        ckpt = SlotCheckpoint(
            phase="decode", cache=None, length=int(self._len_host[slot]),
            cur_token=int(self._cur_host[slot, 0]),
            budget=int(self.slot_budget[slot]))
        if self.paged:
            # no KV copy: the rows stay in the pool, the checkpoint pins
            # the block ids
            ckpt.blocks = list(self._slot_blocks[slot])
            ckpt.reserved = self._slot_reserved[slot]
        else:
            ckpt.cache = self.extract_slot_state(slot)
        return ckpt

    def _evict(self, slot: int) -> Request:
        """Preempt the request running (or prefilling) in ``slot``:
        checkpoint it, free the slot, and put the request back on the
        queue (its checkpoint is picked up at re-admission).  Drains the
        step in flight first: callers picking a victim must choose AFTER
        the drain (a retirement it settles may free the slot)."""
        self.drain()
        if slot in self._chunking:
            req = self._chunking[slot].req
            ckpt = self.snapshot_slot(slot)
            del self._chunking[slot]
        else:
            req = self.slot_meta[slot]
            if req is None:
                raise RuntimeError(f"slot {slot} has no request")
            ckpt = self.snapshot_slot(slot)
            self.active[slot] = False
            self.slot_req[slot] = None
            self.slot_meta[slot] = None
        if self.paged:
            # the blocks now belong to the checkpoint: detach the slot
            # (table row back to the garbage block) without releasing
            self._slot_blocks[slot] = []
            self._slot_reserved[slot] = 0
            self.block_tables[slot].zero_()
        self._ckpt[req.uid] = ckpt
        self.results[req.uid].preemptions += 1
        self.queue.append(req)
        return req

    def _restore_slot(self, req: Request, slot: int,
                      ckpt: SlotCheckpoint) -> None:
        """Re-admit a checkpointed request: a PREFILLING checkpoint
        resumes its chunk loop, a DECODING one re-enters the decode loop
        at exactly the captured state — the decode step is a pure
        function of (cache, token, length), so the continuation matches
        the uninterrupted run.  On a paged engine the pinned block ids
        attach to the new slot; the KV rows never moved."""
        if self.paged:
            self._slot_blocks[slot] = list(ckpt.blocks or [])
            self._slot_reserved[slot] = ckpt.reserved
            cache1 = None
        elif ckpt.phase == "prefill":
            cache1 = {name: t.to(self.device)
                      for name, t in ckpt.cache.items()}
        else:
            cache1 = ckpt.cache
        if ckpt.phase == "prefill":
            # a resumed chunked prefill keeps its decode row on the
            # garbage block: chunk dispatches carry the row directly
            self._chunking[slot] = _ChunkState(req, cache1, ckpt.done_tokens)
        else:
            self._activate_slot(req, slot, cache1, length=ckpt.length,
                                cur_token=ckpt.cur_token, budget=ckpt.budget)

    def _admit(self, req: Request, slot: int) -> None:
        """Route an admission: restore a checkpointed request, start a
        chunked prefill for a long prompt, or prefill one-shot.  On a
        paged engine a FRESH admission reserves its worst-case block
        count up front (the caller checked ``_paged_admissible``), so
        every later ``map_block`` is infallible."""
        ckpt = self._ckpt.pop(req.uid, None)
        if ckpt is not None:
            self._restore_slot(req, slot, ckpt)
            return
        if self.paged:
            need = self._blocks_needed(req)
            self.pool.reserve(need)
            self._slot_reserved[slot] = need
        if self._chunk_eligible(req):
            self._start_chunked(req, slot)
        else:
            self._prefill_one(req, slot)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy tokens: argmax over the true vocab in float32, first
        maximum on ties — the one device-to-host read of a sync step."""
        return (logits[:, :self.cfg.vocab].float().argmax(dim=-1)
                .cpu().numpy())

    def _emit(self, res: RequestResult, tok: int, final: bool) -> None:
        """Append + stream one token — the single place a token becomes
        visible, in both modes, so the output list, the TTFT stamp and
        the ``on_token`` StreamEvent agree by construction (in order,
        exactly once: every snapshot path drains first, so it captures
        the state after emission)."""
        res.output.append(tok)
        self.last_step["processed"] += 1
        now = self.clock()
        if res.first_token_us is None:
            res.first_token_us = now
        if self.on_token is not None:
            self.on_token(StreamEvent(uid=res.uid,
                                      index=len(res.output) - 1,
                                      token=tok, t_us=now, final=final))

    def _retire(self, slot: int) -> None:
        """Free a finished slot (and, paged, its blocks)."""
        self.slot_req[slot].done = True
        self.active[slot] = False
        self.slot_req[slot] = None
        self.slot_meta[slot] = None
        if self.paged:
            self._release_slot_blocks(slot)

    def _grow_blocks(self, slot: int) -> None:
        """Map the block the next decode step's ring write lands in
        (covered by the admission-time reservation) and write the slot's
        new decode-table entries in place, one fill each: no host-to-
        device copy, which would wait for an overlapped step in flight."""
        blocks = self._slot_blocks[slot]
        before = len(blocks)
        self._ensure_blocks(slot, int(self._len_host[slot]) % self.cache_len)
        for j in range(before, len(blocks)):
            self.block_tables[slot, j] = blocks[j]

    def _run_decode(self) -> torch.Tensor:
        """One replay of the decode program over every slot; it updates
        the cache or pool in place.  Returns the logits."""
        if self.paged:
            logits, kv = self._decode(
                (self.params, self.kv_pool, self.block_tables,
                 self.cur_tokens, self.lengths))
            self._check_in_place(kv, self.kv_pool)
        else:
            logits, kv = self._decode(
                (self.params, self.cache, self.cur_tokens, self.lengths))
            self._check_in_place(kv, self.cache)
        return logits

    # -- overlapped decode (docs/STREAMING.md) --------------------------

    def drain(self) -> None:
        """Settle the overlapped loop's step in flight, if any: wait for
        its tokens and run its host bookkeeping (emission, retirement,
        budget and quota charges).  Public because anything doing
        checkpoint surgery from outside — tests, the router, a server
        shutting down — must see consistent slot state first; every
        internal snapshot and evict path calls it.  A no-op on a sync
        engine or with nothing in flight."""
        step, self._inflight = self._inflight, None
        if step is not None:
            self._finish_inflight(step)

    def _finish_inflight(self, step: InflightStep) -> None:
        """Host half of a dispatched decode step: fetch its tokens and
        interpret them against the DISPATCH-TIME slot snapshot.  A slot
        that retired after the dispatch (its budget or EOS is learned one
        step late) is skipped: its extra decode was wasted device work
        whose KV write is overwritten before the slot's next activation
        (or lands on the paged garbage block or a released block that a
        later owner writes before reading), and its token is dropped."""
        t0 = time.perf_counter()
        toks = step.host_fetch()
        wait = time.perf_counter() - t0
        eos = self.cfg.vocab - 1
        for slot, res, req in step.slots:
            if res.done or self.slot_req[slot] is not res:
                continue        # retired between dispatch and readback
            res.decode_s += step.dispatch_s + wait
            self.policy.charge(req.tenant, 1.0)
            tok = int(toks[slot])
            self.slot_budget[slot] -= 1
            self._cur_host[slot, 0] = tok
            done = self.slot_budget[slot] <= 0 or tok == eos
            self._emit(res, tok, final=done)
            if done:
                self._retire(slot)

    def _dispatch_overlapped(self) -> None:
        """Dispatch one decode step WITHOUT reading it back, then settle
        the PREVIOUS step while the device works.  The argmax program
        writes ``cur_tokens`` on the device, so step i+1's inputs never
        pass through the host; the only wait, for step i's tokens,
        overlaps the device running step i+1."""
        pend = ({s for s, _, _ in self._inflight.slots}
                if self._inflight is not None else set())
        if self.paged:
            # grow at DISPATCH time from the host length mirror; a slot
            # whose budget is spent once the step in flight lands is
            # skipped (its write goes to the garbage block, and mapping
            # would overdraw its reservation)
            for slot in range(self.max_slots):
                if self.active[slot] and \
                        self.slot_budget[slot] - (slot in pend) > 0:
                    self._grow_blocks(slot)
        t0 = time.perf_counter()
        logits = self._run_decode()
        if self._logits is None:
            self._logits = torch.empty_like(logits)
        self._logits.copy_(logits)
        toks = self._argmax(self._logits, self.cur_tokens)
        self.lengths += 1
        self._len_host += 1
        self.last_step["decoded"] = True
        prev, self._inflight = self._inflight, self._readback.launch(
            toks, [(s, self.slot_req[s], self.slot_meta[s])
                   for s in range(self.max_slots) if self.active[s]],
            time.perf_counter() - t0)
        if prev is not None:
            self._finish_inflight(prev)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """One engine tick: advance chunked prefills by ONE chunk each,
        admit (policy order, displacing a running victim when the
        preemption policy says so; on a paged engine only while the
        pool can reserve the pick's worst case), then one fused decode
        step over the slots — on an overlapped engine dispatched, with
        the previous step's tokens emitted behind it.  Returns True if
        work remains."""
        self.last_step = {"prefill_tokens": [], "chunks": 0,
                          "decoded": False, "processed": 0}
        for slot in list(self._chunking):
            self._advance_chunk(slot)
        if self.queue:
            if self.overlap and self.preempt is not None:
                # settle the step in flight before any admission or
                # displacement decision: a victim's checkpoint must hold
                # the state after emission, and a retirement in flight
                # may free the slot the queue needs
                self.drain()
            now = self._now()
            for slot in range(self.max_slots):
                if self.queue and not self.active[slot] \
                        and slot not in self._chunking:
                    ci = self.policy.select(self.queue, now)
                    if self.paged \
                            and not self._paged_admissible(self.queue[ci]):
                        break
                    self._admit(self.queue.pop(ci), slot)
            # displacement: every slot busy, queue still holding work —
            # the preemption policy may evict a running victim for the
            # queue's policy-first candidate (its strict-improvement
            # contract bounds this loop by the slot count)
            if self.preempt is not None:
                for _ in range(self.max_slots):
                    if not self.queue:
                        break
                    running = ([(s, self._chunking[s].req)
                                for s in sorted(self._chunking)]
                               + [(s, self.slot_meta[s])
                                  for s in range(self.max_slots)
                                  if self.active[s]])
                    if not running:
                        break
                    ci = self.policy.select(self.queue, now)
                    cand = self.queue[ci]
                    vi = self.preempt.victim([r for _, r in running],
                                             cand, now)
                    if vi is None:
                        break
                    if self.paged and not self._paged_admissible(cand):
                        break   # evicting frees no blocks (they pin to
                        # the checkpoint), so check BEFORE evicting
                    self.queue.pop(ci)
                    slot = running[vi][0]
                    self._evict(slot)
                    self._admit(cand, slot)
        if self.overlap and self.active.any() \
                and self._inflight is not None:
            pend = {s for s, _, _ in self._inflight.slots}
            if all(self.slot_budget[s] - (s in pend) <= 0
                   for s in range(self.max_slots) if self.active[s]):
                # every active slot's budget is spent once the step in
                # flight lands: drain instead of dispatching a step whose
                # every token would be dropped
                self.drain()
        if not self.active.any():
            self.drain()
            return bool(self.active.any() or self.queue or self._chunking)
        if self.overlap:
            self._dispatch_overlapped()
            return bool(self.active.any() or self.queue or self._chunking
                        or self._inflight is not None)
        t0 = time.perf_counter()
        toks = self._sample(self._run_decode())
        dt = time.perf_counter() - t0
        self.last_step["decoded"] = True
        self.lengths += 1
        self._len_host += 1
        eos = self.cfg.vocab - 1
        for slot in range(self.max_slots):
            if not self.active[slot]:
                continue
            res = self.slot_req[slot]
            res.decode_s += dt
            self.policy.charge(self.slot_meta[slot].tenant, 1.0)
            tok = int(toks[slot])
            self.slot_budget[slot] -= 1
            self._cur_host[slot, 0] = tok
            done = self.slot_budget[slot] <= 0 or tok == eos
            self._emit(res, tok, final=done)
            if done:
                self._retire(slot)
            elif self.paged:
                # grow on demand: map the block the NEXT decode step's
                # ring write lands in
                self._grow_blocks(slot)
        self.cur_tokens.copy_(torch.from_numpy(self._cur_host))
        return bool(self.active.any() or self.queue or self._chunking)

    def run(self, max_steps: int = 10_000) -> Dict[int, RequestResult]:
        steps = 0
        while self.step():
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not converge")
        return self.results
