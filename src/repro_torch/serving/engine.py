"""Batched serving engine — the pod-scale analogue of the TF Micro
invoke loop (paper §4.1), ported to PyTorch with the same allocation
discipline:

  * the KV cache — one contiguous ring of ``cache_len`` positions per
    decode slot, (L, max_slots, KH, C, dh) for K and for V — and the
    slot bookkeeping (lengths, current tokens) are allocated on the
    device at construction.  A decode step writes them in place: the
    cache tensors keep their addresses for the engine's life, and
    nothing a step allocates outlives it;
  * cache capacity is budgeted through the SAME ``TwoStackArena`` the
    micro interpreter uses: KV is a persistent (interpreter-lifetime)
    allocation, exactly as the JAX engine accounts it;
  * continuous batching: fixed decode slots, requests admitted as slots
    free up, one fused decode step advances every slot;
  * prefill and decode resolve through the op-registry tag chain
    (``("cuda", "reference")`` by default, §4.7–4.8): the ``"cuda"``
    ``SERVING_DECODE`` runs every layer's attention on the
    decode_attention kernel, and shadows the reference decode with no
    engine change — the micro interpreter's ``TAGS=`` mechanism.

The decode step is eager PyTorch that never reads a device value on the
host and takes no branch on one, so a later change can capture it in a
CUDA graph; the host reads back only the sampled tokens.  Sampling is
greedy (argmax over the true vocab, first maximum on ties; EOS is
``vocab - 1``), as in the JAX engine.

Host-side degrees of freedom ride on top (docs/SCHEDULING.md,
docs/PREEMPTION.md):

  * **admission order is policy-driven** — a ``SchedulingPolicy``
    (FIFO / priority-with-aging / EDF / per-tenant WFQ) picks which
    queued request takes a free slot.  Policies reorder the Python
    queue only.
  * **bucketed prefill** — prompt lengths are quantized to power-of-two
    buckets (``BucketTable``): the prompt is right-padded to its
    bucket.  Decode masks the cache by per-slot length and the first
    decode steps overwrite the padded rows, so decoded tokens are
    identical to the exact-length path.
  * **preemption** (``preempt=``) — when every slot is busy and the
    queue holds a tighter request, a ``PreemptionPolicy`` picks a
    running victim; its KV rows and (length, next token, budget) are
    checkpointed to host memory in a ``SlotCheckpoint``, the request is
    re-queued, and the urgent one takes the slot.  Restoring later, into
    any slot, continues with exactly the tokens of an uninterrupted run.

Chunked prefill, paged KV, quantized serving, mesh sharding and the
overlapped decode loop are refused at construction with
``NotImplementedError`` naming the ROADMAP slice that brings each.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.arena import TwoStackArena, align_up
from repro_torch.core.executor import BucketTable, resolve_device
from repro_torch.core.interpreter import setup_device
from repro_torch.core.op_resolver import MicroMutableOpResolver
from repro_torch.core.schema import OpCode, OpDef
from repro_torch.kernels import ops as _vendor_kernels  # noqa: F401 (tag "cuda")
from repro_torch.models.registry import ModelBundle

from . import ops as serving_ops  # registers tag="reference" serving ops
from .errors import UnsupportedFamilyError
from .scheduling import (PreemptionPolicy, SchedulingPolicy, get_policy,
                         get_preemption)

DEFAULT_TAGS = ("cuda", "reference")

# BUCKETED: decode masks the KV cache by per-slot length, so
# right-padded (bucketed) prefill gives the tokens of exact-length
# prefill.  The JAX engine also buckets vlm and moe, which the port
# does not have yet.
BUCKETED_FAMILIES = ("dense",)

# engine options of the JAX engine that later slices of the port bring
_NOT_PORTED = {
    "prefill_chunk": "chunked prefill (SERVING_PREFILL_CHUNK), ROADMAP "
                     "queue 1, slice 3, item 9",
    "kv_block": "paged KV (SERVING_DECODE_PAGED), ROADMAP queue 1, "
                "slice 3, item 10",
    "kv_pool_blocks": "paged KV (SERVING_DECODE_PAGED), ROADMAP queue 1, "
                      "slice 3, item 10",
    "weight_dtype": "quantized serving (SERVING_*_Q), ROADMAP queue 1, "
                    "slice 4, item 11",
    "kv_dtype": "quantized serving (SERVING_*_Q), ROADMAP queue 1, "
                "slice 4, item 11",
    "mesh": "mesh-sharded serving, ROADMAP queue 1, slice 8, item 15",
    "overlap": "overlapped decode, ROADMAP queue 1, slice 6, item 13",
}


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
    """A preempted request's continuation state, in host memory: the
    slot's KV rows as a batch=1 cache of CPU tensors, plus the (length,
    next token, remaining budget) triple the decode step is a pure
    function of.  Restoring them into any slot continues the run with
    exactly its uninterrupted tokens."""

    cache: Any                          # batch=1 cache dict (CPU tensors)
    length: int = 0                     # absolute position
    cur_token: int = 0                  # next token to feed
    budget: int = 0                     # remaining new tokens


def _cache_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ServingEngine:
    """One model, ``max_slots`` concurrent sequences, on ``device``
    (``"cuda"`` by default; raises without a card — pass ``"cpu"`` for
    the plain reference path on the CPU).  ``params`` is the model
    module from ``bundle.init`` or ``lm.params_from_jax``, on that
    device."""

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
        for name, value in (("prefill_chunk", prefill_chunk),
                            ("kv_block", kv_block),
                            ("kv_pool_blocks", kv_pool_blocks),
                            ("weight_dtype", weight_dtype),
                            ("kv_dtype", kv_dtype), ("mesh", mesh),
                            ("overlap", overlap)):
            if value:
                raise NotImplementedError(
                    f"{name}={value!r}: {_NOT_PORTED[name]} is not in "
                    f"the PyTorch port yet")
        self.device = resolve_device(device)
        setup_device(self.device)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        for name, p in params.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"engine on {self.device}")
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.policy: SchedulingPolicy = get_policy(policy)
        self.preempt: Optional[PreemptionPolicy] = get_preemption(preempt)
        self.clock = clock if clock is not None else default_clock
        self.on_token = on_token
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
        # resident weight bytes and KV bytes: the HBM footprint
        self.param_bytes = _cache_bytes(params.parameters())

        # --- the KV cache: allocated once, interpreter-lifetime --------
        self.cache = self._empty_cache(max_slots)
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
        self._ckpt: Dict[int, SlotCheckpoint] = {}
        # what the last step() did: prefill token counts, decode dispatch
        self.last_step: Dict[str, Any] = {"prefill_tokens": [],
                                          "decoded": False}

        # --- steps resolved at init, like interpreter prepare ----------
        self.resolver = MicroMutableOpResolver(tags).add_many(
            [OpCode.SERVING_PREFILL, OpCode.SERVING_DECODE])
        window = self.cfg.sliding_window
        self._prefill_op = OpDef(OpCode.SERVING_PREFILL, (), (),
                                 params={"cache_len": cache_len,
                                         "window": window})
        self._decode_op = OpDef(OpCode.SERVING_DECODE, (), (),
                                params={"window": window})
        prefill_reg = self.resolver.resolve(OpCode.SERVING_PREFILL)
        decode_reg = self.resolver.resolve(OpCode.SERVING_DECODE)
        pctx = serving_ops.ServingContext(bundle)
        prefill_ctx = serving_ops.ServingContext(
            bundle, prefill_reg.prepare(pctx, self._prefill_op).op_data)
        decode_ctx = serving_ops.ServingContext(
            bundle, decode_reg.prepare(pctx, self._decode_op).op_data)
        self._prefill = functools.partial(prefill_reg.eval, prefill_ctx,
                                          self._prefill_op)
        self._decode = functools.partial(decode_reg.eval, decode_ctx,
                                         self._decode_op)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.arrival_us is None:
            req.arrival_us = self.clock()
        self.queue.append(req)
        self.results[req.uid] = RequestResult(uid=req.uid,
                                              prompt_len=len(req.tokens))

    def _empty_cache(self, batch: int) -> Dict[str, torch.Tensor]:
        return self.bundle.empty_cache(batch, self.cache_len,
                                       self.cfg.torch_dtype(), self.device)

    def insert_slot_state(self, slot: int,
                          new_cache: Dict[str, torch.Tensor]) -> None:
        """Copy a batch=1 cache (on any device) into slot ``slot`` in
        place — the state-INSERTION hook, inverse of
        ``extract_slot_state``.  The slot index is a host-side offset, so
        a checkpoint restores into ANY slot."""
        for name, full in self.cache.items():
            full[:, slot:slot + 1].copy_(new_cache[name])

    def extract_slot_state(self, slot: int) -> Dict[str, torch.Tensor]:
        """Slot ``slot``'s KV rows as a batch=1 cache of CPU copies — the
        state-EXTRACTION hook a ``SlotCheckpoint`` carries."""
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
        if padded is None or padded > self.cache_len:
            return tokens                   # over-cap: exact length
        self.bucket_table.bucket(s)         # committed: count the hit
        if padded == s:
            return tokens
        return np.concatenate([tokens, np.zeros(padded - s, tokens.dtype)])

    def _activate_slot(self, req: Request, slot: int,
                       cache1: Optional[Dict[str, torch.Tensor]] = None, *,
                       length: Optional[int] = None,
                       cur_token: Optional[int] = None,
                       budget: Optional[int] = None) -> None:
        """Hand a prefilled (or restored) request to the decode loop:
        write its cache rows and the slot bookkeeping the decode step
        reads.  The keyword overrides are the restore path."""
        last_pos = len(req.tokens) - 1 if length is None else length
        tok = int(req.tokens[-1]) if cur_token is None else cur_token
        if cache1 is not None:
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
            batch = {"tokens": torch.as_tensor(
                prompt[None].astype(np.int64), device=self.device)}
            _, cache1 = self._prefill((self.params, batch))
            self.last_step["prefill_tokens"].append(len(prompt))
            self.policy.charge(req.tenant, 1.0)
        else:   # single-token prompt: the slot starts from a fresh cache
            cache1 = self._empty_cache(1)
        self._activate_slot(req, slot, cache1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # time to completion
        self.results[req.uid].prefill_s += time.perf_counter() - t0

    # -- preemption: slot checkpoint / evict / restore ------------------

    def snapshot_slot(self, slot: int) -> SlotCheckpoint:
        """Capture a running slot's continuation state host-side: its KV
        rows + (length, next token, budget).  The slot itself is
        untouched — pair with ``_evict``."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not running")
        return SlotCheckpoint(
            cache=self.extract_slot_state(slot),
            length=int(self._len_host[slot]),
            cur_token=int(self._cur_host[slot, 0]),
            budget=int(self.slot_budget[slot]))

    def _evict(self, slot: int) -> Request:
        """Preempt the request running in ``slot``: checkpoint it, free
        the slot, and put the request back on the queue (its checkpoint
        is picked up at re-admission)."""
        req = self.slot_meta[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} has no request")
        ckpt = self.snapshot_slot(slot)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.slot_meta[slot] = None
        self._ckpt[req.uid] = ckpt
        self.results[req.uid].preemptions += 1
        self.queue.append(req)
        return req

    def _restore_slot(self, req: Request, slot: int,
                      ckpt: SlotCheckpoint) -> None:
        """Re-admit a checkpointed request at exactly the captured
        state: the decode step is a pure function of (cache, token,
        length), so the continuation matches the uninterrupted run."""
        self._activate_slot(req, slot, ckpt.cache, length=ckpt.length,
                            cur_token=ckpt.cur_token, budget=ckpt.budget)

    def _admit(self, req: Request, slot: int) -> None:
        """Route an admission: restore a checkpointed request, or
        prefill one-shot."""
        ckpt = self._ckpt.pop(req.uid, None)
        if ckpt is not None:
            self._restore_slot(req, slot, ckpt)
        else:
            self._prefill_one(req, slot)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy tokens: argmax over the true vocab in float32, first
        maximum on ties — the one device-to-host read of a step."""
        return (logits[:, :self.cfg.vocab].float().argmax(dim=-1)
                .cpu().numpy())

    def _emit(self, res: RequestResult, tok: int, final: bool) -> None:
        """Append + stream one token — the single place a token becomes
        visible, so the output list, the TTFT stamp and the ``on_token``
        StreamEvent agree by construction."""
        res.output.append(tok)
        now = self.clock()
        if res.first_token_us is None:
            res.first_token_us = now
        if self.on_token is not None:
            self.on_token(StreamEvent(uid=res.uid,
                                      index=len(res.output) - 1,
                                      token=tok, t_us=now, final=final))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """One engine tick: admit (policy order, displacing a running
        victim when the preemption policy says so), then one fused
        decode step over the slots.  Returns True if work remains."""
        self.last_step = {"prefill_tokens": [], "decoded": False}
        if self.queue:
            now = self.clock()
            for slot in range(self.max_slots):
                if self.queue and not self.active[slot]:
                    self._admit(self.policy.pop(self.queue, now), slot)
            # displacement: every slot busy, queue still holding work —
            # the preemption policy may evict a running victim for the
            # queue's policy-first candidate (its strict-improvement
            # contract bounds this loop by the slot count)
            if self.preempt is not None:
                for _ in range(self.max_slots):
                    if not self.queue:
                        break
                    running = [(s, self.slot_meta[s])
                               for s in range(self.max_slots)
                               if self.active[s]]
                    if not running:
                        break
                    ci = self.policy.select(self.queue, now)
                    cand = self.queue[ci]
                    vi = self.preempt.victim([r for _, r in running],
                                             cand, now)
                    if vi is None:
                        break
                    self.queue.pop(ci)
                    slot = running[vi][0]
                    self._evict(slot)
                    self._admit(cand, slot)
        if not self.active.any():
            return bool(self.queue)
        t0 = time.perf_counter()
        logits, self.cache = self._decode(
            (self.params, self.cache, self.cur_tokens, self.lengths))
        toks = self._sample(logits)
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
                res.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
                self.slot_meta[slot] = None
        self.cur_tokens.copy_(torch.from_numpy(self._cur_host))
        return bool(self.active.any() or self.queue)

    def run(self, max_steps: int = 10_000) -> Dict[int, RequestResult]:
        steps = 0
        while self.step():
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not converge")
        return self.results
