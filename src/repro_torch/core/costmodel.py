"""Calibration-driven cost model for bucket & chunk sizing, the port of the
JAX package's ``repro.core.costmodel``.

The paper's discipline is that resource-constrained inference replaces
runtime-dynamic decisions with offline, MEASURED, static configuration:
the memory planner lays the arena out before a single op runs.  This
module applies the same discipline to the serving knobs that would
otherwise be hand-picked constants — the prefill ``BucketTable`` layout,
the ``prefill_chunk`` size, the paged-KV block, the micro lane width,
the replica count and the serving precision:

  1. **calibrate** — a short deterministic calibration pass runs the
     engine's real programs through the profiler's compile/step timer
     (``repro_torch.core.profiler.measure_compile_and_step``).  On the
     card a program's "compile" is its eager first run plus its CUDA-graph
     capture, and its step a replay: a different cost landscape from the
     TPU's, so a profile is a fact about the device it was measured on;
  2. **solve** — a small dynamic program picks the bucket level set and
     the chunk size that minimize the workload's expected prefill
     latency: each level costs its capture overhead once plus a warm
     padded step per request it serves; padding waste pushes the solver
     toward finer tables, capture cost toward coarser ones.  An optional
     head-of-line bound (``max_dispatch_us``) trades serial prefill cost
     for bounded per-dispatch blocking;
  3. **persist** — the result is a versioned ``CalibrationProfile`` JSON
     (the JAX package's layout: measurements included, wall clock
     excluded) keyed by model AND by the device it was measured on, so
     engines are built from a profile without re-measuring
     (``ServingEngine.from_profile``; ``MultiTenantHost(profile=...)``
     shares one profile's table across tenants), and never from a profile
     measured on another device.  The port's profile cache lives under
     ``build/profiles/`` at the root of the checkout.  With no profile,
     every surface falls back to the hand-picked defaults.

Determinism contract: given the same seed and the same measurement
function, ``calibrate`` produces an identical profile, and with the same
injected measurements the port's profile equals the JAX package's field
for field apart from ``meta``.  The default measurers read wall clocks,
so two real calibration runs agree in distribution, not bit-for-bit —
inject ``measure=`` (any ``(kind, size) -> CompileStepTiming`` callable)
for exact reproducibility or for solver-only experiments.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .executor import (BucketTable, CapturedProgram, capture_count,
                       disable_capture, resolve_device)
from .profiler import CompileStepTiming, _block_on, measure_compile_and_step

PROFILE_VERSION = 1

# default on-disk location of the port's calibration-profile cache, keyed
# by model_key: <repo>/build/profiles/<key with / -> __>.json (the JAX
# package's results under benchmarks/ are never read or written here)
DEFAULT_PROFILE_DIR = (pathlib.Path(__file__).resolve().parents[3]
                       / "build" / "profiles")

# default candidate chunk sizes offered to the solver (0 = chunking off)
DEFAULT_CHUNK_CANDIDATES = (0, 8, 16)
# floor for candidate bucket levels: below this, padding waste is noise
MIN_LEVEL = 4
# cap on measured candidate levels — calibration cost is one capture
# per candidate, so the pass stays seconds-scale
MAX_CANDIDATES = 12


def profile_model_key(cfg: Any, cache_len: int) -> str:
    """The identity a profile is calibrated FOR: model family + arch +
    cache capacity.  ``ServingEngine.from_profile`` refuses a profile
    whose key does not match (the measured costs would be someone
    else's); ``MultiTenantHost`` may still deliberately share one
    profile's bucket LAYOUT across tenants — see docs/SCHEDULING.md."""
    return f"{cfg.family}/{getattr(cfg, 'arch_id', '?')}/L{int(cache_len)}"


def device_identity(device: Any) -> Dict[str, str]:
    """What a profile measured on ``device`` is keyed by: the device type
    and, on the card, its model name (``torch.cuda.get_device_name``).
    ``"cuda"`` with no card raises, as every entry point does."""
    dev = resolve_device(device)
    ident = {"device": dev.type}
    if dev.type == "cuda":
        ident["device_name"] = torch.cuda.get_device_name(dev)
    return ident


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketCost:
    """Measured cost of one candidate bucket level: ``compile_us`` the
    cold first prefill at padded length ``length``, ``step_us`` the
    warm padded-step latency (the per-request price every prompt that
    lands in this bucket pays)."""

    length: int
    compile_us: float
    step_us: float

    @property
    def trace_overhead_us(self) -> float:
        """One-time cost the table pays when this level is first hit."""
        return max(self.compile_us - self.step_us, 0.0)


@dataclasses.dataclass(frozen=True)
class ChunkCost:
    """Measured cost of one candidate chunk size: ``step_us`` is one
    warm chunked-prefill dispatch (a prompt of m tokens pays
    ceil(m/chunk) of these), ``compile_us`` the cold first chunk —
    paid ONCE total because the start offset is a tensor input."""

    chunk: int
    compile_us: float
    step_us: float

    @property
    def trace_overhead_us(self) -> float:
        """The chunk program's one-time capture cost."""
        return max(self.compile_us - self.step_us, 0.0)


@dataclasses.dataclass(frozen=True)
class DecodeCost:
    """Measured cost of the fused decode step at ``slots`` concurrent
    slots: ``step_us`` one warm batched dispatch (every active request
    advances one token for this price), ``compile_us`` the cold first
    dispatch — paid once per engine, since slot occupancy is a tensor
    value."""

    slots: int
    compile_us: float
    step_us: float

    @property
    def trace_overhead_us(self) -> float:
        """The decode program's one-time capture cost."""
        return max(self.compile_us - self.step_us, 0.0)


@dataclasses.dataclass(frozen=True)
class BlockCost:
    """Measured cost of one candidate PAGED KV block size: ``step_us``
    one warm paged decode dispatch with ``block``-row blocks (where a
    too-small block shows up as per-block overhead in the paged decode
    kernel), ``compile_us`` the cold first dispatch."""

    block: int
    compile_us: float
    step_us: float

    @property
    def trace_overhead_us(self) -> float:
        """The paged decode program's one-time capture cost."""
        return max(self.compile_us - self.step_us, 0.0)


@dataclasses.dataclass(frozen=True)
class LaneCost:
    """Measured cost of one BATCHED micro dispatch at ``lanes``
    concurrent lanes (``InterpreterPool.invoke`` advances every lane
    for one program replay): ``step_us`` the warm dispatch,
    ``compile_us`` the cold first one — paid once per lane count,
    since the batch axis is a shape."""

    lanes: int
    compile_us: float
    step_us: float

    @property
    def trace_overhead_us(self) -> float:
        """The pooled dispatch program's one-time capture cost."""
        return max(self.compile_us - self.step_us, 0.0)


@dataclasses.dataclass(frozen=True)
class ReplicaCost:
    """Modeled serving capacity of ``replicas`` engine replicas,
    priced from ONE measured fused decode dispatch: each replica
    advances ``slots`` tokens per ``step_us`` warm dispatch, and
    replicas run on DISJOINT device sets (serving/router.py), so
    capacity adds linearly while the per-tick latency floor stays a
    single dispatch."""

    replicas: int
    slots: int
    step_us: float

    @property
    def tokens_per_us(self) -> float:
        """Aggregate decode throughput of the replica set."""
        return self.replicas * self.slots / self.step_us


@dataclasses.dataclass(frozen=True)
class QuantCost:
    """Measured cost of the QUANTIZED fused decode step at ``slots``
    concurrent slots under one precision pair (``weight_dtype`` /
    ``kv_dtype``; ``"fp32"`` = that axis unquantized — the baseline
    row): ``step_us`` one warm dispatch, ``compile_us`` the cold
    first, and ``hbm_bytes`` the engine's RESIDENT footprint (the
    quantized weights plus the KV cache — the axis quantization exists
    to shrink; 0 when the measurement hook could not report it, e.g.
    an injected synthetic ``measure``)."""

    weight_dtype: str
    kv_dtype: str
    slots: int
    compile_us: float
    step_us: float
    hbm_bytes: int = 0

    @property
    def trace_overhead_us(self) -> float:
        """The quantized decode program's one-time capture cost."""
        return max(self.compile_us - self.step_us, 0.0)


def _refuse_traced(device: torch.device) -> None:
    """On the card a measurement runs untraced: torch.profiler inflates
    every launch, and the costs would be wrong."""
    if device.type == "cuda" and torch.autograd._profiler_enabled():
        raise RuntimeError("calibration measures the card untraced: run it "
                           "outside torch.profiler")


def _measure_program(program: CapturedProgram, call: Callable[[], Any],
                     iters: int, warm: bool) -> CompileStepTiming:
    """Time ``call`` — one call of ``program`` on its bound buffers —
    cold (its eager run and capture) then warm (replays).  With ``warm``
    one untimed eager call under ``disable_capture()`` goes first, so the
    library's lazy set-up (cuBLAS's handle and workspace, a kernel's
    lasting buffers, module loading) is charged to no candidate.  The
    measurement must add exactly one signature to ``program``; anything
    else means the inputs were not at the program's bound addresses."""
    if warm:
        with disable_capture():
            _block_on(call())
    before = capture_count(program) + program.evictions
    timing = measure_compile_and_step(call, iters=iters)
    added = capture_count(program) + program.evictions - before
    if added != 1:
        raise RuntimeError(f"measuring the {program.name} program added "
                           f"{added} captures, not 1")
    return timing


def _build_kernels(device: torch.device) -> None:
    """On the card, build the package's kernels now (one ``nvcc`` per
    missing source at once), so no measurement carries a compile."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()


class EngineMeasurer:
    """The default ``measure`` hook: times the REAL serving programs of
    fresh engines on ``device`` (the card by default) —
    ``("prefill", L)`` the one-shot prefill at padded length L,
    ``("chunk", C)`` one chunked-prefill dispatch of C tokens,
    ``("decode", B)`` one fused decode dispatch at B slots,
    ``("decode_paged", BS)`` one paged decode dispatch at block size BS
    and ``("decode_q:<weight>:<kv>", B)`` one quantized decode dispatch —
    each cold (eager run and capture) then warm (replays).

    Every call goes through the engine's own bound buffers, staged as
    serving stages them (the prefill token view and extras buffers, the
    chunk step's static tokens, start, true count and batch=1 cache, the
    engine's cache or pool, block table, ``cur_tokens`` and ``lengths``),
    so each measurement adds exactly one capture to the program it times
    (checked).  The kernels are built at construction, and each engine's
    first measurement is preceded by one untimed eager step.
    The engines share ``params`` (a quantized candidate quantizes once,
    in its own engine); ``close()`` releases them and their graph pools.
    Token values come from a seeded rng (they cannot affect timing, only
    determinism of the recorded workload), and every timed call waits
    for the device."""

    def __init__(self, bundle: Any, params: Any, cache_len: int,
                 *, seed: int = 0, iters: int = 5, device: Any = "cuda"):
        self.bundle = bundle
        self.params = params
        self.cache_len = int(cache_len)
        self.iters = int(iters)
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self._engines: Dict[int, Any] = {}
        self._aux_engines: Dict[Tuple[str, int], Any] = {}
        self._warm: set = set()
        _build_kernels(self.device)

    def _new(self, **kw):
        # lazy import: serving sits above core in the layering
        from repro_torch.serving.engine import ServingEngine
        return ServingEngine(self.bundle, self.params,
                             cache_len=self.cache_len, device=self.device,
                             **kw)

    def _engine(self, chunk: int):
        eng = self._engines.get(chunk)
        if eng is None:
            eng = self._new(max_slots=1, prefill_buckets=False,
                            prefill_chunk=chunk or None)
            self._engines[chunk] = eng
        return eng

    def _extras(self) -> Optional[Dict[str, np.ndarray]]:
        """A measured prompt's extras — a vlm bundle additionally needs
        its vision prefix (synthesized patch embeddings; only the shape
        matters for timing)."""
        cfg = self.bundle.cfg
        if cfg.family == "vlm":
            return {"vision": self.rng.normal(
                0, 1, (cfg.n_vision_tokens, cfg.d_vision)
            ).astype(np.float32)}
        return None

    def _time(self, eng, program: CapturedProgram,
              call: Callable[[], Any]) -> CompileStepTiming:
        warm = id(eng) not in self._warm
        self._warm.add(id(eng))
        return _measure_program(program, call, self.iters, warm)

    def __call__(self, kind: str, size: int) -> CompileStepTiming:
        _refuse_traced(self.device)
        vocab = self.bundle.cfg.vocab
        toks = self.rng.integers(0, max(vocab - 2, 1),
                                 int(size)).astype(np.int32)
        if kind == "prefill":
            eng = self._engine(0)
            batch = eng._stage_prefill(toks, self._extras())
            return self._time(eng, eng._prefill,
                              lambda: eng._prefill((eng.params, batch)))
        if kind == "chunk":
            # the chunk step at offset 0 on the engine's static batch=1
            # cache; a recurrent chunk also takes its true token count
            eng = self._engine(int(size))
            eng._chunk_tokens.copy_(torch.from_numpy(
                toks[None].astype(np.int64)))
            eng._chunk_start.fill_(0)
            eng._chunk_real.fill_(int(size))
            return self._time(eng, eng._prefill_chunk,
                              lambda: eng._prefill_chunk(eng._chunk_args()))
        if kind in ("decode", "decode_paged") or kind.startswith("decode_q:"):
            # one fused decode dispatch: `size` slots (decode, decode_q —
            # the kind string carries the precision pair, "fp32" = that
            # axis unquantized, so injected hooks keep the flat (kind,
            # size) contract) or 2 slots with `size`-row KV blocks
            # (decode_paged: the zeroed pool and the table on the garbage
            # block are fine — timing depends on shapes, not on which
            # blocks the table points at); half-full caches so masking
            # work is representative
            eng = self._aux(kind, int(size))
            eng.cur_tokens.zero_()
            eng.lengths.fill_(self.cache_len // 2)
            return self._time(eng, eng._decode, eng._run_decode)
        raise ValueError(f"unknown measurement kind {kind!r}")

    def _aux(self, kind: str, size: int):
        """Engines for the decode-side measurement kinds, keyed by
        (kind, size): ``decode`` wants a contiguous engine at `size`
        slots, ``decode_q`` a quantized one, ``decode_paged`` a 2-slot
        paged engine at block `size`."""
        eng = self._aux_engines.get((kind, size))
        if eng is None:
            if kind == "decode":
                eng = self._new(max_slots=size, prefill_buckets=False)
            elif kind.startswith("decode_q:"):
                _, wd, kd = kind.split(":")
                eng = self._new(max_slots=size, prefill_buckets=False,
                                weight_dtype=None if wd == "fp32" else wd,
                                kv_dtype=None if kd == "fp32" else kd)
            else:
                eng = self._new(max_slots=2, prefill_buckets=False,
                                kv_block=size)
            self._aux_engines[(kind, size)] = eng
        return eng

    def hbm_bytes(self, kind: str, size: int) -> int:
        """Resident weight + KV bytes of the engine behind a
        decode-side measurement — the footprint axis of ``QuantCost``
        (built on demand if that measurement has not run yet)."""
        eng = self._aux(kind, int(size))
        return int(eng.param_bytes + eng.kv_bytes)

    def close(self) -> None:
        """Release the engines: drop every program's graphs, then the
        engines (and a quantized engine's weights) themselves."""
        for eng in [*self._engines.values(), *self._aux_engines.values()]:
            for program in eng.programs().values():
                program.clear()
        self._engines.clear()
        self._aux_engines.clear()
        self._warm.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class MicroMeasurer:
    """The ``measure`` hook for the multi-lane micro path: ``("micro",
    B)`` times one REAL pooled dispatch (``InterpreterPool.invoke``) at
    B lanes on ``device`` (the card by default), cold (eager run and
    capture) then warm (replays) — the cost landscape ``solve_lanes``
    picks the host's micro batch width from.  Each pool's first dispatch
    is preceded by one untimed eager one, and the measurement must add
    exactly one capture to the pool's program.  Lane inputs are seeded
    random frames (values cannot affect timing, only determinism of the
    recorded workload); ``invoke`` blocks until its outputs are on the
    host."""

    def __init__(self, model: Any, resolver: Any, *, seed: int = 0,
                 iters: int = 5, device: Any = "cuda"):
        self.model = model
        self.resolver = resolver
        self.iters = int(iters)
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        _build_kernels(self.device)

    def __call__(self, kind: str, size: int) -> CompileStepTiming:
        if kind != "micro":
            raise ValueError(
                f"MicroMeasurer prices batched micro dispatches only, "
                f"not {kind!r}")
        _refuse_traced(self.device)
        from .executor import InterpreterPool
        pool = InterpreterPool(self.model, self.resolver, batch=int(size),
                               device=self.device)
        for lane in range(pool.batch):
            for pos, tid in enumerate(pool.alloc.model.inputs):
                spec = pool.alloc.specs[tid]
                pool.set_input(lane, pos, self.rng.normal(
                    0, 1, spec.shape).astype(np.float32))
        try:
            return _measure_program(pool.program, pool.invoke, self.iters,
                                    True)
        finally:
            pool.program.clear()        # release the pool's graph now


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    """What the solver decided and why: the chosen bucket ``levels``
    and ``chunk`` size, the objective at the optimum
    (``expected_us``: total expected prefill latency over the
    workload, capture overheads included), the worst single dispatch
    the config can issue (``max_dispatch_us`` — the head-of-line number
    a bound constrains), how many prefill programs the workload will
    capture (``predicted_compiles``), and whether the head-of-line bound
    was met (``feasible``; without a bound, always True)."""

    levels: List[int]
    chunk: int
    expected_us: float
    max_dispatch_us: float
    predicted_compiles: int             # prefill captures: the number
    feasible: bool                      # prefill_compiles() ends at
                                        # (chunk program excluded —
                                        # that is chunk_compiles())


def _bucket_dp(plens: np.ndarray, cands: List[BucketCost],
               bound: Optional[float]) -> Optional[Tuple[
                   List[int], float, float, List[int]]]:
    """Pick the min-cost subset of candidate levels covering every
    prefill length in ``plens``: each chosen level pays its capture
    overhead once (if hit) plus a warm step per request it serves.
    Levels whose step exceeds ``bound`` are excluded.  Returns (levels,
    cost, max_step_us, hit_levels) — ``hit_levels`` are the levels at
    least one request actually pads into, i.e. the prefill programs
    the workload will capture — or None when ``plens`` cannot be
    covered (every allowed candidate is smaller than some length)."""
    if len(plens) == 0:
        return [], 0.0, 0.0, []
    cands = [c for c in cands
             if bound is None or c.step_us <= bound]
    cands = sorted(cands, key=lambda c: c.length)
    if not cands or cands[-1].length < int(plens.max()):
        return None
    xs = np.sort(plens)
    bounds = [0] + [int(np.searchsorted(xs, c.length, side="right"))
                    for c in cands]
    k = len(cands)
    INF = float("inf")
    best = [INF] * (k + 1)
    best[0] = 0.0
    back = [0] * (k + 1)
    for j in range(1, k + 1):
        for i in range(j):
            cnt = bounds[j] - bounds[i]
            seg = 0.0 if cnt == 0 else (
                cands[j - 1].trace_overhead_us
                + cnt * cands[j - 1].step_us)
            if best[i] + seg < best[j]:
                best[j] = best[i] + seg
                back[j] = i
    # the answer must cover max(plens): last chosen level is any c_j
    # >= max; walking back from the cheapest such j yields the table
    need = int(plens.max())
    j_opt = min((j for j in range(1, k + 1)
                 if cands[j - 1].length >= need),
                key=lambda j: best[j])
    levels, hit_costs = [], []
    j = j_opt
    while j > 0:
        i = back[j]
        if bounds[j] - bounds[i] > 0 or j == j_opt:
            levels.append(cands[j - 1].length)
            if bounds[j] - bounds[i] > 0:
                hit_costs.append(cands[j - 1])
        j = i
    levels.sort()
    max_step = max((c.step_us for c in hit_costs), default=0.0)
    return levels, best[j_opt], max_step, sorted(
        c.length for c in hit_costs)


def solve(prompt_lengths: Sequence[int], bucket_costs: Sequence[BucketCost],
          chunk_costs: Sequence[ChunkCost], *, cache_len: int,
          max_dispatch_us: Optional[float] = None,
          vis_tokens: int = 0) -> SolveResult:
    """Jointly choose the bucket table and chunk size minimizing the
    workload's expected prefill latency.

    For every chunk candidate (0 = chunking off), requests the engine
    WOULD chunk (prefill length > chunk and the chunked prompt —
    including the ``vis_tokens`` a vlm's vision prefix occupies —
    fits the cache, mirroring ``ServingEngine._chunk_eligible``) pay
    one warm PREFILL step at the chunk length (the engine's
    ``_start_chunked`` runs the first chunk through the ordinary
    prefill program) plus ceil(len/chunk)-1 warm chunk steps, with the
    chunk program's capture overhead charged once; the remaining
    requests go through the bucket DP.  The first-chunk prefill at
    shape (1, chunk) reads the same token view as a bucket level of the
    same length, so it shares that level's capture: ``predicted_compiles``
    counts it only when no unchunked request hits that level (and
    ``expected_us`` charges its capture overhead under the same
    condition).  Among configurations meeting the head-of-line bound
    (every single dispatch <= ``max_dispatch_us``), the cheapest wins;
    when no configuration meets the bound, the one with the smallest
    worst dispatch wins (least-bad, flagged ``feasible=False``)."""
    plens = np.array([max(int(l) - 1, 0) for l in prompt_lengths],
                     dtype=np.int64)
    plens = plens[plens >= 1]      # single-token prompts skip prefill
    chunk_by = {int(c.chunk): c for c in chunk_costs}
    by_len = {c.length: c for c in bucket_costs}
    results: List[SolveResult] = []
    for chunk in sorted(set([0] + list(chunk_by))):
        if chunk == 0:
            chunked = np.zeros(len(plens), bool)
        else:
            n_chunks = -(-plens // chunk)
            chunked = (plens > chunk) \
                & (vis_tokens + n_chunks * chunk <= cache_len)
        cost = 0.0
        max_disp = 0.0
        compiles = 0
        if chunked.any():
            cc = chunk_by[chunk]
            # first chunk: the ordinary prefill program at length
            # `chunk` (measured as a bucket candidate when available)
            first = by_len.get(chunk)
            first_step = first.step_us if first is not None else cc.step_us
            n_first = int(chunked.sum())
            later = float((-(-plens[chunked] // chunk) - 1).sum())
            cost += n_first * first_step + later * cc.step_us
            cost += cc.trace_overhead_us        # the chunk program
            max_disp = max(max_disp, cc.step_us, first_step)
        dp = _bucket_dp(plens[~chunked], list(bucket_costs),
                        max_dispatch_us)
        if dp is None and max_dispatch_us is not None:
            # the bound excludes every covering table: fall back to
            # the unbounded optimum and flag it infeasible below —
            # a too-tight bound is reported, never an exception
            dp = _bucket_dp(plens[~chunked], list(bucket_costs), None)
        if dp is None:
            continue
        levels, dp_cost, dp_max, hit_levels = dp
        if not levels:              # every request chunked: the table
            levels = [min(c.length for c in bucket_costs)]  # still
        cost += dp_cost             # needs one level to exist
        max_disp = max(max_disp, dp_max)
        compiles += len(hit_levels)
        if chunked.any() and chunk not in hit_levels:
            # the (1, chunk) first-chunk prefill capture is NOT shared
            # with a HIT bucket level: one more prefill program
            compiles += 1
            first = by_len.get(chunk)
            if first is not None:
                cost += first.trace_overhead_us
        feasible = (max_dispatch_us is None
                    or max_disp <= max_dispatch_us)
        results.append(SolveResult(
            levels=levels, chunk=chunk, expected_us=cost,
            max_dispatch_us=max_disp, predicted_compiles=compiles,
            feasible=feasible))
    if not results:
        raise ValueError(
            "no candidate configuration covers the workload — widen "
            "candidate_levels or raise max_dispatch_us")
    feas = [r for r in results if r.feasible]
    if feas:
        return min(feas, key=lambda r: (r.expected_us, len(r.levels),
                                        r.chunk))
    return min(results, key=lambda r: (r.max_dispatch_us, r.expected_us))


@dataclasses.dataclass(frozen=True)
class BlockSolveResult:
    """What the block solver decided and why: the chosen ``block``
    size, the expected ``admissible_slots`` the paged pool can hold at
    the reference memory budget (vs. ``contiguous_slots``, the same
    budget spent on whole cache_len slabs), the ``mean_blocks`` a
    workload request actually needs, and the measured warm paged
    decode ``step_us`` at that block size (the tie-breaker)."""

    block: int
    admissible_slots: float
    contiguous_slots: int
    mean_blocks: float
    step_us: float


def solve_block_size(prompt_lengths: Sequence[int],
                     block_costs: Sequence[BlockCost], *,
                     cache_len: int, slots: int = 2,
                     new_tokens: int = 16,
                     vis_tokens: int = 0) -> BlockSolveResult:
    """Choose the paged-KV block size for a workload: at a reference
    memory budget of ``slots`` contiguous cache_len slabs, a smaller
    block admits more concurrent requests (less tail waste, finer
    packing) but pays more per-block kernel overhead — so the solver
    maximizes expected admissible slots and breaks ties on the
    MEASURED warm paged-decode step cost.

    Per request the engine reserves ceil(min(vis + (len-1) +
    new_tokens, cache_len) / block) blocks (``_blocks_needed``); one
    pool block is the garbage sink and never allocatable.  Candidates
    that do not divide ``cache_len`` are skipped (the engine requires
    an integral table)."""
    plens = np.array([max(int(l) - 1, 0) for l in prompt_lengths],
                     dtype=np.int64)
    plens = plens[plens >= 1]
    if len(plens) == 0:
        raise ValueError("prompt_lengths contains no multi-token "
                         "prompt — nothing to solve block size for")
    budget_rows = int(slots) * int(cache_len)
    best: Optional[BlockSolveResult] = None
    for c in sorted(block_costs, key=lambda c: c.block):
        bs = int(c.block)
        if bs <= 0 or cache_len % bs != 0:
            continue
        usable = budget_rows // bs - 1          # minus the garbage block
        if usable <= 0:
            continue
        need_rows = np.minimum(vis_tokens + plens + new_tokens, cache_len)
        need_blocks = -(-need_rows // bs)
        mean_blocks = float(need_blocks.mean())
        admissible = usable / mean_blocks
        cand = BlockSolveResult(
            block=bs, admissible_slots=round(admissible, 3),
            contiguous_slots=int(slots), mean_blocks=round(mean_blocks, 3),
            step_us=c.step_us)
        if best is None or (cand.admissible_slots, -cand.step_us) > \
                (best.admissible_slots, -best.step_us):
            best = cand
    if best is None:
        raise ValueError(
            f"no block candidate divides cache_len={cache_len} — offer "
            f"divisor block sizes (e.g. powers of two up to cache_len)")
    return best


@dataclasses.dataclass(frozen=True)
class LaneSolveResult:
    """What the lane solver decided and why: the chosen pooled batch
    width ``lanes``, the expected total dispatch time over the demand
    trace (``expected_us``, capture overhead included), the worst
    single dispatch (``max_dispatch_us``), and whether the head-of-line
    bound was met (``feasible``; without a bound, always True)."""

    lanes: int
    expected_us: float
    max_dispatch_us: float
    feasible: bool


def solve_lanes(demand: Sequence[int],
                lane_costs: Sequence[LaneCost], *,
                max_dispatch_us: Optional[float] = None
                ) -> LaneSolveResult:
    """Choose the micro pool's batch width from measured dispatch
    costs: a tick with ``d`` concurrent micro jobs needs ceil(d/B)
    pooled dispatches at width B, so wide lanes amortize fixed
    dispatch overhead while narrow lanes waste less on padding ticks
    (idle lanes still run on zeros — the dispatch is one program).
    Each width's capture overhead is charged once.  Among widths
    meeting the head-of-line bound (one dispatch <= ``max_dispatch_us``),
    the cheapest expected total wins; when none meets it, the least-bad
    worst dispatch wins, flagged ``feasible=False``."""
    ds = np.array([int(d) for d in demand], dtype=np.int64)
    ds = ds[ds >= 1]
    if len(ds) == 0:
        raise ValueError("demand contains no tick with micro jobs — "
                         "nothing to solve lane width for")
    if not lane_costs:
        raise ValueError("solve_lanes needs at least one measured "
                         "LaneCost candidate")
    results = []
    for c in sorted(lane_costs, key=lambda c: c.lanes):
        dispatches = -(-ds // int(c.lanes))
        cost = float(dispatches.sum()) * c.step_us + c.trace_overhead_us
        feasible = (max_dispatch_us is None
                    or c.step_us <= max_dispatch_us)
        results.append(LaneSolveResult(
            lanes=int(c.lanes), expected_us=round(cost, 3),
            max_dispatch_us=round(c.step_us, 3), feasible=feasible))
    feas = [r for r in results if r.feasible]
    if feas:
        return min(feas, key=lambda r: (r.expected_us, r.lanes))
    return min(results, key=lambda r: (r.max_dispatch_us, r.expected_us))


@dataclasses.dataclass(frozen=True)
class ReplicaSolveResult:
    """What the replica solver decided and why: the smallest replica
    count whose modeled aggregate decode throughput
    (``tokens_per_us``) meets ``target_tokens_per_us`` — or the
    largest candidate, flagged ``feasible=False``, when none does."""

    replicas: int
    slots: int
    step_us: float
    tokens_per_us: float
    target_tokens_per_us: float
    feasible: bool


def solve_replicas(target_tokens_per_us: float, decode: DecodeCost, *,
                   candidates: Sequence[int] = (1, 2, 4, 8)
                   ) -> ReplicaSolveResult:
    """Size the data-parallel replica set from one measured decode
    dispatch: each replica sustains ``slots/step_us`` tokens/µs and
    replicas add linearly (disjoint devices), so the smallest
    candidate count meeting the throughput target wins — replicas
    beyond it buy tail latency, not feasibility."""
    cands = sorted({int(r) for r in candidates if int(r) >= 1})
    if not cands:
        raise ValueError("candidates must contain a positive count")
    if target_tokens_per_us <= 0:
        raise ValueError("target_tokens_per_us must be positive")
    best = None
    for r in cands:
        rc = ReplicaCost(replicas=r, slots=decode.slots,
                         step_us=decode.step_us)
        if rc.tokens_per_us >= target_tokens_per_us:
            best = (rc, True)
            break
        best = (rc, False)
    rc, feasible = best
    return ReplicaSolveResult(
        replicas=rc.replicas, slots=rc.slots, step_us=rc.step_us,
        tokens_per_us=round(rc.tokens_per_us, 6),
        target_tokens_per_us=float(target_tokens_per_us),
        feasible=feasible)


def solve_precision(candidates: Sequence[QuantCost], *,
                    max_step_us: Optional[float] = None,
                    hbm_budget_bytes: Optional[int] = None
                    ) -> QuantCost:
    """Pick the serving precision from measured quantized decode
    steps: among candidates within the latency bound and the memory
    budget (each unbounded when None; a candidate with unreported
    ``hbm_bytes == 0`` never satisfies an explicit budget), the
    SMALLEST footprint wins, tie-broken by step time — quantization
    buys occupancy, so footprint is the objective and latency the
    constraint.  When nothing qualifies, the fastest candidate is
    returned (the infeasible-but-least-bad answer, mirroring
    ``solve_replicas``' feasible flag convention)."""
    cands = list(candidates)
    if not cands:
        raise ValueError("candidates must be non-empty")
    ok = [c for c in cands
          if (max_step_us is None or c.step_us <= max_step_us)
          and (hbm_budget_bytes is None
               or (c.hbm_bytes and c.hbm_bytes <= hbm_budget_bytes))]
    if not ok:
        return min(cands, key=lambda c: c.step_us)
    return min(ok, key=lambda c: (c.hbm_bytes or float("inf"),
                                  c.step_us))


# ---------------------------------------------------------------------------
# the profile (versioned JSON; measurements in, wall clock out)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationProfile:
    """A calibration pass, frozen: the solved configuration
    (``bucket_levels`` + ``prefill_chunk``, and the decode-side
    extensions), the raw measurements it was solved FROM, the workload
    it was solved FOR, the identity of the model it measured
    (``model_key``) and, in ``meta``, the device it was measured on
    (``device_identity``) and the torch version.

    The JSON layout (``to_json``) is the JAX package's, versioned;
    ``load`` refuses a version it does not understand instead of
    misreading it.  Nothing volatile (timestamps, hostnames) is stored,
    so the same seed and the same measurements produce byte-identical
    profiles — profiles are diffable artifacts, re-calibrated
    deliberately when the model, the hardware, or the workload
    changes."""

    model_key: str
    seed: int
    cache_len: int
    bucket_levels: List[int]
    prefill_chunk: int                       # 0 = chunking off
    expected_us: float
    default_expected_us: float
    max_dispatch_us: float
    predicted_compiles: int
    feasible: bool
    prompt_lengths: List[int]
    bucket_costs: List[BucketCost]
    chunk_costs: List[ChunkCost]
    meta: Dict[str, str]
    # paged-KV extension (defaulted: version-1 profiles without these
    # fields load unchanged — kv_block 0 means "paging not calibrated")
    kv_block: int = 0
    decode_costs: List[DecodeCost] = dataclasses.field(
        default_factory=list)
    block_costs: List[BlockCost] = dataclasses.field(
        default_factory=list)
    # batched-dispatch extension (defaulted, same load-compat rule):
    # micro_lanes 0 = lane width not calibrated, replicas 0 = replica
    # count not solved
    micro_lanes: int = 0
    lane_costs: List[LaneCost] = dataclasses.field(
        default_factory=list)
    replicas: int = 0
    replica_costs: List[ReplicaCost] = dataclasses.field(
        default_factory=list)
    # quantized-serving extension (defaulted, same load-compat rule):
    # empty = precision not calibrated
    quant_costs: List[QuantCost] = dataclasses.field(
        default_factory=list)
    version: int = PROFILE_VERSION

    def bucket_table(self) -> BucketTable:
        """The solved table, ready to hand to an engine — identical
        (``BucketTable.__eq__``) to ``BucketTable.from_levels`` of the
        profile's levels."""
        return BucketTable.from_levels(self.bucket_levels)

    def matches(self, cfg: Any, cache_len: int) -> bool:
        """Whether this profile was calibrated for exactly this model
        and cache capacity."""
        return self.model_key == profile_model_key(cfg, cache_len)

    def measured_on(self) -> Dict[str, str]:
        """The device identity recorded in ``meta`` (empty for a profile
        the JAX package wrote: it records a backend, not a device)."""
        return {k: self.meta[k] for k in ("device", "device_name")
                if k in self.meta}

    def matches_device(self, device: Any) -> bool:
        """Whether this profile was MEASURED on the kind of device
        ``device`` is.  Costs are hardware facts: a card's profile never
        matches a CPU engine or another card model, a CPU profile never
        matches the card, and a profile the JAX package wrote (a
        ``backend``, no ``device``) matches no device.  One torch process
        runs CPU and card engines side by side, so the check takes the
        engine's device, not a process-wide backend.  (A torch *version*
        drift is allowed — same hardware, costs drift rather than change
        meaning — but ``meta["torch"]`` records it.)"""
        return ("torch" in self.meta
                and self.measured_on() == device_identity(device))

    # -- (de)serialization -------------------------------------------

    def to_json(self) -> str:
        """The canonical, sorted-key JSON form (what ``save`` writes)."""
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        """Inverse of ``to_json``; raises on an unknown version."""
        d = json.loads(text)
        version = d.get("version")
        if version != PROFILE_VERSION:
            raise ValueError(
                f"calibration profile version {version!r} is not "
                f"supported (expected {PROFILE_VERSION}); re-calibrate")
        d["bucket_costs"] = [BucketCost(**c) for c in d["bucket_costs"]]
        d["chunk_costs"] = [ChunkCost(**c) for c in d["chunk_costs"]]
        d.setdefault("kv_block", 0)
        d["decode_costs"] = [DecodeCost(**c)
                             for c in d.get("decode_costs", [])]
        d["block_costs"] = [BlockCost(**c)
                            for c in d.get("block_costs", [])]
        d.setdefault("micro_lanes", 0)
        d.setdefault("replicas", 0)
        d["lane_costs"] = [LaneCost(**c)
                           for c in d.get("lane_costs", [])]
        d["replica_costs"] = [ReplicaCost(**c)
                              for c in d.get("replica_costs", [])]
        d["quant_costs"] = [QuantCost(**c)
                            for c in d.get("quant_costs", [])]
        return cls(**d)

    def save(self, path: str) -> str:
        """Write the profile JSON to ``path`` (returns ``path``)."""
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        """Read a profile written by ``save``."""
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# the on-disk profile cache (keyed by model_key)
# ---------------------------------------------------------------------------

def profile_cache_path(model_key: str,
                       cache_dir: Optional[Any] = None) -> str:
    """Where the cached profile for ``model_key`` lives: one JSON per
    key under ``DEFAULT_PROFILE_DIR`` (``build/profiles/``; slashes
    flattened so the key stays a single filename)."""
    base = pathlib.Path(cache_dir) if cache_dir is not None \
        else DEFAULT_PROFILE_DIR
    return str(base / (model_key.replace("/", "__") + ".json"))


def save_cached_profile(profile: CalibrationProfile,
                        cache_dir: Optional[Any] = None) -> str:
    """Persist ``profile`` into the cache at its ``model_key`` slot
    (creating the cache directory if needed); returns the path."""
    path = profile_cache_path(profile.model_key, cache_dir)
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    return profile.save(path)


def load_cached_profile(model_key: str,
                        cache_dir: Optional[Any] = None
                        ) -> Optional[CalibrationProfile]:
    """The cached profile for ``model_key``, or None when absent —
    absence is the normal cold-cache case, so no exception.  A present
    but unreadable/foreign-version file DOES raise: silent fallback
    would hide a corrupted cache."""
    path = profile_cache_path(model_key, cache_dir)
    if not pathlib.Path(path).exists():
        return None
    return CalibrationProfile.load(path)


def _candidate_levels(plens: np.ndarray, cache_len: int,
                      explicit: Optional[Sequence[int]]
                      ) -> List[int]:
    """The bucket lengths worth measuring: the power-of-two ladder
    (the default layout — so the solver can always reproduce the
    fallback) plus the workload's own distinct prefill lengths, capped
    at ``MAX_CANDIDATES`` by quantile subsampling."""
    if explicit is not None:
        cands = sorted({int(x) for x in explicit})
        if not cands:
            raise ValueError("candidate_levels must be non-empty")
        cands = [c for c in cands if c <= cache_len]
        if not cands:
            raise ValueError(
                f"every candidate level in {sorted(explicit)} exceeds "
                f"the usable cache room ({cache_len}) — the engine "
                f"would fall back to exact-length prefill for every "
                f"prompt, which is what calibration exists to prevent")
        return cands
    need = int(plens.max()) if len(plens) else MIN_LEVEL
    pow2 = []
    b = MIN_LEVEL
    while b <= cache_len:
        pow2.append(b)
        b <<= 1
    own = sorted({int(x) for x in plens if MIN_LEVEL <= x <= cache_len})
    room = max(2, MAX_CANDIDATES - len(pow2))
    if len(own) > room:
        qs = np.linspace(0, 100, room)
        own = sorted({int(np.percentile(own, q,
                                        method="higher")) for q in qs})
    cands = sorted(set(pow2) | set(own) | {min(need, cache_len)})
    return cands


def calibrate(bundle: Any, params: Any,
              prompt_lengths: Sequence[int], *,
              cache_len: int = 256, seed: int = 0,
              candidate_levels: Optional[Sequence[int]] = None,
              chunk_candidates: Sequence[int] = DEFAULT_CHUNK_CANDIDATES,
              max_dispatch_us: Optional[float] = None,
              iters: int = 5,
              decode_slots: Sequence[int] = (),
              block_candidates: Sequence[int] = (),
              new_tokens: int = 16,
              lane_candidates: Sequence[int] = (),
              lane_demand: Sequence[int] = (),
              micro: Optional[Tuple[Any, Any]] = None,
              replica_candidates: Sequence[int] = (),
              target_tokens_per_us: Optional[float] = None,
              quant_candidates: Sequence[Tuple[str, str]] = (),
              measure: Optional[Callable[[str, int],
                                         CompileStepTiming]] = None,
              device: Any = "cuda") -> CalibrationProfile:
    """Run the calibration pass and solve for the serving config, on
    ``device`` (the card by default; the profile is keyed by it).

    Measures every candidate bucket level's (compile, padded-step)
    cost and every candidate chunk size's step cost through
    ``measure`` (default: ``EngineMeasurer`` timing the real programs
    on ``device``), then solves for the bucket levels and chunk size
    that minimize the expected prefill latency of ``prompt_lengths``
    and freezes everything into a ``CalibrationProfile``.  The default
    measurers' engines and pools are released before this returns.

    ``max_dispatch_us`` bounds how long any single prefill dispatch
    may monopolize the engine (the head-of-line knob chunking exists
    for); ``measure`` injection makes the pass exactly reproducible
    (see the module docstring's determinism contract).

    The decode side is opt-in (both default empty, so injected
    measurement hooks written for the prefill-only contract keep
    working): ``decode_slots`` prices the fused decode step at each
    slot count (``("decode", B)``), and ``block_candidates`` prices
    the PAGED decode step at each block size (``("decode_paged",
    BS)``) then solves for the block size maximizing admissible
    concurrent slots at a reference memory budget
    (``solve_block_size`` with ``new_tokens`` reserved per request) —
    the solved size lands in ``profile.kv_block`` and
    ``ServingEngine.from_profile`` turns it on.

    Batched-dispatch calibration is opt-in the same way:
    ``lane_candidates`` prices the host's pooled micro dispatch at
    each lane count (``("micro", B)`` — supply ``micro=(model,
    resolver)`` so the default measurer can build real
    ``InterpreterPool``s, or inject ``measure``) and ``solve_lanes``
    over ``lane_demand`` (per-tick concurrent micro job counts;
    defaults to steady full demand at the widest candidate) lands in
    ``profile.micro_lanes``; ``replica_candidates`` models per-replica
    decode capacity from the measured fused decode step (requires
    ``decode_slots``) and, when ``target_tokens_per_us`` is given,
    ``solve_replicas`` lands the smallest sufficient replica count in
    ``profile.replicas``.

    ``quant_candidates`` prices the QUANTIZED fused decode step for
    each (weight_dtype, kv_dtype) precision pair — ``"fp32"`` on
    either axis means unquantized, so ``("fp32", "fp32")`` is the
    baseline row — at the largest ``decode_slots`` count (2 when
    unset), landing ``QuantCost`` rows (with the engine's resident
    footprint, when the measurer can report it) in
    ``profile.quant_costs``; ``solve_precision`` picks a deployment
    precision from them."""
    plens = np.array([max(int(l) - 1, 0) for l in prompt_lengths],
                     dtype=np.int64)
    plens = plens[plens >= 1]
    if len(plens) == 0:
        raise ValueError("prompt_lengths contains no multi-token "
                         "prompt — nothing to calibrate")
    # lazy import: serving sits above core; by call time both exist
    from repro_torch.serving.engine import BUCKETED_FAMILIES
    from repro_torch.serving.errors import UnsupportedFamilyError
    from repro_torch.serving.ops import CHUNKED_FAMILIES
    calibratable = tuple(dict.fromkeys(BUCKETED_FAMILIES
                                       + CHUNKED_FAMILIES))
    if bundle.cfg.family not in calibratable:
        raise UnsupportedFamilyError(
            bundle.cfg.family, "bucket/chunk calibration (no bucketed "
            "or chunked prefill fast path to size)",
            supported=calibratable)
    injected = measure is not None
    if lane_candidates and not injected and micro is None:
        raise ValueError(
            "lane_candidates needs micro=(model, resolver) so the "
            "default measurer can build real InterpreterPools (or "
            "inject measure=)")
    meta = {"torch": torch.__version__, **device_identity(device)}
    owned: Optional[EngineMeasurer] = None   # released below
    if measure is None:
        measure = owned = EngineMeasurer(bundle, params, cache_len,
                                         seed=seed, iters=iters,
                                         device=device)
    try:
        # a vlm's vision prefix occupies cache rows the prompt cannot use:
        # mirror the engine's `room` (bucket over-cap) and chunk-fit math
        vis = (int(getattr(bundle.cfg, "n_vision_tokens", 0))
               if bundle.cfg.family == "vlm" else 0)
        room = cache_len - vis
        cands = _candidate_levels(plens, room, candidate_levels)
        chunks = sorted({int(c) for c in chunk_candidates} - {0})
        # measure prefill at each chunk size too: the engine's FIRST chunk
        # runs through the ordinary prefill program at that length, so the
        # solver needs its cost (and it may double as a bucket level)
        cands = sorted(set(cands) | {c for c in chunks if c <= room})
        # also measure every level the DEFAULT pow2 table would hit on
        # this workload — NOT offered to the solver (explicit
        # candidate_levels stay authoritative), only priced, so the
        # solved-vs-default comparison below rests on measurements
        default_tbl = BucketTable(min_bucket=8, max_bucket=cache_len)
        default_levels = set()
        for m in np.unique(plens):
            lvl = default_tbl.fit(int(m))
            if lvl is not None and lvl <= room:
                default_levels.add(lvl)
        bucket_costs = []
        for L in sorted(set(cands) | default_levels):
            t = measure("prefill", L)
            bucket_costs.append(BucketCost(length=L, compile_us=t.compile_us,
                                           step_us=t.step_us))
        chunk_costs = []
        for C in chunks:
            t = measure("chunk", C)
            chunk_costs.append(ChunkCost(chunk=C, compile_us=t.compile_us,
                                         step_us=t.step_us))
        decode_costs = []
        for B in sorted({int(b) for b in decode_slots if int(b) >= 1}):
            t = measure("decode", B)
            decode_costs.append(DecodeCost(slots=B, compile_us=t.compile_us,
                                           step_us=t.step_us))
        block_costs = []
        for BS in sorted({int(b) for b in block_candidates
                          if int(b) >= 1 and cache_len % int(b) == 0}):
            t = measure("decode_paged", BS)
            block_costs.append(BlockCost(block=BS, compile_us=t.compile_us,
                                         step_us=t.step_us))
        kv_block = 0
        if block_costs:
            ref_slots = max(decode_slots) if decode_slots else 2
            kv_block = solve_block_size(
                prompt_lengths, block_costs, cache_len=cache_len,
                slots=ref_slots, new_tokens=new_tokens,
                vis_tokens=vis).block
        lane_costs: List[LaneCost] = []
        micro_lanes = 0
        lane_cands = sorted({int(b) for b in lane_candidates
                             if int(b) >= 1})
        if lane_cands:
            lane_measure = measure
            if not injected:
                # validated up front: micro is a (model, resolver) pair
                lane_measure = MicroMeasurer(*micro, seed=seed, iters=iters,
                                             device=device)
            for B in lane_cands:
                t = lane_measure("micro", B)
                lane_costs.append(LaneCost(lanes=B, compile_us=t.compile_us,
                                           step_us=t.step_us))
            demand = [int(d) for d in lane_demand] or [max(lane_cands)]
            micro_lanes = solve_lanes(
                demand, lane_costs,
                max_dispatch_us=max_dispatch_us).lanes
        replicas = 0
        replica_costs: List[ReplicaCost] = []
        rep_cands = sorted({int(r) for r in replica_candidates
                            if int(r) >= 1})
        if rep_cands:
            if not decode_costs:
                raise ValueError(
                    "replica_candidates requires decode_slots — the "
                    "per-replica tick is priced from the measured fused "
                    "decode step")
            base = max(decode_costs, key=lambda c: c.slots)
            replica_costs = [ReplicaCost(replicas=r, slots=base.slots,
                                         step_us=base.step_us)
                             for r in rep_cands]
            if target_tokens_per_us is not None:
                replicas = solve_replicas(target_tokens_per_us, base,
                                          candidates=rep_cands).replicas
        quant_costs: List[QuantCost] = []
        if quant_candidates:
            q_slots = max([int(b) for b in decode_slots], default=2)
            hbm_hook = getattr(measure, "hbm_bytes", None)
            for wd, kd in dict.fromkeys((str(w), str(k))
                                        for w, k in quant_candidates):
                qk = f"decode_q:{wd}:{kd}"
                t = measure(qk, q_slots)
                quant_costs.append(QuantCost(
                    weight_dtype=wd, kv_dtype=kd, slots=q_slots,
                    compile_us=t.compile_us, step_us=t.step_us,
                    hbm_bytes=int(hbm_hook(qk, q_slots))
                    if hbm_hook else 0))
    finally:
        if owned is not None:
            owned.close()
    solver_costs = [c for c in bucket_costs if c.length in set(cands)]
    best = solve(prompt_lengths, solver_costs, chunk_costs,
                 cache_len=cache_len, max_dispatch_us=max_dispatch_us,
                 vis_tokens=vis)
    # capacity guard: always keep one level at the largest measured
    # candidate, so a serving-time prompt LONGER than anything in the
    # calibration workload still buckets (one capture) instead of
    # silently falling back to exact-length prefill, one program per
    # length.  An unhit level costs nothing — predicted_compiles and
    # expected_us are unchanged for the calibrated workload.
    levels = list(best.levels)
    cap = max(c.length for c in solver_costs)
    if levels[-1] < cap:
        levels.append(cap)
    best.levels = levels
    # the objective of the hand-picked fallback (pow2 ladder from 8,
    # chunking off), evaluated on the SAME measurements — what
    # "beating the defaults" is measured against.  Every bucketed
    # default level was added to the candidate set above; over-room
    # lengths (the engine's exact-length fallback, one program per
    # distinct length) interpolate from the nearest measured level
    by_len = {c.length: c for c in bucket_costs}
    default_cost = 0.0
    default_traced: Dict[int, float] = {}
    for m in plens:
        lvl = default_tbl.fit(int(m))
        if lvl is not None and lvl > room:
            lvl = None                  # engine over-cap: exact length
        want = lvl if lvl is not None else int(m)
        c = by_len.get(want)
        if c is not None:
            default_cost += c.step_us
            default_traced[want] = c.trace_overhead_us
        else:
            ref = min(bucket_costs,
                      key=lambda r: abs(r.length - want))
            default_cost += ref.step_us * want / ref.length
            default_traced[want] = ref.trace_overhead_us
    default_cost += sum(default_traced.values())
    return CalibrationProfile(
        model_key=profile_model_key(bundle.cfg, cache_len),
        seed=int(seed), cache_len=int(cache_len),
        bucket_levels=list(best.levels),
        prefill_chunk=int(best.chunk),
        expected_us=round(float(best.expected_us), 3),
        default_expected_us=round(float(default_cost), 3),
        max_dispatch_us=round(float(best.max_dispatch_us), 3),
        predicted_compiles=int(best.predicted_compiles),
        feasible=bool(best.feasible),
        prompt_lengths=[int(x) for x in prompt_lengths],
        bucket_costs=bucket_costs, chunk_costs=chunk_costs, meta=meta,
        kv_block=int(kv_block),
        decode_costs=decode_costs, block_costs=block_costs,
        micro_lanes=int(micro_lanes), lane_costs=lane_costs,
        replicas=int(replicas), replica_costs=replica_costs,
        quant_costs=quant_costs)
