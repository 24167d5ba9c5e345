"""Serving entry point of the port: ``python -m repro_torch.launch.serve
--arch yi-6b --full`` on the card, ``--device cpu`` for the plain
reference path on the CPU (reduced widths are the default).

Batched-request serving through the ``ServingEngine`` (continuous
batching, arena-budgeted KV or recurrent state): build the model of any
of the six families (dense, ``--arch deepseek-moe-16b`` for moe,
``mamba2-780m`` for ssm, ``zamba2-1.2b`` for hybrid, ``paligemma-3b``
for vlm, ``whisper-large-v3`` for audio) from seeded random weights,
submit a workload of prompts (with seeded patch or frame embeddings for
vlm and audio), run the engine to completion, and print per-request
latency and the throughput summary (with the engine's program counts).

With ``--stream`` a ``StreamingServer`` drives the engine (overlapped
decode where the family supports it) on a background thread, and every
token is printed the moment the host learns it, with per-request TTFT
and mean inter-token latency lines:
``python -m repro_torch.launch.serve --arch yi-6b --stream --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.executor import capture_count, resolve_device
from repro_torch.models import get_model
from repro_torch.serving import (STREAMING_FAMILIES, Request, ServingEngine,
                                 StreamEvent, default_clock)


class StreamingServer:
    """Minimal streaming front-end over one ``ServingEngine``:
    ``start()`` → ``submit()`` / ``stream()`` → ``shutdown()``.

    The engine runs on ONE dedicated loop thread, which makes every
    engine call and so is the only thread that touches CUDA: the engine's
    programs are captured there, and a CUDA-graph capture (its default
    ``capture_error_mode="global"``) fails if another thread makes an
    unsafe CUDA call meanwhile.  ``submit`` hands numpy prompts over a
    lock-protected inbox that the loop drains before each engine tick,
    and the engine's ``on_token`` callback — firing on the loop thread —
    puts each ``StreamEvent`` on a per-uid ``queue.Queue`` as it is
    emitted.  Consumers iterate ``stream(uid)`` from any thread, reading
    only those Python queues, and see that request's tokens in order,
    exactly once, ending with the ``final`` event; the engine's own
    emission contract (docs/STREAMING.md) keeps that across preemption
    and restore.  Nothing is captured before ``start()``: the engine
    only allocates its buffers at construction.

    ``shutdown()`` stops the loop, which settles any overlapped step in
    flight (``engine.drain()``) before it exits, then unblocks every open
    stream with a ``None`` sentinel so no consumer hangs on a request the
    server will never finish."""

    def __init__(self, engine: ServingEngine, *, idle_s: float = 0.001):
        self.engine = engine
        self._idle_s = idle_s
        self._inbox: List[Request] = []
        self._lock = threading.Lock()
        self._streams: Dict[int, "queue.Queue"] = {}
        # the callback holds the streams, not the server: a bound method
        # would put server and engine in a reference cycle, which the
        # cyclic collector may free while another engine captures a graph
        streams = self._streams
        engine.on_token = lambda ev: streams[ev.uid].put(ev)
        self._next_uid = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        """True between ``start()`` and ``shutdown()``."""
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "StreamingServer":
        """Spawn the engine loop thread (a second start while running is
        refused)."""
        if self.running:
            raise RuntimeError("server already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-loop", daemon=True)
        self._thread.start()
        return self

    def submit(self, tokens: np.ndarray, *, max_new_tokens: int = 16,
               uid: Optional[int] = None, **req_kw: Any) -> int:
        """Enqueue one prompt (numpy tokens; extras as numpy arrays);
        returns the uid to ``stream()`` on.  Extra keywords (priority,
        deadline_us, tenant, extras, …) pass through to ``Request``."""
        if not self.running:
            raise RuntimeError("server is not running")
        with self._lock:
            if uid is None:
                uid = self._next_uid
            self._next_uid = max(self._next_uid, uid + 1)
            if uid in self._streams:
                raise ValueError(f"uid {uid} already submitted")
            self._streams[uid] = queue.Queue()
            self._inbox.append(Request(
                uid=uid, tokens=np.asarray(tokens, np.int32),
                max_new_tokens=max_new_tokens, **req_kw))
        return uid

    def stream(self, uid: int, *,
               timeout: float = 60.0) -> Iterator[StreamEvent]:
        """Yield ``uid``'s StreamEvents in order until its ``final``
        token.  Raises ``queue.Empty`` if no token arrives within
        ``timeout`` seconds, and ``RuntimeError`` if the server shuts
        down with the request unfinished."""
        q = self._streams[uid]
        while True:
            ev = q.get(timeout=timeout)
            if ev is None:
                raise RuntimeError(
                    f"server shut down before request {uid} finished")
            yield ev
            if ev.final:
                return

    def result(self, uid: int):
        """The accumulated ``RequestResult`` for ``uid`` (None until the
        engine has seen the submission)."""
        return self.engine.results.get(uid)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the loop thread (it drains the step in flight on its way
        out) and unblock every open stream.  Safe to call twice; raises
        if the loop does not stop within ``timeout`` seconds."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)
        with self._lock:
            for uid, q in self._streams.items():
                res = self.engine.results.get(uid)
                if res is None or not res.done:
                    q.put(None)
        if thread is not None and thread.is_alive():
            raise RuntimeError(f"the serving loop did not stop within "
                               f"{timeout} s")

    # -- loop thread ----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                pending, self._inbox = self._inbox, []
            for req in pending:
                self.engine.submit(req)
            if not self.engine.step():
                # idle: the engine is drained — nap until new work lands
                self._stop.wait(self._idle_s)
        self.engine.drain()


def _build_engine(args) -> ServingEngine:
    """One engine from the CLI knobs, its weights drawn on the device
    from a generator seeded with ``--seed``; ``--stream`` turns
    overlapped decode on for the families it supports."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = get_model(cfg)
    params = bundle.init(torch.Generator(device).manual_seed(args.seed))
    overlap = args.stream and cfg.family in STREAMING_FAMILIES
    return ServingEngine(bundle, params, max_slots=args.slots,
                         cache_len=args.cache_len, overlap=overlap,
                         device=device)


def _workload(cfg, args) -> List[Dict[str, Any]]:
    """The demo prompt mix: random prompts from ``--seed`` (plus the
    vision or audio extras the multimodal families need), as the JAX
    package's."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2,
                                args.prompt_len + 1))
        extras = None
        if cfg.family == "vlm":
            extras = {"vision": rng.normal(
                0, 1, (cfg.n_vision_tokens, cfg.d_vision)
            ).astype(np.float32)}
        elif cfg.family == "audio":
            extras = {"frames": rng.normal(
                0, 0.1, (cfg.n_audio_ctx, cfg.d_model)
            ).astype(np.float32)}
        reqs.append(dict(
            uid=uid,
            tokens=rng.integers(0, cfg.vocab - 2, plen).astype(np.int32),
            max_new_tokens=args.max_new, extras=extras))
    return reqs


def _serve_stream(eng: ServingEngine, cfg, args) -> None:
    """``--stream`` mode: per-token delivery through a StreamingServer,
    TTFT and mean inter-token latency per request (engine clock, µs)."""
    server = StreamingServer(eng).start()
    t0 = time.time()
    uids, t_sub = [], {}
    try:
        for r in _workload(cfg, args):
            t_sub[r["uid"]] = default_clock()
            uids.append(server.submit(
                r["tokens"], max_new_tokens=r["max_new_tokens"],
                uid=r["uid"], extras=r["extras"]))
        total = 0
        for uid in uids:
            stamps, toks = [], []
            for ev in server.stream(uid):
                stamps.append(ev.t_us)
                toks.append(ev.token)
            total += len(toks)
            ttft_ms = (stamps[0] - t_sub[uid]) / 1e3
            itl = np.diff(stamps) / 1e3 if len(stamps) > 1 else np.zeros(1)
            print(f"  req {uid}: new={len(toks)}  ttft={ttft_ms:.2f}ms  "
                  f"itl_mean={float(itl.mean()):.2f}ms  "
                  f"tokens={toks[:8]}{'...' if len(toks) > 8 else ''}")
        wall = time.time() - t0
    finally:
        server.shutdown()
    print(json.dumps({
        "mode": "stream", "device": str(eng.device), "overlap": eng.overlap,
        "wall_s": round(wall, 3), "tokens_generated": total,
        "tok_per_s": round(total / wall, 2),
        "captures": {name: capture_count(prog)
                     for name, prog in eng.programs().items()},
    }))


def _serve_batch(eng: ServingEngine, cfg, args) -> None:
    """Submit everything, run to completion, print the per-request table
    and throughput summary."""
    t0 = time.time()
    for r in _workload(cfg, args):
        eng.submit(Request(**r))
    results = eng.run()
    wall = time.time() - t0

    total_new = sum(len(r.output) for r in results.values())
    for uid in sorted(results):
        r = results[uid]
        print(f"  req {uid}: prompt={r.prompt_len}  new={len(r.output)}  "
              f"prefill={r.prefill_s * 1e3:.1f}ms  "
              f"decode={r.decode_s * 1e3:.1f}ms  "
              f"tokens={r.output[:8]}{'...' if len(r.output) > 8 else ''}")
    print(json.dumps({
        "device": str(eng.device),
        "wall_s": round(wall, 3),
        "tokens_generated": total_new,
        "tok_per_s": round(total_new / wall, 2),
        "arena_persistent_bytes": eng.arena.usage().persistent,
        # programs captured (on the card) or signatures run (on the CPU):
        # decode 1, prefill one per bucket or prompt length hit
        "captures": {"decode": capture_count(eng._decode),
                     "prefill": eng.prefill_compiles(),
                     "chunk": eng.chunk_compiles()},
    }))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-32b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--stream", action="store_true",
                    help="per-token streaming through StreamingServer "
                         "(overlapped decode where supported)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    eng = _build_engine(args)
    print(f"arch={cfg.arch_id}  requests={args.requests}  "
          f"slots={args.slots}  device={eng.device}  "
          f"mode={'stream' if args.stream else 'batch'}")
    if args.stream:
        _serve_stream(eng, cfg, args)
    else:
        _serve_batch(eng, cfg, args)


if __name__ == "__main__":
    main()
