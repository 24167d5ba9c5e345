"""The serving driver: a configuration of ``kind`` serve under an open or
closed loop of requests, through the port's served entry,
``launch/serve.py``'s ``StreamingServer`` over a ``ServingEngine``.

Set-up builds the engine on the seed's weights, warms every prefill
bucket the run's requests will use (and with them the decode and argmax
programs), and starts the server; the load then runs a lead-in before
the window opens.  Every token's ``StreamEvent`` is recorded as it is
emitted.  In a traced run the engine's decode and prefill programs are
timed by CUDA events around each call (the benchmark's own spans), and
``torch.profiler`` traces a few seconds at the same load after the
window has closed, so that nothing the tracer does falls in the window.
Once the window's requests have finished, the engine is freed and a
sample of them is held against the reference (``compare.serve``).
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic, weights
from portbench.model import model_config

# the most a window's request may finish after the window closes, with
# the time the server's loop was paused to start and end a profile
WAIT_S = 60.0
# after the pause that starts a profile: the held requests are taken in
SETTLE_S = 5.0
WARM_UID = 1 << 40


def _now_us() -> int:
    return time.monotonic_ns() // 1000


class Spans:
    """Device spans of a program's calls: a CUDA event before and after
    each call (host clock spans on the CPU), the host time of the call,
    and what ``note(args)`` says of it."""

    def __init__(self, prog, note):
        self.calls: List[tuple] = []
        spans, cuda = self, torch.cuda.is_available()
        base = type(prog)

        class Spanned(base):
            def __call__(self, *args):
                t = time.monotonic_ns()
                if cuda:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = base.__call__(self, *args)
                    b.record()
                else:
                    a = time.perf_counter()
                    out = base.__call__(self, *args)
                    b = time.perf_counter()
                spans.calls.append((t, a, b, note(args)))
                return out

        prog.__class__ = Spanned
        self.prog, self.base = prog, base

    def close(self) -> List[tuple]:
        """(host ns, device s, note) of every call; the program restored."""
        self.prog.__class__ = self.base
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            return [(t, a.elapsed_time(b) / 1e3, n)
                    for t, a, b, n in self.calls]
        return [(t, b - a, n) for t, a, b, n in self.calls]


class _Client:
    """The load, sent from a thread of its own; ``join()`` re-raises
    what it raised."""

    def __init__(self, load):
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(load,),
                                       name="portbench-client", daemon=True)
        self.thread.start()

    def _run(self, load) -> None:
        try:
            load()
        except BaseException as e:          # re-raised by join()
            self.error = e

    def join(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise self.error


class ServeSession:
    """One engine on the seed's weights, warmed for a list of requests,
    behind a started ``StreamingServer``."""

    def __init__(self, conf: Dict, mix: Dict, seed: int, device,
                 requests: List[Dict]):
        from repro_torch.core.executor import capture_count
        from repro_torch.launch.serve import StreamingServer
        from repro_torch.models import get_model
        from repro_torch.models.registry import empty_model
        from repro_torch.serving import Request, ServingEngine

        self.mix = mix
        self.device = torch.device(device)
        self.cfg = model_config(conf)
        model = weights.fill_module(empty_model(self.cfg, "meta"), conf,
                                    seed, self.device)
        e = conf["engine"]
        block = int(e["kv_block"])
        self.engine = ServingEngine(
            get_model(self.cfg), model, max_slots=int(mix["slots"]),
            cache_len=-(-traffic.cache_len(mix) // block) * block,
            kv_block=block,
            overlap=e["overlap"], device=self.device,
            prefill_buckets=None if e.get("prefill_buckets", True)
            else False)
        del model
        self._capture_count = capture_count
        # every bucket the requests use, once: prompts of its full length
        table = self.engine.bucket_table
        sizes = sorted({table.fit(len(r["prompt"]) - 1) or
                        len(r["prompt"]) - 1 for r in requests}
                       if table is not None else
                       {len(r["prompt"]) - 1 for r in requests})
        rng = np.random.default_rng(seed)
        vocab = self.cfg.vocab
        for i, s in enumerate(sizes):
            self.engine.submit(Request(
                uid=WARM_UID + i, max_new_tokens=2,
                tokens=rng.integers(0, vocab - 1, s + 1).astype(np.int32)))
        self.engine.run()
        self.events: Dict[int, List[tuple]] = {}
        self.server = StreamingServer(self.engine).start()
        forward = self.engine.on_token
        events = self.events

        def on_token(ev):
            events.setdefault(ev.uid, []).append((ev.t_us, ev.token,
                                                  ev.final))
            forward(ev)
            if ev.final and self._on_final is not None:
                self._on_final(ev)

        self._on_final = None
        self.engine.on_token = on_token
        self.submitted: List[int] = []
        self._lock = threading.Lock()
        self._paused = None
        self.paused_us = 0

    def captures(self) -> Dict[str, tuple]:
        return {n: (self._capture_count(p), p.capture_s)
                for n, p in self.engine.programs().items()}

    def submit(self, r: Dict, due_us: int) -> None:
        with self._lock:
            r["due_us"] = due_us
            self.submitted.append(r["uid"])
            if self._paused is None:
                self.server.submit(r["prompt"], max_new_tokens=r["max_new"],
                                   uid=r["uid"])
            else:
                self._paused.append(r)

    def pause(self) -> None:
        """Stop the server's loop (its step in flight settled); requests
        sent meanwhile wait for ``resume()``."""
        with self._lock:
            self._paused = []
        self._pause_t0 = _now_us()
        self.server.shutdown()

    def resume(self) -> None:
        self.paused_us += _now_us() - self._pause_t0
        self.server.start()
        with self._lock:
            for r in self._paused:
                self.server.submit(r["prompt"], max_new_tokens=r["max_new"],
                                   uid=r["uid"])
            self._paused = None

    def drive(self, requests: List[Dict], seconds: float, lead_s: float,
              spans: bool = False, trace_s: float = 0.0) -> Dict:
        """Offer ``requests`` (their ``due_s`` from now on an open loop;
        ``clients`` at a time on a closed one), open the window after
        ``lead_s``, and return the records once the window's requests
        have finished (open loop) or the window has closed (closed loop).
        With ``trace_s`` the load goes on after the window while the
        profiler traces ``trace_s`` of it (``_trace``)."""
        eng = self.engine
        dec = pre = None
        if spans:
            progs = eng.programs()
            dec = Spans(progs["decode"],
                        lambda args: int(eng.active.sum()))
            pre = Spans(progs["prefill"],
                        lambda args: int(args[0][1]["tokens"].shape[1]))
        t0 = _now_us()
        w0 = t0 + int(lead_s * 1e6)
        w1 = w0 + int(seconds * 1e6)
        before = self.captures()
        traced = threading.Event()
        if not trace_s:
            traced.set()
        if self.mix["loop"] == "open":
            load = lambda: self._open_loop(requests, t0, w0, w1, traced)
        else:
            load = lambda: self._closed_loop(requests, w1, traced)
        trace_data = None
        if trace_s:
            # the profiler starts and stops in this thread (kineto refuses
            # to set up in another), so a client thread sends the load
            client = _Client(load)
            try:
                trace_data = self._trace(requests, w0, w1, trace_s)
            finally:
                traced.set()
            client.join()
        else:
            load()
        after = self.captures()
        end = _now_us()
        return {"t0_us": t0, "w0_us": w0, "w1_us": w1, "end_us": end,
                "requests": self._records(requests),
                "decode_spans": dec.close() if dec else None,
                "prefill_spans": pre.close() if pre else None,
                "submitted": list(self.submitted),
                "captures_in_window": {
                    n: after[n][0] - before[n][0]
                    for n in after if after[n][1] != before[n][1]},
                "trace": trace_data}

    def _trace(self, requests, w0: int, w1: int, trace_s: float):
        """Trace ``trace_s`` of the load after the window.  Once the
        window has closed and each of its requests has its first token,
        the server's loop is paused while the profile starts, and again
        while it ends (a teardown while the loop's thread launched decode
        graphs hung a traced run now and then); the traced stretch starts
        ``SETTLE_S`` after the first pause, once the requests held by it
        have been taken in."""
        from portbench import trace as tr

        time.sleep(max(0.0, (w1 - _now_us()) / 1e6))
        due = {r["uid"] for r in requests
               if w0 <= r.get("due_us", -1) < w1}
        while (not all(u in self.events for u in due)
               and _now_us() < self._wait_end(w1)):
            time.sleep(0.01)
        traced = tr.Traced(torch, self.device)
        self.pause()
        traced.start()
        self.resume()
        time.sleep(SETTLE_S)
        traced.lead()
        time.sleep(trace_s)
        traced.trail()
        self.pause()
        traced.finish()
        self.resume()
        return traced.read()

    def _open_loop(self, requests, t0: int, w0: int, w1: int,
                   traced: threading.Event) -> None:
        due_window = set()
        for r in requests:
            due = t0 + int(r["due_s"] * 1e6)
            if w0 <= due < w1:
                due_window.add(r["uid"])
            if (due >= w1 and traced.is_set()
                    and self._finished(due_window)):
                break
            if due > self._wait_end(w1):
                break
            sleep_s = (due - _now_us()) / 1e6
            if sleep_s > 0:
                time.sleep(sleep_s)
            self.submit(r, due)
        while (not self._finished(due_window)
               and (not traced.is_set() or _now_us() < self._wait_end(w1))):
            time.sleep(0.01)

    def _wait_end(self, w1: int) -> int:
        return w1 + int(WAIT_S * 1e6) + self.paused_us

    def _finished(self, uids) -> bool:
        ev = self.events
        return all(u in ev and ev[u][-1][2] for u in uids)

    def _closed_loop(self, requests, w1: int,
                     traced: threading.Event) -> None:
        pool = iter(requests)
        stop = threading.Event()

        def next_request(ev=None):
            if stop.is_set():
                return
            r = next(pool, None)
            if r is None:
                stop.set()
                return
            self.submit(r, ev.t_us if ev is not None else _now_us())

        self._on_final = next_request
        for _ in range(int(self.mix["clients"])):
            next_request()
        while ((_now_us() < w1 or not traced.is_set())
               and not stop.is_set()):
            time.sleep(0.01)
        ran_out = stop.is_set() and _now_us() < w1
        stop.set()
        self._on_final = None
        if ran_out:
            raise RuntimeError("the closed loop's request pool ran out "
                               "before the window closed")

    def _records(self, requests) -> List[Dict]:
        res = self.engine.results
        out = []
        for r in requests:
            if "due_us" not in r:
                continue
            got = res.get(r["uid"])
            ev = self.events.get(r["uid"], [])
            out.append({"uid": r["uid"], "due_us": r["due_us"],
                        "prompt": r["prompt"], "max_new": r["max_new"],
                        "times": [t for t, _, _ in ev],
                        "tokens": [k for _, k, _ in ev],
                        "done": bool(ev) and ev[-1][2],
                        "prefill_s": got.prefill_s if got else None,
                        "first_token_us": got.first_token_us
                        if got else None})
        return out

    def close(self) -> None:
        if self.server.running:
            self.server.shutdown()
        self.engine = self.server = None


def run(ctx: Dict) -> Dict:
    """One run of a serving cell: set-up, lead-in and window, the
    records, then the check against the reference."""
    from portbench import compare

    conf, mix, seed = ctx["conf"], ctx["mix"], ctx["seed"]
    device = torch.device(ctx["device"])
    vocab = conf["model"]["vocab_size"]
    requests = traffic.serve_requests(mix, seed, ctx["seconds"], vocab)
    session = ServeSession(conf, mix, seed, device, requests)
    lead_s = float(mix["lead_in_s"])
    rec = session.drive(requests, ctx["seconds"], lead_s,
                        spans=bool(ctx["trace"]),
                        trace_s=ctx.get("trace_s", 0.0) if ctx["trace"]
                        else 0.0)
    rec["setup_s"] = rec["w0_us"] / 1e6 - ctx["t0"]
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    window = [r for r in rec["requests"]
              if rec["w0_us"] <= r["due_us"] < rec["w1_us"]]
    if mix["loop"] == "open":
        rec["attempted"] = len(window)
        rec["failed"] = sum(not r["done"] for r in window)
    else:
        rec["attempted"] = sum(
            r["done"] and rec["w0_us"] <= r["times"][-1] < rec["w1_us"]
            for r in rec["requests"])
        rec["failed"] = 0
    session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    rec.update(compare.serve(ctx, rec, control=bool(ctx.get("control"))))
    return rec
