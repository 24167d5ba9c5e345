#!/usr/bin/env python3
"""Where a StreamingServer's inter-token latency goes, on the card.

``chip_smoke.py`` phase 22 reports each request's TTFT and mean
inter-token latency (ITL) and the loop's median decode tick.  This script
serves the same workload (Yi-6B at full width in bfloat16, 4 slots x
2048, phase 7's 8 requests of 32 new tokens, an overlapped engine, one
consumer thread a stream) on a warm engine and keeps every tick of the
server's loop (its host-clock span, whether requests were queued, the
prefill tokens and chunks it ran, the tokens it emitted) and every
token's stamp, then prints each request's ITL spread and the ticks that
make up its long gaps.

Run from the root of a checkout on a machine with one card:

    python3 tools/stream_ticks.py [--out stream_ticks.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def quantiles(xs):
    xs = sorted(xs)
    return {"n": len(xs), "p50": xs[len(xs) // 2],
            "p90": xs[min(len(xs) - 1, int(0.9 * len(xs)))], "max": xs[-1]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="JSON of every tick and "
                    "token stamp")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("stream_ticks.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import StreamingServer
    from repro_torch.models import get_model
    from repro_torch.serving import default_clock

    _build.build_all()
    dev = torch.device("cuda")
    bundle = get_model(get_config(cs.LM_ARCH))
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    prompts = cs.serving_workload(np, bundle.cfg.vocab)
    eng = cs.family_engine(dev, bundle, model)(overlap=True)
    ticks = []

    def timed_step():
        t0 = time.perf_counter()
        more = type(eng).step(eng)
        ls = eng.last_step
        ticks.append({"t0": t0, "ms": (time.perf_counter() - t0) * 1e3,
                      "queued": len(eng.queue),
                      "prefill_tokens": list(ls["prefill_tokens"]),
                      "decoded": ls["decoded"],
                      "processed": ls["processed"]})
        return more

    def serve():
        server = StreamingServer(eng).start()
        got, t_sub, threads = {}, {}, []

        def consume(uid):
            got[uid] = list(server.stream(uid, timeout=300))
        for uid, p in enumerate(prompts):
            t_sub[uid] = default_clock()
            server.submit(p, max_new_tokens=cs.SERVE_NEW, uid=uid)
            threads.append(threading.Thread(target=consume, args=(uid,)))
            threads[-1].start()
        for th in threads:
            th.join(timeout=300)
        server.shutdown()
        return got, t_sub

    serve()                                 # captures every program
    eng.step = timed_step
    try:
        got, t_sub = serve()
    finally:
        del eng.step
    t_base = ticks[0]["t0"]
    for t in ticks:
        t["t0_ms"] = (t.pop("t0") - t_base) * 1e3
    card = torch.cuda.get_device_name(0)
    print(f"{card}; {len(ticks)} loop ticks")
    requests = {}
    for uid, evs in sorted(got.items()):
        stamps = [e.t_us for e in evs]
        itl = list(np.diff(stamps) / 1e3)
        requests[uid] = {"ttft_ms": (stamps[0] - t_sub[uid]) / 1e3,
                         "itl_mean_ms": statistics.mean(itl),
                         "itl": quantiles(itl)}
        print(f"  req {uid}: ttft {requests[uid]['ttft_ms']:.1f} ms, itl "
              f"mean {requests[uid]['itl_mean_ms']:.2f} ms, "
              + ", ".join(f"{k} {v:.2f}" for k, v in
                          requests[uid]["itl"].items() if k != "n"))
    kinds = {"prefill": [t["ms"] for t in ticks if t["prefill_tokens"]],
             "decode": [t["ms"] for t in ticks
                        if t["decoded"] and not t["prefill_tokens"]],
             "idle": [t["ms"] for t in ticks if not t["decoded"]]}
    for kind, ms in kinds.items():
        if ms:
            print(f"  {kind} ticks: " + ", ".join(
                f"{k} {v:.3f}" if k != "n" else f"{k} {v}"
                for k, v in quantiles(ms).items()))
    med = statistics.median(kinds["decode"])
    long = [t for t in ticks if t["ms"] > 2 * med]
    print(f"  ticks over twice the median decode tick ({med:.3f} ms): "
          + "; ".join(f"at {t['t0_ms']:.1f} ms {t['ms']:.1f} ms, queued "
                      f"{t['queued']}, prefill {t['prefill_tokens']}"
                      for t in long))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": card, "ticks": ticks, "requests": requests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
