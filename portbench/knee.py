"""The knee of an open-loop cell: the highest rate at which the queue
waiting for slots does not grow over the window, found by a sweep.

    python -m portbench.knee --workload yi6b.chat --rates 8,10,12,14 \
        --seconds 20 [--seed N] [--write]

One process, one engine (set up once, warmed for every rate's
requests); the rates are offered from the lowest up, each for the mix's
lead-in and ``--seconds`` (and until the window's requests have
finished), then the queue is cleared and the slots finish before the
next.  For each rate it prints the requests due in the window, how many
waited for a slot (due, no first token yet) over the window's first and
last tenths, the TTFT's median and 95th percentile, and the tokens a
second; the queue grows where the last tenth's mean count of waiting
requests exceeds the first's by more than 3 and a tenth.  The sweep
stops at the first rate whose queue grows (a higher one would only wait
out its backlog).  With ``--write`` the mix's ``rate_per_s`` is set to
0.8 of the knee, to a tenth, in its file under ``traffic/``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def waiting(reqs, t_us: int) -> int:
    return sum(r["due_us"] <= t_us and not (r["times"] and r["times"][0]
                                            <= t_us) for r in reqs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from portbench import traffic
    from portbench.drivers.serve import ServeSession
    from portbench.spec import Bench
    from portbench.stats import percentile

    if not torch.cuda.is_available():
        print("portbench.knee: no CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    cell = bench.cell(args.workload)
    conf, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    rates = sorted(float(r) for r in args.rates.split(","))
    vocab = conf["model"]["vocab_size"]
    plans = []
    for i, rate in enumerate(rates):
        reqs = traffic.serve_requests(dict(mix, rate_per_s=rate), args.seed,
                                      args.seconds, vocab)
        for r in reqs:
            r["uid"] += (i + 1) << 32
        plans.append(reqs)
    session = ServeSession(conf, mix, args.seed, "cuda",
                           [r for p in plans for r in p])
    eng = session.engine
    rows = []
    for rate, reqs in zip(rates, plans):
        rec = session.drive(reqs, args.seconds, float(mix["lead_in_s"]))
        session.server.shutdown()
        eng.queue.clear()
        eng.run()
        session.server.start()
        w0, w1 = rec["w0_us"], rec["w1_us"]
        win = [r for r in rec["requests"] if w0 <= r["due_us"] < w1]
        tenth = int((w1 - w0) / 10)
        first = np.mean([waiting(rec["requests"], t)
                         for t in range(w0, w0 + tenth, 100_000)])
        last = np.mean([waiting(rec["requests"], t)
                        for t in range(w1 - tenth, w1, 100_000)])
        ttft = [(r["times"][0] - r["due_us"]) / 1e3 for r in win
                if r["times"]]
        toks = sum(w0 <= t < w1 for r in rec["requests"] for t in r["times"])
        row = {"rate": rate, "requests": len(win),
               "waiting_first": float(first), "waiting_last": float(last),
               "ttft_p50_ms": percentile(ttft, 50),
               "ttft_p95_ms": percentile(ttft, 95),
               "unserved": len(win) - len(ttft),
               "tokens_per_s": toks / ((w1 - w0) / 1e6)}
        row["grows"] = bool(last - first > max(3.0, 0.1 * first))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if row["grows"]:
            break
    session.close()
    ok = [r["rate"] for r in rows if not r["grows"]]
    knee = max(ok) if ok else None
    out = {"workload": args.workload, "knee": knee,
           "device": torch.cuda.get_device_name()}
    if args.write and knee is not None:
        out["rate_per_s"] = round(0.8 * knee, 1)
        path = ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json"
        doc = json.loads(path.read_text())
        doc["rate_per_s"] = out["rate_per_s"]
        path.write_text(json.dumps(doc, indent=2) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
