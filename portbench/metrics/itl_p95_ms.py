"""itl_p95_ms (ms, host clock): the 95th percentile of every gap between
two consecutive tokens of one request whose later token came inside the
window."""

from portbench.stats import percentile


def read(rec, ctx):
    if "requests" not in rec:
        return None
    w0, w1 = rec["w0_us"], rec["w1_us"]
    gaps = [(b - a) / 1e3 for r in rec["requests"]
            for a, b in zip(r["times"], r["times"][1:]) if w0 <= b < w1]
    return percentile(gaps, 95)
