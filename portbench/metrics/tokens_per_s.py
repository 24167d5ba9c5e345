"""tokens_per_s (tokens/s, host clock): every output token emitted inside
the window, over the window."""


def read(rec, ctx):
    if "requests" not in rec:
        return None
    w0, w1 = rec["w0_us"], rec["w1_us"]
    n = sum(w0 <= t < w1 for r in rec["requests"] for t in r["times"])
    return n / ((w1 - w0) / 1e6)
