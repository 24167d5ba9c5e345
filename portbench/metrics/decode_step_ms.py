"""decode_step_ms (ms, the benchmark's spans): the device time of the
engine's decode program per step, between CUDA events recorded around
each call, averaged over the window's steps."""


def read(rec, ctx):
    spans = rec.get("decode_spans")
    if not spans:
        return None
    w0, w1 = rec["w0_us"] * 1000, rec["w1_us"] * 1000
    mine = [dev for t, dev, _ in spans if w0 <= t < w1]
    return 1e3 * sum(mine) / len(mine) if mine else None
