"""k4_roofline (%, device trace): K4's (paged decode attention's)
least time over the traced stretch, the bytes its launches need
(``work.k4_bytes``: the valid K and V rows of each token's sequence, its
query and its output) at 3.35 TB/s, over its device time there by
kernel name."""

from portbench import work


def read(rec, ctx):
    data = rec.get("trace")
    if data is None or not data.by_kernel.get("paged_decode_attention"):
        return None
    h0, h1 = (t / 1000 for t in data.host_window)
    nbytes = 0.0
    for r in rec["requests"]:
        p = len(r["prompt"])
        for i, t in enumerate(r["times"]):
            if h0 <= t < h1:
                nbytes += work.k4_bytes(ctx["conf"], 1, p + i)
    return 100.0 * nbytes / work.PEAK_BYTES_PER_S \
        / data.by_kernel["paged_decode_attention"]
