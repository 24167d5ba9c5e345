"""prefill_ms_p50 (ms, the engine's RequestResult.prefill_s): the median
prefill time of the window's requests, from its start to its end on the
device."""

from portbench.stats import percentile, window_requests


def read(rec, ctx):
    if "requests" not in rec:
        return None
    return percentile([r["prefill_s"] * 1e3 for r in window_requests(rec)
                       if r["prefill_s"]], 50)
