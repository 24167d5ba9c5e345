"""ttft_p95_ms (ms, host clock): the 95th percentile, over every request
due inside the window, of the time from its due time to its first
token's StreamEvent.  A request that never got a first token counts the
whole wait, to the end of the run."""

from portbench.stats import percentile, window_requests


def read(rec, ctx):
    if ctx["mix"]["loop"] != "open":
        return None
    lat = [((r["times"][0] if r["times"] else rec["end_us"]) - r["due_us"])
           / 1e3 for r in window_requests(rec)]
    return percentile(lat, 95)
