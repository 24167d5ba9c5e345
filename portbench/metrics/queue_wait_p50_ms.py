"""queue_wait_p50_ms (ms, the engine's RequestResult): the median, over
the window's requests, of the time from the due time to the first token
less the prefill's own time (first_token_us - due - prefill_s): the wait
for a slot and for the engine's tick."""

from portbench.stats import percentile, window_requests


def read(rec, ctx):
    if ctx["mix"]["loop"] != "open":
        return None
    waits = [(r["first_token_us"] - r["due_us"]) / 1e3 - r["prefill_s"] * 1e3
             for r in window_requests(rec) if r["first_token_us"]]
    return percentile(waits, 50)
