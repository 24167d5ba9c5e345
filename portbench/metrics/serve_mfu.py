"""serve_mfu (%, the benchmark's spans and portbench.work): the least
time at the H100's roofline of every decode step and prefill the engine
ran in the window (each the larger of FLOPs / 989 TFLOP/s and bytes /
3.35 TB/s, ``work.py``), over the window.

A decode step is counted at its active slots (read at its call) and the
mean attended length of the window's tokens; a prefill at its request's
true prompt length (padding is no work).  The k-th prefill call is the
k-th request submitted: the engine admits first in, first out."""

from portbench import work


def read(rec, ctx):
    spans, pre = rec.get("decode_spans"), rec.get("prefill_spans")
    if not spans or pre is None:
        return None
    conf = ctx["conf"]
    w0, w1 = rec["w0_us"], rec["w1_us"]
    n_tok = ctx_sum = 0
    for r in rec["requests"]:
        p = len(r["prompt"])
        for i, t in enumerate(r["times"]):
            if w0 <= t < w1:
                n_tok += 1
                ctx_sum += p + i
    if not n_tok:
        return None
    mean = ctx_sum / n_tok
    least = sum(work.least_s(*work.decode_step(conf, n, n * mean))
                for t, _, n in spans if w0 * 1000 <= t < w1 * 1000 and n)
    prompts = {r["uid"]: len(r["prompt"]) for r in rec["requests"]}
    for (t, _, bucket), uid in zip(pre, rec["submitted"]):
        length = prompts[uid] - 1
        if bucket < length:
            return None                     # not the request it was taken for
        if w0 * 1000 <= t < w1 * 1000:
            least += work.least_s(*work.prefill(conf, length))
    return 100.0 * least / ((w1 - w0) / 1e6)
