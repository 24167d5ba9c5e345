"""train_mfu (%, host clock and portbench.work): the FLOPs of the
window's train steps (PaLM's count, causal attention, no recompute),
over the window, over 989 TFLOP/s."""

from portbench import work


def read(rec, ctx):
    if "steps" not in rec:
        return None
    mix = ctx["mix"]
    flops, _ = work.train_step(ctx["conf"], int(mix["batch"]),
                               int(mix["seq"]))
    return 100.0 * rec["steps"] * flops / (rec["w1"] - rec["w0"]) \
        / work.PEAK_BF16_FLOPS
