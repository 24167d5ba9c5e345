"""train_tokens_per_s (tokens/s, host clock): the tokens of every train
step of the window, over the window, which ends when its last step
has."""


def read(rec, ctx):
    if "steps" not in rec:
        return None
    return rec["tokens"] / (rec["w1"] - rec["w0"])
