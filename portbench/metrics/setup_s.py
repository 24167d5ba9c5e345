"""setup_s (s, host clock): from the start of the run's process to the
window's start: the weights made on the device, the kernels loaded,
the cell's programs captured and, for serving, the lead-in."""


def read(rec, ctx):
    return rec["setup_s"]
