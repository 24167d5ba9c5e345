"""device_idle_pct (%, device trace): the share of the traced stretch in
which no device record (kernel, copy, set) ran."""


def read(rec, ctx):
    data = rec.get("trace")
    if data is None or data.window_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)
