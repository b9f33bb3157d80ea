"""Share of the traced window in which no operation ran on the device:
1 - the union of the device events' intervals over the window (the
union of `chip_smoke.warm`, copied into `harness/trace.py`)."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
