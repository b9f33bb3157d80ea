"""Seconds of `TorchEngine.compare`, the benchmark's own span ended by a
synchronise; mean per job."""


def read(ctx):
    return ctx.mean_span("compare_s")
