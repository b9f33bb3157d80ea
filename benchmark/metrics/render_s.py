"""Seconds of `TorchEngine.render_report`, the benchmark's own span ended
by a synchronise; mean per job."""


def read(ctx):
    return ctx.mean_span("render_s")
