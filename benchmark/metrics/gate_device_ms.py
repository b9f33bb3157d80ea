"""Device milliseconds of the extension gate's kernels (`csrc/gate.cu`:
the gate and the seg words' block totals and scan) in the trace, per
job."""

KERNELS = r"\b(gate_kernel|seg_totals_kernel|seg_scan_kernel)\b"


def read(ctx):
    if not ctx.jobs or not ctx.trace.kernel_count(KERNELS):
        return None
    return 1e3 * ctx.trace.kernel_s(KERNELS) / len(ctx.jobs)
