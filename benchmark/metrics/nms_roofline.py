"""The suppression kernel's share of its roofline, in %: the least time
of its launches in the traced window (each launch's bound from the cell's
shapes and the reference's own kept sets, benchmark/harness/peaks.py)
over their device time, read by the kernel's name in the trace. Moves
frames_per_s."""

KERNEL = "nms_suppress_kernel"


def read(run):
    k = run.trace.kernel(KERNEL)
    if k is None or not run.nms_bound_s or k["count"] != run.nms_launches:
        return None
    return 100.0 * run.nms_bound_s / (k["device_ms"] / 1e3)
