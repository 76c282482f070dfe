"""Device ms per batch of the conv epilogue kernel (the folded bias, SiLU
and the bottleneck's residual of every inference conv in one pass),
read by the kernel's name in the trace. The program launches it inside a
profiler op of its own within the `forward` range, so this time is also
part of `forward_ms`. Nothing to read where the program has no such
kernel. Moves frames_per_s."""

KERNEL = "conv_epilogue_kernel"


def read(run):
    k = run.trace.kernel(KERNEL)
    if k is None or not run.batches:
        return None
    return k["device_ms"] / run.batches
