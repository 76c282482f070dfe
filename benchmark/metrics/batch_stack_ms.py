"""Host ms per batch of the program's `stack` range: the frames stacked
into one batch on the host (video/io.py `batched`). Moves frames_per_s."""


def read(run):
    r = run.trace.range("stack")
    return None if r is None or not run.batches else r["host_ms"] / run.batches
