"""Host ms per batch of the program's `fetch` ranges: the copies of a
step's outputs to the host, which wait for the step to finish on the
device (pipeline.py, slicing/sahi.py). Moves frames_per_s."""


def read(run):
    r = run.trace.range("fetch")
    return None if r is None or not run.batches else r["host_ms"] / run.batches
