"""Device ms per batch of the program's `upload` range (the frames'
host-to-device copy). Moves frames_per_s."""


def read(run):
    r = run.trace.range("upload")
    if r is None or not run.batches or r["device_ms"] <= 0:
        return None
    return r["device_ms"] / run.batches
