"""Device ms per batch of the program's `forward` range (the YOLOv8
forward through DetectCore). Moves frames_per_s."""


def read(run):
    r = run.trace.range("forward")
    if r is None or not run.batches or r["device_ms"] <= 0:
        return None
    return r["device_ms"] / run.batches
