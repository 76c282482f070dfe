"""Device ms per batch of the program's `team_features` range (the fused
team branch). Moves frames_per_s."""


def read(run):
    r = run.trace.range("team_features")
    if r is None or not run.batches or r["device_ms"] <= 0:
        return None
    return r["device_ms"] / run.batches
