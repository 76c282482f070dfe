"""Host ms per batch of the program's `tracker_scan` range, which holds
the waits of the auction's host syncs. Moves frames_per_s."""


def read(run):
    r = run.trace.range("tracker_scan")
    return None if r is None or not run.batches else r["host_ms"] / run.batches
