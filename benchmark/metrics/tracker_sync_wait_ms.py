"""Host ms per batch of the program's `auction_sync` ranges: the auction's
reads of its loop condition (ops/assignment.py), each a wait for the
tracker's work queued on the device. The rest of `tracker_scan`'s host
time is spent issuing that work. Moves frames_per_s."""


def read(run):
    r = run.trace.range("auction_sync")
    return None if r is None or not run.batches else r["host_ms"] / run.batches
