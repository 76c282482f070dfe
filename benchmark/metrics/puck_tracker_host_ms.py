"""Host ms per frame of the program's `puck_track` stage: the puck
tracker's gated selection and smoothing on the host (slicing/sahi.py
PuckTracker through pipeline.py `puck_frames`), read as a range. Moves
frames_per_s."""


def read(run):
    r = run.trace.range("puck_track")
    return None if r is None or not run.frames else r["host_ms"] / run.frames
