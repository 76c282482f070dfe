"""Host ms per frame of the pipeline outside its `detect` stage: the
traced window less the `detect` stage's total (`VideoProcessor.timers`,
host clock), over the window's frames. Moves frames_per_s."""


def read(run):
    if "detect" not in run.timers or not run.frames:
        return None
    return 1e3 * (run.window_s - run.timers["detect"]) / run.frames
