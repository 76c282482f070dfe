"""The share of the traced window, in %, in which no kernel, copy or set
ran on the device: 1 - the union of their intervals over the window.
Moves frames_per_s."""


def read(run):
    if run.window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
