"""The whole serving step's share of the chip's peak, in %: the model's
forward FLOPs per frame (benchmark/harness/flops.py) times the traced
window's frames, over the window's seconds times the published dense
bf16 peak of one H100. Moves frames_per_s."""


def read(run):
    if not run.frames or run.window_s <= 0 or run.busy_s <= 0:
        return None
    flops = run.flops_per_frame * run.frames
    return 100.0 * flops / (run.window_s * run.peaks.BF16_FLOPS_PER_S)
