"""Host syncs per batch of the tracker's assignment
(`hockey_tpu_torch.ops.assignment.stats.syncs`, read around the traced
window). Moves frames_per_s."""


def read(run):
    n = run.counters.get("assignment_syncs")
    return None if n is None or not run.batches else n / run.batches
