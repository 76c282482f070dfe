"""Frame batches staged in page-locked memory and the one upload helper
(core/staging.py), as `VideoProcessor` uses them (video/io.py `batched`).

On the CPU: a staged batch (in pageable memory there, which the CPU can
stage but not pin) is bit-equal to `np.stack`, the padded final batch and
strided frames included; a view of an early batch, as the team fit keeps
its crops, is unchanged after four more batches, with and without the
prefetch thread; the helper copies everything on the CPU by the blocking
copy and counts it, and the CPU pipeline stacks as before, never pinning.

On the card (skipped without CUDA: page-locked memory needs it): the
staged block is pinned and uploads bit for bit without a host wait; every
batch of `classify_frames`, `detect_frames` and `puck_frames` is uploaded
pinned, none pageable; a frame held across four prefetched batches that
are uploaded meanwhile is unchanged; and in the steady state no new
page-locked block is allocated."""

import functools
import json

import numpy as np
import pytest
import torch

from hockey_tpu_torch.core import staging
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.models.detector import fetch, pack
from hockey_tpu_torch.ops.nms import Detections
from hockey_tpu_torch.pipeline import VideoProcessor
from hockey_tpu_torch.teams.base import host_crops
from hockey_tpu_torch.utils.metrics import StageTimers
from hockey_tpu_torch.video.io import batched, prefetched

# a staged batch in pageable memory: the CPU's stand-in for `stage`
cpu_stage = functools.partial(staging.stage, pin_memory=False)


def clip(n: int, hw=(36, 52), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), np.uint8)


def _frames(case: str):
    frames = clip(13)
    if case == "strided":  # mirrored views, as a flipped clip gives them
        return [f[:, ::-1] for f in frames]
    return list(frames[:8] if case == "full" else frames)


# --------------------------------------------------------------------------
# the CPU

@pytest.mark.parametrize("case", ["full", "padded", "strided"])
def test_staged_batches_are_bit_equal_to_np_stack(case):
    frames = _frames(case)
    want = list(batched(iter(frames), 8))
    got = list(batched(iter(frames), 8, cpu_stage))
    assert [n for _, n in got] == [n for _, n in want]
    for (g, _), (w, _) in zip(got, want):
        assert torch.is_tensor(g.base)  # written into an allocator's block
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_frames_stage_cannot_take_are_stacked_by_numpy():
    f = clip(3)
    mixed = [f[0], f[1].astype(np.float32), f[2]]
    assert np.array_equal(staging.stage(mixed), np.stack(mixed))
    assert staging.stage(mixed).dtype == np.float32
    with pytest.raises(ValueError):
        staging.stage([f[0], f[1][:-1]])  # as np.stack: shapes differ


@pytest.mark.parametrize("prefetch", [False, True], ids=["direct", "prefetched"])
def test_a_view_of_batch_1_is_unchanged_after_4_more_batches(prefetch):
    """The team fit keeps `host_crops` views of every batch's frames until
    it fits; later batches must not be staged over them."""
    frames = clip(40, seed=1)
    batches = batched(iter(frames), 8, cpu_stage)
    if prefetch:
        batches = prefetched(batches)
    first, _ = next(batches)
    crops = host_crops(first[3], np.array([[4, 2, 30, 33], [0, 0, 52, 36]]))
    kept = [c.copy() for c in crops]
    del first
    later = 0
    for batch, _ in batches:
        batch[:] = 0  # the consumer scribbles on its own batch
        later += 1
    assert later == 4
    assert all(np.array_equal(c, k) for c, k in zip(crops, kept))
    assert np.array_equal(crops[1], frames[3])


class _UploadStub:
    """A player detector that uploads its batch through the helper and
    finds nothing; it keeps the batches it was given."""

    def __init__(self):
        self.got = []

    def detect_batch(self, frames):
        self.got.append(frames)
        x = staging.upload(frames, torch.device("cpu"))
        b = x.shape[0]
        return Detections(torch.zeros(b, 4, 4), torch.full((b, 4), -1.0),
                          torch.full((b, 4), -1, dtype=torch.int32),
                          torch.zeros(b, 4, dtype=torch.bool))

    def fetch_batch(self, frames):
        return fetch(pack(self.detect_batch(frames)))


def test_the_helper_counts_pageable_uploads_on_the_cpu_and_never_pins():
    staging.stats.reset()
    batch = np.stack(list(clip(4)))
    x = staging.upload(batch, torch.device("cpu"))
    assert torch.equal(x, torch.from_numpy(batch)) and not x.is_pinned()
    staged = cpu_stage(list(clip(4)))
    assert staging.staged_block(staged) is None  # not page-locked
    staging.upload(staged, torch.device("cpu"))
    staging.upload(torch.from_numpy(batch), torch.device("cpu"))
    assert staging.stats.as_dict() == {"pinned_uploads": 0, "pageable_uploads": 3}

    # the CPU pipeline stacks with numpy, as before, and uploads pageable
    stub = _UploadStub()
    vp = VideoProcessor(Config(frame_batch=4), device="cpu", frame_hw=(36, 52),
                        mode=ProcessingMode.PLAYER_DETECTION, player_detector=stub)
    staging.stats.reset()
    assert len(list(vp.detect_frames(iter(clip(10))))) == 10
    assert staging.stats.as_dict() == {"pinned_uploads": 0, "pageable_uploads": 3}
    assert all(b.base is None for b in stub.got)


def test_json_metrics_put_extra_entries_beside_the_timers(tmp_path):
    t = StageTimers()
    with t.stage("detect"):
        t.count("detections", 3)
    path = tmp_path / "m.json"
    t.dump_json(str(path), uploads=staging.stats.as_dict())
    got = json.loads(path.read_text())
    assert got["counters"] == {"detections": 3}
    assert set(got["uploads"]) == {"pinned_uploads", "pageable_uploads"}


# --------------------------------------------------------------------------
# the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked staging needs CUDA")
    staging.stats.reset()
    return torch.device("cuda")


def test_staged_block_is_pinned_and_uploads_bit_equal(card):
    frames = list(clip(8, hw=(1080, 1920), seed=2))
    staged = staging.stage(frames)
    block = staging.staged_block(staged)
    assert block is not None and block.is_pinned()
    assert staging.staged_block(staged[0]) is None  # a view: not the batch
    x = staging.upload(staged, card)
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), torch.from_numpy(np.stack(frames)))
    assert staging.stats.as_dict() == {"pinned_uploads": 1, "pageable_uploads": 0}


def _entry_runs(mode: ProcessingMode):
    """(the entry of a VideoProcessor in `mode` on the card, its frames)."""
    from chip_smoke import puck_scene, synthetic_frames

    n = 20  # 3 batches of 8, the last padded
    if mode == ProcessingMode.PUCK_DETECTION:
        vp = VideoProcessor(Config(), device="cuda", mode=mode)
        return vp.puck_frames, puck_scene(0, n)
    vp = VideoProcessor(Config(), device="cuda", mode=mode,
                        team_names=("HOME", "AWAY"))
    entry = (vp.classify_frames if mode == ProcessingMode.TEAM_CLASSIFICATION
             else vp.detect_frames)
    return entry, synthetic_frames(0, n)


@pytest.mark.parametrize("mode", [ProcessingMode.TEAM_CLASSIFICATION,
                                  ProcessingMode.PLAYER_DETECTION,
                                  ProcessingMode.PUCK_DETECTION],
                         ids=lambda m: m.name)
def test_every_serving_batch_is_uploaded_pinned(card, mode):
    entry, frames = _entry_runs(mode)
    staging.stats.reset()
    assert len(list(entry(iter(frames)))) == len(frames)
    assert staging.stats.as_dict() == {"pinned_uploads": 3, "pageable_uploads": 0}


def test_a_frame_held_across_4_prefetched_batches_is_unchanged(card):
    frames = clip(40, hw=(1080, 1920), seed=3)
    batches = prefetched(batched(iter(frames), 8, staging.stage))
    first, _ = next(batches)
    held = first[5]
    x = staging.upload(first, card)
    del first
    outs = [x]
    for batch, _ in batches:
        outs.append(staging.upload(batch, card))
    torch.cuda.synchronize()
    assert len(outs) == 5
    assert np.array_equal(held, frames[5])
    for i, x in enumerate(outs):
        assert torch.equal(x.cpu(), torch.from_numpy(frames[8 * i:8 * i + 8]))
    assert staging.stats.as_dict() == {"pinned_uploads": 5, "pageable_uploads": 0}


def test_steady_state_allocates_no_new_page_locked_block(card):
    """Batches staged and uploaded as the serving loop does: after the
    first few, every block comes back from the allocator's cache."""
    frames = clip(16, hw=(1080, 1920), seed=4)
    loop = batched((frames[i % 16] for i in range(8 * 24)), 8, staging.stage)
    warm, ptrs, allocs = 4, [], []
    stats = getattr(torch.cuda, "host_memory_stats", None)
    for k, (batch, _) in enumerate(loop):
        x = staging.upload(batch, card)
        ptrs.append(batch.ctypes.data)
        x.sum().item()  # the step's result, fetched
        if stats is not None:
            allocs.append(stats().get("num_host_alloc"))
    assert len(ptrs) == 24
    assert set(ptrs[warm:]) <= set(ptrs[:warm])
    if stats is not None and allocs[0] is not None:
        assert allocs[-1] == allocs[warm - 1]
