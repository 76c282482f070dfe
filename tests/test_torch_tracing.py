"""The port's profiler ranges on the CPU, under `torch.profiler.profile`
with CPU activity, at small sizes: the player model at 256 on 320-px
rendered scenes (as tests/test_torch_team_pipeline.py builds it, the
fused route asked for with `use_device_tracker=True`) and the puck model
on 128-px tiles of 256x384 frames.

- `detect_frames`, `puck_frames` and `classify_frames` open each host
  span (`stack`, `fetch`, `unpack`, `puck_track`, `teams`,
  `auction_sync`) as often as their batches, frames and syncs say, with
  one `auction_sync` range per host sync that `assignment.stats` counts.
- No span holds a `yield`: a consumer that sleeps between `next()` calls
  under a range of its own never sleeps inside a program span, and the
  spans' host time does not grow by the sleeps.
- Outside a profile `annotate` is one shared no-op context; inside, a
  `record_function`, on the profiling thread alone.
- The outputs are equal with and without a profile.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.models.detector import Detector
from hockey_tpu_torch.ops import assignment
from hockey_tpu_torch.pipeline import VideoProcessor
from hockey_tpu_torch.train.scenes import render_scene_sequence
from hockey_tpu_torch.utils.profiling import annotate

PLAYER = "hockey-player-detection"
HW, IMGSZ, BATCH, N_BATCHES = (320, 320), 256, 2, 2
PUCK_HW = (256, 384)
PUCK_KW = dict(puck_slice_size=128, puck_slice_overlap=0.25, nms_pre_topk=32,
               max_detections=8)
SPANS = ("stack", "fetch", "unpack", "puck_track", "teams", "auction_sync")
SLEEP = "consumer_sleep"


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    frames, _ = render_scene_sequence(np.random.default_rng(3), HW[0],
                                      n_frames=BATCH * N_BATCHES)
    return np.stack(frames)


@pytest.fixture(scope="module")
def puck_clip():
    """Dark discs moving over a noisy white rink."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:PUCK_HW[0], :PUCK_HW[1]]
    out = []
    for i in range(BATCH * N_BATCHES):
        f = np.full(PUCK_HW + (3,), 220, np.uint8)
        f += rng.integers(0, 12, f.shape, dtype=np.uint8)
        for x, y in ((40 + 12 * i, 60), (112 + 3 * i, 150)):
            f[((xx - x) / 7.0) ** 2 + ((yy - y) / 4.0) ** 2 <= 1] = (20, 18, 18)
        out.append(f)
    return np.stack(out)


@pytest.fixture(scope="module")
def detector():
    return Detector(PLAYER, Config(), frame_hw=HW, imgsz=IMGSZ, device="cpu",
                    dtype=torch.float32, with_team_features=True)


def processor(entry, detector):
    if entry == "puck_frames":
        return VideoProcessor(Config(**PUCK_KW, frame_batch=BATCH), device="cpu",
                              mode=ProcessingMode.PUCK_DETECTION, frame_hw=PUCK_HW)
    if entry == "classify_frames":
        cfg = Config(frame_batch=BATCH, use_device_tracker=True)
        mode = ProcessingMode.TEAM_CLASSIFICATION
    else:
        cfg, mode = Config(frame_batch=BATCH), ProcessingMode.PLAYER_DETECTION
    return VideoProcessor(cfg, device="cpu", frame_hw=HW, mode=mode,
                          player_detector=detector)


def run(entry, detector, frames, traced, sleep_s=0.0):
    """(results, the finished profiler or None, auction syncs) of a fresh
    processor's `entry` over the frames; with `sleep_s` the consumer
    sleeps that long between `next()` calls, inside a range of its own."""
    vp = processor(entry, detector)
    syncs0 = assignment.stats.syncs
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else \
        contextlib.nullcontext()
    out = []
    with prof:
        for r in getattr(vp, entry)(iter(frames)):
            out.append(r)
            if sleep_s:
                with record_function(SLEEP):
                    time.sleep(sleep_s)
    return out, (prof if traced else None), assignment.stats.syncs - syncs0


def counts(prof):
    return {e.key: e.count for e in prof.key_averages()}


def host_ms(prof, name):
    return sum(e.cpu_time_total for e in prof.key_averages() if e.key == name) / 1e3


def frames_for(entry, clip, puck_clip):
    return puck_clip if entry == "puck_frames" else clip


def expected(entry, results, syncs):
    n_frames = len(results)
    batches = n_frames // BATCH
    want = {"stack": batches, "fetch": batches, "detect": batches, "upload": batches}
    if entry == "puck_frames":
        want.update(puck_track=n_frames)
    else:
        want.update(unpack=batches)
    if entry == "classify_frames":
        want.update(tracker_scan=batches, auction_sync=syncs,
                    teams=sum(int((r["classes"] == 0).any()) for r in results))
    return want


def equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b))


ENTRIES = ("detect_frames", "puck_frames", "classify_frames")


@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_count_batches_frames_and_syncs(entry, detector, clip, puck_clip):
    frames = frames_for(entry, clip, puck_clip)
    plain, _, _ = run(entry, detector, frames, traced=False)
    got, prof, syncs = run(entry, detector, frames, traced=True)
    assert len(got) == len(frames)
    assert all(equal(a, b) for a, b in zip(plain, got))  # tracing changes nothing
    seen = counts(prof)
    want = expected(entry, got, syncs)
    assert {k: seen.get(k, 0) for k in want} == want
    for name in set(SPANS) - set(want):
        assert name not in seen, name
    if entry == "classify_frames":
        assert syncs >= 2 * (len(frames) // BATCH)
        assert want["teams"] >= 1
        # the sync waits are part of the tracker's host time
        assert host_ms(prof, "auction_sync") <= host_ms(prof, "tracker_scan")
    if entry != "puck_frames":  # the scenes really have players
        assert sum(len(r["boxes"] if isinstance(r, dict) else r.boxes) for r in got) >= 4


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_span_holds_a_yield(entry, detector, clip, puck_clip):
    """The consumer sleeps 50 ms after each frame: no program span encloses
    one of its sleeps, and no span's host time grows by them."""
    frames = frames_for(entry, clip, puck_clip)
    _, prof, _ = run(entry, detector, frames, traced=True, sleep_s=0.05)
    events = list(prof.events())
    sleeps = [(e.time_range.start, e.time_range.end) for e in events if e.name == SLEEP]
    assert len(sleeps) == len(frames)
    names = set(SPANS) | {"detect", "upload", "tracker_scan"}
    spans = [e for e in events if e.name in names]
    assert spans
    for e in spans:
        for s, t in sleeps:
            assert not (e.time_range.start <= s and t <= e.time_range.end), e.name
    slept_ms = 50.0 * len(frames)
    _, quiet, _ = run(entry, detector, frames, traced=True)
    for name in SPANS:
        if name in counts(quiet):
            assert host_ms(prof, name) < host_ms(quiet, name) + slept_ms / 2, name


def test_annotate_is_a_noop_outside_a_profile():
    off = annotate("stack")
    assert off is annotate("fetch")
    assert isinstance(off, contextlib.nullcontext)
    with off, off:  # shared, so entered again and nested
        pass
    other = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = annotate("stack")
        assert isinstance(on, record_function)
        with on:
            torch.ones(4).sum()
        # a thread without a profile of its own gets the no-op
        t = threading.Thread(target=lambda: other.append(annotate("fetch")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert other == [off]
    assert counts(prof).get("stack") == 1
    assert annotate("stack") is off
