"""Saved calibration segments (the 'G' key) through the port's two routes
against the JAX `VideoProcessor.process_frame` (hockey_tpu/pipeline.py:
345-369, homography/calibrator.py:177-184), on the CPU with stub
detectors.

A camera holds view A, pans to view B and comes back to A; the segment
saved in A's first visit is reused on the return. The calibrator's motion
probe reads the frame: the drawing route (`VideoProcessor.process_frame`)
gives it the frame with the keypoints drawn, as the JAX package does, the
numeric route (`track_frames`) the raw frame. Per frame the status and
the stabilised homography are held against the JAX run:

- drawing route: equal on every frame, at 360x640 and at 72x128;
- numeric route: equal on every frame at 1080x1920, the main path's
  frames, where the drawn keypoints (radius `keypoint_radius` px and
  their labels) change little of the 36x64 probe. At 360x640 they cover
  a larger share of the frame: on the return to A, whose keypoints have
  moved by 1% of the frame, the drawn probe differs from the saved one by
  more than the threshold, so the JAX package (and the drawing route)
  fits anew, while the raw probe matches and the numeric route reuses the
  saved homography. The test pins that difference (ROADMAP §3).
"""

import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from hockey_tpu.core.config import ProcessingMode as JaxMode  # noqa: E402
from hockey_tpu.homography import keypoints as jkp  # noqa: E402
from hockey_tpu.pipeline import VideoProcessor as JaxVideoProcessor  # noqa: E402
from hockey_tpu_torch.core.config import ProcessingMode  # noqa: E402
from hockey_tpu_torch.homography.ransac import dlt_homography, project  # noqa: E402
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402
from hockey_tpu_torch.rinkmap.dimensions import default_keypoint_positions  # noqa: E402
from tests.test_pipeline import StubDetector, small_config  # noqa: E402
from tests.test_torch_session import (PortStubDetector,  # noqa: E402,F401
                                      one_torch_thread, port_config)

# views A, A, A, A, A (saved after frame 3), B x 4, A x 5
VIEWS = "AAAAABBBBAAAAA"
SAVE_AFTER = 3


def frames_and_keypoints(h, w):
    """(frames (N, h, w, 3) uint8, keypoints (N, 56, 3)): view A darkens
    the left 40% of the frame and B the right 40%; the rink keypoints are
    projected through each view's homography, and on the return to A move
    by about 1% of the frame (a keypoint model's jitter)."""
    table = default_keypoint_positions()
    src = np.array([[10.0, 0.0], [190.0, 0.0], [10.0, 85.0], [190.0, 85.0]])
    corners = {"A": [[0.1, 0.15], [0.9, 0.15], [-0.05, 0.95], [1.05, 0.95]],
               "B": [[-0.3, 0.1], [0.6, 0.12], [-0.5, 0.9], [0.8, 0.98]]}
    hs = {v: dlt_homography(src, np.array(c) * [w, h]) for v, c in corners.items()}
    rng = np.random.default_rng(0)
    frames, kpts = [], []
    for i, v in enumerate(VIEWS):
        f = np.full((h, w, 3), 232, np.uint8)
        band = slice(0, 4 * w // 10) if v == "A" else slice(6 * w // 10, w)
        f[:, band] = (70, 60, 50)
        pts = project(hs[v], table)
        if v == "A" and i > VIEWS.index("B"):
            pts = pts + rng.normal(0, 0.01 * w, pts.shape)
        vis = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
        kpts.append(np.concatenate([pts, np.where(vis, 0.9, 0.1)[:, None]], 1))
        frames.append(f)
    return np.stack(frames), np.asarray(kpts, np.float32)


class JaxRinkStub:
    def __init__(self, kpts):
        self.kpts, self.i = kpts, 0

    def detect_keypoints(self, frame, conf_threshold=0.5):
        self.i += 1
        return jkp.keypoints_from_array(self.kpts[self.i - 1], conf_threshold)


class PortRinkStub:
    def __init__(self, kpts):
        self.kpts, self.i = kpts, 0

    def detect_keypoints_batch(self, frames):
        self.i += len(frames)
        return self.kpts[self.i - len(frames):self.i]


class NoNumbers:
    """A jersey reader that reads nothing (the OCR is not under test)."""

    def get_number(self, tid):
        return None

    def observe(self, frame, boxes, tids):
        pass


def _record(cal):
    h = cal.stabilizer.current
    return cal.status, None if h is None else h.copy()


def run_jax(frames, kpts):
    vp = JaxVideoProcessor(config=small_config(), mode=JaxMode.PLAYER_TRACKING,
                           frame_hw=frames.shape[1:3], player_detector=StubDetector(),
                           show_2d_map=True)
    vp.rink_detector, vp.ocr = JaxRinkStub(kpts), None
    out = []
    for i, f in enumerate(frames):
        vp.process_frame(f)
        out.append(_record(vp.calibrator))
        if i == SAVE_AFTER:
            assert vp.calibrator.save_segment()
    return out


def port_processor(frames, kpts):
    vp = VideoProcessor(port_config(frame_batch=1), device="cpu",
                        mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=frames.shape[1:3],
                        player_detector=PortStubDetector(), show_2d_map=True)
    vp.rink_detector, vp.ocr = PortRinkStub(kpts), NoNumbers()
    return vp


def run_port(frames, kpts, draw):
    vp = port_processor(frames, kpts)
    out = []
    steps = (vp.process_frame(f) for f in frames) if draw else \
        vp.track_frames(iter(frames))
    for i, _ in enumerate(steps):
        out.append(_record(vp.calibrator))
        if i == SAVE_AFTER:
            assert vp.calibrator.save_segment()
    assert len(out) == len(frames)
    return out


def same(a, b):
    (sa, ha), (sb, hb) = a, b
    return sa == sb and (ha is None) == (hb is None) and (
        ha is None or np.allclose(ha, hb, rtol=0, atol=1e-9))


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)
    yield


@pytest.mark.parametrize("hw", [(360, 640), (72, 128)])
def test_saved_segments_drawing_route_matches_jax(hw):
    frames, kpts = frames_and_keypoints(*hw)
    want = run_jax(frames, kpts)
    got = run_port(frames, kpts, draw=True)
    assert [same(g, w) for g, w in zip(got, want)] == [True] * len(VIEWS)
    assert want[VIEWS.index("B")][0].startswith("OK")  # B is fitted anew


@pytest.mark.parametrize("hw", [(1080, 1920), (360, 640)])
def test_saved_segments_numeric_route(hw):
    """At 1080x1920 the numeric route reuses the segment where the JAX
    package does, on every frame; at 360x640 it reuses it where the JAX
    package, whose probe sees the drawn keypoints, fits anew (the recorded
    difference)."""
    back = VIEWS.index("B") + 4  # the first frame back in view A
    reused = "Reused saved calibration segment"
    frames, kpts = frames_and_keypoints(*hw)
    want = run_jax(frames, kpts)
    got = run_port(frames, kpts, draw=False)
    if hw[0] == 1080:
        assert [same(g, w) for g, w in zip(got, want)] == [True] * len(VIEWS)
        assert want[back][0] == reused
    else:
        assert [same(g, w) for g, w in zip(got[:back], want[:back])] == [True] * back
        assert got[back][0] == reused and want[back][0].startswith("OK")
        assert not np.allclose(got[back][1], want[back][1])
