"""Jersey-number OCR of the port against the JAX package on the CPU.

The digit net with the shipped `jersey_digits.msgpack` on both sides in
f32: logits within 1e-4 (f32 convolutions in two libraries; measured
5e-5). `normalize_crop` without OpenCV equals the JAX package's cv2 chain
exactly (gray and resize checked bit for bit against cv2), so predicted
numbers are equal on crops rendered by the JAX package's
`render_number_crop`, and confidences within 1e-5. The reader and the
PLAYER_TRACKING labels are then held to the JAX package's on one sequence
of frames with numbered jerseys."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.core.config import ProcessingMode as JaxMode
from hockey_tpu.ocr import digits as jax_digits
from hockey_tpu.ocr.jersey import JerseyNumberReader as JaxReader
from hockey_tpu.pipeline import VideoProcessor as JaxVideoProcessor
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.models.detector import HostDetections
from hockey_tpu_torch.ocr import digits
from hockey_tpu_torch.ocr.jersey import JerseyNumberReader
from hockey_tpu_torch.pipeline import VideoProcessor
from tests import test_pipeline as jax_golden

NUMBERS = (7, 23, 88, 4, 55, 12, 9, 31)  # player j wears NUMBERS[j]


@pytest.fixture(scope="module")
def params():
    return digits.load_default_params()


@pytest.fixture(scope="module")
def net(params):
    return digits.DigitNet.from_params(params)


@pytest.fixture(scope="module")
def rendered():
    """60 (BGR crop, expected text) from the JAX package's renderer."""
    rng = np.random.default_rng(123)
    out = []
    for _ in range(60):
        crop, tens, ones = jax_digits.render_number_crop(rng)
        out.append((crop, str(ones) if tens == jax_digits.TENS_NONE
                    else f"{tens}{ones}"))
    return out


@pytest.mark.parametrize("h,w", [(1, 1), (7, 300), (37, 23), (96, 96),
                                 (144, 200), (300, 11)])
def test_gray_and_resize_equal_cv2(h, w):
    img = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3),
                                                      dtype=np.uint8)
    gray = digits.bgr_to_gray(img)
    np.testing.assert_array_equal(gray, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(digits.resize_gray(gray, (48, 48)),
                                  cv2.resize(gray, (48, 48)))


def test_normalize_crop_equals_jax(rendered):
    for crop, _ in rendered:
        got = digits.normalize_crop(crop)
        assert got.shape == (48, 48, 1) and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jax_digits.normalize_crop(crop).astype(np.float32))


def test_digit_net_logits_match_jax(params, net, rendered):
    x = np.stack([digits.normalize_crop(c) for c, _ in rendered[:16]])
    want = jax_digits.forward(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x))
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_predict_matches_jax(params, net, rendered):
    x = np.stack([digits.normalize_crop(c) for c, _ in rendered])
    texts, conf = digits.predict(net, x)
    want_texts, want_conf = jax_digits.predict(params, x)
    assert texts == want_texts
    np.testing.assert_allclose(conf, want_conf, rtol=0, atol=1e-5)
    # the shipped net reads the renderer's numbers (hockey_tpu's own bar)
    assert np.mean([t == e for t, (_, e) in zip(texts, rendered)]) >= 0.9


def numbered_frame(i: int) -> np.ndarray:
    """hockey_tpu test_sahi_ocr.py's golden frame: tests/test_pipeline.py's
    players with their NUMBERS drawn on the torso."""
    f = np.full((jax_golden.H, jax_golden.W, 3), 235, np.uint8)
    for j in range(jax_golden.N_PLAYERS):
        x, y = jax_golden.player_pos(i, j)
        color = (30, 30, 200) if j % 2 else (120, 40, 40)
        cv2.rectangle(f, (x, y), (x + 24, y + 60), color, -1)
        cv2.putText(f, str(NUMBERS[j]), (x + 2, y + 32),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 2)
    return f


def test_reader_matches_jax_on_a_sequence():
    """One sequence of frames, boxes and ids through both readers with the
    digit backend: the same reads, votes, numbers and confidences."""
    ours = JerseyNumberReader(device="cpu")
    ref = JaxReader()
    assert ours.backend == ref.backend == "digits"
    for r in (ours, ref):
        r.read_every_n, r.min_crop_height = 2, 30
    ids = np.arange(1, jax_golden.N_PLAYERS + 1)
    for i in range(8):
        boxes = jax_golden.gt_detections(i)[0]
        frame = numbered_frame(i)
        ours.observe(frame, boxes, ids)
        ref.observe(frame, boxes, ids)
    assert ours.numbers == ref.numbers and len(ours.numbers) >= 4
    assert set(ours.votes) == set(ref.votes)
    for tid, tally in ours.votes.items():
        assert set(tally) == set(ref.votes[tid])
        np.testing.assert_allclose([tally[k] for k in sorted(tally)],
                                   [ref.votes[tid][k] for k in sorted(tally)],
                                   rtol=1e-5)
    assert len(set(ours.numbers.values()) & {str(n) for n in NUMBERS}) >= 4


def test_reader_without_backend_and_persistence():
    r = JerseyNumberReader(digit_params=False, device="cpu")
    assert r.backend is None and not r.available and r.net is None
    r.observe(np.zeros((100, 100, 3), np.uint8), np.asarray([[10, 10, 50, 90]]),
              np.asarray([1]))
    assert r.get_number(1) is None
    r2 = JerseyNumberReader(device="cpu")
    assert (r2.min_confidence, r2.min_crop_height, r2.read_every_n) == (0.45, 26, 5)
    r2.numbers[5] = "42"
    assert r2.get_number(5) == "42"
    r2.drop(5)
    assert r2.get_number(5) is None


class _PortStub:
    """tests/test_pipeline.py's canned player detections as the port's
    HostDetections."""

    def __init__(self):
        self.frame_idx = 0

    def detect(self, frame):
        b, s, c = jax_golden.gt_detections(self.frame_idx)
        self.frame_idx += 1
        return HostDetections(b, s, c)


def _labels(vp, frames):
    seen = []
    vp.label_annotator.annotate = lambda img, b, lab, c: seen.append(list(lab)) or img
    for f in frames:
        vp.process_frame(f)
    return seen


def test_player_tracking_labels_match_jax(monkeypatch):
    """PLAYER_TRACKING through both VideoProcessors with the stub detector
    (host ByteTrack, frame by frame): labels '#id (number)' frame for
    frame, as hockey_tpu test_sahi_ocr.py's golden test draws them."""
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")
    frames = [numbered_frame(i) for i in range(12)]
    jvp = JaxVideoProcessor(config=jax_golden.small_config(),
                            mode=JaxMode.PLAYER_TRACKING,
                            frame_hw=(jax_golden.H, jax_golden.W),
                            player_detector=jax_golden.StubDetector(),
                            team_names=("A", "B"))
    cfg = Config()
    cfg.max_initialization_frames, cfg.initialization_stride = 3, 5
    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=(jax_golden.H, jax_golden.W),
                        player_detector=_PortStub(), team_names=("A", "B"))
    assert vp.ocr.backend == jvp.ocr.backend == "digits"
    for p in (jvp, vp):
        p.ocr.read_every_n, p.ocr.min_crop_height = 1, 30
    got, want = _labels(vp, frames), _labels(jvp, frames)
    assert got == want
    assert vp.ocr.numbers == jvp.ocr.numbers
    assert any("(" in lab for lab in got[-1])
    assert any(lab.startswith("Goalie #") for lab in got[-1])


def test_pretracked_route_labels_carry_numbers(monkeypatch):
    """The fused route's rows (`pretracked`) take the same labels and feed
    the reader: a player's number, a goalie without one."""
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")
    vp = VideoProcessor(Config(), device="cpu",
                        mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=(jax_golden.H, jax_golden.W),
                        player_detector=_PortStub())
    boxes, scores, classes = jax_golden.gt_detections(0)
    tids = np.arange(11, 11 + len(boxes), dtype=np.int32)
    vp.ocr.numbers[12] = "42"
    vp.ocr.numbers[11] = "1"  # track 11 is the goalie (class 1)
    *_, labels = vp._tracked_result(numbered_frame(0),
                                    pretracked=(boxes, scores, classes, tids))
    assert labels[0] == "Goalie #11" and labels[1] == "#12 (42)"
    assert labels[2] == "#13"
    assert vp.ocr._since_read[12] == 0  # the reader saw the players
    assert 11 not in vp.ocr._since_read  # and not the goalie
