"""The PUCK_DETECTION slice of the port against the JAX package on the CPU.

Both sides run the shipped YOLOv8s puck model in f32: the JAX sliced
detector's program is rebuilt at f32 over the unfused f32 checkpoint (its
`Detector` would fold and cast the weights to bf16), the port's is its CPU
default. Frames are 256x384 with dark discs drawn on a noisy rink, one on
a tile seam; tiles are 128 px with overlap 0.25 (12 tiles per frame), as
in hockey_tpu's tests/test_sahi_ocr.py. Tolerances: tiles equal; valid
masks (so kept sets) and classes equal; boxes within 1e-3 px and scores
within 1e-4 (f32 convolutions in two libraries; measured 3e-5 and 5e-7);
the host stages (PuckTracker, demotion, drawing) are the same numpy code,
so their outputs on the same inputs are equal."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.core.config import Config as JaxConfig
from hockey_tpu.core.config import ProcessingMode as JaxMode
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.models.detector import build_detect_fn
from hockey_tpu.pipeline import VideoProcessor as JaxVideoProcessor
from hockey_tpu.slicing import sahi as jax_sahi
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.ops.nms_kernel import suppress
from hockey_tpu_torch.pipeline import VideoProcessor
from hockey_tpu_torch.slicing import sahi

PUCK = "hockey-puck-detection"
HW = (256, 384)
KW = dict(puck_slice_size=128, puck_slice_overlap=0.25, nms_pre_topk=32,
          max_detections=8)
N_FRAMES = 4


def draw_frames(n: int, hw=HW, seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8: a noisy white rink with three dark discs per
    frame, the second on the seam of two tiles (x 96-128)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = np.full(hw + (3,), 220, np.uint8)
        f += rng.integers(0, 12, f.shape, dtype=np.uint8)
        for x, y in ((40 + 12 * i, 60), (112 + 3 * i, 150), (300, 200 - 10 * i)):
            if x < hw[1] and y < hw[0]:
                cv2.ellipse(f, (x, y), (7, 4), 0, 0, 360, (20, 18, 18), -1)
        out.append(f)
    return np.stack(out)


def jax_sliced_f32(config, hw):
    """The JAX SlicedDetector with its detector's program in f32 on the
    unfused f32 weights."""
    sd = jax_sahi.SlicedDetector(config, frame_hw=hw)
    d = sd.detector
    d.params = jax.tree_util.tree_map(jnp.asarray,
                                      jax_load_params(shipped_weights_path(PUCK)))
    d._fn = build_detect_fn(
        d.cfg, imgsz=d.imgsz, frame_hw=d.frame_hw, conf=d.conf,
        iou=d.config.nms_iou_threshold,
        containment=d.config.nms_containment_threshold,
        pre_topk=d.config.nms_pre_topk, max_det=d.max_det, dtype=jnp.float32)
    return sd


@pytest.fixture(scope="module")
def frames():
    return draw_frames(N_FRAMES)


@pytest.fixture(scope="module")
def jax_sliced():
    return jax_sliced_f32(JaxConfig(**KW), HW)


@pytest.fixture(scope="module")
def sliced():
    return sahi.SlicedDetector(Config(**KW), HW, device="cpu")


@pytest.fixture(scope="module")
def jax_merged(frames, jax_sliced):
    return jax_sliced.detect_frames(frames)


def _close(got, want):
    """Merged or tile detections: valid equal, boxes and scores close."""
    gb, gs, gv = got
    wb, ws, wv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w,size,overlap", [
    (1080, 1920, 640, 0.2), (960, 960, 640, 0.2), (256, 384, 128, 0.25),
    (400, 500, 640, 0.2), (720, 1280, 640, 0.2), (640, 640, 640, 0.2),
    (1080, 1920, 320, 0.5), (100, 150, 100, 0.2)])
def test_slice_grid_matches_jax(h, w, size, overlap):
    got = sahi.slice_grid(h, w, size, overlap)
    assert got == jax_sahi.slice_grid(h, w, size, overlap)
    assert all(0 <= y <= h - min(size, h) and 0 <= x <= w - min(size, w)
               for y, x in got)


def test_puck_path_shapes_at_1080p():
    """The card's shapes: 8 tiles of 640 per 1080p frame, so the tile NMS
    runs at B = 8 x 8 and the merge at K = min(64, 8 x 8)."""
    grid = sahi.slice_grid(1080, 1920, 640, 0.2)
    assert sorted({y for y, _ in grid}) == [0, 440]
    assert sorted({x for _, x in grid}) == [0, 512, 1024, 1280]
    assert len(sahi.slice_grid(960, 960, 640, 0.2)) == 4


def test_tile_step_matches_jax(frames, jax_sliced, sliced):
    """Tiles cut on the device equal the JAX slices; the per-tile
    detections (forward, per-tile NMS with containment) match."""
    want_tiles = np.asarray(jax.vmap(jax_sliced._slice_fn)(jnp.asarray(frames)))
    tiles = sliced.tiles(torch.from_numpy(frames))
    np.testing.assert_array_equal(
        tiles.numpy(), want_tiles.reshape(tiles.shape))
    want = jax_sliced.detector.detect_batch(want_tiles.reshape(tiles.shape))
    with torch.inference_mode():
        det = sliced.detector.core(sliced.detector.model, tiles)
    _close((det.boxes.numpy(), det.scores.numpy(), det.valid.numpy()),
           (want.boxes, want.scores, want.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(want.classes))
    assert det.valid.any(1).sum() >= 8  # discs found in most tiles


def test_detect_frames_matches_jax(frames, jax_merged, sliced):
    suppress.launches = 0
    got = sliced.detect_frames(frames)
    _close(got, jax_merged)
    assert got[0].shape == (N_FRAMES, 4, 4)
    # the seam disc gives one merged box, not two: three discs, three boxes
    assert (got[2].sum(1) == 3).all()
    assert suppress.launches == 0  # CPU tensors take the plain suppression


def test_merge_candidates_offsets_and_invalid_slots(frames, sliced):
    """Invalid tile slots enter the merge at score -1 and class -1 (so
    class-aware NMS moves their boxes by -1e4); valid slots carry their
    tile's offset."""
    with torch.inference_mode():
        det = sliced.detector.core(sliced.detector.model,
                                   sliced.tiles(torch.from_numpy(frames)))
        c = sliced.merge_candidates(det)
    t = len(sliced.grid)
    assert c.boxes.shape == (N_FRAMES, min(64, t * 8), 4)
    assert ((c.scores == -1) == (c.classes == -1)).all()
    assert (c.keep0 == (c.scores > 0.25)).all()
    off = sliced.offsets.repeat_interleave(8, 0)  # (T * d, 4)
    shifted = det.boxes.reshape(N_FRAMES, -1, 4) + off
    for f in range(N_FRAMES):
        for box in c.boxes[f][c.keep0[f]]:
            assert (shifted[f] == box).all(-1).any()


def test_detect_single_frame_matches(frames, jax_sliced, sliced, jax_merged):
    for i in range(2):
        b, s = sliced.detect(frames[i])
        jb, js = jax_sliced.detect(frames[i])
        np.testing.assert_allclose(b, jb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-4)
        v = jax_merged[2][i]
        np.testing.assert_allclose(b, jax_merged[0][i][v], rtol=0, atol=1e-3)


def test_tile_not_a_multiple_of_32_matches_jax():
    """A 100x150 frame shrinks the 640 tile to 100 px, which the rect
    letterbox pads to 128x128 (pad 14 px each side)."""
    cfg = dict(nms_pre_topk=32)
    fr = draw_frames(2, hw=(100, 150), seed=1)
    sd = sahi.SlicedDetector(Config(**cfg), (100, 150), device="cpu")
    assert sd.size == 100 and sd.detector.core.in_hw == (128, 128)
    assert sd.grid == [(0, 0), (0, 50)]
    _close(sd.detect_frames(fr),
           jax_sliced_f32(JaxConfig(**cfg), (100, 150)).detect_frames(fr))


def _detection_sequences(seed: int, n: int = 60):
    """Per-frame (boxes, scores) of a puck on a bouncing path with noise,
    misses, one-frame false fires and a far re-appearance."""
    rng = np.random.default_rng(seed)
    pos, vel = np.array([100.0, 200.0]), rng.uniform(-14, 14, 2)
    seq = []
    for t in range(n):
        pos = pos + vel
        if not 40 < pos[0] < 900:
            vel[0] = -vel[0]
        if t == 35:
            pos = pos + rng.uniform(-300, 300, 2)
        boxes, scores = [], []
        if rng.uniform() > 0.2 and not 20 <= t < 26:
            c = pos + rng.normal(0, 2.0, 2)
            boxes.append([c[0] - 6, c[1] - 4, c[0] + 6, c[1] + 4])
            scores.append(rng.uniform(0.3, 0.95))
        for _ in range(int(rng.integers(0, 3))):
            c = rng.uniform(0, 900, 2)
            boxes.append([c[0] - 5, c[1] - 5, c[0] + 5, c[1] + 5])
            scores.append(rng.uniform(0.25, 0.99))
        seq.append((np.asarray(boxes, np.float32).reshape(-1, 4),
                    np.asarray(scores, np.float32)))
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_puck_tracker_replay_matches_jax(seed):
    ours, ref = sahi.PuckTracker(), jax_sahi.PuckTracker()
    locked = 0
    for boxes, scores in _detection_sequences(seed):
        got, want = ours.ingest(boxes, scores), ref.ingest(boxes, scores)
        assert got == want
        locked += got[0] is not None
    assert list(ours.trail) == list(ref.trail) and locked > 10
    for center in [(5.0, 6.0), None, None, (400.0, 90.0)] + [None] * 20:
        assert ours.update(center) == ref.update(center)


def test_puck_tracker_on_detector_output(frames, sliced, jax_merged):
    """The tracker replayed on the same detection sequence (the merged
    boxes of the frames, twice over) gives the JAX tracker's positions."""
    boxes, scores, valid = sliced.detect_frames(frames)
    ours, ref = sahi.PuckTracker(), jax_sahi.PuckTracker()
    jb, js, jv = jax_merged
    for i in list(range(N_FRAMES)) * 2:
        got = ours.ingest(boxes[i][valid[i]], scores[i][valid[i]])
        want = ref.ingest(jb[i][jv[i]], js[i][jv[i]])
        assert got[1] == want[1]
        np.testing.assert_allclose(np.asarray(got[0] or [0, 0], np.float64),
                                   np.asarray(want[0] or [0, 0], np.float64),
                                   rtol=0, atol=1e-3)


def test_demote_in_player_boxes_matches_jax():
    rng = np.random.default_rng(4)
    pucks = rng.uniform(0, 300, (3, 4, 2))
    pucks = np.concatenate([pucks, pucks + 10], -1).astype(np.float32)
    scores = rng.uniform(0.2, 1.0, (3, 4)).astype(np.float32)
    players = rng.uniform(0, 250, (3, 5, 2))
    players = np.concatenate([players, players + [60, 200]], -1).astype(np.float32)
    valid = rng.uniform(size=(3, 5)) < 0.7
    valid[2] = False
    for band in (0.0, 0.2, 0.5):
        got = sahi.demote_in_player_boxes(pucks, scores, players, valid, 0.3, band)
        want = jax_sahi.demote_in_player_boxes(pucks, scores, players, valid,
                                               0.3, band)
        np.testing.assert_array_equal(got, want)
    assert (got != scores).any() and (got[2] == scores[2]).all()
    # the geometry of hockey_tpu tests/test_sahi_ocr.py: glove demoted,
    # skate band and outside kept
    box = lambda x, y: [x - 6, y - 4, x + 6, y + 4]  # noqa: E731
    p = np.asarray([[box(130, 180), box(130, 290), box(400, 180)]], np.float32)
    out = sahi.demote_in_player_boxes(
        p, np.asarray([[0.9, 0.8, 0.7]], np.float32),
        np.asarray([[[100, 100, 160, 300]]], np.float32), np.ones((1, 1), bool),
        factor=0.5, foot_band=0.2)
    np.testing.assert_allclose(out[0], [0.45, 0.8, 0.7])


def test_puck_pipeline_process_batch_matches_jax(frames, jax_sliced):
    jp = jax_sahi.PuckPipeline(JaxConfig(**KW), frame_hw=HW)
    jp.sliced = jax_sliced
    pp = sahi.PuckPipeline(Config(**KW), frame_hw=HW, device="cpu")
    assert pp.player_detector is None  # demotion off by default
    for _ in range(2):  # the tracker locks in the first batch, then follows
        got, want = pp.process_batch(frames, n=3), jp.process_batch(frames, n=3)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(pp.last_center, jp.last_center, atol=1e-3)
    assert pp.last_detection is not None
    assert (got[-1] != frames[2]).any()  # box and trail drawn


def _write_clip(path, frames):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        (frames.shape[2], frames.shape[1]))
    for f in frames:
        w.write(f)
    w.release()
    cap, out = cv2.VideoCapture(path), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return np.stack(out)


def test_video_processor_puck_matches_jax(tmp_path, jax_sliced):
    """One decoded clip through both VideoProcessors in PUCK_DETECTION at
    frame batch 4 (two batches, the second padded): the annotated frames
    and the tracker's positions; `puck_frames` gives the same positions
    without drawing."""
    clip = str(tmp_path / "clip.mp4")
    decoded = _write_clip(clip, draw_frames(7, seed=2))
    jvp = JaxVideoProcessor(config=JaxConfig(**KW, frame_batch=4),
                            mode=JaxMode.PUCK_DETECTION, frame_hw=HW)
    jvp.puck_pipeline.sliced = jax_sliced
    want, want_c = [], []
    for out in jvp.process_video(clip):
        want.append(out)
        want_c.append(jvp.puck_pipeline.last_center)
    vp = VideoProcessor(Config(**KW, frame_batch=4), device="cpu",
                        mode=ProcessingMode.PUCK_DETECTION, frame_hw=HW)
    assert vp.player_detector is None and vp.puck_pipeline is not None
    got = list(vp.process_video(clip))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    vp2 = VideoProcessor(Config(**KW, frame_batch=4), device="cpu",
                         mode=ProcessingMode.PUCK_DETECTION, frame_hw=HW)
    res = list(vp2.puck_frames(iter(decoded)))
    assert len(res) == 7 and sum(r.center is not None for r in res) >= 4
    for r, c in zip(res, want_c):
        np.testing.assert_allclose(np.asarray(r.center or [0, 0], np.float64),
                                   np.asarray(c or [0, 0], np.float64),
                                   rtol=0, atol=1e-3)
        assert r.boxes.shape == (len(r.scores), 4) and len(r.scores) <= 4
    with pytest.raises(ValueError, match="PLAYER_TRACKING"):
        next(vp2.track_frames(iter(decoded)))


def test_cli_puck_writes_video(tmp_path):
    from hockey_tpu_torch.cli.main import main

    src, dst = str(tmp_path / "clip.mp4"), str(tmp_path / "out.mp4")
    _write_clip(src, draw_frames(4, seed=3))
    assert main(["--source_path", src, "--target_path", dst, "--mode",
                 "PUCK_DETECTION", "--device", "cpu", "--frame-batch", "2",
                 "--limit-frames", "3", "--headless"]) == 0
    cap = cv2.VideoCapture(dst)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()


def test_puck_entry_points_default_to_cuda():
    from hockey_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(["--source_path", "x.mp4", "--mode",
                                      "PUCK_DETECTION", "--puck-checkpoint",
                                      "p.msgpack"])
    assert args.device == "cuda" and args.puck_checkpoint == "p.msgpack"
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            VideoProcessor(mode=ProcessingMode.PUCK_DETECTION)
