"""The PLAYER_DETECTION slice of the port as a whole, on the CPU.

The port's detect core against the JAX `_build_detect_core` in f32 with the
shipped YOLOv8x player weights (unfused f32 on both sides) on rendered
scenes: same kept detections and classes, boxes within 1e-3 px, scores
within 1e-4 (f32 convolutions in two libraries; measured ~2e-5 px and
~1e-6). Then VideoProcessor and the CLI on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.core.config import Config as JaxConfig
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.models.detector import _build_detect_core
from hockey_tpu.models.yolov8 import MODEL_ZOO as JAX_ZOO
from hockey_tpu.train.scenes import render_scene
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.models.detector import Detector, HostDetections
from hockey_tpu_torch.ops.nms_kernel import suppress_reference
from hockey_tpu_torch.pipeline import VideoProcessor

PLAYER = "hockey-player-detection"


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(11)
    return np.stack([render_scene(rng, 320)[0] for _ in range(3)])


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(jnp.asarray, jax_load_params(
        shipped_weights_path(PLAYER)))


@pytest.mark.parametrize("crop,imgsz", [((320, 320), 320), ((180, 320), 256)])
def test_detect_core_matches_jax(scenes, jax_params, crop, imgsz):
    frames = np.ascontiguousarray(scenes[:2, :crop[0], :crop[1]])
    cfg = Config()
    core = jax.jit(_build_detect_core(
        JAX_ZOO[PLAYER], imgsz=imgsz, frame_hw=crop, conf=cfg.detection_confidence,
        iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
        pre_topk=cfg.nms_pre_topk, max_det=cfg.max_detections, dtype=jnp.float32))
    want = jax.tree_util.tree_map(np.asarray, core(jax_params, jnp.asarray(frames)))
    det = Detector(PLAYER, cfg, frame_hw=crop, imgsz=imgsz, fuse=False,
                   device="cpu", dtype=torch.float32)
    got = det.detect_batch(frames)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0, atol=1e-4)
    assert want.valid.sum() >= 4  # the scenes really have players


def test_detect_core_halves_compose(scenes):
    """candidates -> plain suppression -> finish is the whole step (the
    check chip_smoke.py makes with the kernel on the card)."""
    det = Detector(PLAYER, Config(), frame_hw=(320, 320), imgsz=128,
                   device="cpu", dtype=torch.float32)
    whole = det.detect_batch(scenes)
    with torch.inference_mode():
        c = det.core.candidates(det.model, torch.from_numpy(scenes))
        halves = det.core.finish(c, suppress_reference(c.matrix, c.keep0, c.thr))
    for a, b in zip(whole, halves):
        assert torch.equal(a, b)
    assert int(whole.valid.sum()) >= 2


@pytest.fixture(scope="module")
def cpu_processor():
    cfg = Config(detection_imgsz=256)
    return VideoProcessor(cfg, device="cpu", frame_hw=(320, 320))


def test_video_processor_detect_frames(cpu_processor, scenes):
    vp = cpu_processor
    dets = list(vp.detect_frames(iter(scenes)))
    assert len(dets) == len(scenes)
    conf = vp.config.detection_confidence
    for frame, d in zip(scenes, dets):
        assert isinstance(d, HostDetections)
        single = vp.player_detector.detect(frame)
        keep = np.isin(single.classes, (0, 1)) & (single.scores > conf)
        np.testing.assert_array_equal(d.boxes, single.boxes[keep])
        np.testing.assert_array_equal(d.classes, single.classes[keep])
        assert (d.scores > conf).all() and np.isin(d.classes, (0, 1)).all()
        out = vp.process_frame(frame, d)
        assert out.shape == frame.shape and out.dtype == np.uint8
    assert sum(len(d) for d in dets) >= 4
    assert vp.timers.counters["detections"] >= sum(len(d) for d in dets)

    # a batched run gives the same detections (last batch padded)
    vp.config.frame_batch = 2
    try:
        batched = list(vp.detect_frames(iter(scenes)))
    finally:
        vp.config.frame_batch = 0
    for a, b in zip(dets, batched):
        np.testing.assert_allclose(a.boxes, b.boxes, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(a.classes, b.classes)


def test_cli_writes_video(tmp_path, scenes):
    cv2 = pytest.importorskip("cv2")
    from hockey_tpu_torch.cli.main import main

    src, dst = str(tmp_path / "clip.mp4"), str(tmp_path / "out.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 30, (320, 320))
    for f in list(scenes) + list(scenes[:2]):
        w.write(f)
    w.release()
    assert main(["--source_path", src, "--target_path", dst, "--mode",
                 "PLAYER_DETECTION", "--device", "cpu", "--imgsz", "128",
                 "--frame-batch", "2", "--limit-frames", "3", "--headless"]) == 0
    cap = cv2.VideoCapture(dst)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()


def test_entry_points_refuse_what_the_slice_lacks():
    if not torch.cuda.is_available():  # default device is CUDA: no fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            Detector(PLAYER)
        with pytest.raises(RuntimeError, match="CUDA"):
            VideoProcessor()
    # PUCK_DETECTION is ported: it builds the sliced YOLOv8s on the CPU
    # (8 tiles of 640 for 1080p) and no player detector
    vp = VideoProcessor(mode=ProcessingMode.PUCK_DETECTION, device="cpu")
    assert vp.player_detector is None
    assert len(vp.puck_pipeline.sliced.grid) == 8
    # the rink pose model is ported: its Detector returns keypoints too
    assert Detector("hockey-detection", device="cpu", imgsz=128).core.with_keypoints
    # TEAM_CLASSIFICATION and the fused team features are ported now
    det = Detector(PLAYER, device="cpu", imgsz=128, with_team_features=True)
    vp = VideoProcessor(mode=ProcessingMode.TEAM_CLASSIFICATION, device="cpu",
                        player_detector=det)
    assert vp.player_detector.with_team_features


def test_config_matches_jax_and_batch_rule():
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())
    cfg = Config()
    assert cfg.resolved_frame_batch("cuda") == 8
    assert cfg.resolved_frame_batch("cpu") == 1
    cfg.frame_batch = 3
    assert cfg.resolved_frame_batch("cuda") == cfg.resolved_frame_batch("cpu") == 3
