"""The rink slice of the port against the JAX package on the CPU: the pose
head and `decode_keypoints`, the detect step's square letterbox and
keypoint branch, the dual step, the keypoint and map drawing, and the
VideoProcessor and CLI with rink keypoints and the 2D map.

Both sides run f32: the JAX programs are rebuilt at f32 on the unfused
f32 weights (the JAX detectors fold and cast them to bf16 even on the
CPU), the port runs its CPU default (BN folded in f32). Tolerances:
kept sets (valid masks) and classes equal; boxes within 1e-3 px and
scores within 1e-4, as test_torch_detector.py; keypoints within 1e-3 px
and their confidences within 1e-5 (f32 convolutions in two libraries;
measured 5e-4 px); team features as test_torch_team_pipeline.py
(dominant_hue equal, white_ratio within 0.01, saturation and brightness
within 0.05); the stabilised homographies within 1e-3 ft of each other
(mean displacement over the frame's probe grid). Host code that both
sides share as numpy (keypoint lists, drawing) gives equal outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.core.config import Config as JaxConfig
from hockey_tpu.core.config import ProcessingMode as JaxMode
from hockey_tpu.homography import keypoints as jkp
from hockey_tpu.models import dual as jdual
from hockey_tpu.models import yolov8 as J
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.models.checkpoint import save_params as jax_save_params
from hockey_tpu.models.detector import _build_detect_core, build_detect_fn
from hockey_tpu.pipeline import VideoProcessor as JaxVideoProcessor
from hockey_tpu.rinkmap import renderer as jren
from hockey_tpu.train.scenes import render_scene_sequence
from hockey_tpu_torch.cli.main import build_parser, main
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.homography import keypoints as kp
from hockey_tpu_torch.homography.calibrator import CalibratorState
from hockey_tpu_torch.homography.stabilizer import homography_distance
from hockey_tpu_torch.models import yolov8 as P
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.models.detector import DetectCore, Detector
from hockey_tpu_torch.models.dual import DualDetector
from hockey_tpu_torch.ops.nms_kernel import suppress
from hockey_tpu_torch.pipeline import DUAL_MAX_BATCH, VideoProcessor
from hockey_tpu_torch.rinkmap import renderer as ren
from hockey_tpu_torch.tracking.bytetrack import ByteTrack
from hockey_tpu_torch.tracking.device_tracker import DeviceByteTrack

PLAYER, RINK = "hockey-player-detection", "hockey-detection"
S, IMGSZ, RINK_IMGSZ, N_FRAMES = 320, 256, 320, 6


def jax_tree(name):
    return jax.tree_util.tree_map(jnp.asarray,
                                  jax_load_params(shipped_weights_path(name)))


def f32_model(name, cfg=None):
    """The port's model of a shipped checkpoint in f32, BN unfolded."""
    cfg = cfg or P.MODEL_ZOO[name]
    return P.build_model(cfg, jax_load_params(shipped_weights_path(name)))


def assert_det_close(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)


def assert_kpts_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def rink_frames():
    """(n, 144, 256, 3) rendered broadcast frames of the rink camera
    family (span 0.82-0.95), 16:9 so the rect and square letterboxes
    differ."""
    frames, _ = render_scene_sequence(np.random.default_rng(3), 144, 2,
                                      span_range=(0.82, 0.95), width=256)
    return np.stack(frames)


# ---------------------------------------------------------------------------
# the pose head

def test_pose_head_random_init_matches_jax():
    cfg = J.YoloConfig("n", 1, num_keypoints=7)
    params = J.init_params(cfg, 0)
    model = P.build_model(P.YoloConfig("n", 1, num_keypoints=7),
                          jax.tree_util.tree_map(np.asarray, params))
    assert len(model.head["kpt"]) == 3  # head.kpt.{0,1,2} loaded strictly
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    want = J.forward_raw(params, jnp.asarray(x), cfg)
    with torch.no_grad():
        got = P.forward_raw(model, torch.from_numpy(x))
    for key in ("box", "cls", "kpt"):
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape  # NHWC
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    assert_kpts_close(P.decode_keypoints(got, model.cfg, (64, 96)),
                      J.decode_keypoints(want, cfg, (64, 96)))


def test_pose_head_shipped_matches_jax():
    """The shipped YOLOv8s-pose (56 keypoints) at 128x160: the keypoint
    maps flattened in NHWC order, so each anchor's row holds its own 56
    (x, y, conf) triples."""
    cfg = J.MODEL_ZOO[RINK]
    x = np.random.default_rng(1).uniform(0, 1, (2, 128, 160, 3)).astype(np.float32)
    want = J.forward_raw(jax_tree(RINK), jnp.asarray(x), cfg)
    with torch.no_grad():
        got = P.forward_raw(f32_model(RINK), torch.from_numpy(x))
        kpts = P.decode_keypoints(got, P.MODEL_ZOO[RINK], (128, 160))
        boxes, scores = P.decode_boxes(got, P.MODEL_ZOO[RINK], (128, 160))
    assert kpts.shape == (2, 16 * 20 + 8 * 10 + 4 * 5, 56, 3)
    assert_kpts_close(kpts, J.decode_keypoints(want, cfg, (128, 160)))
    jb, js = J.decode_boxes(want, cfg, (128, 160))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=0, atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0, atol=1e-4)


@pytest.mark.parametrize("rect", [True, False])
def test_detect_core_keypoints_matches_jax(rink_frames, rect):
    """DetectCore(with_keypoints) on the rect and the square letterbox:
    NMS'd boxes and the best anchor's keypoints un-mapped by that
    route's geometry."""
    cfg = Config()
    kw = dict(imgsz=256, frame_hw=rink_frames.shape[1:3], conf=0.25,
              iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
              pre_topk=64, max_det=8)
    want_det, want_k = jax.jit(_build_detect_core(
        J.MODEL_ZOO[RINK], **kw, with_keypoints=True, rect=rect,
        dtype=jnp.float32))(jax_tree(RINK), jnp.asarray(rink_frames))
    core = DetectCore(P.MODEL_ZOO[RINK], **kw, dtype=torch.float32,
                      with_keypoints=True, rect=rect)
    assert core.in_hw == ((160, 256) if rect else (256, 256))
    with torch.inference_mode():
        det, kpts = core(f32_model(RINK), torch.from_numpy(rink_frames))
    assert_det_close(det, want_det)
    assert kpts.shape == (2, 56, 3)
    assert_kpts_close(kpts, want_k)
    assert (kpts[..., 2] >= 0.3).sum() >= 20  # the rink is read


def test_pose_detector_builds_and_returns_keypoints(rink_frames):
    det = Detector(RINK, device="cpu", frame_hw=rink_frames.shape[1:3], imgsz=256)
    assert det.core.with_keypoints and det.cfg.num_keypoints == 56
    out, kpts = det.detect_batch(rink_frames)
    assert kpts.shape == (2, 56, 3) and out.boxes.shape == (2, 64, 4)
    assert det.detect(rink_frames[0]).boxes.shape[1] == 4


# ---------------------------------------------------------------------------
# the dual step

@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    """Random-init n-scale player (2 classes) and pose (56 keypoints)
    checkpoints, as tests/test_pipeline.py::TestDualMegastep sizes them."""
    d = tmp_path_factory.mktemp("tiny")
    pc = J.YoloConfig("n", num_classes=2)
    rc = J.YoloConfig("n", num_classes=1, num_keypoints=56)
    pp, rp = J.init_params(pc, 0), J.init_params(rc, 1)
    jax_save_params(str(d / "p.msgpack"), pp)
    jax_save_params(str(d / "r.msgpack"), rp)
    return pc, rc, pp, rp, str(d / "p.msgpack"), str(d / "r.msgpack")


@pytest.mark.parametrize("teams", [True, False])
def test_dual_detector_matches_jax(tiny_checkpoints, monkeypatch, teams):
    """DualDetector against build_dual_fn(dtype=f32) on 2 frames of 48x96:
    random-init scores sit near the class prior, so conf 0.002 keeps a few
    dozen candidates for NMS."""
    pc, rc, pp, rp, p_path, r_path = tiny_checkpoints
    monkeypatch.setitem(P.MODEL_ZOO, "tiny-player", P.YoloConfig("n", num_classes=2))
    monkeypatch.setitem(P.MODEL_ZOO, "tiny-rink",
                        P.YoloConfig("n", num_classes=1, num_keypoints=56))
    cfg = Config(player_model_name="tiny-player", hockey_model_name="tiny-rink",
                 detection_imgsz=96, rink_imgsz=64, nms_pre_topk=32,
                 max_detections=8, detection_confidence=0.002)
    frames = np.random.default_rng(0).integers(0, 255, (2, 48, 96, 3)).astype(np.uint8)
    fn = jdual.build_dual_fn(
        pc, rc, imgsz=96, frame_hw=(48, 96), conf=0.002,
        iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
        pre_topk=32, max_det=8, with_team_features=teams, rink_imgsz=64,
        dtype=jnp.float32)
    want_det, want_f, want_k = fn(pp, rp, jnp.asarray(frames))
    d = DualDetector(cfg, frame_hw=(48, 96), checkpoint=p_path,
                     rink_checkpoint=r_path, with_team_features=teams,
                     device="cpu")
    suppress.launches = 0
    out = d.detect_batch(frames)
    assert suppress.launches == 0  # CPU tensors take the plain suppression
    det = out[0] if teams else out
    assert_det_close(det, want_det)
    assert 4 <= int(det.valid.sum()) < 16  # some kept, some suppressed
    assert d.last_keypoints.shape == (2, 56, 3)
    assert_kpts_close(d.last_keypoints, want_k)
    if teams:
        got, ref = out[1].numpy(), np.asarray(want_f)
        np.testing.assert_array_equal(got[..., 1], ref[..., 1])
        np.testing.assert_allclose(got[..., 0], ref[..., 0], rtol=0, atol=0.01)
        np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=0, atol=0.05)
    # the step on the device: one packed row per frame, D * 11 or D * 7
    # detection columns, then 56 * 3 keypoint values
    packed = d.run(frames)[3]
    assert packed.shape == (2, 8 * (11 if teams else 7) + 168)
    host = d.detect(frames[1])
    assert len(host) == int(det.valid[1].sum())


# ---------------------------------------------------------------------------
# keypoint lists and drawing

def test_keypoints_from_array_and_drawing_match_jax():
    rng = np.random.default_rng(4)
    arr = np.concatenate([rng.uniform(0, 300, (56, 2)),
                          rng.uniform(0, 1, (56, 1))], 1).astype(np.float32)
    frame = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
    for thr in (0.3, 0.5):
        ours, theirs = kp.keypoints_from_array(arr, thr), jkp.keypoints_from_array(arr, thr)
        assert [(k.id, k.name, k.position, k.confidence) for k in ours] == \
            [(k.id, k.name, k.position, k.confidence) for k in theirs]
        for labels in (True, False):
            np.testing.assert_array_equal(
                kp.RinkKeypointDetector.visualize_keypoints(frame, ours, 10, labels),
                jkp.RinkKeypointDetector.visualize_keypoints(frame, theirs, 10, labels))
    assert [kp.zone_of(i) for i in (0, 19, 20, 35, 36, 55, 56)] == \
        [jkp.zone_of(i) for i in (0, 19, 20, 35, 36, 55, 56)]
    assert kp.KEYPOINT_GROUPS == jkp.KEYPOINT_GROUPS


def test_rink_renderer_matches_jax():
    rng = np.random.default_rng(6)
    h = np.array([[0.3, 0.05, -20.0], [0.01, 0.4, -30.0], [1e-5, 4e-4, 1.0]])
    anchors = rng.uniform(50, 400, (12, 2))
    teams = rng.integers(0, 3, 12)
    boxes = np.concatenate([anchors - 20, anchors], 1)
    np.testing.assert_array_equal(ren.bottom_center_anchors(boxes),
                                  jren.bottom_center_anchors(boxes))
    ours, theirs = ren.RinkRenderer(), jren.RinkRenderer()
    for args in ((h, anchors, teams, (200.0, 150.0)), (None, anchors / 3, None, None),
                 (h, None, None, None)):
        got, want = ours.render(*args), theirs.render(*args)
        np.testing.assert_array_equal(got, want)
    frame = rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)
    for corner in ("bottom-right", "top-left"):
        np.testing.assert_array_equal(
            ours.overlay(frame.copy(), got, corner=corner),
            theirs.overlay(frame.copy(), want, corner=corner))


# ---------------------------------------------------------------------------
# the VideoProcessor and the CLI

def _write_clip(path, frames):
    import cv2

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


@pytest.fixture(scope="module")
def decoded_clip(tmp_path_factory):
    frames, _ = render_scene_sequence(np.random.default_rng(3), S, N_FRAMES,
                                      span_range=(0.82, 0.95))
    path = str(tmp_path_factory.mktemp("clip") / "rink.mp4")
    return path, _write_clip(path, np.stack(frames))


@pytest.fixture(scope="module")
def jax_run(decoded_clip):
    """The JAX VideoProcessor (PLAYER_TRACKING, 2D map, frame by frame)
    over the clip, its dual program at f32 on the unfused weights: per
    frame (drawn frame, keypoints (56, 3), last_frame_result,
    stabilizer.current)."""
    cfg = JaxConfig(detection_imgsz=IMGSZ, rink_imgsz=RINK_IMGSZ)
    vp = JaxVideoProcessor(config=cfg, mode=JaxMode.PLAYER_TRACKING,
                           frame_hw=(S, S), show_2d_map=True)
    d = vp.player_detector
    d.player_params, d.rink_params = jax_tree(PLAYER), jax_tree(RINK)
    d._fn = jdual.build_dual_fn(
        d.player_cfg, d.rink_cfg, imgsz=IMGSZ, frame_hw=(S, S),
        rink_imgsz=RINK_IMGSZ, conf=cfg.detection_confidence,
        iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
        pre_topk=cfg.nms_pre_topk, max_det=cfg.max_detections,
        with_team_features=False, dtype=jnp.float32)
    out = []
    for frame in vp.process_video(decoded_clip[0]):
        h = vp.calibrator.stabilizer.current
        out.append((frame, d.last_keypoints[0].copy(), dict(vp.last_frame_result),
                    None if h is None else h.copy()))
    return out


@pytest.mark.parametrize("frame_batch", [1, 4])
def test_video_processor_2d_map_matches_jax(decoded_clip, jax_run, frame_batch):
    """PLAYER_TRACKING with the 2D map on one decoded clip: the numeric
    route (`track_frames`) and the drawing route (`process_video`), frame
    by frame and in batches of 4 (the last one padded), against the JAX
    VideoProcessor frame by frame: keypoints, tracked rows, stabilised
    homography and (drawing) the annotated frame."""
    path, frames = decoded_clip
    want = jax_run
    cfg = Config(detection_imgsz=IMGSZ, rink_imgsz=RINK_IMGSZ,
                 frame_batch=frame_batch)
    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=(S, S), show_2d_map=True)
    assert vp.use_dual and isinstance(vp.player_detector, DualDetector)
    assert not vp.use_fused_tracker and isinstance(vp.tracker, ByteTrack)
    n_kpts = 0
    for i, row in enumerate(vp.track_frames(iter(frames))):
        _, k, res, h = want[i]
        got_k = vp.player_detector.last_keypoints[i % frame_batch]
        assert_kpts_close(got_k, k)
        np.testing.assert_array_equal(row[3], res["tracker_ids"])
        np.testing.assert_array_equal(row[2], res["classes"])
        np.testing.assert_allclose(row[0], res["boxes"], rtol=0, atol=1e-3)
        got_h = vp.calibrator.stabilizer.current
        assert (got_h is None) == (h is None)
        if h is not None:
            assert homography_distance(got_h, h, (S, S)) < 1e-3
        n_kpts += len(vp.last_keypoints)
    assert n_kpts >= 20 * N_FRAMES and h is not None
    assert sum(len(w[2]["tracker_ids"]) for w in want) >= 3 * N_FRAMES

    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=(S, S), show_2d_map=True)
    drawn = list(vp.process_video(path))
    assert len(drawn) == len(want) == N_FRAMES
    for g, (w, *_) in zip(drawn, want):
        # the keypoints, boxes and map markers are drawn at int()
        # truncations of coordinates that differ by < 1e-3 px: a marker
        # may shift by a pixel where one straddles an integer
        assert (g != w).any(axis=-1).mean() < 2e-3
    s = vp.timers.summary()
    assert s["counters"]["keypoints"] >= 20 * N_FRAMES
    assert "rink2d" in s and s["gauges"]["homography_tier"] in (1.0, 2.0)


def test_rink_detector_route_matches_jax(decoded_clip):
    """An injected player detector: the keypoints come from a separate
    RinkKeypointDetector (a rect pose Detector at rink_imgsz, NMS on its
    boxes), once per batch, equal to the JAX one's."""
    _, frames = decoded_clip
    frames = frames[:4]
    cfg = Config(detection_imgsz=IMGSZ, rink_imgsz=RINK_IMGSZ, frame_batch=2)
    player = Detector(PLAYER, cfg, frame_hw=(S, S), imgsz=128, device="cpu")
    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=(S, S), player_detector=player,
                        enable_rink_keypoints=True)
    assert not vp.use_dual and isinstance(vp.rink_detector, kp.RinkKeypointDetector)
    assert vp.calibrator is None  # keypoints only, no map
    rd = kp.RinkKeypointDetector(RINK, cfg, frame_hw=(S, S), device="cpu")
    assert rd.detector.core.rect and rd.detector.imgsz == RINK_IMGSZ
    rd.detector.model = f32_model(RINK)  # unfolded, as the JAX side below
    got = rd.detect_keypoints_batch(frames)

    jrd = jkp.RinkKeypointDetector(RINK, JaxConfig(rink_imgsz=RINK_IMGSZ),
                                   frame_hw=(S, S))
    jd = jrd.detector
    jd.params = jax_tree(RINK)
    jd._fn = build_detect_fn(
        jd.cfg, imgsz=RINK_IMGSZ, frame_hw=(S, S), conf=jd.conf,
        iou=jd.config.nms_iou_threshold,
        containment=jd.config.nms_containment_threshold,
        pre_topk=jd.config.nms_pre_topk, max_det=jd.max_det,
        with_keypoints=True, dtype=jnp.float32)
    assert_kpts_close(got, jrd.detect_keypoints_batch(frames))
    one = rd.detect_keypoints(frames[1], conf_threshold=0.3)
    assert [k.id for k in one] == [k.id for k in jrd.detect_keypoints(
        frames[1], conf_threshold=0.3)]
    n = sum(len(vp.last_keypoints) for _ in vp.track_frames(iter(frames)))
    assert n >= 20 * len(frames)


def test_rink_routes_and_settings(tmp_path):
    """The dual step has no fused tracker (host ByteTrack; DeviceByteTrack
    frame by frame when asked for); its batch is capped at 32; a saved
    calibration profile is loaded; PUCK_DETECTION ignores the rink."""
    cfg = Config(use_device_tracker=True, frame_batch=40, detection_imgsz=128)
    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.TEAM_CLASSIFICATION,
                        frame_hw=(S, S), enable_rink_keypoints=True)
    assert vp.use_dual and vp.player_detector.with_team_features
    assert isinstance(vp.tracker, DeviceByteTrack) and not vp.use_fused_tracker
    assert vp._batch() == DUAL_MAX_BATCH == 32 and vp.calibrator is None

    cal = CalibratorState(frame_hw=(S, S))
    cal.stabilizer.current = np.diag([0.5, 0.5, 1.0])
    cal.manual_points[4] = (10.0, 20.0)
    profile = str(tmp_path / "game.calibration.json")
    cal.save_profile(profile)
    vp = VideoProcessor(Config(detection_imgsz=128), device="cpu",
                        mode=ProcessingMode.PLAYER_DETECTION, frame_hw=(S, S),
                        show_2d_map=True, calibration_profile=profile,
                        rink_checkpoint=shipped_weights_path(RINK))
    assert vp.use_dual and not vp.player_detector.with_team_features
    np.testing.assert_array_equal(vp.calibrator.stabilizer.current,
                                  np.diag([0.5, 0.5, 1.0]))
    assert vp.calibrator.manual_points == {4: (10.0, 20.0)}
    vp = VideoProcessor(device="cpu", mode=ProcessingMode.PUCK_DETECTION,
                        show_2d_map=True)
    assert not vp.use_dual and vp.rink_detector is None
    assert vp.player_detector is None


def test_cli_rink_flags(tmp_path, decoded_clip):
    import cv2

    _, frames = decoded_clip
    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    _write_clip(src, frames[:4])
    args = build_parser().parse_args(["--source_path", src])
    assert not (args.rink_keypoints or args.show_2d_map)
    assert args.calibration is None and args.rink_checkpoint is None
    assert main(["--source_path", src, "--target_path", dst, "--mode",
                 "PLAYER_TRACKING", "--device", "cpu", "--imgsz", "128",
                 "--frame-batch", "2", "--limit-frames", "3", "--headless",
                 "--rink-keypoints", "--show-2d-map", "--rink-checkpoint",
                 shipped_weights_path(RINK)]) == 0
    cap = cv2.VideoCapture(dst)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()
