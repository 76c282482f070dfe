"""The PLAYER_TRACKING slice of the port as a whole, on the CPU.

The fused detect + track step against the JAX `build_detect_track_fn` in
f32 with the shipped YOLOv8x player weights at imgsz 256 (unfused f32 on
both sides), over a rendered moving clip in three batches with the track
state carried between batches: track ids and classes equal, boxes within
1e-3 px and scores within 1e-4 (f32 convolutions in two libraries, as in
test_torch_detector.py). Then VideoProcessor in PLAYER_TRACKING on the
CPU (host ByteTrack by default, the fused step when asked for) and the
CLI on a tiny clip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.models.detector import build_detect_track_fn
from hockey_tpu.models.yolov8 import MODEL_ZOO as JAX_ZOO
from hockey_tpu.pipeline import unpack_tracked as jax_unpack_tracked
from hockey_tpu.tracking.device_tracker import init_state as jax_init_state
from hockey_tpu.train.scenes import render_scene_sequence
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.models.detector import BYTE_FLOOR, Detector
from hockey_tpu_torch.ops.nms_kernel import suppress
from hockey_tpu_torch.pipeline import VideoProcessor
from hockey_tpu_torch.tracking.bytetrack import ByteTrack
from hockey_tpu_torch.tracking.device_tracker import (
    DeviceByteTrack,
    init_state,
    track_state_to_numpy,
)

PLAYER = "hockey-player-detection"
HW, IMGSZ, BATCH, N_BATCHES = (320, 320), 256, 4, 3


@pytest.fixture(scope="module")
def clip():
    frames, _ = render_scene_sequence(np.random.default_rng(3), HW[0],
                                      n_frames=BATCH * N_BATCHES)
    return np.stack(frames)


@pytest.fixture(scope="module")
def detector():
    return Detector(PLAYER, Config(), frame_hw=HW, imgsz=IMGSZ, fuse=False,
                    device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_run(clip, detector):
    """The JAX fused step over the clip, batch by batch: [output]."""
    cfg = Config()
    params = jax.tree_util.tree_map(jnp.asarray, jax_load_params(
        shipped_weights_path(PLAYER)))
    fn = build_detect_track_fn(
        JAX_ZOO[PLAYER], tracker_kwargs=detector.tracker_kwargs(), imgsz=IMGSZ,
        frame_hw=HW, conf=min(cfg.detection_confidence, BYTE_FLOOR),
        iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
        pre_topk=cfg.nms_pre_topk, max_det=cfg.max_detections,
        dtype=jnp.float32)
    state, outs = jax_init_state(cfg.max_tracks), []
    for b in range(N_BATCHES):
        out = fn(params, jnp.asarray(clip[BATCH * b:BATCH * (b + 1)]), state)
        state = out[-1]
        outs.append(jax.tree_util.tree_map(np.asarray, out))
    return outs


def test_fused_step_matches_jax(clip, detector, jax_run):
    state = init_state(Config().max_tracks, "cpu")
    suppress.launches = 0
    for b, want in enumerate(jax_run):
        det, feats, tids, packed, state = detector.detect_track_batch(
            clip[BATCH * b:BATCH * (b + 1)], state)
        assert feats is None and packed.shape == (BATCH, 64, 7)
        np.testing.assert_array_equal(tids.numpy(), want[2])
        got, ref = packed.numpy(), want[3]
        np.testing.assert_array_equal(got[..., 5:], ref[..., 5:])
        np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(det.valid.numpy(), want[0].valid)
    ours, ref = track_state_to_numpy(state), jax_run[-1][-1]
    for f in ("track_id", "active", "tracked", "activated", "next_id"):
        np.testing.assert_array_equal(ours[f], getattr(ref, f), err_msg=f)
    np.testing.assert_allclose(ours["mean"], ref.mean, rtol=1e-5, atol=1e-3)
    assert suppress.launches == 0  # CPU tensors take the plain suppression
    assert (jax_run[-1][2] >= 0).sum() >= 10  # players really were tracked


def test_fused_step_settings(detector):
    """NMS floored at BYTE_FLOOR; track initiation at max(activation,
    conf) (hockey_tpu test_nms_floor_and_initiation_threshold)."""
    cfg = Config()
    kw = detector.tracker_kwargs()
    assert kw["activation_thresh"] == max(cfg.track_activation_threshold,
                                          cfg.detection_confidence)
    assert kw["duplicate_kill_iomin"] == cfg.duplicate_kill_iomin
    assert kw["lost_dup_kill_iomin"] == cfg.lost_dup_kill_iomin
    assert detector._track_step.core.conf == BYTE_FLOOR


def _check_rows(rows):
    for boxes, scores, classes, tids in rows:
        assert boxes.shape == (len(tids), 4) and len(scores) == len(tids)
        assert (tids > 0).all() and len(set(tids.tolist())) == len(tids)
        assert np.isin(classes, (0, 1)).all()


def test_video_processor_fused_on_cpu_matches_jax(clip, detector, jax_run):
    """use_device_tracker=True with a frame batch above 1: the fused path,
    even on the CPU; its rows equal the JAX pipeline's `unpack_tracked`."""
    cfg = Config(frame_batch=BATCH, use_device_tracker=True)
    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=HW, player_detector=detector)
    assert vp.use_fused_tracker and isinstance(vp.tracker, DeviceByteTrack)
    rows = list(vp.track_frames(iter(clip)))
    want = [r for out in jax_run for r in jax_unpack_tracked(out)]
    assert len(rows) == len(want) == len(clip)
    for got, ref in zip(rows, want):
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3)
    _check_rows(rows)
    out = vp.process_frame(clip[-1], pretracked=rows[-1])
    assert out.shape == clip[-1].shape and out.dtype == np.uint8
    np.testing.assert_array_equal(vp.last_frame_result["tracker_ids"], rows[-1][3])


def test_video_processor_host_tracker_on_cpu(clip, detector):
    """On the CPU by default: the host ByteTrack over the filtered
    detections, frame by frame, with the duplicate-kill knobs."""
    cfg = Config()
    vp = VideoProcessor(cfg, device="cpu", mode=ProcessingMode.PLAYER_TRACKING,
                        frame_hw=HW, player_detector=detector)
    assert not vp.use_fused_tracker and isinstance(vp.tracker, ByteTrack)
    assert vp.tracker.dup_kill_iomin == cfg.duplicate_kill_iomin
    rows = list(vp.track_frames(iter(clip[:6])))
    ref_vp = VideoProcessor(cfg, device="cpu", frame_hw=HW,
                            player_detector=vp.player_detector)
    ref = ByteTrack.from_config(cfg)
    for got, d in zip(rows, ref_vp.detect_frames(iter(clip[:6]))):
        for g, w in zip(got, ref.update(d.boxes, d.scores, d.classes)):
            np.testing.assert_array_equal(g, w)
    _check_rows(rows)
    assert sum(len(r[3]) for r in rows) >= 5
    labels = []
    vp.label_annotator.annotate = lambda s, b, lab, c: labels.extend(lab) or s
    vp.process_frame(clip[6])  # detects and tracks the frame itself
    assert labels and all(x.startswith(("#", "Goalie #")) for x in labels)
    with pytest.raises(ValueError, match="PLAYER_TRACKING"):
        next(ref_vp.track_frames(iter(clip[:1])))


@pytest.mark.parametrize("style", ["box", "ellipse", "styled"])
def test_cli_tracking_writes_video(tmp_path, clip, style):
    cv2 = pytest.importorskip("cv2")
    from hockey_tpu_torch.cli.main import main

    src, dst = str(tmp_path / "clip.mp4"), str(tmp_path / "out.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 30, HW[::-1])
    for f in clip[:5]:
        w.write(f)
    w.release()
    assert main(["--source_path", src, "--target_path", dst, "--mode",
                 "PLAYER_TRACKING", "--device", "cpu", "--imgsz", "128",
                 "--conf", "0.3", "--annotator", style, "--frame-batch", "2",
                 "--limit-frames", "5", "--headless"]) == 0
    cap = cv2.VideoCapture(dst)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()


def test_tracking_entry_points_default_to_cuda():
    from hockey_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(["--source_path", "x.mp4", "--mode",
                                      "PLAYER_TRACKING"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            VideoProcessor(mode=ProcessingMode.PLAYER_TRACKING)
