"""The TEAM_CLASSIFICATION slice of the port as a whole, on the CPU.

- The fused detect + track step with team features against the JAX
  `build_detect_track_fn(..., with_team_features=True)` in f32 with the
  shipped YOLOv8x player weights at imgsz 256 (unfused on both sides),
  three batches with the track state carried: ids and classes equal,
  boxes within 1e-3 px, scores within 1e-4 (test_torch_track_pipeline.py's
  tolerances), and the team columns 7-10 with dominant_hue equal,
  white_ratio within 0.01 and saturation and brightness within 0.05 (the
  crops come from boxes that differ by up to 1e-3 px, and LAB values at
  a .5 boundary can flip by 1; see test_torch_teams.py).
- VideoProcessor in TEAM_CLASSIFICATION against the JAX VideoProcessor on
  the same decoded clip, frame-sequential (frame batch 1) and batched with
  the host ByteTrack (frame batch 4): tracker ids and team ids equal per
  frame, team ids up to a global swap only where the fitted clusters'
  white ratios tie.
- The step's constants are built once per shape, device and dtype.
- The CLI in TEAM_CLASSIFICATION with --headless and --team-names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.core.config import Config as JaxConfig
from hockey_tpu.core.config import ProcessingMode as JaxMode
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.models.detector import Detector as JaxDetector
from hockey_tpu.models.detector import build_detect_fn, build_detect_track_fn
from hockey_tpu.models.yolov8 import MODEL_ZOO as JAX_ZOO
from hockey_tpu.pipeline import VideoProcessor as JaxVideoProcessor
from hockey_tpu.tracking.device_tracker import init_state as jax_init_state
from hockey_tpu.train.scenes import render_scene_sequence
from hockey_tpu_torch.core.config import Config, ProcessingMode
from hockey_tpu_torch.core.device import CONSTANTS
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.models.detector import BYTE_FLOOR, Detector
from hockey_tpu_torch.ops.letterbox import _resize_matrix, letterbox_rect_batch
from hockey_tpu_torch.pipeline import VideoProcessor, unpack_tracked
from hockey_tpu_torch.tracking.device_tracker import init_state

PLAYER = "hockey-player-detection"
HW, IMGSZ, BATCH, N_BATCHES = (320, 320), 256, 4, 3


@pytest.fixture(scope="module")
def clip():
    frames, _ = render_scene_sequence(np.random.default_rng(3), HW[0],
                                      n_frames=BATCH * N_BATCHES)
    return np.stack(frames)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(jnp.asarray, jax_load_params(
        shipped_weights_path(PLAYER)))


@pytest.fixture(scope="module")
def detector():
    return Detector(PLAYER, Config(), frame_hw=HW, imgsz=IMGSZ, fuse=False,
                    device="cpu", dtype=torch.float32, with_team_features=True)


def _check_team_columns(got, ref):
    np.testing.assert_array_equal(got[..., 8], ref[..., 8])            # hue
    np.testing.assert_allclose(got[..., 7], ref[..., 7], rtol=0, atol=0.01)
    np.testing.assert_allclose(got[..., 9:], ref[..., 9:], rtol=0, atol=0.05)


def test_fused_team_step_matches_jax(clip, detector, jax_params):
    cfg = Config()
    fn = build_detect_track_fn(
        JAX_ZOO[PLAYER], tracker_kwargs=detector.tracker_kwargs(), imgsz=IMGSZ,
        frame_hw=HW, conf=min(cfg.detection_confidence, BYTE_FLOOR),
        iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
        pre_topk=cfg.nms_pre_topk, max_det=cfg.max_detections,
        dtype=jnp.float32, with_team_features=True)
    jstate, state = jax_init_state(cfg.max_tracks), init_state(cfg.max_tracks, "cpu")
    for b in range(N_BATCHES):
        frames = clip[BATCH * b:BATCH * (b + 1)]
        want = jax.tree_util.tree_map(np.asarray, fn(jax_params, jnp.asarray(frames),
                                                     jstate))
        jstate = want[-1]
        out = detector.detect_track_batch(frames, state)
        det, feats, tids, packed, state = out
        assert packed.shape == (BATCH, 64, 11) and feats.shape == (BATCH, 64, 4)
        np.testing.assert_array_equal(tids.numpy(), want[2])
        got, ref = packed.numpy(), want[3]
        assert ref.shape == got.shape
        np.testing.assert_array_equal(got[..., 5:7], ref[..., 5:7])
        np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=1e-4)
        _check_team_columns(got, ref)
        np.testing.assert_array_equal(got[..., 7:], feats.numpy())
        rows = unpack_tracked(out)
        for i, r in enumerate(rows):
            keep = want[2][i] >= 0
            assert r[4].shape == (int(keep.sum()), 4)
            np.testing.assert_array_equal(r[3], want[2][i][keep])
    assert (want[2] >= 0).sum() >= 10  # players really were tracked
    assert (got[..., 7][got[..., 6] >= 0] != 0.5).any()  # real features


def test_step_constants_built_once(clip, detector):
    """The detect step and the fused step build their constants (the
    letterbox and the ds = 4 resize matrices, the anchor points and
    strides) once per shape, device and dtype, and no new one after; the
    outputs do not change, and the memoised letterbox matrices give what
    fresh ones give."""
    frames = torch.from_numpy(clip[:BATCH])
    first = detector.detect_batch(frames)
    cpu32 = (torch.device("cpu"), torch.float32)
    assert {("resize", 320, 256), ("resize_t", 320, 256), ("resize", 320, 80),
            ("resize_t", 320, 80), ("anchor_points", (256, 256)),
            ("anchor_strides", (256, 256))} <= {
                k for k, *dd in CONSTANTS if tuple(dd) == cpu32}
    built = dict(CONSTANTS)

    def unchanged():
        return (CONSTANTS.keys() == built.keys()
                and all(CONSTANTS[k] is t for k, t in built.items()))

    again = detector.detect_batch(frames)
    assert unchanged()
    for a, b in zip(first[0], again[0]):
        assert torch.equal(a, b)
    assert torch.equal(first[1], again[1])
    state = init_state(Config().max_tracks, "cpu")
    for _ in range(2):
        out = detector.detect_track_batch(frames, state)
        assert unchanged()
    x = frames.float()
    ah = torch.from_numpy(_resize_matrix(320, 256))
    aw = torch.from_numpy(_resize_matrix(320, 256).T.copy())
    fresh = torch.einsum("brwc,wk->brkc", torch.einsum("rh,bhwc->brwc", ah, x),
                         aw) * (1.0 / 255.0)
    lb = letterbox_rect_batch(frames, IMGSZ, 32, torch.float32)
    assert torch.equal(lb, fresh)  # 320 -> 256 square, no padding
    assert unchanged()
    assert out[3].shape == (BATCH, 64, 11)


@pytest.fixture(scope="module")
def decoded_clip(tmp_path_factory, clip):
    """The clip through mp4v and back, as both pipelines read it: (path,
    decoded frames)."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("teams") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, HW[::-1])
    for f in clip:
        w.write(f)
    w.release()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return path, np.stack(frames)


def _jax_processor(jax_params, frame_batch):
    cfg = JaxConfig(frame_batch=frame_batch, detection_imgsz=IMGSZ)
    jd = JaxDetector(PLAYER, cfg, frame_hw=HW, params=jax_params, imgsz=IMGSZ,
                     fuse=False, with_team_features=True)
    jd._fn = build_detect_fn(    # the same step in f32, as the port's CPU run
        JAX_ZOO[PLAYER], imgsz=IMGSZ, frame_hw=HW, conf=jd.conf,
        iou=cfg.nms_iou_threshold, containment=cfg.nms_containment_threshold,
        pre_topk=cfg.nms_pre_topk, max_det=jd.max_det, dtype=jnp.float32,
        with_team_features=True)
    return JaxVideoProcessor(config=cfg, mode=JaxMode.TEAM_CLASSIFICATION,
                             frame_hw=HW, player_detector=jd,
                             team_names=("TOR", "DET"))


@pytest.mark.parametrize("frame_batch", [1, 4])
def test_video_processor_teams_match_jax(decoded_clip, detector, jax_params,
                                         frame_batch):
    path, frames = decoded_clip
    ref = _jax_processor(jax_params, frame_batch)
    ref.initialize_team_classifier(path)
    want = []
    for _ in ref.process_video(path, skip_init=True):
        want.append(ref.last_frame_result)
    assert not ref.use_fused_tracker

    cfg = Config(frame_batch=frame_batch, detection_imgsz=IMGSZ)
    vp = VideoProcessor(cfg, device="cpu", frame_hw=HW, player_detector=detector,
                        team_names=("TOR", "DET"))
    assert vp.mode == ProcessingMode.TEAM_CLASSIFICATION  # the default
    assert not vp.use_fused_tracker
    assert vp.fit_teams(iter(frames)) > 0
    assert vp.team_classifier.get_team_name(1) == "DET"
    got = list(vp.classify_frames(iter(frames)))
    assert len(got) == len(want) == len(frames)

    colors = ref.team_classifier._impl.team_colors
    tie = colors is not None and colors[0]["is_white"] == colors[1]["is_white"]
    swapped = None
    n_players = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tracker_ids"], w["tracker_ids"])
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        players = g["classes"] == 0
        n_players += int(players.sum())
        gt, wt = g["team_ids"][players], w["team_ids"][players]
        if tie and swapped is None and len(gt):
            swapped = not np.array_equal(gt, wt)
        np.testing.assert_array_equal(1 - gt if swapped else gt, wt)
        np.testing.assert_array_equal(g["team_ids"][~players], w["team_ids"][~players])
    assert n_players >= 20
    teams = np.concatenate([g["team_ids"][g["classes"] == 0] for g in got])
    assert set(teams.tolist()) == {0, 1}  # both teams were seen

    # the annotated frame draws the same rows
    out = vp.process_frame(frames[-1], vp._filter(detector.detect(frames[-1])))
    assert out.shape == frames[-1].shape and out.dtype == np.uint8
    assert vp.last_frame_result["team_ids"].dtype == np.int32


def test_fused_route_on_cpu_when_asked(clip, detector):
    """use_device_tracker=True: the fused route even on the CPU; its rows'
    features drive the classifier and classify_frames matches the step."""
    cfg = Config(frame_batch=BATCH, use_device_tracker=True)
    vp = VideoProcessor(cfg, device="cpu", frame_hw=HW, player_detector=detector)
    assert vp.use_fused_tracker
    got = list(vp.classify_frames(iter(clip[:BATCH])))
    rows = unpack_tracked(vp.last_track_batch)
    for g, r in zip(got, rows):
        order = np.concatenate([np.flatnonzero(r[2] == 0), np.flatnonzero(r[2] == 1)])
        np.testing.assert_array_equal(g["tracker_ids"], r[3][order])
        unfitted = np.where(r[4][r[2] == 0, 0] > 0.4, 0, 1)
        np.testing.assert_array_equal(g["team_ids"][g["classes"] == 0], unfitted)
    with pytest.raises(ValueError, match="TEAM_CLASSIFICATION"):
        next(VideoProcessor(cfg, device="cpu", frame_hw=HW, player_detector=detector,
                            mode=ProcessingMode.PLAYER_TRACKING).classify_frames(clip))


def test_cli_team_classification(tmp_path, decoded_clip, capsys):
    cv2 = pytest.importorskip("cv2")
    from hockey_tpu_torch.cli.main import build_parser, main

    assert build_parser().parse_args(["--source_path", "x"]).mode == \
        "TEAM_CLASSIFICATION"
    src, dst = decoded_clip[0], str(tmp_path / "out.mp4")
    assert main(["--source_path", src, "--target_path", dst, "--mode",
                 "TEAM_CLASSIFICATION", "--device", "cpu", "--imgsz", "256",
                 "--frame-batch", "2", "--limit-frames", "5", "--headless",
                 "--team-names", "TOR, DET"]) == 0
    assert "Teams set: TOR vs DET" in capsys.readouterr().out
    cap = cv2.VideoCapture(dst)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()
