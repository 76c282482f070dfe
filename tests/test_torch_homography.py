"""The port's rink geometry and homography modules against the JAX
package on the CPU: rinkmap/dimensions.py, homography/ransac.py,
stabilizer.py, view.py and calibrator.py (with its motion probe), and the
cv2-free gray and resize of ops/gray.py against OpenCV.

These modules are numpy on both sides, and the port's are copies, so on
the same inputs their outputs are held equal (array_equal, ==), not
close: the homographies, qualities, tiers, stabiliser states, segment
reuse and statuses over a sequence with a camera cut, and the probe's
gray images bit for bit."""

import dataclasses
import os

import cv2
import numpy as np
import pytest

import hockey_tpu
from hockey_tpu.homography import calibrator as jcal
from hockey_tpu.homography import keypoints as jkp
from hockey_tpu.homography import ransac as jr
from hockey_tpu.homography import stabilizer as jst
from hockey_tpu.homography import view as jview
from hockey_tpu.rinkmap import dimensions as jdim
from hockey_tpu_torch.homography import calibrator as cal
from hockey_tpu_torch.homography import keypoints as kp
from hockey_tpu_torch.homography import ransac as r
from hockey_tpu_torch.homography import stabilizer as st
from hockey_tpu_torch.homography import view
from hockey_tpu_torch.ops.gray import bgr_to_gray, gray_resize
from hockey_tpu_torch.rinkmap import dimensions as dim

HW = (360, 640)


def camera(rng, hw=HW):
    """A random broadcast camera: rink (ft) -> image (px), as the scene
    generator draws them (a window of the rink onto a trapezoid)."""
    h, w = hw
    span = rng.uniform(0.5, 0.95) * 200
    cx = rng.uniform(span / 2, 200 - span / 2)
    src = np.array([[cx - span / 2, 0], [cx + span / 2, 0],
                    [cx - span / 2, 85], [cx + span / 2, 85]])
    ti, to = rng.uniform(0.04, 0.2) * w, rng.uniform(0, 0.25) * w
    dst = np.array([[ti, rng.uniform(0.02, 0.2) * h], [w - ti, 0.1 * h],
                    [-to, rng.uniform(0.9, 1.2) * h], [w + to, h]])
    return jr.dlt_homography(src, dst)


def keypoint_array(rng, h_rink_to_img, noise=1.5, outliers=4, drop=0.3):
    """(56, 3) keypoints of a camera: the table projected, with pixel
    noise, a few gross outliers and low-confidence drops."""
    xy = jr.project(h_rink_to_img, jdim.default_keypoint_positions())
    xy = xy + rng.normal(0, noise, xy.shape)
    bad = rng.choice(56, outliers, replace=False)
    xy[bad] += rng.uniform(-80, 80, (outliers, 2))
    conf = rng.uniform(0.55, 0.99, 56)
    conf[rng.uniform(size=56) < drop] = rng.uniform(0.0, 0.45)
    return np.concatenate([xy, conf[:, None]], 1).astype(np.float32)


def both_keypoints(arr, thr=0.5):
    return kp.keypoints_from_array(arr, thr), jkp.keypoints_from_array(arr, thr)


def assert_same_quality(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def assert_same_h(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# dimensions

def test_dimensions_match_jax(tmp_path):
    assert dataclasses.asdict(dim.NHL) == dataclasses.asdict(jdim.NHL)
    np.testing.assert_array_equal(dim.default_keypoint_positions(),
                                  jdim.default_keypoint_positions())
    assert dim.STABLE_KEYPOINT_IDS == jdim.STABLE_KEYPOINT_IDS
    # the JAX package's keypoints.json, and a user override merged over
    # the defaults
    shipped = os.path.join(os.path.dirname(hockey_tpu.__file__), "data",
                           "keypoints.json")
    np.testing.assert_array_equal(dim.load_keypoint_positions(shipped),
                                  jdim.load_keypoint_positions(shipped))
    np.testing.assert_array_equal(dim.load_keypoint_positions(shipped),
                                  dim.default_keypoint_positions())
    p = tmp_path / "kp.json"
    p.write_text('{"3": [1.5, 2.5], "40": [180, 40]}')
    got = dim.load_keypoint_positions(str(p))
    np.testing.assert_array_equal(got, jdim.load_keypoint_positions(str(p)))
    assert tuple(got[3]) == (1.5, 2.5)
    small = dim.RinkDimensions(length=180.0, width=80.0)
    np.testing.assert_array_equal(
        dim.default_keypoint_positions(small),
        jdim.default_keypoint_positions(jdim.RinkDimensions(180.0, 80.0)))


# ---------------------------------------------------------------------------
# ransac

@pytest.mark.parametrize("seed", range(6))
def test_dlt_project_and_ransac_match_jax(seed):
    rng = np.random.default_rng(seed)
    h_cam = camera(rng)
    arr = keypoint_array(rng, h_cam)
    src = arr[:, :2].astype(np.float64)
    dst = jdim.default_keypoint_positions().astype(np.float64)
    assert_same_h(r.dlt_homography(src[:9], dst[:9]),
                  jr.dlt_homography(src[:9], dst[:9]))
    assert r.dlt_homography(src[:3], dst[:3]) is None
    np.testing.assert_array_equal(r.project(h_cam, dst), jr.project(h_cam, dst))
    idx = rng.integers(0, 56, (50, 4))
    got = r._batched_dlt4(src[idx], dst[idx])
    want = jr._batched_dlt4(src[idx], dst[idx])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    for thr in (3.0, 12.0):
        h, q = r.ransac_homography(src, dst, threshold=thr, seed=seed)
        jh, jq = jr.ransac_homography(src, dst, threshold=thr, seed=seed)
        assert_same_h(h, jh)
        assert_same_quality(q, jq)
    got = r.fit_homography_tiered(src, dst, seed=seed)
    want = jr.fit_homography_tiered(src, dst, seed=seed)
    assert_same_h(got[0], want[0])
    assert_same_quality(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("noise,tier", [(0.3, "fine"), (30.0, "coarse"),
                                         (150.0, None)])
def test_tiers_and_homography_from_keypoints_match_jax(noise, tier):
    """Small pixel noise fits the fine tier, more the coarse one, much
    more neither; degenerate (collinear) samples give None on both
    sides."""
    rng = np.random.default_rng(11)
    h_cam = camera(rng)
    arr = keypoint_array(rng, h_cam, noise=noise, outliers=0, drop=0.0)
    src = arr[:, :2].astype(np.float64)
    dst = jdim.default_keypoint_positions().astype(np.float64)
    got = r.fit_homography_tiered(src, dst)
    want = jr.fit_homography_tiered(src, dst)
    assert got[2] == want[2] == tier
    assert_same_h(got[0], want[0])
    ours, theirs = both_keypoints(arr)
    assert_same_h(r.homography_from_keypoints(ours),
                  jr.homography_from_keypoints(theirs))
    assert_same_h(r.homography_from_keypoints(ours, validate=False,
                                              stable_only=False),
                  jr.homography_from_keypoints(theirs, validate=False,
                                               stable_only=False))
    line = np.stack([np.linspace(0, 100, 8), np.zeros(8)], 1)
    assert r.ransac_homography(line, line)[0] is None
    assert jr.ransac_homography(line, line)[0] is None


# ---------------------------------------------------------------------------
# stabilizer and view

def _homography_sequence(rng):
    """(image->rink H or None, tier) per frame: a steady camera with
    jitter and gaps, coarse fits, a cut that persists, a one-frame jump."""
    a = np.linalg.inv(camera(rng))
    b = np.linalg.inv(camera(rng))
    seq = []
    for t in range(70):
        base = a if t < 35 else b
        if t == 20:
            base = b  # a one-frame jump: rejected
        h = base + rng.normal(0, 1e-4, (3, 3)) * np.abs(base)
        tier = "coarse" if t % 7 == 3 or t > 50 else "fine"
        seq.append((None if t % 9 == 4 else h, tier))
    return seq


@pytest.mark.parametrize("seed", range(3))
def test_stabilizer_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ours = st.HomographyStabilizer(frame_hw=HW, fine_ttl=10)
    theirs = jst.HomographyStabilizer(frame_hw=HW, fine_ttl=10)
    for t, (h, tier) in enumerate(_homography_sequence(rng)):
        if t == 40:
            ours.lock(), theirs.lock()
        if t == 44:
            ours.lock(False), theirs.lock(False)
        assert_same_h(ours.update(h, tier), theirs.update(h, tier))
        assert ours.current_tier == theirs.current_tier
        assert (ours._jump_count, ours._fine_age) == \
            (theirs._jump_count, theirs._fine_age)
    a, b = np.linalg.inv(camera(rng)), np.linalg.inv(camera(rng))
    assert st.homography_distance(a, b, HW) == jst.homography_distance(a, b, HW)
    ours.reset()
    assert ours.current is None and not ours.locked


def test_view_transformer_matches_jax():
    rng = np.random.default_rng(5)
    h = np.linalg.inv(camera(rng))
    pts = rng.uniform(0, 600, (20, 2))
    boxes = np.concatenate([pts, pts + rng.uniform(10, 80, (20, 2))], 1)
    ours, theirs = view.ViewTransformer(h), jview.ViewTransformer(h)
    np.testing.assert_array_equal(ours.image_to_rink(pts), theirs.image_to_rink(pts))
    np.testing.assert_array_equal(ours.rink_to_image(pts), theirs.rink_to_image(pts))
    np.testing.assert_array_equal(ours.boxes_to_rink(boxes),
                                  theirs.boxes_to_rink(boxes))
    rink = jdim.default_keypoint_positions()[:10]
    img = jr.project(np.linalg.inv(h), rink)
    np.testing.assert_array_equal(view.ViewTransformer.from_points(img, rink).h,
                                  jview.ViewTransformer.from_points(img, rink).h)
    with pytest.raises(ValueError):
        view.ViewTransformer.from_points(img[:3], rink[:3])


# ---------------------------------------------------------------------------
# the motion probe and the calibrator

@pytest.mark.parametrize("hw", [(1080, 1920), (640, 640), (720, 1280),
                                (512, 512), (36, 64), (1079, 1917),
                                (333, 777), (48, 50)])
def test_probe_gray_and_resize_are_cv2s(hw):
    """OpenCV 5's COLOR_BGR2GRAY and INTER_LINEAR resize to the 36x64
    probe, bit for bit: 30x shrinks from 1080p, 17.8x and 10x from 640,
    odd sizes and an enlargement."""
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    gray = bgr_to_gray(img)
    np.testing.assert_array_equal(gray, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(gray_resize(img, (36, 64)),
                                  cv2.resize(gray, (64, 36)))


def test_probe_random_sizes_are_cv2s():
    rng = np.random.default_rng(0)
    for _ in range(40):
        h, w = rng.integers(8, 1200, 2)
        oh, ow = rng.integers(4, 200, 2)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), (int(ow), int(oh)))
        np.testing.assert_array_equal(gray_resize(img, (oh, ow)), want)


def _frames_with_cut(rng, n=16, cut=9):
    """Frames of a slowly panning textured scene, a cut at `cut`."""
    a, b = (cv2.resize(rng.integers(0, 256, (6, 11, 3), dtype=np.uint8),
                       (HW[1] + 64, HW[0]), interpolation=cv2.INTER_LINEAR)
            for _ in range(2))
    return [(a if t < cut else b)[:, 2 * t:2 * t + HW[1]].copy()
            for t in range(n)]


def test_camera_movement_detector_matches_jax():
    frames = _frames_with_cut(np.random.default_rng(1))
    ours, theirs = cal.CameraMovementDetector(), jcal.CameraMovementDetector()
    flags = [ours.update(f) for f in frames]
    assert flags == [theirs.update(f) for f in frames]
    assert flags[9] and not flags[1]  # the cut moves, the pan does not
    np.testing.assert_array_equal(ours._last, theirs._last)


def test_calibrator_sequence_with_cut_matches_jax(tmp_path):
    """CalibratorState over frames with a camera cut: per-frame
    homography, tier, quality, status and probe equal to the JAX one;
    then manual edits, keys, segments and profiles."""
    rng = np.random.default_rng(3)
    frames = _frames_with_cut(rng)
    cams = (camera(rng), camera(rng))
    ours, theirs = cal.CalibratorState(frame_hw=HW), jcal.CalibratorState(frame_hw=HW)
    for t, frame in enumerate(frames):
        arr = keypoint_array(rng, cams[t >= 9], noise=1.0 if t % 5 else 6.0)
        a, b = both_keypoints(arr)
        assert_same_h(ours.process_frame(frame, a), theirs.process_frame(frame, b))
        assert ours.last_tier == theirs.last_tier
        assert_same_quality(ours.last_quality, theirs.last_quality)
        assert ours.status == theirs.status
        if t == 5:
            assert ours.save_segment() == theirs.save_segment()
    assert ours.stabilizer.current is not None and len(ours.segments) == 1
    # back to the first camera: the saved segment is reused
    for frame in frames[:2]:
        arr = keypoint_array(rng, cams[0])
        a, b = both_keypoints(arr)
        assert_same_h(ours.process_frame(frame, a), theirs.process_frame(frame, b))
        assert ours.status == theirs.status
    # manual edits override detections
    for s in (ours, theirs):
        x, y = s.detected_keypoints[0].position
        assert s.select_near(x + 3, y - 2) == s.detected_keypoints[0].id
        s.drag_to(x + 5, y + 5)
        s.select_near(-500, -500)
        for key in "hlcrgl":
            s.drive_key(key)
    assert ours.manual_points == theirs.manual_points
    assert (ours.show_help, ours.show_confidence, ours.stabilizer.locked) == \
        (theirs.show_help, theirs.show_confidence, theirs.stabilizer.locked)
    assert ours.status == theirs.status
    np.testing.assert_array_equal(ours.effective_correspondences()[0],
                                  theirs.effective_correspondences()[0])
    assert_same_h(ours.recalculate(), theirs.recalculate())
    x, y = next(iter(ours.manual_points.values()))
    ours.remove_near(x, y), theirs.remove_near(x, y)
    assert ours.manual_points == theirs.manual_points == {}
    # profiles: each side loads the other's file
    ours.manual_points[7] = (12.5, 30.0)
    theirs.manual_points[7] = (12.5, 30.0)
    po, pj = str(tmp_path / "o" / "p.json"), str(tmp_path / "j" / "p.json")
    ours.save_profile(po, source="clip.mp4")
    theirs.save_profile(pj, source="clip.mp4")
    assert open(po).read() == open(pj).read()
    a, b = cal.CalibratorState(frame_hw=HW), jcal.CalibratorState(frame_hw=HW)
    a.load_profile(pj)
    b.load_profile(po)
    assert_same_h(a.stabilizer.current, b.stabilizer.current)
    assert a.manual_points == b.manual_points == {7: (12.5, 30.0)}
    assert cal.CalibratorState.profile_path_for("/v/game.mp4") == \
        jcal.CalibratorState.profile_path_for("/v/game.mp4")
    assert cal.CalibrationProfile.from_json(open(po).read()) == \
        cal.CalibrationProfile(**jcal.CalibrationProfile.from_json(
            open(pj).read()).__dict__)
    with pytest.raises(ValueError):
        cal.CalibratorState(frame_hw=HW).save_profile(po)


def test_calibrator_needs_four_points():
    arr = np.zeros((56, 3), np.float32)
    arr[:3, 2] = 0.9
    arr[:3, :2] = [[10, 10], [50, 20], [90, 60]]
    frame = np.zeros(HW + (3,), np.uint8)
    ours, theirs = cal.CalibratorState(frame_hw=HW), jcal.CalibratorState(frame_hw=HW)
    a, b = both_keypoints(arr)
    assert ours.process_frame(frame, a) is None
    assert theirs.process_frame(frame, b) is None
    assert ours.status == theirs.status == "Need >= 4 points (3 available)"
