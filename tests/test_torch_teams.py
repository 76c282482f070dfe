"""The team modules of the port against the JAX package, on the CPU, on
the same numpy-seeded inputs.

Tolerances, and why:
- colour conversions: |diff| <= 1 on at most 0.01 % of the values. torch
  has no cbrt and its pow can differ from XLA's by an ULP; the results
  are rounded, so a value at a .5 boundary can flip by 1 (measured: 4 of
  3M LAB values, no HSV value);
- resize, crops: 1e-3 on [0, 255] values (f32 products in two libraries);
- masks equal on >= 99.9 % of the pixels (a LAB flip or an ULP in the
  border's mean can cross the distance threshold); dominant_hue equal;
  white_ratio within 0.01 (one pixel of a 100-pixel mask), saturation
  and brightness within 0.05 (means of 8-bit values);
- standardize_crops within 1 of cv2.resize (OpenCV's 11-bit fixed-point
  weights, against the port's f32 bilinear resize rounded to uint8);
- k-means: the same partition as scikit-learn, centres within 1e-4, on
  separated clusters; on overlapping ones an inertia no worse than its;
- fitted centres within 0.5 (white_ratio 0.01) and the simple
  classifier's confidences within 0.01: their host crops differ from
  cv2's by up to 1;
- classifiers: equal team ids; a global swap is allowed only where the
  two clusters' white ratios tie, since then only the clusters' order
  decides the labels.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.ops import color as jax_color
from hockey_tpu.ops import crop_resize as jax_crop
from hockey_tpu.ops.letterbox import resize_batch as jax_resize_batch
from hockey_tpu.teams import base as jax_base
from hockey_tpu.teams import features as jax_features
from hockey_tpu.teams.segmentation import \
    SegmentationTeamClassifier as JaxSegmentation
from hockey_tpu.teams.simple import SimpleTeamClassifier as JaxSimple
from hockey_tpu.train.scenes import render_scene_sequence
from hockey_tpu_torch.core.device import CONSTANTS
from hockey_tpu_torch.ops import color, crop_resize
from hockey_tpu_torch.ops.letterbox import resize_batch
from hockey_tpu_torch.teams import base, features
from hockey_tpu_torch.teams.facade import TeamClassifier
from hockey_tpu_torch.teams.kmeans import KMeans
from hockey_tpu_torch.teams.segmentation import SegmentationTeamClassifier
from hockey_tpu_torch.teams.simple import SimpleTeamClassifier
from hockey_tpu_torch.ui.team_selector import InteractiveTeamSelector


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(x)


@pytest.fixture(scope="module")
def scene():
    """Rendered frames with two teams: (frames (6, 320, 320, 3) uint8,
    per-frame labels)."""
    frames, labels = render_scene_sequence(np.random.default_rng(5), 320,
                                           n_frames=6)
    return np.stack(frames), labels


@pytest.fixture(scope="module")
def player_crops(scene):
    """(host crops of the skaters, their gt teams, the (N, 4) boxes and
    frame index of each)."""
    frames, labels = scene
    crops, teams, boxes, which = [], [], [], []
    for f, lab in enumerate(labels):
        for b, t in zip(lab["boxes"], lab["team_ids"]):
            if t in (0, 1):
                x1, y1, x2, y2 = [int(v) for v in b]
                if x2 - x1 >= 4 and y2 - y1 >= 8:
                    crops.append(frames[f][max(y1, 0):y2, max(x1, 0):x2])
                    teams.append(int(t))
                    boxes.append(b)
                    which.append(f)
    return crops, np.asarray(teams), np.asarray(boxes, np.float32), np.asarray(which)


@pytest.fixture(scope="module")
def crop_batch(scene, player_crops):
    """(N, 128, 64, 3) f32 crops: the skaters sampled from their frames
    plus uniformly random crops."""
    frames, _ = scene
    _, _, boxes, which = player_crops
    sampled = [np.asarray(jax_crop.crop_and_resize(J(frames[f]), J(boxes[which == f])))
               for f in np.unique(which)]
    rand = np.random.default_rng(1).uniform(0, 255, (8, 128, 64, 3))
    return np.concatenate(sampled + [rand.astype(np.float32)])


# ---------------------------------------------------------------------------
# ops

def _pixels():
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 256, (1_000_000, 3)).astype(np.float32)
    frac = rng.uniform(0, 255, (100_000, 3)).astype(np.float32)
    grey = np.repeat(np.arange(256, dtype=np.float32)[:, None], 3, 1)
    tied = rng.integers(0, 256, (30_000, 3)).astype(np.float32)
    tied[:10_000, 1] = tied[:10_000, 2]     # g == r
    tied[10_000:20_000, 0] = tied[10_000:20_000, 1]  # b == g
    tied[20_000:, 0] = tied[20_000:, 2]     # b == r
    return np.concatenate([rand, frac, grey, tied])


@pytest.mark.parametrize("fn", ["bgr_to_hsv", "bgr_to_lab"])
def test_color_conversions_match_jax(fn):
    px = _pixels()
    want = np.asarray(getattr(jax_color, fn)(J(px)))
    got = getattr(color, fn)(T(px)).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= 1e-4, (diff > 0).sum()
    # uint8 input converts as its float values do
    u8 = px[:1000].astype(np.uint8)
    np.testing.assert_array_equal(getattr(color, fn)(T(u8)).numpy(), got[:1000])


@pytest.mark.parametrize("out_hw", [(27, 48), (45, 80)])
def test_resize_batch_matches_jax(out_hw):
    frames = np.random.default_rng(2).integers(0, 256, (2, 180, 320, 3),
                                               dtype=np.uint8)
    want = np.asarray(jax_resize_batch(J(frames), out_hw))
    got = resize_batch(T(frames), out_hw)
    assert got.dtype == torch.float32 and got.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    keys = {(("resize", 180, out_hw[0]), torch.device("cpu"), torch.float32),
            (("resize_t", 320, out_hw[1]), torch.device("cpu"), torch.float32)}
    assert keys <= CONSTANTS.keys()
    built = dict(CONSTANTS)
    for _ in range(2):  # later calls reuse the two matrices
        np.testing.assert_array_equal(resize_batch(T(frames), out_hw).numpy(),
                                      got.numpy())
        assert CONSTANTS.keys() == built.keys()
        assert all(CONSTANTS[k] is built[k] for k in keys)


def test_crop_functions_match_jax(scene, player_crops):
    frames, _ = scene
    _, _, boxes, which = player_crops
    rng = np.random.default_rng(3)
    small = frames[:2, ::4, ::4].astype(np.float32)           # (2, 80, 80, 3)
    bx = boxes[which == 0][:6] / 4
    bx = np.concatenate([bx, np.zeros((2, 4), np.float32),   # padded slots
                         rng.uniform(-5, 85, (2, 4)).astype(np.float32)])
    want = np.asarray(jax_crop.crop_and_resize_mm(J(small[0]), J(bx)))
    got = crop_resize.crop_and_resize_mm(T(small[0]), T(bx))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # batched: each frame's boxes from that frame, in one call
    bxs = np.stack([bx, bx[::-1].copy()])
    batched = crop_resize.crop_and_resize_mm(T(small), T(bxs)).numpy()
    for i in range(2):
        ref = np.asarray(jax_crop.crop_and_resize_mm(J(small[i]), J(bxs[i])))
        np.testing.assert_allclose(batched[i], ref, rtol=0, atol=1e-3)
    # the gather crop at full resolution, and the jersey boxes
    want = np.asarray(jax_crop.crop_and_resize(J(frames[0]), J(bx * 4), (64, 32)))
    got = crop_resize.crop_and_resize(T(frames[0]), T(bx * 4), (64, 32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        crop_resize.crop_jersey_boxes(T(bx)).numpy(),
        np.asarray(jax_crop.crop_jersey_boxes(J(bx))), rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# features

def test_hist_scatter_equals_one_hot():
    rng = np.random.default_rng(4)
    vals = rng.uniform(0, 180, (6, 8192)).astype(np.float32)
    w = (rng.uniform(size=(6, 8192)) < 0.4).astype(np.float32)
    got = features._hist(T(vals), T(w), 18, 180.0).numpy()
    for i in range(6):
        want = np.asarray(jax_features._hist(J(vals[i]), J(w[i]), 18, 180.0))
        np.testing.assert_array_equal(got[i], want)


def test_masks_and_features_match_jax(crop_batch):
    masks_j = np.asarray(jax_features.color_prior_masks(J(crop_batch)))
    masks = features.color_prior_masks(T(crop_batch)).numpy()
    assert (masks == masks_j).mean() >= 0.999
    want = np.asarray(jax_features.segmentation_features(J(crop_batch), J(masks_j)))
    got = features.segmentation_features(T(crop_batch), T(masks_j)).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])        # dominant_hue
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=0.01)
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=0.05)
    assert (want[:, 3] != 128).sum() >= len(want) // 2  # real masks, not defaults
    stats_j = np.asarray(jax_features.simple_jersey_stats(J(crop_batch)))
    stats = features.simple_jersey_stats(T(crop_batch)).numpy()
    np.testing.assert_allclose(stats, stats_j, rtol=0, atol=0.05)
    # an empty mask takes the defaults
    none = features.segmentation_features(T(crop_batch[:2]),
                                          torch.zeros(2, 128, 64)).numpy()
    np.testing.assert_array_equal(none, [[0.5, 0, 0, 128]] * 2)


def test_grabcut_mask_matches_jax(player_crops):
    cv2 = pytest.importorskip("cv2")
    crops = np.asarray(jax_base.standardize_crops(player_crops[0][:4]), np.uint8)
    for c in crops:  # GrabCut seeds its mixtures from OpenCV's RNG
        cv2.setRNGSeed(0)
        got = features.grabcut_mask_host(c)
        cv2.setRNGSeed(0)
        np.testing.assert_array_equal(got, jax_features.grabcut_mask_host(c))


# ---------------------------------------------------------------------------
# base

def test_standardize_crops_within_one_of_cv2(player_crops):
    rng = np.random.default_rng(6)
    crops = list(player_crops[0][:10]) + [
        rng.integers(0, 256, s, dtype=np.uint8)
        for s in ((256, 128, 3), (128, 64, 3), (40, 17, 3), (300, 90, 3))]
    crops.append(np.zeros((0, 5, 3), np.uint8))
    want = jax_base.standardize_crops(crops)
    got = base.standardize_crops(crops)
    assert got.shape == want.shape == (len(crops), 128, 64, 3)
    assert np.abs(got - want).max() <= 1.0
    np.testing.assert_array_equal(got[-1], 0)


def test_majority_vote_matches_jax():
    rng = np.random.default_rng(7)
    ours, ref = base.MajorityVote(), jax_base.MajorityVote()
    for _ in range(40):
        tids = rng.choice(np.arange(1, 12), size=6, replace=False)
        teams = rng.integers(0, 2, 6)
        np.testing.assert_array_equal(ours.update(tids, teams), ref.update(tids, teams))
    np.testing.assert_array_equal(ours.update(None, [1, 0]), [1, 0])
    assert dict(ours.history) == dict(ref.history)


# ---------------------------------------------------------------------------
# k-means

def _blobs(sep: float):
    """Two Gaussian blobs in 4 dims, `sep` standard deviations apart, at
    the scales of the segmentation features."""
    rng = np.random.default_rng(int(sep * 10))
    x = np.concatenate([rng.normal(0, 1, (23, 4)), rng.normal(sep, 1, (19, 4))])
    return x * [0.3, 40.0, 60.0, 50.0], rng


@pytest.mark.parametrize("sep", [2.0, 4.0, 8.0])
def test_kmeans_matches_sklearn(sep):
    from sklearn.cluster import KMeans as SkKMeans

    x, rng = _blobs(sep)
    ours = KMeans(n_clusters=2, random_state=42, n_init=10)
    sk = SkKMeans(n_clusters=2, random_state=42, n_init=10)
    a, b = ours.fit_predict(x), sk.fit_predict(x)
    perm = [0, 1] if (a == b).mean() >= 0.5 else [1, 0]
    np.testing.assert_array_equal(np.asarray(perm)[a], b)
    np.testing.assert_allclose(ours.cluster_centers_[perm], sk.cluster_centers_,
                               rtol=0, atol=1e-4)
    q = rng.normal(sep / 2, 2, (50, 4)) * [0.3, 40.0, 60.0, 50.0]
    np.testing.assert_array_equal(np.asarray(perm)[ours.predict(q)], sk.predict(q))


def test_kmeans_overlapping_blobs_no_worse_than_sklearn():
    """Blobs half a standard deviation apart have several local optima, and
    which one a run finds depends on its seeding, which cannot be
    scikit-learn's: the port's best of 10 must reach an inertia no worse
    than scikit-learn's (here it is lower: another partition of one point)."""
    from sklearn.cluster import KMeans as SkKMeans

    x, _ = _blobs(0.5)
    ours = KMeans(n_clusters=2, random_state=42, n_init=10).fit(x)
    sk = SkKMeans(n_clusters=2, random_state=42, n_init=10).fit(x)
    assert ours.inertia_ <= sk.inertia_ * (1 + 1e-9)


# ---------------------------------------------------------------------------
# classifiers

def _same_up_to_tie(ours, ref, got, want):
    """Team ids equal; swapped only where the two white ratios tie."""
    w = ref.team_colors
    if w is not None and w[0]["is_white"] == w[1]["is_white"]:
        if not np.array_equal(got, want):
            np.testing.assert_array_equal(got, 1 - np.asarray(want))
            return
    np.testing.assert_array_equal(got, want)


def test_segmentation_classifier_matches_jax(scene, player_crops):
    frames, _ = scene
    crops, teams, boxes, which = player_crops
    ref = JaxSegmentation()
    ours = SegmentationTeamClassifier("cpu")
    ref.fit(crops)
    ours.fit(crops)
    assert ours.kmeans is not None and ref.kmeans is not None
    # the fit's host crops are resized within 1 of cv2's, so the centres
    # agree to a fraction of one 8-bit level, white_ratio to 0.01
    diff = np.abs(ours.kmeans.cluster_centers_ - ref.kmeans.cluster_centers_)
    assert (diff <= [0.01, 0.5, 0.5, 0.5]).all(), diff
    for k in (0, 1):
        assert ours.team_colors[k]["is_white"] == pytest.approx(
            ref.team_colors[k]["is_white"], abs=0.01)
    tids = np.arange(1, len(crops) + 1)
    _same_up_to_tie(ours, ref, ours.predict(crops, tids), ref.predict(crops, tids))
    for f in np.unique(which):
        b, t = boxes[which == f], tids[which == f]
        _same_up_to_tie(ours, ref, ours.predict_from_frame(frames[f], b, t),
                        ref.predict_from_frame(frames[f], b, t))
    masks = ours.get_segmentation_masks([1, 2])
    assert masks == {} or all(m.shape == (128, 64) for m in masks.values())
    # the fitted JAX state carried across: predict_features equal, with no
    # dependence on either k-means' seeding
    carried = SegmentationTeamClassifier.from_fitted(
        ref.kmeans.cluster_centers_, ref.team_colors, device="cpu")
    fresh = JaxSegmentation()
    fresh.kmeans, fresh.team_colors = ref.kmeans, ref.team_colors
    feats = np.asarray(jax_features.segmentation_features(
        *(lambda c: (c, jax_features.color_prior_masks(c)))(
            J(jax_base.standardize_crops(crops)))))
    np.testing.assert_array_equal(carried.predict_features(feats, tids),
                                  fresh.predict_features(feats, tids))
    # the two teams really were told apart
    pred = carried.predict_features(feats)
    acc = max((pred == teams).mean(), (pred != teams).mean())
    assert acc >= 0.9


def test_unfitted_and_too_few_crops_match_jax(player_crops):
    crops = player_crops[0][:5]
    ours, ref = SegmentationTeamClassifier("cpu"), JaxSegmentation()
    ours.fit(crops[:1])
    ref.fit(crops[:1])
    assert ours.kmeans is None and ref.kmeans is None
    np.testing.assert_array_equal(ours.predict(crops), ref.predict(crops))
    assert len(ours.predict([])) == 0 and len(ours.predict_features(np.zeros((0, 4)))) == 0


def test_simple_classifier_matches_jax(player_crops):
    crops = player_crops[0]
    got, conf = SimpleTeamClassifier("cpu").classify_batch(crops)
    want, conf_j = JaxSimple().classify_batch(crops)
    np.testing.assert_array_equal(got, want)
    # confidences from crops resized within 1 of cv2's: within 0.01
    np.testing.assert_allclose(conf, conf_j, rtol=0, atol=0.01)
    tids = np.arange(len(crops))
    np.testing.assert_array_equal(SimpleTeamClassifier("cpu").predict(crops, tids),
                                  JaxSimple().predict(crops, tids))


# ---------------------------------------------------------------------------
# facade and selector

def test_facade_names_and_demotion(player_crops, monkeypatch):
    clf = TeamClassifier(device="cpu")
    assert clf.active_strategy == "segmentation" and clf.supports_fused_features()
    assert clf.get_team_name(0) == "Team 0" and clf.get_team_name(5) == "Team 5"
    clf.set_team_names({0: "TOR", 1: "DET"})
    assert (clf.get_team_name(0), clf.get_team_name(1)) == ("TOR", "DET")

    # a failed fit demotes down the cascade, as in the JAX facade:
    # interactive needs a frame, robust crops of 50 px, hybrid fits these
    def broken(*a, **k):
        raise RuntimeError("segmentation broke")

    monkeypatch.setattr(clf._impl, "fit", broken)
    clf.fit(player_crops[0])
    assert clf.active_strategy == "hybrid"
    for flags, first in (({"use_segmentation": False}, "interactive"),
                         ({"use_segmentation": False, "use_interactive": False},
                          "robust"),
                         ({"use_segmentation": False, "use_interactive": False,
                           "use_robust": False}, "hybrid")):
        assert TeamClassifier(device="cpu", **flags).active_strategy == first
    # segmentation alone demotes to simple, which the port has
    only = TeamClassifier(device="cpu", use_interactive=False, use_robust=False,
                          use_hybrid=False)
    monkeypatch.setattr(only._impl, "fit", broken)
    only.fit(player_crops[0])
    assert only.active_strategy == "simple" and not only.supports_fused_features()
    frame = np.full((300, 400, 3), 235, np.uint8)
    frame[50:176, 50:114] = (40, 40, 200)
    assert len(only.predict_from_frame(frame, np.asarray([[45, 30, 125, 210]]),
                                       np.asarray([1]))) == 1
    assert only.get_segmentation_masks([1]) is None


def test_team_selector_headless(monkeypatch):
    boxes = np.asarray([[0, 0, 10, 10]] * 3, np.float32)
    sel = InteractiveTeamSelector(("TOR", "DET")).select_teams(None, boxes)
    assert sel.team_names == {0: "TOR", 1: "DET"}
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")
    monkeypatch.setenv("DISPLAY", ":0")
    sel = InteractiveTeamSelector().select_teams(None, boxes)
    assert sel.team_names == {0: "HOME", 1: "AWAY"}
    assert sel.selected_players == {0: [], 1: []}
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "0")
    monkeypatch.delenv("DISPLAY")
    assert InteractiveTeamSelector().select_teams(None, boxes).team_names[1] == "AWAY"
    assert "DISPLAY" not in os.environ
