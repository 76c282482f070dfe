"""The rest of the team cascade of the port (hybrid, robust, interactive and
the facade's demotions) against the JAX package, on the CPU, on the same
crops of a rendered scene.

The classifiers' parity runs on crops standardised once by the JAX
package (cv2.resize) and handed to both sides as one (N, 128, 64, 3)
array; the facade runs on the host crops themselves, which each package
resizes on its own (the port within 1 of cv2 per value, see
test_torch_teams.py).

Tolerances, and why:
- embeddings: |diff| <= 1e-4 + 2e-5 |value| (test_torch_embed.py);
- colour vectors, interactive features and similarities: within 1e-3
  (an HSV or LAB value at a rounding boundary flips by 1); robust's colour
  block is weighted x 20, so within 0.02;
- the fitted labels, the kNN and nearest-crop teams, the predicted team
  ids and the cascade's active strategy at every step: equal;
- robust confidences within 1e-3 (distances through the PCA of features
  that differ within the tolerances above).

The JAX robust classifier tries SigLIP through `transformers` first; the
tests hide that package, so both sides take the MobileNetV3 path, as on
the GPU machine, and no weights are looked up.
"""

import sys

import numpy as np
import pytest

from hockey_tpu.teams import base as jax_base
from hockey_tpu.teams import facade as jax_facade
from hockey_tpu.teams import hybrid as jax_hybrid
from hockey_tpu.teams import interactive as jax_interactive
from hockey_tpu.teams import robust as jax_robust
from hockey_tpu.train.scenes import render_scene_sequence
from hockey_tpu_torch.teams import facade, hybrid, interactive, robust
from tests.test_torch_session import one_torch_thread  # noqa: F401

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

EMBED_TOL = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def headless_without_transformers(monkeypatch):
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)


@pytest.fixture(scope="module")
def scene():
    """(host crops of the skaters of 4 frames at 640, their teams, their
    box centres, the frame index of each)."""
    frames, labels = render_scene_sequence(np.random.default_rng(5), 640, n_frames=4)
    crops, teams, centres, which = [], [], [], []
    for f, lab in enumerate(labels):
        for b, t in zip(lab["boxes"], lab["team_ids"]):
            x1, y1, x2, y2 = [int(v) for v in b]
            if t in (0, 1) and x2 - x1 >= 8 and y2 - y1 >= 16:
                crops.append(frames[f][max(y1, 0):y2, max(x1, 0):x2])
                teams.append(int(t))
                centres.append(((b[0] + b[2]) / 2, (b[1] + b[3]) / 2))
                which.append(f)
    return crops, np.asarray(teams), centres, np.asarray(which)


@pytest.fixture(scope="module")
def batches(scene):
    """The crops standardised by the JAX package: (jersey regions for the
    hybrid classifier, whole crops)."""
    crops = scene[0]
    return (jax_base.standardize_crops([jax_hybrid._jersey_region(c) for c in crops]),
            jax_base.standardize_crops(crops))


def _frames(scene, batch):
    """[(crops of frame f, tracker ids, positions)] for the scene's frames."""
    _, _, centres, which = scene
    return [(batch[which == f], np.flatnonzero(which == f) + 1,
             [centres[i] for i in np.flatnonzero(which == f)])
            for f in np.unique(which)]


def agreement(pred, teams) -> float:
    """Share of crops on their true team, up to a swap of the two labels
    (team 0 is the white or less saturated team, which the scene's team
    0 need not be)."""
    same = float(np.mean(np.asarray(pred) == teams))
    return max(same, 1.0 - same)


# ---------------------------------------------------------------------------
# features

def test_robust_color_features_match_jax(batches):
    x = batches[1]
    want = np.asarray(jax_robust.robust_color_features(jnp.asarray(x)))
    got = robust.robust_color_features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    want = np.asarray(jax_robust.masked_saturation_stats(jnp.asarray(x)))
    got = robust.masked_saturation_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    want = np.asarray(jnp.stack([jax_robust._number_mask_single(c)
                                 for c in jnp.asarray(x[:6])]))
    np.testing.assert_array_equal(
        robust.number_masks(torch.from_numpy(x[:6])).numpy(), want)


def test_interactive_features_and_similarity_match_jax(batches):
    x = batches[1]
    want = np.asarray(jax_interactive.interactive_features(jnp.asarray(x)))
    got = interactive.interactive_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x), interactive.DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(interactive.similarity_matrix(got[:9], got[9:]),
                               jax_interactive.similarity_matrix(want[:9], want[9:]),
                               rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# classifiers

def test_hybrid_matches_jax(scene, batches):
    _, teams, centres, _ = scene
    x = batches[0]
    ref = jax_hybrid.HybridTeamClassifier()
    clf = hybrid.HybridTeamClassifier(device="cpu")
    want, got = ref.extract_all_features(x), clf.extract_all_features(x)
    np.testing.assert_allclose(got[:, :576], want[:, :576], **EMBED_TOL)
    np.testing.assert_allclose(got[:, 576:], want[:, 576:], rtol=0, atol=1e-3)
    ref.fit(x, positions=centres)
    clf.fit(x, positions=centres)
    np.testing.assert_array_equal(clf.fitted_labels, ref.fitted_labels)
    assert 0 < clf.fitted_labels.sum() < len(x)  # two clusters
    for crops, tids, _ in _frames(scene, x):
        np.testing.assert_array_equal(clf.predict(crops, tids),
                                      ref.predict(crops, tids))
    assert hybrid.HybridTeamClassifier(device="cpu").predict(x[:4]).tolist() == \
        jax_hybrid.HybridTeamClassifier().predict(x[:4]).tolist()  # unfitted
    with pytest.raises(ValueError):
        clf.fit(x[:3])


def test_robust_matches_jax(scene, batches):
    _, teams, centres, _ = scene
    x = batches[1]
    ref = jax_robust.RobustTeamClassifier()
    clf = robust.RobustTeamClassifier(device="cpu")
    assert ref._siglip is None
    want = ref.extract_multimodal_features(x, centres)
    got = clf.extract_multimodal_features(x, centres)
    np.testing.assert_allclose(got[:, :576], want[:, :576], **EMBED_TOL)
    np.testing.assert_allclose(got[:, 576:], want[:, 576:], rtol=0, atol=0.02)
    ref.fit(x, positions=centres)
    clf.fit(x, positions=centres)
    assert clf.team_mapping.keys() == ref.team_mapping.keys()
    np.testing.assert_array_equal(clf._train_labels, ref._train_labels)
    assert len(clf._train_labels) >= 0.8 * len(x)
    for crops, tids, pos in _frames(scene, x):
        a, b = clf.predict(crops, tids, pos), ref.predict(crops, tids, pos)
        np.testing.assert_array_equal(clf.get_team_labels(a), ref.get_team_labels(b))
        np.testing.assert_allclose(clf.get_confidences(a), ref.get_confidences(b),
                                   rtol=0, atol=1e-3)
        assert [p.is_outlier for p in a] == [p.is_outlier for p in b]
    assert agreement(clf._train_labels, teams) >= 0.9  # it finds the teams


def test_robust_subsamples_like_jax():
    """Above 500 crops both draw the same 500 (np.random.default_rng(42),
    p by area and shape)."""
    rng = np.random.default_rng(0)
    crops = [np.zeros((int(h), int(h) // 2, 3), np.uint8)
             for h in rng.integers(40, 140, 620)]
    kept, _, scores = robust.RobustTeamClassifier.filter_crops_for_clustering(crops)
    want = jax_robust.RobustTeamClassifier.filter_crops_for_clustering(crops)
    assert scores == want[2] and len(kept) == len(want[0]) > 500


def test_interactive_matches_jax(scene, batches):
    _, teams, _, _ = scene
    x = batches[1]
    ex0, ex1 = x[teams == 0][:4], x[teams == 1][:4]
    ref = jax_interactive.InteractiveTeamClassifier()
    clf = interactive.InteractiveTeamClassifier(device="cpu")
    with pytest.raises(ValueError):
        clf.predict(x[:2])
    assert not clf.initialize_from_examples(ex0[:1], ex1)
    assert clf.initialize_from_examples(ex0, ex1) and ref.initialize_from_examples(ex0, ex1)
    for t in (0, 1):
        np.testing.assert_allclose(clf.examples[t], ref.examples[t], rtol=0, atol=1e-3)
    for crops, tids, _ in _frames(scene, x):
        np.testing.assert_array_equal(clf.predict(crops, tids), ref.predict(crops, tids))
    assert dict(clf.player_history) == dict(ref.player_history)


def test_interactive_user_selection_headless():
    """Headless, the click UI picks nothing and the selection fails, as in
    the JAX package."""
    from hockey_tpu_torch.ui.team_selector import pick_team_examples

    frame = np.zeros((64, 64, 3), np.uint8)
    boxes = np.array([[0, 0, 10, 20], [20, 0, 30, 20]], np.float32)
    assert pick_team_examples(frame, boxes) is None
    clf = interactive.InteractiveTeamClassifier(device="cpu")
    assert not clf.initialize_from_user_selection(frame, (boxes, np.array([1, 2])))


# ---------------------------------------------------------------------------
# the facade's cascade

def _boom(*a, **k):
    raise RuntimeError("boom")


CASES = {
    # name: (TeamClassifier flags, [(strategy, method) to fail])
    "headless": (dict(use_segmentation=False), []),
    "no_robust": (dict(use_segmentation=False, use_robust=False), []),
    "simple_only": (dict(use_segmentation=False, use_interactive=False,
                         use_robust=False, use_hybrid=False), []),
    "robust_fit_fails": (dict(use_segmentation=False), [("robust", "fit")]),
    "robust_predict_fails": (dict(use_segmentation=False), [("robust", "predict")]),
    "hybrid_predict_fails": (dict(use_segmentation=False, use_robust=False),
                             [("hybrid", "predict")]),
}
_CLASSES = {
    "robust": (robust.RobustTeamClassifier, jax_robust.RobustTeamClassifier),
    "hybrid": (hybrid.HybridTeamClassifier, jax_hybrid.HybridTeamClassifier),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_facade_cascade_matches_jax(scene, monkeypatch, case):
    """The strategy after the constructor, after `fit` and after each
    `predict`, and the labels, against the JAX facade on the same host
    crops, headless (interactive demotes), with failures injected into
    both packages' classifiers alike."""
    crops, teams, centres, which = scene
    flags, failures = CASES[case]
    for name, method in failures:
        for cls in _CLASSES[name]:
            monkeypatch.setattr(cls, method, _boom)
    ref = jax_facade.TeamClassifier(**flags)
    clf = facade.TeamClassifier(device="cpu", **flags)
    assert clf.active_strategy == ref.active_strategy
    frame = np.zeros((64, 64, 3), np.uint8)
    dets = (np.zeros((0, 4), np.float32), np.zeros(0, np.int64))
    ref.fit(crops, positions=centres, frame=frame, detections=dets)
    clf.fit(crops, positions=centres, frame=frame, detections=dets)
    steps = [(ref.active_strategy, clf.active_strategy)]
    for f in np.unique(which):
        idx = np.flatnonzero(which == f)
        c = [crops[i] for i in idx]
        p = [centres[i] for i in idx]
        want = ref.predict(c, idx + 1, positions=p)
        got = clf.predict(c, idx + 1, positions=p)
        steps.append((ref.active_strategy, clf.active_strategy))
        np.testing.assert_array_equal(got, want)
    assert all(a == b for a, b in steps), steps


def test_facade_without_segmentation_no_longer_raises():
    """The repaired fault: `use_segmentation=False` starts on the
    interactive strategy, as the JAX facade does, where the port raised
    NotImplementedError."""
    clf = facade.TeamClassifier(device="cpu", use_segmentation=False)
    assert clf.active_strategy == jax_facade.TeamClassifier(
        use_segmentation=False).active_strategy == "interactive"
    ref = jax_facade.TeamClassifier(use_segmentation=False)
    few = [np.zeros((40, 20, 3), np.uint8)] * 3  # too few for robust, hybrid
    clf.fit(few)
    ref.fit(few)
    assert clf.active_strategy == ref.active_strategy == "simple"
    assert facade.TeamClassifier(device="cpu").active_strategy == "segmentation"


def test_classifiers_default_to_cuda():
    for cls in (hybrid.HybridTeamClassifier, robust.RobustTeamClassifier,
                interactive.InteractiveTeamClassifier, facade.TeamClassifier):
        if not torch.cuda.is_available():  # no fallback to the CPU
            with pytest.raises(RuntimeError, match="CUDA"):
                cls()
