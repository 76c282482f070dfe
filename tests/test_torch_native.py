"""The host runtime of the port (tracking/native.py, csrc/hockey_host.cpp)
against the JAX package's (hockey_tpu/tracking/native.py over
native/hockey_host.cpp) on the CPU, and the host ByteTrack through it.

The fault this runtime repairs: scipy's Hungarian and the JAX package's
Jonker-Volgenant solver both return an optimal assignment, but where
costs tie they return different ones, and the host ByteTrack's ids then
differ from the JAX package's. Duplicated detections tie the IoU costs.
Each test here first shows the plain route (numpy IoU, scipy) differing
on its inputs, then the port's runtime equal to the JAX package's.

Tolerances: none. IoU bit for bit, assignments index for index, the
trackers' boxes, scores, classes, ids and row indices equal.
"""

import numpy as np
import pytest

from hockey_tpu.tracking import native as jnative
from hockey_tpu.tracking.bytetrack import ByteTrack as JaxByteTrack
from hockey_tpu_torch.tracking import bytetrack, native
from hockey_tpu_torch.tracking.bytetrack import ByteTrack

N_CLIPS, CLIP_FRAMES = 120, 8


@pytest.fixture(scope="module", autouse=True)
def _jax_native_built():
    """The JAX package's library must be the one under test, not its
    numpy/scipy fallback."""
    assert jnative.available(), "the JAX package's native library did not build"
    assert native.available()


def _boxes(rng, n, degenerate=0.0):
    xy = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    wh = rng.uniform(0, 80, (n, 2)).astype(np.float32)
    wh[rng.random(n) < degenerate] = 0.0  # zero-area boxes
    return np.concatenate([xy, xy + wh], 1)


def test_iou_bit_equal_to_jax_native():
    rng = np.random.default_rng(0)
    for n, m in [(1, 1), (7, 5), (30, 40), (0, 4), (3, 0)]:
        a, b = _boxes(rng, n, 0.2), _boxes(rng, m, 0.2)
        b[: min(n, m) // 2] = a[: min(n, m) // 2]  # identical pairs
        got = native.iou_matrix(a, b)
        want = jnative.iou_matrix(a, b)
        assert got.dtype == np.float32 and got.shape == (n, m)
        np.testing.assert_array_equal(got, want)
    # a degenerate pair: the library's rule (0), not numpy's 1e-7 floor
    pt = np.asarray([[5, 5, 5, 5]], np.float32)
    assert native.iou_matrix(pt, pt)[0, 0] == jnative.iou_matrix(pt, pt)[0, 0] == 0.0
    # where the union is positive the plain IoU agrees bit for bit
    a, b = _boxes(rng, 50), _boxes(rng, 60)
    np.testing.assert_array_equal(native.iou_matrix(a, b), native._iou_numpy(a, b))


def _tied_costs(rng, n):
    for _ in range(n):
        r, c = rng.integers(2, 7, 2)
        yield rng.integers(0, 4, (r, c)).astype(np.float64)


def test_tied_assignments_equal_jax_native():
    rng = np.random.default_rng(1)
    plain_differs = 0
    for cost in _tied_costs(rng, 1000):
        rows, cols = native.linear_sum_assignment(cost)
        jr, jc = jnative.linear_sum_assignment(cost)
        assert rows.dtype == cols.dtype == np.int64
        np.testing.assert_array_equal(rows, jr)
        np.testing.assert_array_equal(cols, jc)
        pr, pc = native.linear_sum_assignment_reference(cost)
        assert cost[rows, cols].sum() == cost[pr, pc].sum()  # both optimal
        plain_differs += not (np.array_equal(rows, pr) and np.array_equal(cols, pc))
    assert plain_differs > 100, plain_differs  # the fault: other optima
    empty = native.linear_sum_assignment(np.zeros((0, 3)))
    assert [x.shape for x in empty] == [(0,), (0,)]


def test_non_finite_costs_raise():
    with pytest.raises(ValueError, match="non-finite"):
        native.linear_sum_assignment(np.full((2, 2), np.nan))


def _duplicate_clip(rng, frames=CLIP_FRAMES):
    """Players walking with jitter; each frame duplicates some detections
    exactly (tied IoU costs) and adds low-score copies."""
    n = int(rng.integers(2, 7))
    start = _boxes(rng, n)
    start[:, 2:] = start[:, :2] + rng.uniform(30, 90, (n, 2))
    vel = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    out = []
    for f in range(frames):
        b = start + np.tile(vel * f, 2) + rng.normal(0, 1.5, (n, 4))
        s = rng.uniform(0.3, 0.95, n)
        dup = rng.random(n) < 0.5
        low = rng.random(n) < 0.3
        boxes = np.concatenate([b, b[dup], b[low] + 2.0]).astype(np.float32)
        scores = np.concatenate([s, s[dup], rng.uniform(0.1, 0.25, low.sum())])
        keep = rng.random(len(boxes)) < 0.9  # missed detections
        out.append((boxes[keep], scores[keep].astype(np.float32)))
    return out


def _tracks(tracker, clip):
    rows = []
    for boxes, scores in clip:
        b, s, c, ids = tracker.update(boxes, scores)
        rows.append((b, s, c, ids, tracker.last_indices.copy()))
    return rows


def _same(a, b):
    return all(np.array_equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb))


@pytest.fixture
def plain_route(monkeypatch):
    """The port's host ByteTrack before the host runtime: numpy IoU and
    scipy's solver."""
    def use():
        monkeypatch.setattr(bytetrack, "_iou_matrix", native._iou_numpy)
        monkeypatch.setattr(native, "linear_sum_assignment",
                            native.linear_sum_assignment_reference)
    return use


def test_host_bytetrack_equals_jax_on_duplicated_boxes(plain_route):
    rng = np.random.default_rng(2)
    clips = [_duplicate_clip(rng) for _ in range(N_CLIPS)]
    kw = dict(minimum_consecutive_frames=1)
    want = [_tracks(JaxByteTrack(**kw), c) for c in clips]
    emitted = 0
    for i, (clip, w) in enumerate(zip(clips, want)):
        got = _tracks(ByteTrack(**kw), clip)
        assert _same(got, w), f"clip {i} differs from the JAX host ByteTrack"
        emitted += sum(len(r[3]) for r in w)
    assert emitted > 0
    plain_route()
    differ = sum(not _same(_tracks(ByteTrack(**kw), c), w)
                 for c, w in zip(clips, want))
    assert differ >= 1, "no clip shows the solver-tie divergence"


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.iou_matrix(np.zeros((1, 4)), np.zeros((1, 4)))
    assert native._lib is None and not native.available()
    monkeypatch.setenv("CXX", "false")  # runs, fails, no output
    with pytest.raises(RuntimeError, match="false failed"):
        native.linear_sum_assignment(np.zeros((2, 2)))
    # ByteTrack has no other route
    with pytest.raises(RuntimeError):
        ByteTrack().update(np.asarray([[0, 0, 10, 10]], np.float32),
                           np.asarray([0.9], np.float32))
