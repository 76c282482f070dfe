"""The tracker of the port against the JAX package on the CPU:
`auction_match`, the Kalman filter, the state carried across, the scan at
the main path's shapes, `DeviceByteTrack`, the host `ByteTrack`, and the
display smoothing.

Tolerances: assignments, track ids, flags, counters and emitted ids equal
element for element; `mean` and `cov` within rtol 1e-5 and atol 1e-4 (the
same f32 filter, with the transition and the 4x4 solve evaluated by two
libraries in other orders); the host trackers' boxes, scores, classes and
ids equal (the same numpy code over the same host runtime's solver,
tests/test_torch_native.py);
smoothed display boxes within 1e-5 (the same numpy code)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.annotate.smooth import SmoothAnnotator as JaxSmooth
from hockey_tpu.ops.assignment import auction_match as jax_auction
from hockey_tpu.tracking import device_tracker as jdt
from hockey_tpu.tracking.bytetrack import ByteTrack as JaxByteTrack
from hockey_tpu.tracking.kalman import BatchKalmanXYAH as JaxKF
from hockey_tpu_torch.annotate.smooth import SmoothAnnotator
from hockey_tpu_torch.core.config import Config
from hockey_tpu_torch.ops import assignment
from hockey_tpu_torch.ops.assignment import auction_match
from hockey_tpu_torch.tracking import device_tracker as tdt
from hockey_tpu_torch.tracking.bytetrack import ByteTrack
from hockey_tpu_torch.tracking.kalman import BatchKalmanXYAH
from tests.tracker_cases import (D_MAIN, DEVICE_SCENARIOS, SETTINGS, T_MAIN,
                                 config_kwargs, scenario_frames,
                                 tracker_sequence)

_jax_auction = jax.jit(jax_auction)


# --------------------------------------------------------------------------
# auction_match

def _tracker_matrices(rng, t, d, n):
    """The generator of test_device_tracker.py::test_matches_scipy_on_
    tracker_matrices: each det overlaps its own track strongly and 0-2
    rivals weakly; rows 70% and columns 90% admissible."""
    for _ in range(n):
        b = np.zeros((t, d), np.float32)
        for j in range(int(rng.integers(1, d))):
            i = int(rng.integers(0, t))
            b[i, j] = rng.uniform(0.5, 0.95)
            for _ in range(int(rng.integers(0, 3))):
                b[int(rng.integers(0, t)), j] = rng.uniform(0.05, 0.6)
        yield b, rng.random(t) < 0.7, rng.random(d) < 0.9


def _auction_cases(name):
    rng = np.random.default_rng(0)
    if name == "tracker_32x16":
        return list(_tracker_matrices(rng, 32, 16, 100))
    if name == "main_path_128x64":
        return list(_tracker_matrices(np.random.default_rng(1), T_MAIN,
                                      D_MAIN, 20))
    if name == "tied_bids":  # every row wants the same two columns equally
        b = np.zeros((16, 8), np.float32)
        b[:, :2] = 0.7
        b[3, 5] = 0.7
        return [(b, np.ones(16, bool), np.ones(8, bool))]
    if name == "all_masked":
        b = rng.uniform(0, 1, (12, 6)).astype(np.float32)
        return [(b, np.zeros(12, bool), np.ones(6, bool)),
                (b, np.ones(12, bool), np.zeros(6, bool)),
                (b, np.zeros(12, bool), np.zeros(6, bool))]
    if name == "dense_near_tie_round_bound":
        # 128 rows bid for 32 strong columns with near-equal values: prices
        # climb by about eps a round, so 96 rounds end the auction with
        # rows still bidding, and the 32 weak columns go to the greedy fill
        b = np.empty((T_MAIN, D_MAIN), np.float32)
        b[:, :32] = 0.9 + 1e-4 * rng.random((T_MAIN, 32))
        b[:, 32:] = 0.5 + 1e-4 * rng.random((T_MAIN, 32))
        return [(b, np.ones(T_MAIN, bool), np.ones(D_MAIN, bool))]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["tracker_32x16", "main_path_128x64",
                                  "tied_bids", "all_masked",
                                  "dense_near_tie_round_bound"])
def test_auction_matches_jax(name):
    """Same `assign` as the JAX auction, element for element."""
    for b, row_ok, col_ok in _auction_cases(name):
        want = np.asarray(_jax_auction(jnp.asarray(b), jnp.asarray(row_ok),
                                       jnp.asarray(col_ok)))
        got = auction_match(torch.from_numpy(b), torch.from_numpy(row_ok),
                            torch.from_numpy(col_ok))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_auction_round_bound_and_syncs():
    """The near-tie case runs exactly 96 rounds and then the fill; the
    loop syncs once per round plus once, and the fill's steps run without
    a sync. A converged case stops early."""
    (b, row_ok, col_ok), = _auction_cases("dense_near_tie_round_bound")
    st = assignment.stats
    st.syncs = st.rounds = st.fill_steps = 0
    a = auction_match(torch.from_numpy(b), torch.from_numpy(row_ok),
                      torch.from_numpy(col_ok))
    assert (st.rounds, st.syncs, st.fill_steps) == (96, 97, 32)
    assert int((a >= 32).sum()) == 32
    b = np.eye(8, dtype=np.float32) * 0.9
    st.syncs = st.rounds = st.fill_steps = 0
    auction_match(torch.from_numpy(b), torch.ones(8, dtype=torch.bool),
                  torch.ones(8, dtype=torch.bool))
    assert (st.rounds, st.syncs, st.fill_steps) == (1, 2, 0)


# --------------------------------------------------------------------------
# Kalman filter

def _kf_state(rng, t):
    boxes = np.concatenate([rng.uniform(0, 1500, (t, 2)),
                            rng.uniform(20, 120, (t, 2))], 1).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    xyah = np.asarray(jdt._xyxy_to_xyah(jnp.asarray(boxes)))
    mean = np.concatenate([xyah, rng.normal(0, 2, (t, 4))], 1).astype(np.float32)
    cov = np.array(jdt._init_cov(jnp.asarray(xyah)))
    return boxes, mean, cov


def test_kalman_matches_jax():
    rng = np.random.default_rng(2)
    boxes, mean, cov = _kf_state(rng, 32)
    meas = (np.asarray(jdt._xyxy_to_xyah(jnp.asarray(boxes)))
            + rng.normal(0, 1, (32, 4))).astype(np.float32)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-5, atol=1e-4)
    want = jdt._kf_predict(jnp.asarray(mean), jnp.asarray(cov))
    got = tdt._kf_predict(torch.from_numpy(mean), torch.from_numpy(cov))
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w))
    want = jdt._kf_update(*want, jnp.asarray(meas))
    got = tdt._kf_update(*got, torch.from_numpy(meas))
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w))
    close(tdt._init_cov(torch.from_numpy(meas)).numpy(),
          np.asarray(jdt._init_cov(jnp.asarray(meas))))
    np.testing.assert_allclose(
        tdt._xyah_to_xyxy(tdt._xyxy_to_xyah(torch.from_numpy(boxes))).numpy(),
        boxes, atol=1e-3)
    # a free slot's singular S does not raise
    z = torch.zeros(2, 8), torch.zeros(2, 8, 8)
    m2, c2 = tdt._kf_update(*z, torch.ones(2, 4))
    assert m2.shape == (2, 8) and c2.shape == (2, 8, 8)


def test_host_kalman_matches_jax():
    rng = np.random.default_rng(4)
    boxes, _, _ = _kf_state(rng, 6)
    from hockey_tpu.tracking.kalman import xyxy_to_xyah as jx
    from hockey_tpu_torch.tracking.kalman import xyxy_to_xyah
    meas = xyxy_to_xyah(boxes)
    np.testing.assert_array_equal(meas, jx(boxes))
    ours, ref = BatchKalmanXYAH(), JaxKF()
    a, b = ours.initiate(meas), ref.initiate(meas)
    for _ in range(3):
        a = ours.update(*ours.predict(*a), meas + 1)
        b = ref.update(*ref.predict(*b), meas + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# the scan

@functools.lru_cache(maxsize=None)
def _jax_scan(items):
    return jax.jit(functools.partial(jdt.tracker_scan, **dict(items)))


def _jax_scan_np(state, data, kw):
    st, tids = _jax_scan(tuple(sorted(kw.items())))(
        state, *map(jnp.asarray, data))
    return jax.tree_util.tree_map(np.asarray, st), np.asarray(tids)


def _assert_states_equal(got: tdt.TrackState, want):
    got = tdt.track_state_to_numpy(got)
    for f in ("track_id", "active", "tracked", "activated", "missed",
              "consecutive", "next_id", "class_id"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
        assert got[f].dtype == np.asarray(getattr(want, f)).dtype, f
    for f in ("mean", "cov", "score"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_scan_matches_jax_at_main_path_shapes(setting):
    """48 frames at T = 128, D = 64 from init_state, in 6 batches of 8 as
    the fused step runs them, with the state carried between batches."""
    kw = {**config_kwargs(), **SETTINGS[setting]}
    data = tracker_sequence(0, 48, D_MAIN)
    jst, pst = jdt.init_state(T_MAIN), tdt.init_state(T_MAIN, "cpu")
    emitted = 0
    for b in range(6):
        chunk = tuple(x[8 * b:8 * b + 8] for x in data)
        jst, want = _jax_scan_np(jst, chunk, kw)
        pst, got = tdt.tracker_scan(pst, *map(torch.from_numpy, chunk), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        _assert_states_equal(pst, jst)
        emitted += int((want >= 0).sum())
    assert int(np.asarray(jst.next_id)) > 24 and emitted > 300


def test_scan_equals_jax_and_sequential_steps():
    """The scenario of test_device_tracker.py::test_scan_equals_sequential_
    steps: the port's scan == the JAX scan == the port's steps in turn."""
    rng = np.random.default_rng(3)
    k, d = 12, 8
    boxes = np.zeros((k, d, 4), np.float32)
    scores = np.full((k, d), -1.0, np.float32)
    classes = np.zeros((k, d), np.int32)
    valid = np.zeros((k, d), bool)
    pos = rng.uniform(100, 700, (5, 2))
    for f in range(k):
        for j in range(5 if f % 4 != 3 else 3):
            x, y = pos[j] + f * np.asarray([4.0, 1.5])
            boxes[f, j] = [x, y, x + 30, y + 80]
            scores[f, j] = 0.9 if j != 2 else 0.2
            valid[f, j] = True
    kw = dict(activation_thresh=0.25, match_thresh=0.8, max_time_lost=30,
              min_consecutive=2)
    data = (boxes, scores, classes, valid)
    jst, want = _jax_scan_np(jdt.init_state(32), data, kw)
    pst, got = tdt.tracker_scan(tdt.init_state(32, "cpu"),
                                *map(torch.from_numpy, data), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_states_equal(pst, jst)
    st, seq = tdt.init_state(32, "cpu"), []
    for f in range(k):
        st, tid = tdt.tracker_step(st, *(torch.from_numpy(x[f]) for x in data),
                                   **kw)
        seq.append(tid.numpy())
    np.testing.assert_array_equal(np.stack(seq), want)


def test_state_carried_across_packages():
    """A mid-sequence JAX state, carried into the port, and the port's state
    carried back into JAX, give the same next frames as staying put."""
    kw = config_kwargs()
    data = tracker_sequence(5, 24, D_MAIN)
    head = tuple(x[:12] for x in data)
    tail = tuple(x[12:] for x in data)
    jst, _ = _jax_scan_np(jdt.init_state(T_MAIN), head, kw)
    carried = tdt.track_state_from_numpy(jst, "cpu")
    back = tdt.track_state_to_numpy(carried)
    for f in jdt.TrackState._fields:  # the round trip is exact
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
        assert back[f].dtype == np.asarray(getattr(jst, f)).dtype
    jend, want = _jax_scan_np(jst, tail, kw)
    pend, got = tdt.tracker_scan(carried, *map(torch.from_numpy, tail), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_states_equal(pend, jend)
    jend2, want2 = _jax_scan_np(jdt.TrackState(**back), tail, kw)
    np.testing.assert_array_equal(want2, want)


# --------------------------------------------------------------------------
# DeviceByteTrack and the host ByteTrack on the scenarios of
# tests/test_device_tracker.py and tests/test_tracking.py

def _run_both(ours, ref, frames):
    n_ids = 0
    for i, fr in enumerate(frames):
        got, want = ours.update(*fr), ref.update(*fr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"frame {i}")
        np.testing.assert_array_equal(ours.last_indices, ref.last_indices)
        n_ids += len(want[3])
    return n_ids


@pytest.mark.parametrize("name", DEVICE_SCENARIOS)
def test_device_bytetrack_matches_jax(name):
    kw, frames = scenario_frames(name)
    ours = tdt.DeviceByteTrack(device="cpu", **kw)
    assert _run_both(ours, jdt.DeviceByteTrack(**kw), frames) > 0
    ours.reset()
    assert not bool(ours.state.active.any())


def _scan_kwargs(kw):
    """DeviceByteTrack's keyword names -> tracker_step's (the wrapper's own
    mapping, defaults from Config())."""
    return tdt.DeviceByteTrack(device="cpu", capacity=1, **kw).kwargs


@pytest.mark.parametrize("name", ["occlusion_gap", "expiry", "low_score",
                                  "lost_reacquire_on", "lost_reacquire_off",
                                  "crossing_occlusion",
                                  "duplicate_alternation_kill",
                                  "duplicate_alternation_veto"])
def test_scan_matches_jax_on_scenarios(name):
    """The scenarios of tests/test_device_tracker.py as one padded sequence
    (D = 16) through the port's and the JAX `tracker_scan`."""
    kw, frames = scenario_frames(name)
    k, d = len(frames), 16
    data = (np.zeros((k, d, 4), np.float32), np.full((k, d), -1.0, np.float32),
            np.zeros((k, d), np.int32), np.zeros((k, d), bool))
    for f, fr in enumerate(frames):
        n = len(fr[0])
        data[0][f, :n], data[1][f, :n], data[3][f, :n] = fr[0], fr[1], True
    skw = _scan_kwargs(kw)
    jst, want = _jax_scan_np(jdt.init_state(64), data, skw)
    pst, got = tdt.tracker_scan(tdt.init_state(64, "cpu"),
                                *map(torch.from_numpy, data), **skw)
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_states_equal(pst, jst)
    assert (want >= 0).any()


HOST_SCENARIOS = ["steady", "occlusion_gap", "expiry", "low_score",
                  "goalies_and_random_walk", "crossing_targets",
                  "host_duplicate_kill", "host_lost_duplicate_kill",
                  "crossing_occlusion"]


@pytest.mark.parametrize("name", HOST_SCENARIOS)
def test_host_bytetrack_matches_jax(name):
    kw, frames = scenario_frames(name)
    assert _run_both(ByteTrack(**kw), JaxByteTrack(**kw), frames) > 0


def test_host_bytetrack_from_config():
    cfg = Config()
    tr = ByteTrack.from_config(cfg, minimum_consecutive_frames=1)
    assert (tr.dup_kill_iomin, tr.lost_dup_kill_iomin) == (
        cfg.duplicate_kill_iomin, cfg.lost_dup_kill_iomin)
    assert tr.min_consecutive == 1 and tr.max_time_lost == 30


def test_device_bytetrack_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tdt.DeviceByteTrack().state.mean.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tdt.DeviceByteTrack()


@pytest.mark.parametrize("make", [
    lambda: tdt.init_state(8),
    lambda: tdt.track_state_from_numpy(jdt.init_state(8)),
], ids=["init_state", "track_state_from_numpy"])
def test_tracker_state_defaults_to_cuda(make):
    if torch.cuda.is_available():
        assert make().mean.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_device_bytetrack_from_config():
    """`from_config` takes the Config's slots and settings, duplicate kills
    included; the fused step's settings differ only in track initiation."""
    cfg = Config(max_tracks=16, minimum_consecutive_frames=1)
    tr = tdt.DeviceByteTrack.from_config(cfg, device="cpu")
    assert tr.state.mean.shape == (16, 8)
    want = dict(config_kwargs(), min_consecutive=1,
                activation_thresh=cfg.track_activation_threshold,
                lost_reacquire_floor=0.0, init_contain_veto=0.0)
    assert tr.kwargs == want
    assert tdt.step_kwargs(Config(), activation_thresh=0.4) == config_kwargs()


# --------------------------------------------------------------------------
# display smoothing

@pytest.mark.parametrize("kind", ["adaptive", "kalman", "ema", "ema_hysteresis"])
def test_smoothing_matches_jax(kind):
    """A seeded 40-frame track sequence (ids appearing and leaving, size
    jitter, varying confidence) through both SmoothAnnotators (adaptive
    and Kalman stabilizers) or both EmaStabilizers."""
    rng = np.random.default_rng(9)
    if kind.startswith("ema"):
        from hockey_tpu.annotate.stabilizers import EmaStabilizer as JaxEma
        from hockey_tpu_torch.annotate.stabilizers import EmaStabilizer

        hyst = kind == "ema_hysteresis"
        ours, ref = SmoothAnnotator(None), JaxSmooth(None)
        ours.stabilizer = EmaStabilizer(0.3, hysteresis=hyst)
        ref.stabilizer = JaxEma(0.3, hysteresis=hyst)
    else:
        ours = SmoothAnnotator(None, smoothing_factor=0.3,
                               use_adaptive=kind == "adaptive")
        ref = JaxSmooth(None, smoothing_factor=0.3,
                        use_adaptive=kind == "adaptive")
    pos = rng.uniform(100, 900, (12, 2))
    for f in range(40):
        ids = np.flatnonzero(rng.random(12) < 0.8) + 1
        p = pos[ids - 1] + f * 4 + rng.normal(0, 2, (len(ids), 2))
        wh = rng.uniform(38, 44, (len(ids), 1)) * [1, 2]
        boxes = np.concatenate([p, p + wh], 1).astype(np.float32)
        conf = rng.uniform(0.3, 1.0, len(ids)).astype(np.float32)
        got = ours.smooth_boxes(boxes, ids, conf)
        want = ref.smooth_boxes(boxes, ids, conf)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ours.smooth_boxes(boxes, None).shape == boxes.shape
