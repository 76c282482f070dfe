"""The device tracker's test inputs, without JAX, for the CPU tests against
the JAX package (tests/test_torch_tracking.py) and the card tests of the
tracker's CUDA kernel (tests/test_torch_scan_kernel.py): a seeded crowded
scene at the main path's shapes, the fused step's settings and the
scenarios of tests/test_device_tracker.py and tests/test_tracking.py."""

import functools

import numpy as np

from hockey_tpu_torch.core.config import Config

T_MAIN, D_MAIN = 128, 64  # Config().max_tracks, Config().max_detections


def make_box(cx, cy, w=40.0, h=80.0):
    """tests/test_tracking.py make_box."""
    return np.asarray([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], np.float32)


def tracker_sequence(seed, k, d, n_targets=24):
    """(boxes (K, D, 4), scores, classes, valid) of a seeded scene: targets
    born and dying, dropped detections, two pairs crossing head-on, scores
    across the low and high bands, duplicate-extent (torso) boxes, a few
    goalies and clutter."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((k, d, 4), np.float32)
    scores = np.full((k, d), -1.0, np.float32)
    classes = np.zeros((k, d), np.int32)
    valid = np.zeros((k, d), bool)
    pos = rng.uniform(50, 1700, (n_targets, 2))
    vel = rng.uniform(-8, 8, (n_targets, 2))
    for a, b in ((0, 1), (2, 3)):  # head-on crossings at frame k / 2
        vel[b] = -vel[a]
        pos[b] = pos[a] + vel[a] * k + [0, 6]
    size = rng.uniform(30, 80, (n_targets, 2)) * [1, 2]
    cls = (rng.random(n_targets) < 0.1).astype(np.int32)
    birth = rng.integers(0, k // 2, n_targets)
    birth[:4] = 0
    death = birth + rng.integers(k // 3, 2 * k, n_targets)
    for f in range(k):
        rows = []
        for j in range(n_targets):
            if not birth[j] <= f < death[j] or rng.random() < 0.08:
                continue
            x, y = pos[j] + vel[j] * f + rng.normal(0, 1.5, 2)
            w, h = size[j]
            s = rng.choice([0.9, 0.6, 0.35, 0.15], p=[.6, .2, .1, .1])
            rows.append(([x, y, x + w, y + h], s, cls[j]))
            if rng.random() < 0.1:
                rows.append(([x + 2, y, x + w - 2, y + 0.6 * h], 0.5, cls[j]))
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(0, 1800, 2)
            rows.append(([x, y, x + 40, y + 90], rng.uniform(0.1, 0.5), 0))
        order = rng.permutation(len(rows))[:d]
        for i, r in enumerate(order):
            boxes[f, i], scores[f, i], classes[f, i] = rows[r]
            valid[f, i] = True
    assert (birth > 0).any() and (death < k).any()
    return boxes, scores, classes, valid


def config_kwargs():
    """The fused detect step's tracker settings under Config() defaults
    (models/detector.py Detector.tracker_kwargs, conf 0.4)."""
    c = Config()
    return dict(activation_thresh=max(c.track_activation_threshold,
                                      c.detection_confidence),
                match_thresh=c.minimum_matching_threshold,
                max_time_lost=int(c.frame_rate / 30.0 * c.lost_track_buffer),
                min_consecutive=c.minimum_consecutive_frames,
                duplicate_kill_iomin=c.duplicate_kill_iomin,
                lost_dup_kill_iomin=c.lost_dup_kill_iomin)


SETTINGS = {
    "config_defaults": {},
    "stock_bytetrack": dict(duplicate_kill_iomin=0.0, lost_dup_kill_iomin=0.0),
    "duplicate_kill_only": dict(lost_dup_kill_iomin=0.0),
    "lost_dup_kill_only": dict(duplicate_kill_iomin=0.0),
    "lost_reacquire_floor": dict(lost_reacquire_floor=0.15),
    "init_contain_veto": dict(init_contain_veto=0.85),
}


_EMPTY = (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32))


def scenario_frames(name):
    """(tracker kwargs, [(boxes, scores[, classes]) per frame])."""
    f32 = functools.partial(np.asarray, dtype=np.float32)
    if name == "steady":
        return dict(minimum_consecutive_frames=2), [
            (np.stack([make_box(100 + f, 100), make_box(400, 300)]),
             f32([0.9, 0.85])) for f in range(10)]
    if name == "occlusion_gap":
        return dict(lost_track_buffer=30), (
            [(make_box(100 + 5 * f, 100)[None], f32([0.9])) for f in range(5)]
            + [_EMPTY] * 10 + [(make_box(175, 100)[None], f32([0.9]))])
    if name == "expiry":
        return dict(lost_track_buffer=5), (
            [(make_box(100, 100)[None], f32([0.9]))] * 5 + [_EMPTY] * 12
            + [(make_box(100, 100)[None], f32([0.9]))])
    if name == "low_score":
        return dict(minimum_consecutive_frames=2), (
            [(make_box(100 + 2 * f, 100)[None], f32([0.9])) for f in range(4)]
            + [(make_box(108, 100)[None], f32([0.2])),
               (make_box(110, 100)[None], f32([0.9]))])
    if name.startswith("lost_reacquire"):
        floor = 0.15 if name.endswith("on") else 0.0
        return dict(minimum_consecutive_frames=1, lost_track_buffer=30,
                    track_activation_threshold=0.4,
                    lost_reacquire_floor=floor), (
            [(make_box(100 + 3 * f, 100)[None], f32([0.9])) for f in range(4)]
            + [_EMPTY] * 3 + [(make_box(118, 100)[None], f32([0.3]))])
    if name == "crossing_occlusion":
        rng = np.random.default_rng(11)
        start = rng.uniform(100, 800, (8, 2))
        vel = rng.uniform(-4, 4, (8, 2))
        vel[1], vel[3] = -vel[0], -vel[2]
        frames = []
        for f in range(30):
            js = [j for j in range(8) if not (j == 5 and 10 <= f < 16)]
            bx = [[*(start[j] + f * vel[j]), *(start[j] + f * vel[j] + [30, 80])]
                  for j in js]
            sc = [0.9 if not (j == 6 and f % 3 == 0) else 0.2 for j in js]
            frames.append((f32(bx), f32(sc)))
        return dict(minimum_consecutive_frames=2, lost_track_buffer=30), frames
    if name == "padding_change":
        return dict(minimum_consecutive_frames=1), [
            (make_box(50, 50)[None], f32([0.9])),
            (np.stack([make_box(53, 50)] + [make_box(200 + 60 * j, 300)
                                            for j in range(9)]),
             np.full(10, 0.9, np.float32))]
    if name.startswith("duplicate_alternation"):
        body = f32([100, 100, 140, 180])
        torso = f32([102, 100, 138, 148])
        kw = dict(minimum_consecutive_frames=1, track_activation_threshold=0.4)
        if name.endswith("kill"):
            kw["lost_dup_kill_iomin"] = 0.55
        if name.endswith("veto"):
            kw["init_contain_veto"] = 0.85
        return kw, ([(np.stack([body, torso]), f32([0.9, 0.85]))] * 4
                    + [(body[None], f32([0.9]))] * 3
                    + [(torso[None], f32([0.9]))])
    if name == "goalies_and_random_walk":
        rng = np.random.default_rng(7)
        pos = rng.uniform(100, 500, (4, 2))
        frames = []
        for _ in range(8):
            pos = pos + rng.normal(0, 2, pos.shape)
            frames.append((np.stack([make_box(*p) for p in pos]),
                           rng.uniform(0.5, 1.0, 4).astype(np.float32),
                           np.asarray([0, 1, 0, 1], np.int32)))
        return dict(minimum_consecutive_frames=1), frames
    if name == "host_duplicate_kill":
        full, torso = f32([100, 100, 140, 240]), f32([100, 100, 140, 170])
        return dict(minimum_consecutive_frames=1, duplicate_kill_iomin=0.55), [
            (np.stack([full, torso]), f32([0.9, 0.85]))] * 4
    if name == "host_lost_duplicate_kill":
        full, torso = f32([100, 100, 140, 240]), f32([100, 102, 140, 172])
        return dict(minimum_consecutive_frames=1, lost_dup_kill_iomin=0.55), (
            [(np.stack([full, torso]), f32([0.9, 0.85]))] * 2
            + [((torso if f % 2 else full)[None], f32([0.9])) for f in range(10)])
    if name == "crossing_targets":
        return dict(minimum_consecutive_frames=1), [
            (np.stack([make_box(100 + 10 * f, 100), make_box(300 - 10 * f, 108)]),
             f32([0.9, 0.9])) for f in range(21)]
    raise KeyError(name)


DEVICE_SCENARIOS = ["steady", "occlusion_gap", "expiry", "low_score",
                    "lost_reacquire_on", "lost_reacquire_off",
                    "crossing_occlusion", "padding_change",
                    "duplicate_alternation", "duplicate_alternation_kill",
                    "duplicate_alternation_veto"]
