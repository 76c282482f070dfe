"""On-device ByteTrack: port of hockey_tpu/tracking/device_tracker.py
(`TrackState`, `init_state`, the KF pieces, `_match`, `_tracker_step_impl`
as `tracker_step`, `tracker_scan`, `DeviceByteTrack`).

The whole tracker state lives in device tensors; one step runs KF
predict/update, the IoU cost matrix and the two-stage (optionally
three-stage) association per frame for every slot of a fixed-capacity
track table, with the host tracker's semantics (tracking/bytetrack.py).

`tracker_scan` steps a batch of frames. On CUDA tensors it is one launch
of the CUDA kernel of tracking/scan_kernel.py (csrc/tracker_scan.cu), with
no host sync, and raises on what the kernel does not take; on CPU tensors
it is `tracker_scan_reference`, a Python loop of `tracker_step` where JAX
has a `lax.scan`. `tracker_step` and `tracker_scan_reference` are the plain
version the kernel is held to: association solves the assignment with the
auction of ops/assignment.py, whose loop tests its condition on the host
once per round.

The step is functional: it never writes into the state it is given, so
a state made under `torch.inference_mode()` (the fused detect step's) and
one made outside it both work. Everything stays f32 (the KF's products
are einsums, which PyTorch runs in full f32 unless TF32 is turned on; no
module of the port turns it on). The constant-velocity transition F is
applied as the adds it amounts to, so no constant matrix is uploaded.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..ops.assignment import auction_match
from ..ops.iou import box_iou
from .scan_kernel import scan as scan_kernel


class TrackState(NamedTuple):
    mean: torch.Tensor         # (T, 8) xyah + velocities, f32
    cov: torch.Tensor          # (T, 8, 8) f32
    track_id: torch.Tensor     # (T,) int32; 0 = free slot
    active: torch.Tensor       # (T,) bool: slot holds a live track
    tracked: torch.Tensor      # (T,) bool: TRACKED (else LOST)
    consecutive: torch.Tensor  # (T,) int32
    activated: torch.Tensor    # (T,) bool: emitted at least once
    missed: torch.Tensor       # (T,) int32 frames since last update
    class_id: torch.Tensor     # (T,) int32
    score: torch.Tensor        # (T,) f32
    next_id: torch.Tensor      # () int32


_INT_FIELDS = ("track_id", "consecutive", "missed", "class_id", "next_id")
_BOOL_FIELDS = ("active", "tracked", "activated")


def init_state(capacity: int = 64, device="cuda") -> TrackState:
    t, dev = capacity, resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    no = dict(dtype=torch.bool, device=dev)
    return TrackState(
        mean=torch.zeros((t, 8), dtype=torch.float32, device=dev),
        cov=torch.zeros((t, 8, 8), dtype=torch.float32, device=dev),
        track_id=torch.zeros(t, **i32),
        active=torch.zeros(t, **no),
        tracked=torch.zeros(t, **no),
        consecutive=torch.zeros(t, **i32),
        activated=torch.zeros(t, **no),
        missed=torch.zeros(t, **i32),
        class_id=torch.zeros(t, **i32),
        score=torch.zeros(t, dtype=torch.float32, device=dev),
        next_id=torch.ones((), **i32),
    )


def track_state_from_numpy(arrays, device="cuda") -> TrackState:
    """A TrackState from arrays under the JAX TrackState's field names (a
    JAX TrackState, or one converted to numpy arrays)."""
    device = resolve_device(device)
    out = {}
    for f in TrackState._fields:
        a = np.array(getattr(arrays, f))  # a writable copy
        dtype = (torch.int32 if f in _INT_FIELDS else
                 torch.bool if f in _BOOL_FIELDS else torch.float32)
        out[f] = torch.as_tensor(a).to(device=device, dtype=dtype)
    return TrackState(**out)


def track_state_to_numpy(state: TrackState) -> Dict[str, np.ndarray]:
    """{field: numpy array} under the JAX TrackState's field names and
    dtypes (int32, bool, f32)."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in TrackState._fields}


# --- KF pieces (same constants as tracking/kalman.py) ----------------------
_STD_POS, _STD_VEL = 1.0 / 20.0, 1.0 / 160.0


def _xyxy_to_xyah(b):
    w = b[..., 2] - b[..., 0]
    h = torch.clamp_min(b[..., 3] - b[..., 1], 1e-6)
    return torch.stack([b[..., 0] + w / 2, b[..., 1] + h / 2, w / h, h], -1)


def _xyah_to_xyxy(m):
    cx, cy, a, h = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _diag(stds):
    """(T, n, n) diagonal matrices of the squared stds, n columns of (T, 1)."""
    return torch.diag_embed(torch.cat(stds, dim=1) ** 2)


def _motion_q(mean):
    h = mean[:, 3:4]
    return _diag([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-2),
                  _STD_POS * h, _STD_VEL * h, _STD_VEL * h,
                  torch.full_like(h, 1e-5), _STD_VEL * h])


def _apply_f(x, dim):
    """F x along `dim` for the constant-velocity F = [[I, I], [0, I]]: the
    first four entries gain the last four."""
    lo, hi = x.split(4, dim=dim)
    return torch.cat([lo + hi, hi], dim=dim)


def _kf_predict(mean, cov):
    """mean F^T and F cov F^T + Q (device_tracker.py:89-91)."""
    return _apply_f(mean, 1), _apply_f(_apply_f(cov, 1), 2) + _motion_q(mean)


def _kf_update(mean, cov, meas):
    """The measurement update of every slot (device_tracker.py:94-107). A
    free slot's S is singular; `solve_ex` leaves inf or nan there without
    raising or syncing, and the caller masks those slots out."""
    h = mean[:, 3:4]
    r = _diag([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-1),
               _STD_POS * h])
    s = cov[:, :4, :4] + r
    k = torch.linalg.solve_ex(
        s.transpose(1, 2), cov[:, :, :4].transpose(1, 2)
    ).result.transpose(1, 2)                                  # (T, 8, 4)
    innov = meas - mean[:, :4]
    mean2 = mean + torch.einsum("tij,tj->ti", k, innov)
    cov2 = cov - torch.einsum("tij,tjk->tik", k, cov[:, :4, :])
    return mean2, cov2


def _init_cov(xyah):
    h = xyah[:, 3:4]
    return _diag([2 * _STD_POS * h, 2 * _STD_POS * h, torch.full_like(h, 1e-2),
                  2 * _STD_POS * h, 10 * _STD_VEL * h, 10 * _STD_VEL * h,
                  torch.full_like(h, 1e-5), 10 * _STD_VEL * h])


def _match(iou, row_ok, col_ok, gate: float) -> torch.Tensor:
    """Hungarian-semantics matching: max-total-IoU over the admissible
    matrix, then pairs below the gate rejected. Column per row, -1 = none."""
    a = auction_match(iou, row_ok, col_ok)
    iou_a = iou.gather(1, torch.clamp_min(a, 0).long()[:, None])[:, 0]
    return torch.where((a >= 0) & (iou_a >= gate), a, -1)


def _scatter_drop(n: int, idx, values, fill, base=None):
    """`base.at[idx].set(values, mode="drop")` with out-of-range index n:
    a scatter into n + 1 slots whose last is dropped. `base` defaults to
    n slots of `fill`."""
    if base is None:
        base = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    buf = torch.cat([base, base.new_full((1,), fill)])
    return buf.scatter(0, idx.long(), values)[:n]


def _taken(d: int, a, m) -> torch.Tensor:
    """(D,) bool: detections that rows with m took (a = column per row)."""
    return _scatter_drop(d, torch.where(m, a, d), torch.ones_like(m), False)


def _iomin(a_boxes, b_boxes):
    """Intersection over the smaller area, (N, 4) x (M, 4) -> (N, M)."""
    tl = torch.maximum(a_boxes[:, None, :2], b_boxes[None, :, :2])
    br = torch.minimum(a_boxes[:, None, 2:], b_boxes[None, :, 2:])
    inter = torch.prod(torch.clamp_min(br - tl, 0.0), -1)
    aa = torch.prod(torch.clamp_min(a_boxes[:, 2:] - a_boxes[:, :2], 0.0), -1)
    ba = torch.prod(torch.clamp_min(b_boxes[:, 2:] - b_boxes[:, :2], 0.0), -1)
    return inter / torch.clamp_min(torch.minimum(aa[:, None], ba[None, :]), 1e-9)


def tracker_step(
    state: TrackState,
    boxes: torch.Tensor,    # (D, 4) xyxy, padded
    scores: torch.Tensor,   # (D,)
    classes: torch.Tensor,  # (D,) int32
    valid: torch.Tensor,    # (D,) bool
    *,
    activation_thresh: float = 0.25,
    match_thresh: float = 0.8,      # IoU distance gate (stage 1)
    low_gate: float = 0.5,          # IoU distance gate (stage 2)
    max_time_lost: int = 30,
    min_consecutive: int = 2,
    lost_reacquire_floor: float = 0.0,
    duplicate_kill_iomin: float = 0.0,
    lost_dup_kill_iomin: float = 0.0,
    init_contain_veto: float = 0.0,
) -> Tuple[TrackState, torch.Tensor]:
    """One frame (hockey_tpu device_tracker.py:129-342; its docstring
    gives the semantics of the four extension knobs, each 0 = stock
    ByteTrack). Returns (new_state, det_track_ids (D,) int32; -1 where the
    detection did not acquire an emittable track)."""
    t = state.mean.shape[0]
    d = boxes.shape[0]
    classes = classes.to(torch.int32)

    # predict all live tracks
    mean_p, cov_p = _kf_predict(state.mean, state.cov)
    mean = torch.where(state.active[:, None], mean_p, state.mean)
    cov = torch.where(state.active[:, None, None], cov_p, state.cov)
    missed = torch.where(state.active, state.missed + 1, state.missed)

    iou = box_iou(_xyah_to_xyxy(mean), boxes)                # (T, D)
    high = valid & (scores >= activation_thresh)
    low = valid & (scores >= 0.1) & ~high

    # stage 1: all active tracks (tracked + lost) vs high dets
    a1 = _match(iou, state.active, high, 1.0 - match_thresh)
    m1 = a1 >= 0
    # stage 2: unmatched TRACKED tracks vs low dets
    a2 = _match(iou, state.active & state.tracked & ~m1, low, 1.0 - low_gate)
    m2 = a2 >= 0
    if lost_reacquire_floor > 0.0:
        # stage 3 (extension): unmatched LOST tracks vs sub-threshold dets
        # that stage 2 did not take, at stage 2's gate
        mid = (valid & (scores >= lost_reacquire_floor) & ~high
               & ~_taken(d, a2, m2))
        a3 = _match(iou, state.active & ~state.tracked & ~m1, mid,
                    1.0 - low_gate)
        m3 = a3 >= 0
    else:
        a3 = torch.full_like(a1, -1)
        m3 = torch.zeros_like(m1)

    matched = m1 | m2 | m3
    det_idx = torch.where(m1, a1, torch.where(m2, a2, torch.where(m3, a3, 0)))
    det_idx = det_idx.long()
    mean_u, cov_u = _kf_update(mean, cov, _xyxy_to_xyah(boxes[det_idx]))
    was_lost = ~state.tracked
    mean = torch.where(matched[:, None], mean_u, mean)
    cov = torch.where(matched[:, None, None], cov_u, cov)
    consecutive = torch.where(
        matched, torch.where(was_lost, 1, state.consecutive + 1), 0
    ).to(torch.int32)
    score = torch.where(matched, scores[det_idx], state.score)
    class_id = torch.where(m1, classes[det_idx], state.class_id)
    missed = torch.where(matched, 0, missed).to(torch.int32)
    tracked = matched
    # unmatched previously-tracked become lost; lost expire after buffer
    active = state.active & ~(~matched & ~state.tracked
                              & (missed > max_time_lost))
    activated = state.activated | (matched & (consecutive >= min_consecutive))

    # new tracks from unmatched high detections into free slots
    det_taken = _taken(d, a1, m1) | _taken(d, a2, m2) | _taken(d, a3, m3)
    new_det = high & ~det_taken                              # (D,)
    if init_contain_veto > 0.0:
        contained = torch.any(
            (_iomin(_xyah_to_xyxy(mean), boxes) > init_contain_veto)
            & active[:, None] & (class_id[:, None] == classes[None, :]),
            dim=0)
        new_det = new_det & ~contained
    free = ~active                                           # (T,)
    # pair the k-th free slot with the k-th new detection
    free_rank = torch.cumsum(free, 0) - 1
    det_rank = torch.cumsum(new_det, 0) - 1
    n_new = new_det.sum()
    slot_det = torch.argmax(
        ((det_rank[None, :] == free_rank[:, None]) & new_det[None, :]).to(
            torch.int32), dim=1)
    takes = free & (free_rank < n_new)
    meas_new = _xyxy_to_xyah(boxes[slot_det])
    mean = torch.where(takes[:, None],
                       torch.cat([meas_new, torch.zeros_like(meas_new)], 1),
                       mean)
    cov = torch.where(takes[:, None, None], _init_cov(meas_new), cov)
    new_ids = state.next_id + det_rank[slot_det].to(torch.int32)
    track_id = torch.where(takes, new_ids, state.track_id)
    next_id = state.next_id + n_new.to(torch.int32)
    active = active | takes
    tracked = tracked | takes
    consecutive = torch.where(takes, 1, consecutive).to(torch.int32)
    activated = torch.where(takes, takes & (min_consecutive <= 1), activated)
    class_id = torch.where(takes, classes[slot_det], class_id)
    score = torch.where(takes, scores[slot_det], score)
    missed = torch.where(takes, 0, missed).to(torch.int32)

    if duplicate_kill_iomin > 0.0 or lost_dup_kill_iomin > 0.0:
        tb = _xyah_to_xyxy(mean)
        iomin = _iomin(tb, tb)
        younger = track_id[None, :] < track_id[:, None]
        same_cls = class_id[:, None] == class_id[None, :]
    if duplicate_kill_iomin > 0.0:
        # one-shot: i dies if contained in ANY older live same-class track
        live = active & tracked
        killed = torch.any((iomin > duplicate_kill_iomin) & younger
                           & live[:, None] & live[None, :] & same_cls, dim=1)
        active = active & ~killed
        tracked = tracked & ~killed
    if lost_dup_kill_iomin > 0.0:
        # i (LOST, younger) dies if covered by j (TRACKED, older)
        dup = ((iomin > lost_dup_kill_iomin) & younger
               & (active & ~tracked)[:, None]
               & (active & tracked)[None, :] & same_cls)
        active = active & ~torch.any(dup, dim=1)

    new_state = TrackState(mean, cov, track_id, active, tracked, consecutive,
                           activated, missed, class_id, score, next_id)

    # per-detection emitted track id; later writes win, as in JAX
    emit = active & tracked & activated
    src_tid = torch.where(emit, track_id, -1)
    det_tid = torch.full((d,), -1, dtype=torch.int32, device=boxes.device)
    for a, m, src in ((a1, m1, src_tid), (a2, m2, src_tid), (a3, m3, src_tid),
                      (slot_det, takes, track_id)):
        w = m & emit
        det_tid = _scatter_drop(d, torch.where(w, a, d),
                                torch.where(w, src, -1), -1, base=det_tid)
    return new_state, det_tid


# tracker_step's settings and their defaults
STEP_DEFAULTS = {k: p.default for k, p in
                 inspect.signature(tracker_step).parameters.items()
                 if p.kind is inspect.Parameter.KEYWORD_ONLY}


def tracker_scan_reference(
    state: TrackState,
    boxes: torch.Tensor,    # (B, D, 4)
    scores: torch.Tensor,   # (B, D)
    classes: torch.Tensor,  # (B, D) int32
    valid: torch.Tensor,    # (B, D) bool
    **static_kwargs,
) -> Tuple[TrackState, torch.Tensor]:
    """B frames of tracking in order (device_tracker.py:354-372), a
    `tracker_step` each: returns (state after the last frame,
    det_track_ids (B, D) int32)."""
    tids = []
    for f in range(boxes.shape[0]):
        state, tid = tracker_step(state, boxes[f], scores[f], classes[f],
                                  valid[f], **static_kwargs)
        tids.append(tid)
    return state, torch.stack(tids)


def tracker_scan(
    state: TrackState,
    boxes: torch.Tensor,    # (B, D, 4)
    scores: torch.Tensor,   # (B, D)
    classes: torch.Tensor,  # (B, D) int32
    valid: torch.Tensor,    # (B, D) bool
    **static_kwargs,
) -> Tuple[TrackState, torch.Tensor]:
    """B frames of tracking in order: `tracker_scan_reference` on CPU
    tensors, one launch of the CUDA kernel on CUDA tensors (no fallback:
    it raises on a dtype, shape or size it does not take). Returns (state
    after the last frame, det_track_ids (B, D) int32); the state given is
    not written."""
    if boxes.device.type == "cpu":
        return tracker_scan_reference(state, boxes, scores, classes, valid,
                                      **static_kwargs)
    fields, tids = scan_kernel(state, boxes, scores, classes, valid,
                               **{**STEP_DEFAULTS, **static_kwargs})
    return TrackState(*fields), tids


# the host ByteTrack's keywords: Config fields that set the tracker
BYTETRACK_FIELDS = (
    "track_activation_threshold", "lost_track_buffer",
    "minimum_matching_threshold", "frame_rate", "minimum_consecutive_frames",
    "duplicate_kill_iomin", "lost_dup_kill_iomin")


def step_kwargs(config: Config, activation_thresh=None) -> Dict:
    """`tracker_step`'s settings from `config`: the one mapping of its
    fields. `activation_thresh` overrides track initiation (the fused
    step's max(activation, conf), hockey_tpu detector.py:316-327)."""
    c = config
    if activation_thresh is None:
        activation_thresh = c.track_activation_threshold
    return dict(
        activation_thresh=activation_thresh,
        match_thresh=c.minimum_matching_threshold,
        max_time_lost=int(c.frame_rate / 30.0 * c.lost_track_buffer),
        min_consecutive=c.minimum_consecutive_frames,
        duplicate_kill_iomin=c.duplicate_kill_iomin,
        lost_dup_kill_iomin=c.lost_dup_kill_iomin,
    )


class DeviceByteTrack:
    """Host-facing wrapper with the ByteTrack API over `tracker_scan` of
    one frame (device_tracker.py:375-423). The state stays on `device`;
    each update pads the frame's detections to a power of two of at least
    8."""

    def __init__(self, capacity: int = 64, device="cuda", **kwargs):
        # the host ByteTrack's keywords, which are Config fields; the
        # duplicate kills default off, as in the reference wrapper
        cfg = dataclasses.replace(
            Config(duplicate_kill_iomin=0.0, lost_dup_kill_iomin=0.0),
            **{k: kwargs[k] for k in BYTETRACK_FIELDS if k in kwargs})
        self.device = resolve_device(device)
        self.kwargs = dict(
            step_kwargs(cfg),
            lost_reacquire_floor=kwargs.get("lost_reacquire_floor", 0.0),
            init_contain_veto=kwargs.get("init_contain_veto", 0.0))
        self.state = init_state(capacity, self.device)
        self.last_indices = np.zeros(0, np.int32)

    @classmethod
    def from_config(cls, config: Config, device="cuda") -> "DeviceByteTrack":
        """The tracker of `config`: its `max_tracks` slots and its
        ByteTrack settings, duplicate kills included."""
        return cls(capacity=config.max_tracks, device=device,
                   **{k: getattr(config, k) for k in BYTETRACK_FIELDS})

    def update(self, boxes, scores, classes=None):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        n = len(boxes)
        classes = (np.zeros(n, np.int32) if classes is None
                   else np.asarray(classes, np.int32))
        d = max(8, 1 << (n - 1).bit_length() if n else 3)
        pb = np.zeros((d, 4), np.float32)
        ps = np.full((d,), -1.0, np.float32)
        pc = np.zeros((d,), np.int32)
        pv = np.zeros((d,), bool)
        pb[:n], ps[:n], pc[:n], pv[:n] = boxes, scores, classes, True
        self.state, det_tid = tracker_scan(
            self.state, *(torch.from_numpy(x[None]).to(self.device)
                          for x in (pb, ps, pc, pv)), **self.kwargs)
        det_tid = det_tid[0].cpu().numpy()[:n]
        keep = det_tid >= 0
        # detection indices of the emitted rows (the host tracker's
        # last_indices contract)
        self.last_indices = np.flatnonzero(keep).astype(np.int32)
        return boxes[keep], scores[keep], classes[keep], det_tid[keep]

    def reset(self):
        self.state = init_state(self.state.mean.shape[0], self.device)
