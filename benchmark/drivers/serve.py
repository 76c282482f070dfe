"""The serving driver: one of VideoProcessor's numeric entry points
(`classify_frames`, `detect_frames`, `puck_frames`) in a closed loop over
a seeded clip, then the checks against the plain reference.

Set-up: the clip drawn from the seed, the VideoProcessor built with the
configuration file's model, weights file and dtype, in TEAM_CLASSIFICATION
the one-time team fit (`fit_teams`), then `warmup_batches` batches through
the entry: every shape of the window is built before the clock starts.
The window: the same generator, batch after batch, until `seconds` have
passed (with `trace`, `trace_batches` batches under torch.profiler
instead). A frame's latency runs from the moment the entry pulls it from
the harness's iterator to the moment it yields the frame's result.

The checks (see benchmark/reference/): a sample of the window's batches,
drawn from the seed, is detected again by the reference in float32; the
fused tracker's step and team branch on sampled batches, the team vote
over every frame and the team fit are worked out again from the program's
own inputs to each stage; the puck tracker is replayed over every frame.
"""

from __future__ import annotations

import gc
import os
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import peaks
from benchmark.harness.cell import ROOT, Check, Outcome
from benchmark.harness.flops import yolov8_flops
from benchmark.harness.trace import WINDOW, TraceSummary
from benchmark.reference import puck as ref_puck
from benchmark.reference import teams as ref_teams
from benchmark.reference import tracker as ref_tracker
from benchmark.reference.compare import SCORE_MARGIN, detection_gaps, padded_rows, spread
from benchmark.reference.yolo import Detector, SlicedDetector, letterbox_geometry, slice_grid
from benchmark.traffic import scenes

# the scale of each team feature column, [white_ratio, dominant_hue,
# saturation, brightness], for gaps
FEATURE_SCALE = np.array([1.0, 180.0, 255.0, 255.0])
# a gap of a centre that one side has and the other lacks
MISSING = 1e9


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _weights(cfg: Dict) -> str:
    return os.path.join(ROOT, cfg["weights"])


def _quantile(values, q: float) -> float:
    """The q-quantile of all values (linear between order statistics)."""
    return float(np.quantile(np.asarray(values, np.float64), q))


class Window:
    """The closed loop over an entry's generator: warm-up, then the
    window, noting when each frame is done and keeping what the driver's
    `capture(i, result)` wants."""

    def __init__(self, entry, src, batch: int, capture):
        self.entry, self.src, self.batch, self.capture = entry, src, batch, capture
        self.done: List[float] = []

    def _one_batch(self) -> None:
        for _ in range(self.batch):
            r = next(self.entry)
            self.done.append(time.perf_counter())
            self.capture(len(self.done) - 1, r)

    def warm(self, batches: int) -> None:
        for _ in range(batches):
            self._one_batch()

    def measure(self, seconds: float, max_batches: int = 0):
        """(first frame index, frames, seconds) of the window: whole
        batches until `seconds` have passed, or `max_batches` batches."""
        first = len(self.done)
        t0 = time.perf_counter()
        n = 0
        while True:
            self._one_batch()
            n += 1
            if (max_batches and n >= max_batches) or (
                    not max_batches and time.perf_counter() - t0 >= seconds):
                break
        return first, len(self.done) - first, self.done[-1] - t0


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> Outcome:
    from hockey_tpu_torch.core.config import Config, ProcessingMode
    from hockey_tpu_torch.ops import assignment
    from hockey_tpu_torch.pipeline import VideoProcessor

    w, cfg = cell.workload, cell.config
    mode = ProcessingMode(w["mode"])
    frames, start = scenes.clip(w["traffic"], seed)
    hw = frames.shape[1:3]
    config, weights = _program_config(Config, mode, cfg, w.get("program", {}))
    vp = VideoProcessor(config, device=device, mode=mode, frame_hw=hw,
                        team_names=("TEAM_A", "TEAM_B"), **weights,
                        dtype=getattr(torch, cfg["dtype"]) if
                        torch.device(device).type == "cuda" else None)
    batch = config.resolved_frame_batch(device)
    fit_crops: List[np.ndarray] = []
    if mode == ProcessingMode.TEAM_CLASSIFICATION:
        fit = vp.team_classifier.fit

        def noted_fit(crops, **kw):  # the fit stage's input, for the checks
            fit_crops.extend(crops)
            return fit(crops, **kw)

        vp.team_classifier.fit = noted_fit
        vp.fit_teams(scenes.PingPong(frames, start))
        vp.team_classifier.fit = fit
    src = scenes.PingPong(frames, start)
    entry = {ProcessingMode.TEAM_CLASSIFICATION: vp.classify_frames,
             ProcessingMode.PLAYER_DETECTION: vp.detect_frames,
             ProcessingMode.PUCK_DETECTION: vp.puck_frames}[mode](src)
    results: List = []
    outs: List = []

    def capture(i, r):
        results.append(r)
        if mode == ProcessingMode.TEAM_CLASSIFICATION and i % batch == 0:
            outs.append(vp.last_track_batch)  # this batch's fused step

    loop = Window(entry, src, batch, capture)
    loop.warm(w["warmup_batches"])
    _sync(device)
    setup_s = time.perf_counter() - t_start

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        vp.timers.reset()
        syncs0 = assignment.stats.syncs
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                first, n, window_s = loop.measure(0, w["trace_batches"])
                _sync(device)
        syncs = assignment.stats.syncs - syncs0
        timers = dict(vp.timers.totals)
    else:
        first, n, window_s = loop.measure(seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    latency_ms = [1e3 * (loop.done[i] - src.pulled[i]) for i in range(first, first + n)]
    since = np.asarray(loop.done[first:first + n]) - loop.done[first]
    n_batches = n // batch
    window_batches = list(range(first // batch, first // batch + n_batches))

    # the sample of the window's batches that the reference works out again
    if trace:
        sample = window_batches
    else:
        rng = np.random.default_rng(seed)
        k = min(w["sample_batches"], len(window_batches))
        sample = sorted(rng.choice(window_batches, size=k, replace=False).tolist())

    def batch_frames(b):
        return np.stack([src.frames[src.index(b * batch + j)] for j in range(batch)])

    # the program's outputs to the host, then its state freed
    if mode == ProcessingMode.TEAM_CLASSIFICATION:
        outs = [tuple(x.cpu() if torch.is_tensor(x) else
                      type(x)(*(t.cpu() for t in x)) for x in o) for o in outs]
    del entry, loop, vp
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ref_kw = dict(w["reference"])
    checks: List[Check] = []
    notes: Dict = {"setup_s": setup_s, "window_frames": n, "sample_batches": sample}
    launches: List = []  # (B, K, tail) of each suppression launch of the traced window
    limits = w["limits"]
    ctrl: Dict[str, float] = {}
    floor = ref_kw["conf"]

    if mode == ProcessingMode.PUCK_DETECTION:
        sl = SlicedDetector(_weights(cfg), device, margin=SCORE_MARGIN, **ref_kw)
        ref_rows, prog_rows = [], []
        for b in sample:
            merged, tiles = sl(batch_frames(b))
            ref_rows += merged
            prog_rows += [{"boxes": results[b * batch + j].boxes,
                           "scores": results[b * batch + j].scores,
                           "classes": np.zeros(len(results[b * batch + j].scores))}
                          for j in range(batch)]
            k_tile = min(ref_kw["pre_topk"], _anchors(ref_kw["size"], ref_kw["size"]))
            launches.append((len(tiles), k_tile, sum(t["tail"] for t in tiles)))
            k_merge = min(ref_kw["merge_topk"], len(tiles) // batch * ref_kw["tile_max_det"])
            launches.append((batch, k_merge, sum(m["tail"] for m in merged)))
        gaps = detection_gaps(prog_rows, ref_rows, floor)
        if control:
            sl8 = SlicedDetector(_weights(cfg), device, fp8=True, **ref_kw)
            ctrl_rows = sum((sl8(batch_frames(b))[0] for b in sample), [])
            notes["fault_half_batch"] = detection_gaps(
                _half_out(ref_rows, batch, floor), ref_rows, floor)
            notes["control_gaps"] = detection_gaps(ctrl_rows, ref_rows, floor)
            notes["spread"] = {"program": spread(prog_rows, ref_rows, floor),
                               "control": spread(ctrl_rows, ref_rows, floor)}
        tracker = ref_puck.PuckTracker(trail_length=w["puck_trail_length"])
        centre_gap = 0.0
        for r in results:
            c, _ = tracker.ingest(r.boxes, r.scores)
            if (c is None) != (r.center is None):
                centre_gap = MISSING
            elif c is not None:
                centre_gap = max(centre_gap, float(np.abs(np.subtract(c, r.center)).max()))
        checks += _gap_checks(gaps, limits, notes, ctrl)
        checks.append(Check("puck_centre_px", centre_gap, limits["puck_centre_px"]))
        grid = slice_grid(*hw, ref_kw["size"], ref_kw["overlap"])
        flops_frame = len(grid) * yolov8_flops(cfg, (ref_kw["size"], ref_kw["size"]))
    else:
        det = Detector(_weights(cfg), device, margin=SCORE_MARGIN, **ref_kw)
        ref_rows, prog_rows = [], []
        for b in sample:
            got = det(batch_frames(b))
            ref_rows += got
            launches.append((batch, min(ref_kw["pre_topk"], _anchors(*_in_hw(hw, ref_kw))),
                             sum(g["tail"] for g in got)))
            if mode == ProcessingMode.TEAM_CLASSIFICATION:
                d = outs[b][0]
                prog_rows += padded_rows(d.boxes.numpy(), d.scores.numpy(),
                                         d.classes.numpy(), d.valid.numpy())
            else:
                prog_rows += [{"boxes": r.boxes, "scores": r.scores, "classes": r.classes}
                              for r in results[b * batch:(b + 1) * batch]]
        gaps = detection_gaps(prog_rows, ref_rows, floor)
        if control:
            det8 = Detector(_weights(cfg), device, fp8=True, **ref_kw)
            ctrl_rows = sum((det8(batch_frames(b)) for b in sample), [])
            notes["fault_half_batch"] = detection_gaps(
                _half_out(ref_rows, batch, floor), ref_rows, floor)
            notes["control_gaps"] = detection_gaps(ctrl_rows, ref_rows, floor)
            notes["spread"] = {"program": spread(prog_rows, ref_rows, floor),
                               "control": spread(ctrl_rows, ref_rows, floor)}
        checks += _gap_checks(gaps, limits, notes, ctrl)
        if mode == ProcessingMode.TEAM_CLASSIFICATION:
            checks += _team_checks(w, device, outs, results, sample, batch,
                                   batch_frames, fit_crops, control, ctrl, notes)
        flops_frame = yolov8_flops(cfg, _in_hw(hw, ref_kw))

    metrics = {
        "frames_per_s": n / window_s,
        "frame_latency_p95_ms": _quantile(latency_ms, 0.95),
        "setup_s": setup_s,
    }
    notes.update({"window_s": window_s, "batches": n_batches,
                  "frame_latency_p50_ms": _quantile(latency_ms, 0.5),
                  "frames_by_5s": np.bincount((since // 5).astype(int)).tolist()})
    if control:
        notes["control"] = ctrl
    run_ns = None
    if trace:
        summary = TraceSummary(prof)
        run_ns = SimpleNamespace(
            trace=summary, window_s=summary.window_s, busy_s=summary.busy_s,
            frames=n, batches=n_batches, timers=timers,
            counters={"assignment_syncs": syncs} if mode == ProcessingMode.TEAM_CLASSIFICATION else {},
            flops_per_frame=flops_frame,
            nms_bound_s=sum(peaks.suppress_bound_s(*x) for x in launches),
            nms_launches=len(launches), peaks=peaks, breakdown=summary.breakdown)
    return Outcome(metrics, checks, attempted=n, failed=0,
                   memory_peak_bytes=int(peak), run=run_ns, notes=notes)


def _program_config(Config, mode, cfg: Dict, program: Dict):
    """The program's Config and VideoProcessor weight arguments from the
    cell's configuration file: `program_model` names the architecture the
    program builds (its Config model name for the mode), and `weights` the
    file it reads, which the reference reads too."""
    from hockey_tpu_torch.core.config import ProcessingMode

    path = _weights(cfg)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if mode == ProcessingMode.PUCK_DETECTION:
        return (Config(**dict(program, puck_model_name=cfg["program_model"])),
                {"puck_checkpoint": path})
    return (Config(**dict(program, player_model_name=cfg["program_model"])),
            {"checkpoint": path})


def _gap_checks(gaps: Dict[str, float], limits: Dict, notes: Dict,
                ctrl: Dict) -> List[Check]:
    """The detection gaps' checks; the control's gaps go to `ctrl`."""
    ctrl.update(notes.get("control_gaps", {}))
    return [Check(k, v, limits[k]) for k, v in gaps.items()]


def _half_out(rows: List[Dict], batch: int, floor: float) -> List[Dict]:
    """Per-frame detections over `floor` with the second half of each
    batch's frames left empty: the fault of a step that drops half of its
    batch."""
    empty = {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0)}
    return [empty if i % batch >= batch // 2 else
            {k: np.asarray(r[k])[r["scores"] > floor] for k in ("boxes", "scores", "classes")}
            for i, r in enumerate(rows)]


def _in_hw(hw, ref_kw):
    _, _, _, _, _, ih, iw = letterbox_geometry(hw[0], hw[1], ref_kw["imgsz"])
    return ih, iw


def _anchors(h: int, w: int) -> int:
    return sum((h // s) * (w // s) for s in (8, 16, 32))


def _team_checks(w, device, outs, results, sample, batch, batch_frames,
                 fit_crops, control, ctrl, notes) -> List[Check]:
    """The fused tracker's step and team branch on the sampled batches
    (and the run's first batch, from the empty state); the team fit
    worked out again from the program's fit crops (its input to that
    stage: crops under its own detections of the fit frames, whose
    detector path the detect-only cell holds against the reference), then
    the nearest centre and the vote over every frame of the run, on the
    program's team features and track ids."""
    limits = w["limits"]
    trk = w["tracker"]
    capacity = outs[0][4].mean.shape[0]
    mismatch = 0
    for b in sorted(set(sample) | {0}):
        det, _, tids, _, state = outs[b]
        prev = ref_tracker.init_state(capacity, "cpu") if b == 0 else \
            ref_tracker.TrackState(*outs[b - 1][4])
        ok = det.valid & ((det.classes == 0) | (det.classes == 1))
        ref_state, ref_tids = ref_tracker.tracker_scan(
            prev, det.boxes.float(), det.scores.float(), det.classes, ok, **trk)
        mismatch += int((ref_tids != tids).sum())
        for f in ("track_id", "active", "tracked", "consecutive", "activated",
                  "missed", "class_id", "next_id"):
            mismatch += int((getattr(ref_state, f) != getattr(state, f)).sum())

    gaps, ctrl_gaps = [], []
    for b in sample:
        det, feats = outs[b][0], outs[b][1]
        x = torch.as_tensor(batch_frames(b)).to(device)
        ref = ref_teams.team_features(x, det.boxes.to(device)).cpu().numpy()
        valid = det.valid.numpy()
        gaps.append((np.abs(feats.numpy() - ref)[valid] / FEATURE_SCALE).max(-1))
        if control:
            low = ref_teams.team_features(x, det.boxes.to(device), torch.bfloat16).cpu().numpy()
            ctrl_gaps.append((np.abs(low - ref)[valid] / FEATURE_SCALE).max(-1))

    feat_gap = float(np.concatenate(gaps).max())
    notes["team_feat_gap_p99"] = _quantile(np.concatenate(gaps), 0.99)
    centres = ref_teams.fit_centres(fit_crops)
    id_mismatch = _vote_mismatch(centres, outs, results, batch)
    notes["team_centres"] = np.round(centres, 4).tolist()
    if control:
        ctrl["team_feat_gap"] = float(np.concatenate(ctrl_gaps).max())
    return [Check("track_mismatch", float(mismatch), limits["track_mismatch"]),
            Check("team_feat_gap", feat_gap, limits["team_feat_gap"]),
            Check("team_id_mismatch", float(id_mismatch), limits["team_id_mismatch"])]


def _vote_mismatch(centres, outs, results, batch) -> int:
    """Team ids of the run's players that differ from the nearest of
    `centres` under the vote, replayed over every frame from the first on
    the program's packed team features and track ids."""
    vote = ref_teams.MajorityVote()
    mismatch = 0
    for i, r in enumerate(results):
        packed = outs[i // batch][3][i % batch].numpy()
        rows = packed[packed[:, 6] >= 0]
        pmask = rows[:, 5] == 0
        if not pmask.any():
            continue
        d2 = ((rows[pmask, 7:][:, None, :].astype(np.float64) - centres[None]) ** 2).sum(-1)
        teams = vote.update(rows[pmask, 6].astype(np.int64), np.argmin(d2, 1))
        mismatch += int((np.asarray(r["team_ids"][:int(pmask.sum())]) != teams).sum())
    return mismatch

