"""Run checkpoint and resume: port of hockey_tpu/core/session.py.

`save_run_state(path, processor, frame_idx)` snapshots what a
VideoProcessor's later frames depend on: the team names, the active team
strategy's fitted state and vote histories, and the tracker's table;
`load_run_state(path, processor)` restores it into a fresh processor and
returns the frame to resume from (the CLI's `--save-state` and
`--resume`).

The file is the JAX package's: an npz archive of plain arrays and a JSON
manifest, `STATE_VERSION` 2, the same keys, read with
`allow_pickle=False`, so a state file cannot run code. A file written by
the JAX package loads here: the team state of every strategy and the host
ByteTrack's tracks are host data in both packages, and the fused tracker's
`TrackState` has the same fields in the same order in both (the arrays are
moved to the tracker's device). The segmentation centres go into the
port's k-means (teams/kmeans.py), not scikit-learn's KMeans. The robust
strategy's fit, which the JAX package does not save, is saved under extra
keys of `team_impl` that the JAX package ignores.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

STATE_VERSION = 2


def _encode(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Nested state -> JSON; ndarray leaves go to the side array store.
    Dict keys keep their Python type (vote histories use int keys)."""
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"__nd__": len(arrays) - 1}
    if isinstance(obj, np.generic):
        arrays.append(np.asarray(obj))
        return {"__nd0__": len(arrays) - 1}
    if isinstance(obj, dict):
        return {"__dict__": [[_encode(k, arrays), _encode(v, arrays)]
                             for k, v in obj.items()]}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v, arrays) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"run-state cannot serialize {type(obj)!r}")


def _decode(obj: Any, arrays) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return arrays[f"arr_{obj['__nd__']}"]
        if "__nd0__" in obj:
            return arrays[f"arr_{obj['__nd0__']}"][()]
        if "__dict__" in obj:
            return {_decode(k, arrays): _decode(v, arrays)
                    for k, v in obj["__dict__"]}
        if "__tuple__" in obj:
            return tuple(_decode(v, arrays) for v in obj["__tuple__"])
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


def save_run_state(path: str, processor, frame_idx: int) -> None:
    """Snapshot a VideoProcessor mid-run."""
    state: Dict[str, Any] = {
        "version": STATE_VERSION,
        "frame_idx": int(frame_idx),
        "mode": processor.mode.value,
        "team_names": dict(processor.team_classifier.team_names),
        "team_strategy": processor.team_classifier.active_strategy,
        "team_impl": _team_impl_state(processor.team_classifier),
        "tracker": _tracker_state(processor.tracker),
    }
    arrays: List[np.ndarray] = []
    manifest = json.dumps(_encode(state, arrays))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, manifest=np.frombuffer(manifest.encode(), np.uint8),
             **{f"arr_{i}": a for i, a in enumerate(arrays)})
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_run_state(path: str, processor) -> int:
    """Restore a snapshot into a freshly built VideoProcessor; returns the
    frame index to resume from."""
    with np.load(path, allow_pickle=False) as z:
        state = _decode(json.loads(bytes(z["manifest"]).decode()), z)
    if state.get("version") != STATE_VERSION:
        raise ValueError(f"unsupported run-state version {state.get('version')}")
    processor.team_classifier.set_team_names(state["team_names"])
    _restore_team_impl(processor.team_classifier, state)
    if processor.tracker is not None and state.get("tracker") is not None:
        _restore_tracker(processor.tracker, state["tracker"])
    return int(state["frame_idx"])


# --------------------------------------------------------------------------

def _team_impl_state(tc) -> Optional[Dict]:
    impl, name = tc._impl, tc.active_strategy
    if name == "segmentation":
        km = impl.kmeans
        return {"kind": name,
                "centers": None if km is None else np.asarray(km.cluster_centers_),
                "history": dict(impl.vote.history),
                "team_colors": impl.team_colors}
    if name == "hybrid":
        return {"kind": name,
                "fitted_features": impl.fitted_features,
                "fitted_labels": impl.fitted_labels,
                "scaler_mean": impl.scaler.mean_,
                "scaler_scale": impl.scaler.scale_,
                "history": dict(impl.vote.history)}
    if name == "interactive":
        return {"kind": name, "examples": dict(impl.examples),
                "history": dict(impl.player_history)}
    if name == "simple":
        return {"kind": name, "history": dict(impl.vote.history)}
    if impl._train_reduced is None:  # robust, unfitted
        return {"kind": name}
    return {"kind": name,
            "scaler_mean": impl.scaler.mean_, "scaler_scale": impl.scaler.scale_,
            "pca_mean": impl.pca.mean_, "pca_components": impl.pca.components_,
            "train_reduced": impl._train_reduced,
            "train_labels": impl._train_labels,
            "outlier_dist": float(impl._outlier_dist),
            "team_mapping": dict(impl.team_mapping),
            "team_profiles": impl.team_profiles,
            "team_exemplars": {t: list(v) for t, v in impl.team_exemplars.items()},
            "player_profiles": {t: dataclasses.asdict(p)
                                for t, p in impl.player_profiles.items()},
            "current_frame": impl.current_frame}


def _restore_team_impl(tc, state) -> None:
    s = state.get("team_impl") or {}
    kind = s.get("kind")
    if kind and kind != tc.active_strategy:
        tc._activate(kind)
    impl = tc._impl
    if kind == "segmentation" and s.get("centers") is not None:
        from ..teams.kmeans import KMeans

        impl.kmeans = KMeans(n_clusters=2, random_state=42, n_init=10)
        impl.kmeans.cluster_centers_ = np.asarray(s["centers"], np.float64)
        impl.team_colors = s.get("team_colors")
        impl.vote.history.update(s.get("history", {}))
    elif kind == "hybrid" and s.get("fitted_features") is not None:
        impl.fitted_features = s["fitted_features"]
        impl.fitted_labels = s["fitted_labels"]
        if s.get("scaler_mean") is not None:
            impl.scaler.mean_ = s["scaler_mean"]
            impl.scaler.scale_ = s["scaler_scale"]
            impl.scaler.var_ = s["scaler_scale"] ** 2
        impl.vote.history.update(s.get("history", {}))
    elif kind == "interactive" and s.get("examples"):
        impl.examples = s["examples"]
        impl.player_history.update(s.get("history", {}))
    elif kind == "simple":
        impl.vote.history.update(s.get("history", {}))
    elif kind == "robust" and s.get("train_reduced") is not None:
        from ..teams.cluster import PCA
        from ..teams.robust import PlayerProfile

        impl.scaler.mean_ = s["scaler_mean"]
        impl.scaler.scale_ = s["scaler_scale"]
        impl.scaler.var_ = s["scaler_scale"] ** 2
        impl.pca = PCA(len(s["pca_components"]), random_state=42)
        impl.pca.mean_ = s["pca_mean"]
        impl.pca.components_ = s["pca_components"]
        impl._train_reduced = s["train_reduced"]
        impl._train_labels = s["train_labels"]
        impl._outlier_dist = s["outlier_dist"]
        impl.team_mapping = s["team_mapping"]
        impl.team_profiles = s["team_profiles"]
        impl.team_exemplars = {t: list(v) for t, v in s["team_exemplars"].items()}
        impl.player_profiles = {t: PlayerProfile(**p)
                                for t, p in s["player_profiles"].items()}
        impl.current_frame = s["current_frame"]


def _tracker_state(tr) -> Optional[Dict]:
    if tr is None:  # PLAYER_DETECTION tracks nothing
        return None
    if not hasattr(tr, "tracks"):  # DeviceByteTrack: the state's arrays
        return {"device": True,
                "arrays": [x.detach().cpu().numpy() for x in tr.state]}
    return {"next_id": tr._next_id, "frame_id": tr.frame_id,
            "tracks": [dataclasses.asdict(t) for t in tr.tracks]}


def _restore_tracker(tr, state: Dict) -> None:
    if bool(state.get("device")) == hasattr(tr, "tracks"):
        raise ValueError("the state holds a {} tracker, the processor runs {}"
                         .format("device" if state.get("device") else "host",
                                 type(tr).__name__))
    if state.get("device"):
        from ..tracking.device_tracker import TrackState

        tr.state = TrackState(*[torch.from_numpy(np.array(a)).to(tr.device)
                                for a in state["arrays"]])
        return
    from ..tracking.bytetrack import _Track

    tr._next_id = state["next_id"]
    tr.frame_id = state["frame_id"]
    tr.tracks = [_Track(**t) for t in state["tracks"]]
