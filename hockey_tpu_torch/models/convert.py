"""Convert ultralytics YOLOv8 checkpoints to the port's parameter tree.

Port of hockey_tpu/models/convert.py. The reference loads
`hockey-player-detection.pt` and `hockey-detection.pt` through
`YOLO(path)` (hockey/main.py:71-87); a user migrating from it has those
files. `convert_state_dict` maps the ultralytics module-index state dict
(`model.<idx>.<...>`) onto the JAX-layout tree of numpy arrays that
`params_from_jax`, `build_model` and the msgpack writer take, so the JAX
package reads the file `convert_pt_file` writes.

Ultralytics YOLOv8 graph indices (detect and pose):
  0 stem, 1 down1, 2 c2f1, 3 down2, 4 c2f2, 5 down3, 6 c2f3, 7 down4,
  8 c2f4, 9 sppf, 12 c2f_up1, 15 c2f_up2, 16 down_p3, 18 c2f_d1,
  19 down_p4, 21 c2f_d2, 22 head (cv2 the box branch, cv3 the class
  branch, cv4 the keypoint branch of a pose model).

Torch conv weights are OIHW; the tree's are HWIO: transpose (2, 3, 1, 0).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .yolov8 import YOLOv8, YoloConfig, params_to_jax

BACKBONE_IDX = {
    0: ("backbone", "stem"), 1: ("backbone", "down1"), 2: ("backbone", "c2f1"),
    3: ("backbone", "down2"), 4: ("backbone", "c2f2"), 5: ("backbone", "down3"),
    6: ("backbone", "c2f3"), 7: ("backbone", "down4"), 8: ("backbone", "c2f4"),
    9: ("backbone", "sppf"), 12: ("neck", "c2f_up1"), 15: ("neck", "c2f_up2"),
    16: ("neck", "down_p3"), 18: ("neck", "c2f_d1"), 19: ("neck", "down_p4"),
    21: ("neck", "c2f_d2"),
}
HEAD_IDX = 22
HEAD_BRANCH = {"cv2": "reg", "cv3": "cls", "cv4": "kpt"}


def _np(t) -> np.ndarray:
    """A state-dict entry (numpy array or tensor) as f32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _conv_w(t) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(t), (2, 3, 1, 0)))


def _fill_conv(dst: Dict, sd: Mapping, prefix: str) -> None:
    """One ultralytics Conv (conv + BN) into a conv node of the tree."""
    dst["w"] = _conv_w(sd[f"{prefix}.conv.weight"])
    if f"{prefix}.bn.weight" in sd:
        dst["bn"] = {
            "scale": _np(sd[f"{prefix}.bn.weight"]),
            "bias": _np(sd[f"{prefix}.bn.bias"]),
            "mean": _np(sd[f"{prefix}.bn.running_mean"]),
            "var": _np(sd[f"{prefix}.bn.running_var"]),
        }
    elif f"{prefix}.conv.bias" in sd:
        dst["b"] = _np(sd[f"{prefix}.conv.bias"])


def _fill_plain_conv(dst: Dict, sd: Mapping, prefix: str) -> None:
    """A plain nn.Conv2d (the last 1x1 of each head branch)."""
    dst["w"] = _conv_w(sd[f"{prefix}.weight"])
    dst["b"] = _np(sd[f"{prefix}.bias"])


def _fill_c2f(dst: Dict, sd: Mapping, prefix: str) -> None:
    _fill_conv(dst["cv1"], sd, f"{prefix}.cv1")
    _fill_conv(dst["cv2"], sd, f"{prefix}.cv2")
    for i, m in enumerate(dst["m"]):
        _fill_conv(m["cv1"], sd, f"{prefix}.m.{i}.cv1")
        _fill_conv(m["cv2"], sd, f"{prefix}.m.{i}.cv2")


def convert_state_dict(sd: Mapping, cfg: YoloConfig, prefix: str = "model.") -> Dict:
    """An ultralytics state dict (numpy arrays or tensors) -> the JAX-layout
    tree of f32 numpy arrays (unfused). Every leaf of the tree comes from
    `sd`; a missing key raises KeyError."""
    params = params_to_jax(YOLOv8(cfg))  # the tree's shape; every leaf is replaced
    for idx, (group, name) in BACKBONE_IDX.items():
        p = params[group][name]
        mp = f"{prefix}{idx}"
        if name.startswith(("stem", "down")):
            _fill_conv(p, sd, mp)
        elif name == "sppf":
            _fill_conv(p["cv1"], sd, f"{mp}.cv1")
            _fill_conv(p["cv2"], sd, f"{mp}.cv2")
        else:
            _fill_c2f(p, sd, mp)
    for br_torch, br_ours in HEAD_BRANCH.items():
        if br_ours not in params["head"]:
            continue
        for lvl in range(3):
            dst = params["head"][br_ours][lvl]
            mp = f"{prefix}{HEAD_IDX}.{br_torch}.{lvl}"
            _fill_conv(dst["cv1"], sd, f"{mp}.0")
            _fill_conv(dst["cv2"], sd, f"{mp}.1")
            _fill_plain_conv(dst["out"], sd, f"{mp}.2")
    return params


def _state_dict_of(ckpt) -> Mapping:
    """The state dict inside what torch.load returned: an ultralytics
    checkpoint's 'model', a plain state dict, or a module's."""
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return ckpt.state_dict() if hasattr(ckpt, "state_dict") else ckpt


def load_pt_state_dict(pt_path: str) -> Mapping:
    """A .pt file's state dict. A plain state dict (or a dict of them)
    loads with `weights_only=True`; a whole pickled ultralytics model needs
    the `ultralytics` package to unpickle, and without it this says so."""
    import torch

    try:
        ckpt = torch.load(pt_path, map_location="cpu", weights_only=True)
    except Exception as weights_only_error:  # a pickled module, not tensors
        try:
            import ultralytics  # noqa: F401
        except ImportError:
            raise RuntimeError(
                f"{pt_path} holds a pickled ultralytics model, which needs "
                "the `ultralytics` package to load; install it, or save the "
                "model's state_dict() and convert that file") from weights_only_error
        ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    return _state_dict_of(ckpt)


def convert_pt_file(pt_path: str, cfg: YoloConfig, out_path: str) -> Dict:
    """Read an ultralytics .pt and write the JAX package's msgpack
    checkpoint to `out_path`; returns the tree."""
    from .checkpoint import save_params

    sd = load_pt_state_dict(pt_path)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    params = convert_state_dict(sd, cfg, prefix=prefix)
    save_params(out_path, params)
    return params
