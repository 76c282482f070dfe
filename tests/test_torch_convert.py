"""The weight converters of the port against the JAX package's, leaf for
leaf and exactly (they only transpose and copy):

- `models/convert.py convert_state_dict` on ultralytics-layout state
  dicts (numpy arrays and tensors) of a YOLOv8n detector and a YOLOv8n
  pose model, against hockey_tpu/models/convert.py, and back to the tree
  the state dict was made from;
- `convert_pt_file` on a plain state dict and on an ultralytics-style
  checkpoint dict saved by torch.save: the msgpack it writes reads back
  in the JAX package; a pickled module without `ultralytics` installed
  raises, naming the package;
- `models/mobilenetv3.py convert_torchvision` on a torchvision-layout
  state dict of the shipped team embedder against the JAX function, and
  the converted embedder's embeddings equal the shipped one's.

The state dicts come from this test's own inverse maps. The JAX
converters fill a template tree from `init_params`, every leaf of which
they overwrite; the test hands them the port's template (the JAX
`init_params` draws its random template eagerly for ~20 s).
"""

import numpy as np
import pytest
import torch

from hockey_tpu.models import convert as JC
from hockey_tpu.models import mobilenetv3 as JM
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu_torch.models import mobilenetv3 as PM
from hockey_tpu_torch.models import yolov8 as P
from hockey_tpu_torch.models.checkpoint import flatten_tree
from hockey_tpu_torch.models.convert import (
    BACKBONE_IDX, convert_pt_file, convert_state_dict)


def _oihw(w):
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _conv_keys(sd, node, prefix):
    sd[f"{prefix}.conv.weight"] = _oihw(node["w"])
    for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
        sd[f"{prefix}.bn.{theirs}"] = np.asarray(node["bn"][ours])
    sd[f"{prefix}.bn.num_batches_tracked"] = np.asarray(7)


def ultralytics_state_dict(tree, prefix="model."):
    """The inverse of `convert_state_dict`: a JAX-layout YOLOv8 tree as an
    ultralytics DetectionModel / PoseModel state dict (with the DFL conv
    and BN counters the converter skips)."""
    sd = {}
    for idx, (group, name) in BACKBONE_IDX.items():
        node, mp = tree[group][name], f"{prefix}{idx}"
        if name.startswith(("stem", "down")):
            _conv_keys(sd, node, mp)
        else:
            _conv_keys(sd, node["cv1"], f"{mp}.cv1")
            _conv_keys(sd, node["cv2"], f"{mp}.cv2")
            for i, m in enumerate(node.get("m", [])):
                _conv_keys(sd, m["cv1"], f"{mp}.m.{i}.cv1")
                _conv_keys(sd, m["cv2"], f"{mp}.m.{i}.cv2")
    for theirs, ours in (("cv2", "reg"), ("cv3", "cls"), ("cv4", "kpt")):
        for lvl, br in enumerate(tree["head"].get(ours, [])):
            mp = f"{prefix}22.{theirs}.{lvl}"
            _conv_keys(sd, br["cv1"], f"{mp}.0")
            _conv_keys(sd, br["cv2"], f"{mp}.1")
            sd[f"{mp}.2.weight"] = _oihw(br["out"]["w"])
            sd[f"{mp}.2.bias"] = np.asarray(br["out"]["b"])
    sd[f"{prefix}22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    return sd


def torchvision_state_dict(tree):
    """The inverse of `convert_torchvision`: a MobileNetV3 tree as a
    torchvision mobilenet_v3_small state dict (with its classifier)."""
    sd = {}

    def conv_bn(node, prefix):
        sd[f"{prefix}.0.weight"] = _oihw(node["w"])
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.1.{theirs}"] = np.asarray(node["bn"][ours])

    conv_bn(tree["stem"], "features.0")
    for i, b in enumerate(tree["blocks"], start=1):
        j, base = 0, f"features.{i}.block"
        if "expand" in b:
            conv_bn(b["expand"], f"{base}.{j}")
            j += 1
        conv_bn(b["dw"], f"{base}.{j}")
        j += 1
        if "se" in b:
            for fc in ("fc1", "fc2"):
                sd[f"{base}.{j}.{fc}.weight"] = _oihw(b["se"][fc]["w"])
                sd[f"{base}.{j}.{fc}.bias"] = np.asarray(b["se"][fc]["b"])
            j += 1
        conv_bn(b["project"], f"{base}.{j}")
    conv_bn(tree["head"], "features.12")
    sd["classifier.0.weight"] = np.zeros((1024, 576), np.float32)
    return sd


def assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


CFGS = {"detect": P.YoloConfig("n", 2), "pose": P.YoloConfig("n", 1, 56)}


@pytest.fixture
def jax_template(monkeypatch):
    monkeypatch.setattr(JC, "init_params", lambda cfg, seed=0: P.init_params(
        P.YoloConfig(cfg.variant, cfg.num_classes, cfg.num_keypoints), seed=99))


@pytest.mark.parametrize("kind", ["detect", "pose"])
def test_convert_state_dict_matches_jax(kind, jax_template):
    cfg = CFGS[kind]
    tree = P.init_params(cfg, seed=4)
    for path, leaf in flatten_tree(tree).items():  # BN statistics off identity
        if path[-1] in ("mean", "var", "scale", "bias"):
            leaf[...] = np.random.default_rng(len(path)).uniform(0.5, 1.5, leaf.shape)
    sd = ultralytics_state_dict(tree)
    got = convert_state_dict(sd, cfg)
    assert_trees_equal(got, tree)
    from hockey_tpu.models.yolov8 import YoloConfig as JaxConfig

    want = JC.convert_state_dict(sd, JaxConfig("n", cfg.num_classes, cfg.num_keypoints))
    assert_trees_equal(got, want)
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    assert_trees_equal(convert_state_dict(tensors, cfg), tree)
    assert ("kpt" in got["head"]) == (kind == "pose")


@pytest.mark.parametrize("wrap", ["plain", "checkpoint"])
def test_convert_pt_file_reads_back_in_jax(wrap, tmp_path):
    cfg = CFGS["detect"]
    tree = P.init_params(cfg, seed=5)
    sd = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in ultralytics_state_dict(tree).items()}
    pt = str(tmp_path / "m.pt")
    torch.save(sd if wrap == "plain" else {"epoch": 3, "model": sd, "ema": None}, pt)
    out = str(tmp_path / "m.msgpack")
    assert_trees_equal(convert_pt_file(pt, cfg, out), tree)
    assert_trees_equal(jax_load_params(out), tree)


def test_pickled_module_needs_ultralytics(tmp_path):
    pt = str(tmp_path / "module.pt")
    torch.save(torch.nn.Conv2d(3, 4, 1), pt)
    with pytest.raises(RuntimeError, match="ultralytics"):
        convert_pt_file(pt, CFGS["detect"], str(tmp_path / "out.msgpack"))


def test_convert_torchvision_matches_jax(monkeypatch):
    shipped = PM.load_default_params()
    sd = torchvision_state_dict(shipped)
    got = PM.convert_torchvision(sd)
    assert_trees_equal(got, shipped)
    monkeypatch.setattr(JM, "init_params", lambda seed=0: PM.init_params(
        torch.Generator().manual_seed(seed)))
    want = JM.convert_torchvision(sd)
    assert_trees_equal(got, want)
    crops = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (5, 64, 32, 3)).astype(np.uint8))
    a = PM.embed(PM.build_embedder(got, "cpu"), crops)
    b = PM.embed(PM.build_embedder(shipped, "cpu"), crops)
    assert torch.equal(a, b)
