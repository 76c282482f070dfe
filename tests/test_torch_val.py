"""The port's validation CLI (`python -m hockey_tpu_torch.train.val`)
against the JAX CLI (`python -m hockey_tpu.train.val`) on the CPU, with a
tiny random checkpoint (`--variant n --checkpoint`):

- detection on a YOLO directory the test writes (square images, whose
  labels are the JAX f32 detector's own detections moved by about 2 px,
  so the metrics are not 0);
- detection on a pool of scripts/render_val_set.py against the JAX CLI's
  `--dataset hard` renderer at the same size and seed;
- pose on a pool of rink views against the JAX CLI's pose branch
  (SyntheticRinkDataset at the same size and seed).

The JAX detectors are rebuilt at f32 on the BN-folded f32 weights (they
fold and cast to bf16 even on the CPU); the port runs its CPU default,
f32. The `--json` lines have the same keys, and the values agree within
METRIC_TOL (tests/test_torch_eval.py); the CLI raises without CUDA
unless given `--device cpu`, and for two data sources. The `--dataset`
renderers are in tests/test_torch_synthetic_data.py.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hockey_tpu.models import detector as jdet  # noqa: E402
from hockey_tpu.models import yolov8 as J  # noqa: E402
from hockey_tpu.models.checkpoint import save_params as jax_save_params  # noqa: E402
from hockey_tpu.models.layers import fuse_model as jax_fuse_model  # noqa: E402
from hockey_tpu.train import val as jval  # noqa: E402
from hockey_tpu.train.data import SyntheticRinkDataset  # noqa: E402
from hockey_tpu.train.scenes import HardSyntheticHockeyDataset  # noqa: E402
from hockey_tpu_torch.models import yolov8 as P  # noqa: E402
from hockey_tpu_torch.train import val as tval  # noqa: E402
from tests.test_torch_eval import METRIC_TOL, Items, _padded, assert_metrics_equal  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import render_val_set  # noqa: E402

S, SEED = 128, 21
PLAYER, RINK = "hockey-player-detection", "hockey-detection"
_JAX_BUILD = jdet.build_detect_fn


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


@pytest.fixture(autouse=True)
def f32_jax_and_zoos(monkeypatch):
    """The JAX detectors at f32 on f32 weights; both zoos restored after
    the CLIs' `--variant` overrides."""
    monkeypatch.setattr(jdet, "fuse_for_inference", jax_fuse_model)
    monkeypatch.setattr(jdet, "build_detect_fn",
                        lambda cfg, **kw: _JAX_BUILD(cfg, **kw, dtype=jnp.float32))
    for name in (PLAYER, RINK):
        monkeypatch.setitem(J.MODEL_ZOO, name, J.MODEL_ZOO[name])
        monkeypatch.setitem(P.MODEL_ZOO, name, P.MODEL_ZOO[name])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Tiny checkpoints, a YOLO directory of 10 square S-px scenes, and
    detection and rink pools (10 images each, seed SEED)."""
    d = tmp_path_factory.mktemp("val")
    pc = J.YoloConfig("n", num_classes=2)
    rc = J.YoloConfig("n", num_classes=1, num_keypoints=56)
    pp = J.init_params(pc, 0)
    jax_save_params(str(d / "p.msgpack"), pp)
    jax_save_params(str(d / "r.msgpack"), J.init_params(rc, 1))

    scenes = HardSyntheticHockeyDataset(imgsz=S, seed=SEED, pool_size=10)
    scenes.pregenerate(workers=2)
    render_val_set.write(str(d / "hard.npz"),
                         render_val_set.pool_arrays(scenes, 10), "hard", SEED, "a")
    rink = SyntheticRinkDataset(imgsz=S, seed=SEED)
    render_val_set.write(str(d / "rink.npz"),
                         render_val_set.pool_arrays(rink, 10), "rink", SEED, "a")

    items = [scenes.load(i) for i in range(10)]
    fn = _JAX_BUILD(pc, imgsz=S, frame_hw=(S, S), conf=0.001, dtype=jnp.float32)
    det = fn(jax_fuse_model(pp), jnp.asarray(_padded(items)))
    rng = np.random.default_rng(4)
    (d / "images").mkdir()
    (d / "labels").mkdir()
    for j, it in enumerate(items):
        cv2.imwrite(str(d / "images" / f"{j:02d}.png"),
                    (it["images"] * 255).astype(np.uint8))
        v = np.asarray(det.valid[j])
        boxes = np.asarray(det.boxes[j])[v][:6] + rng.normal(0, 2.0, (min(6, v.sum()), 4))
        boxes = np.clip(boxes, 0, S - 1) / S
        rows = [f"{c} {(x0 + x1) / 2} {(y0 + y1) / 2} {x1 - x0} {y1 - y0}"
                for c, (x0, y0, x1, y1) in zip(np.asarray(det.classes[j])[v], boxes)]
        (d / "labels" / f"{j:02d}.txt").write_text("\n".join(rows))
    return d


def _jax_cli(capsys, *argv):
    capsys.readouterr()
    assert jval.main(list(argv) + ["--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_cli(capsys, *argv):
    capsys.readouterr()
    assert tval.main(list(argv) + ["--json", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "images/s" in out.err
    return json.loads(out.out.strip().splitlines()[-1])


def test_cli_on_a_yolo_directory_matches_jax(files, capsys):
    common = ["--variant", "n", "--checkpoint", str(files / "p.msgpack"),
              "--imgsz", str(S), "--images", str(files / "images")]
    want = _jax_cli(capsys, *common)
    got = _port_cli(capsys, *common)
    assert_metrics_equal(got, want, METRIC_TOL)
    assert 0.2 < want["mAP50"] < 1.0


def test_cli_on_a_pool_matches_jax_renderer(files, capsys):
    common = ["--variant", "n", "--checkpoint", str(files / "p.msgpack"),
              "--imgsz", str(S), "--seed", str(SEED), "--limit", "10"]
    want = _jax_cli(capsys, *common, "--dataset", "hard")
    got = _port_cli(capsys, *common, "--pool", str(files / "hard.npz"))
    assert_metrics_equal(got, want, METRIC_TOL)
    assert set(want) >= {"mAP50", "mAP50_95", "precision", "recall", "AP50_class1"}


def test_pose_cli_on_a_pool_matches_jax(files, capsys):
    common = ["--model", RINK, "--variant", "n", "--checkpoint",
              str(files / "r.msgpack"), "--imgsz", str(S), "--seed", str(SEED),
              "--limit", "10"]
    want = _jax_cli(capsys, *common)
    got = _port_cli(capsys, *common, "--pool", str(files / "rink.npz"))
    assert got.keys() == want.keys() == {"mean_kpt_error_px", "pck"}
    assert got["pck"] == want["pck"]
    assert abs(got["mean_kpt_error_px"] - want["mean_kpt_error_px"]) <= 1e-3
    assert np.isfinite(want["mean_kpt_error_px"])


def test_cli_needs_cuda_a_dataset_and_the_pool_seed(files, capsys):
    pool = ["--pool", str(files / "hard.npz"), "--imgsz", str(S), "--variant",
            "n", "--checkpoint", str(files / "p.msgpack")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tval.main(pool)
    with pytest.raises(SystemExit, match="at most one"):
        tval.main(pool + ["--images", str(files), "--device", "cpu"])
    with pytest.raises(SystemExit, match="seed"):
        tval.main(pool + ["--device", "cpu", "--seed", str(SEED + 1)])
    with pytest.raises(SystemExit, match="px images"):
        tval.main(pool[:2] + ["--imgsz", "64", "--device", "cpu"])
    assert tval.build_parser().parse_args([]).device == "cuda"
