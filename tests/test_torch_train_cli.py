"""The port's train CLI (`python -m hockey_tpu_torch.train.loop`) on the
CPU at `--variant n --imgsz 64 --batch 2 --steps 3 --device cpu`, on tiny
pools in the `save_cache` format (tests/test_train_cli.py's counterpart):

- the host path with mosaic, mixup, EMA, precise-BN and `--val-every`:
  the checkpoint and its `.best` are read by the JAX `load_params` with
  arrays equal to the port's reading, hold the EMA weights (precise-BN
  replaces only the running statistics), and the port's val CLI scores
  the checkpoint;
- `--device-data` for the detector and the pose model (a rink pool), and
  the pose model on the host path;
- malformed `--dp`/`--fsdp` values raise, as do contradicting data
  flags, and the default `--device cuda` raises without CUDA (the mesh
  runs in tests/test_torch_sharding.py).
The rendered datasets' choices are in tests/test_torch_synthetic_data.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hockey_tpu.models.checkpoint import load_params as jax_load_params  # noqa: E402
from hockey_tpu.train.data import SyntheticRinkDataset  # noqa: E402
from hockey_tpu_torch.models import yolov8 as P  # noqa: E402
from hockey_tpu_torch.models.checkpoint import flatten_tree, load_params  # noqa: E402
from hockey_tpu_torch.train import loop  # noqa: E402
from hockey_tpu_torch.train import val as tval  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import render_val_set  # noqa: E402

S = 64
SMALL = ["--variant", "n", "--imgsz", str(S), "--batch", "2", "--steps", "3",
         "--log-every", "1", "--save-every", "0", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def write_rect_pool(path, n, seed):
    """A pool in the `save_cache` format: n noise images with 2-4 filled
    rectangles each (10-30 px; the hard scenes' players are a few px at
    64 and most 64-px scenes hold none), classes 0 and 1."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 90, (n, S, S, 3)).astype(np.uint8)
    boxes = np.zeros((n, 4, 4), np.float32)
    classes = np.zeros((n, 4), np.int32)
    counts = rng.integers(2, 5, n).astype(np.int32)
    for i in range(n):
        for j in range(counts[i]):
            x, y = rng.integers(0, S - 30, 2)
            w, h = rng.integers(10, 30, 2)
            classes[i, j] = j % 2
            images[i, y:y + h, x:x + w] = (200, 60 + 150 * (j % 2), 30)
            boxes[i, j] = (x, y, x + w, y + h)
    np.savez(path, images=images, boxes=boxes, classes=classes, counts=counts)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("pools")
    write_rect_pool(str(d / "train.npz"), 8, 3)
    write_rect_pool(str(d / "val.npz"), 6, 4)
    render_val_set.write(str(d / "rink.npz"), render_val_set.pool_arrays(
        SyntheticRinkDataset(imgsz=S, seed=5), 6), "rink", 5, "a")
    return d


def _finite(history, keys=("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm")):
    assert len(history) == 3
    for m in history:
        assert m["skipped"] == 0.0
        for k in keys:
            assert np.isfinite(m[k]), (k, m)


def test_host_path_checkpoint_round_trip(pools, tmp_path, monkeypatch):
    out = str(tmp_path / "m.msgpack")
    run = loop.run(SMALL + ["--pool-file", str(pools / "train.npz"), "--out", out,
                            "--mosaic", "0.5", "--mixup", "0.2", "--ema", "0.999",
                            "--precise-bn", "2", "--val-every", "2",
                            "--val-pool-file", str(pools / "val.npz"), "--val-size", "4"])
    assert run.rc == 0
    _finite(run.history)
    assert [i for i, _ in run.val] == [2, 3] and run.best >= 0
    assert os.path.exists(out + ".best")
    for path in (out, out + ".best"):
        mine = flatten_tree(load_params(path))
        theirs = flatten_tree(jax_load_params(path))
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]))
    ema = flatten_tree(P.params_to_jax(run.trainer.ema.model))
    saved = flatten_tree(load_params(out))
    assert saved.keys() == ema.keys()
    for k in ema:
        if k[-1] in ("mean", "var"):  # precise-BN's statistics
            assert np.isfinite(saved[k]).all()
        else:
            np.testing.assert_array_equal(saved[k], ema[k])
    # the port's val CLI reads the checkpoint (its --variant edits the zoo)
    monkeypatch.setitem(P.MODEL_ZOO, "hockey-player-detection",
                        P.MODEL_ZOO["hockey-player-detection"])
    assert tval.main(["--checkpoint", out, "--pool", str(pools / "val.npz"),
                      "--variant", "n", "--imgsz", str(S), "--limit", "4",
                      "--json", "--device", "cpu"]) == 0


@pytest.mark.parametrize("model,pool,extra", [
    ("hockey-player-detection", "train.npz",
     ["--device-data", "--mosaic", "1.0", "--mixup", "0.5", "--ema", "0.999"]),
    ("hockey-detection", "rink.npz", ["--device-data"]),
    ("hockey-detection", "rink.npz", []),
])
def test_paths_train(pools, tmp_path, model, pool, extra):
    run = loop.run(SMALL + ["--model", model, "--pool-file", str(pools / pool),
                            "--out", str(tmp_path / "m.msgpack"),
                            "--precise-bn", "1"] + extra)
    assert run.rc == 0
    pose = model == "hockey-detection"
    _finite(run.history, ("loss", "kpt_loss", "kobj_loss") if pose else
            ("loss", "box_loss", "cls_loss", "dfl_loss"))
    assert all(m["num_fg"] > 0 for m in run.history)
    assert os.path.exists(tmp_path / "m.msgpack")


@pytest.mark.parametrize("argv,error,names", [
    # the first two ids are those of the cases from before the mesh was
    # ported, when --dp 2 and --fsdp 2 raised; they now run
    # (tests/test_torch_sharding.py) and malformed mesh flags raise
    pytest.param(["--fsdp", "0"], ValueError, "fsdp >= 1",
                 id="argv0-NotImplementedError-sharding.py"),
    pytest.param(["--dp", "-1"], ValueError, "dp >= 0",
                 id="argv1-NotImplementedError-mesh.py"),
    (["--images", "x"], ValueError, "--images or --pool-file"),
    (["--val-every", "5"], ValueError, "--val-pool-file"),
])
def test_unported_flags_raise(pools, argv, error, names):
    with pytest.raises(error, match=names):
        loop.main(SMALL + ["--pool-file", str(pools / "val.npz")] + argv)


def test_default_device_needs_cuda(pools, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.main([a for a in SMALL if a not in ("--device", "cpu")]
                  + ["--pool-file", str(pools / "val.npz")])
