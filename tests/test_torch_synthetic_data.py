"""The synthetic datasets of the port (hockey_tpu_torch/train/data.py)
against the JAX package's (hockey_tpu/train/data.py) on the CPU:

- `fill_rectangle` and `fill_circle` equal cv2.rectangle and cv2.circle
  (filled, 8-connected) on every radius `SyntheticHockeyDataset` draws at
  imgsz up to 1280 (w // 4 with w < 1280 // 4), centres inside, on the
  edges and outside the image;
- `SyntheticHockeyDataset` in a process where cv2 cannot be imported
  equals the JAX dataset drawn with cv2, bit for bit, at 64, 640 and
  1280 px;
- `SyntheticRinkDataset`, sterile and rich, bit for bit;
- the train CLI's default (no data flag), `--dataset synthetic` with
  `--device-data`, and the pose model's default, sterile and rich, with
  `--val-every`, for two steps;
- the val CLI's default (`--dataset synthetic`, 50 images at most) and
  the pose model's sterile and `rink-rich` sets against the JAX CLI
  rebuilt at f32.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from hockey_tpu.train import data as JD  # noqa: E402
from hockey_tpu_torch.train import data as PD  # noqa: E402
from hockey_tpu_torch.train import loop  # noqa: E402
from tests.test_torch_imports import _PRELUDE, ROOT  # noqa: E402
from tests.test_torch_scenes import (  # noqa: E402,F401
    _one_thread, assert_same, check_val_dataset, f32_jax_and_zoos, player_ckpt,
    val_argv)
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401


def test_fill_shapes_equal_cv2():
    rng = np.random.default_rng(0)
    for s in (64, 97):
        for r in range(0, 80):
            centres = [(s // 2, s // 2), (2, 3), (s - 1, s // 3), (-5, 10),
                       (s + 4, s // 2), (10, -6), (s // 2, s + 3), (-90, -90)]
            for c in centres:
                colour = tuple(int(v) for v in rng.integers(0, 256, 3))
                want = np.full((s, s + 5, 3), 7, np.uint8)
                got = want.copy()
                cv2.circle(want, c, r, colour, -1)
                PD.fill_circle(got, c, r, colour)
                np.testing.assert_array_equal(got, want, err_msg=f"{s} {c} {r}")
        for p1, p2 in (((3, 4), (50, 60)), ((-5, -3), (s + 5, 10)), ((20, 30), (10, 5)),
                       ((-9, -9), (-3, -4)), ((s + 2, 2), (s + 9, 9)), ((0, 0), (s - 1, s - 1))):
            want = np.zeros((s, s, 3), np.uint8)
            got = want.copy()
            cv2.rectangle(want, p1, p2, (1, 2, 3), -1)
            PD.fill_rectangle(got, p1, p2, (1, 2, 3))
            np.testing.assert_array_equal(got, want, err_msg=f"{s} {p1} {p2}")


_DRAW_WITHOUT_CV2 = """
import numpy as np
from hockey_tpu_torch.train.data import SyntheticHockeyDataset
out = {}
for s in (64, 640, 1280):
    ds = SyntheticHockeyDataset(imgsz=s, seed=3)
    for i in range(3):
        for k, v in ds.load(i).items():
            out[f"{s}_{i}_{k}"] = v
np.savez(sys.argv[3], **out)
print(len(out))
"""


def test_synthetic_hockey_dataset_without_cv2_equals_jax(tmp_path):
    path = str(tmp_path / "drawn.npz")
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _DRAW_WITHOUT_CV2
         + "\nassert 'cv2' not in sys.modules\n", "cv2,jax,hockey_tpu", ROOT, path],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    drawn = np.load(path)
    for s in (64, 640, 1280):
        ds = JD.SyntheticHockeyDataset(imgsz=s, seed=3)
        for i in range(3):
            for k, v in ds.load(i).items():
                got = drawn[f"{s}_{i}_{k}"]
                assert got.dtype == v.dtype
                np.testing.assert_array_equal(got, v)
    assert len(PD.SyntheticHockeyDataset()) == 1 << 30


@pytest.mark.parametrize("rich", [False, True])
def test_synthetic_rink_dataset_equals_jax(rich):
    mine = PD.SyntheticRinkDataset(imgsz=128, seed=2, rich=rich)
    theirs = JD.SyntheticRinkDataset(imgsz=128, seed=2, rich=rich)
    for i in range(6):
        assert_same(mine.load(i), theirs.load(i))


TRAIN = ["--variant", "n", "--imgsz", "64", "--batch", "2", "--steps", "2",
         "--pool", "4", "--val-size", "2", "--precise-bn", "1", "--log-every", "1",
         "--save-every", "0", "--device", "cpu"]


@pytest.mark.parametrize("extra,source", [
    ([], "synthetic (no --images given)"),
    (["--dataset", "synthetic", "--device-data"], "staging the pool (4 scenes)"),
    (["--model", "hockey-detection", "--val-every", "2"], "rich=False"),
    (["--model", "hockey-detection", "--domain-rand", "--val-every", "2"], "rich=True"),
])
def test_train_cli_synthetic_choices(extra, source, tmp_path, capsys):
    run = loop.run(TRAIN + extra + ["--out", str(tmp_path / "m.msgpack")])
    assert run.rc == 0 and len(run.history) == 2
    assert all(np.isfinite(m["loss"]) for m in run.history)
    assert source in capsys.readouterr().out
    assert os.path.exists(tmp_path / "m.msgpack")
    if "--val-every" in extra:  # the held-out rink views at seed + 7777
        assert [i for i, _ in run.val] == [2] and "pck" in run.val[0][1]


@pytest.mark.parametrize("dataset,model", [
    ("synthetic", "hockey-player-detection"), ("synthetic", "hockey-detection"),
    ("rink-rich", "hockey-detection")])
def test_val_cli_synthetic_matches_jax(player_ckpt, dataset, model, capsys):
    if model == "hockey-detection":  # the shipped rink pose model
        argv = ["--model", model, "--imgsz", "256", "--limit", "8"]
        jax_ds = JD.SyntheticRinkDataset(imgsz=256, seed=7777 + 7777 * (dataset == "rink-rich"),
                                         rich=dataset == "rink-rich")
    else:
        argv = val_argv(dataset, player_ckpt)
        jax_ds = JD.SyntheticHockeyDataset(imgsz=128, seed=0)
    if dataset != "synthetic":
        argv += ["--dataset", dataset]
    else:  # the default
        argv = [a for a in argv if a not in ("--dataset", "synthetic")]
    want = check_val_dataset(argv, jax_ds, capsys)
    if model == "hockey-detection":
        assert want["pck"] > 0.2
