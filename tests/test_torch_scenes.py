"""Generator A of the port (hockey_tpu_torch/train/scenes.py) against the
JAX package's (hockey_tpu/train/scenes.py) on the CPU, bit for bit:

- `render_scene` at 160 px on three seeds, players and pucks, legacy and
  domain-randomised styles (images, boxes, classes), and `sample_style`;
- `render_scene_sequence` with its puck, square and wide;
- `HardSyntheticHockeyDataset`: a pool rendered by worker threads equals
  the JAX pool and the port's own scenes rendered one by one in another
  order; `load` with a flip and the HSV jitter; the pool cache in both
  directions and through `PoolDataset`; the cache file's name is the
  port's own;
- the train CLI's rendered choices (`--dataset hard`, `hard-puck`, `auto`
  with `--val-every`, `--domain-rand`) for two steps, the second run
  reading the first's cache, and the val CLI's `--dataset hard` and
  `hard-puck` against the JAX CLI rebuilt at f32 (tests/test_torch_val.py).
"""

import os
import tempfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from hockey_tpu.train import scenes as JA  # noqa: E402
from hockey_tpu_torch.models import yolov8 as P  # noqa: E402
from hockey_tpu_torch.models.checkpoint import save_params  # noqa: E402
from hockey_tpu_torch.train import loop  # noqa: E402
from hockey_tpu_torch.train import scenes as PA  # noqa: E402
from hockey_tpu_torch.train.data import PoolDataset  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401
# the JAX detectors at f32 on f32 weights (autouse), and the two CLIs
from tests.test_torch_val import (  # noqa: E402,F401
    METRIC_TOL, _jax_cli, _port_cli, assert_metrics_equal, f32_jax_and_zoos)

S = 160


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pucks,domain_rand", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_render_scene_bit_equal(pucks, domain_rand):
    for seed in (0, 1, 2):
        want = JA.render_scene(np.random.default_rng(seed), S, pucks=pucks,
                               domain_rand=domain_rand)
        got = PA.render_scene(np.random.default_rng(seed), S, pucks=pucks,
                              domain_rand=domain_rand)
        assert_same(got, want)
        assert got[0].shape == (S, S, 3) and got[0].dtype == np.uint8
    rng_j, rng_p = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        assert_same(PA.sample_style(rng_p), JA.sample_style(rng_j))


@pytest.mark.parametrize("width", [None, 224])
def test_render_scene_sequence_bit_equal(width):
    kw = dict(s=S, n_frames=4, include_puck=True, width=width)
    assert_same(PA.render_scene_sequence(np.random.default_rng(3), **kw),
                JA.render_scene_sequence(np.random.default_rng(3), **kw))


@pytest.fixture(scope="module")
def pools():
    """The port's and the JAX package's 6-scene pools at 128 px, seed 4,
    both with pucks and without."""
    out = {}
    for pucks in (False, True):
        mine = PA.HardSyntheticHockeyDataset(imgsz=128, seed=4, pool_size=6, pucks=pucks)
        theirs = JA.HardSyntheticHockeyDataset(imgsz=128, seed=4, pool_size=6, pucks=pucks)
        mine.pregenerate(workers=3)
        theirs.pregenerate(workers=2)
        out[pucks] = (mine, theirs)
    return out


@pytest.mark.parametrize("pucks", [False, True])
def test_pool_equals_jax_and_does_not_depend_on_the_worker(pools, pucks):
    mine, theirs = pools[pucks]
    alone = PA.HardSyntheticHockeyDataset(imgsz=128, seed=4, pool_size=6, pucks=pucks)
    for i in (5, 2, 0, 3, 1, 4):  # one by one, another order, no threads
        assert_same(alone._scene(i), mine._scene(i))
    for i in range(6):
        assert_same(mine._scene(i), theirs._scene(i))
        assert_same(mine.load(i), theirs.load(i))
    rng_p, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    for i in range(6):
        assert_same(mine.load(i, hsv_jitter=rng_p, flip=bool(i % 2)),
                    theirs.load(i, hsv_jitter=rng_j, flip=bool(i % 2)))


def test_pool_cache_both_ways(pools, tmp_path):
    mine, theirs = pools[False]
    mine.save_cache(str(tmp_path / "port.npz"))
    theirs.save_cache(str(tmp_path / "jax.npz"))
    a, b = (np.load(str(tmp_path / f)) for f in ("port.npz", "jax.npz"))
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # a cache the JAX package wrote loads in the port, and the reverse
    got = PA.HardSyntheticHockeyDataset(imgsz=128, seed=4, pool_size=6)
    assert got.load_cache(str(tmp_path / "jax.npz"))
    back = JA.HardSyntheticHockeyDataset(imgsz=128, seed=4, pool_size=6)
    assert back.load_cache(str(tmp_path / "port.npz"))
    pool = PoolDataset(str(tmp_path / "port.npz"))
    for i in range(6):
        assert_same(got.load(i), mine.load(i))
        assert_same(back.load(i), mine.load(i))
        assert_same(pool.load(i), mine.load(i))
    assert not got.load_cache(str(tmp_path / "absent.npz"))
    assert not PA.HardSyntheticHockeyDataset(imgsz=128, pool_size=5).load_cache(
        str(tmp_path / "port.npz"))  # another pool size


def test_cache_name_is_the_ports_own():
    path = loop.scene_cache_path(640, 2000, 0, False, True)
    assert os.path.dirname(path) == tempfile.gettempdir()
    name = os.path.basename(path)
    assert name.startswith("hockey_tpu_torch_scenes_v") and name.endswith("_dr.npz")
    jax_name = (f"hockey_scenes_v{JA.RENDERER_VERSION}_640_2000_0_0_dr.npz")
    assert name != jax_name and PA.RENDERER_VERSION == JA.RENDERER_VERSION


TRAIN = ["--variant", "n", "--imgsz", "64", "--batch", "2", "--steps", "2",
         "--pool", "4", "--val-size", "2", "--precise-bn", "1", "--log-every", "1",
         "--save-every", "0", "--device", "cpu"]


@pytest.mark.parametrize("extra", [["--dataset", "hard"], ["--dataset", "hard-puck"],
                                   ["--val-every", "2"],
                                   ["--dataset", "hard", "--domain-rand"]])
def test_train_cli_rendered_choices(extra, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = TRAIN + extra + ["--out", str(tmp_path / "m.msgpack")]
    run = loop.run(argv)
    assert run.rc == 0 and len(run.history) == 2
    assert all(np.isfinite(m["loss"]) for m in run.history)
    if "--val-every" in extra:  # auto with --val-every: generator A, held out
        assert [i for i, _ in run.val] == [2]
    pucks = "hard-puck" in extra
    cache = loop.scene_cache_path(64, 4, 0, pucks, "--domain-rand" in extra)
    assert os.path.exists(cache)
    assert "pre-rendered 4+2 scenes" in capsys.readouterr().out
    assert loop.run(argv).rc == 0  # the second run reads the cache
    assert f"loaded scene pool from {cache}" in capsys.readouterr().out


@pytest.fixture(scope="module")
def player_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "p.msgpack")
    save_params(path, P.init_params(P.YoloConfig("n", 2), seed=3))
    return path


def val_argv(dataset, player_ckpt):
    """A tiny random player checkpoint at 128 px for the player sets (its
    metrics are 0, so the sets' items are compared too), the shipped puck
    model at 256 for the puck sets (metrics above 0)."""
    if "puck" in dataset:
        return ["--model", "hockey-puck-detection", "--imgsz", "256",
                "--limit", "8", "--dataset", dataset]
    return ["--variant", "n", "--checkpoint", player_ckpt, "--imgsz", "128",
            "--limit", "8", "--dataset", dataset]


def check_val_dataset(argv, jax_dataset, capsys):
    """The port's CLI opens the set the JAX CLI renders, item for item,
    and scores it as the JAX CLI (f32) does; returns the JAX metrics."""
    from hockey_tpu_torch.train import val as tval

    args = tval.build_parser().parse_args(argv)
    pose = bool(P.MODEL_ZOO[args.model].num_keypoints)
    ds, n = tval.open_dataset(args, pose)
    assert n == min(args.limit, 50 if args.dataset == "synthetic" else args.limit)
    for i in range(n):
        assert_same(ds.load(i), jax_dataset.load(i))
    want = _jax_cli(capsys, *argv)
    got = _port_cli(capsys, *argv)
    assert got.keys() == want.keys()
    if pose:
        assert got["pck"] == want["pck"]
        assert abs(got["mean_kpt_error_px"] - want["mean_kpt_error_px"]) <= 1e-3
    else:
        assert_metrics_equal(got, want, METRIC_TOL)
    return want


@pytest.mark.parametrize("dataset", ["hard", "hard-puck"])
def test_val_cli_dataset_matches_jax(player_ckpt, dataset, capsys):
    argv = val_argv(dataset, player_ckpt)
    s = int(argv[argv.index("--imgsz") + 1])
    jax_ds = JA.HardSyntheticHockeyDataset(imgsz=s, seed=7777, pool_size=8,
                                           pucks=dataset == "hard-puck")
    want = check_val_dataset(argv, jax_ds, capsys)
    if dataset == "hard-puck":
        assert want["mAP50"] > 0.2
