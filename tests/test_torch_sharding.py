"""Multi-device training and detection of the port (core/mesh.py,
parallel/sharding.py, the train CLI's --dp/--fsdp) on the CPU over gloo,
against the port's single-process step and the JAX package's mesh step.

- the mesh's layout against the JAX mesh's, its errors, `param_pspec`
  against the JAX rule leaf for leaf (YOLOv8n, fsdp 2 and 4), the CLI's
  mesh rule, the launcher's failure and timeout;
- a 1x1 mesh: `shard_train_step` bit for bit the single-device `Trainer`,
  `detect_dp` bit for bit the unsharded detect;
- 4 gloo processes (tests/torch_mesh_ranks.py, dp 2 x fsdp 2, YOLOv8n at
  64 px, f32, 2 steps on batches of 4 whose halves are unlike: the first
  dp rank's rows dark with one box each, the second's bright with four):
  loss within LOSS_REL (1e-5) relative of the single-process step's and
  the parameters within PARAM_REL (1e-4) of each leaf's largest value (at
  least 1); against JAX's `make_mesh(4, dp=2, fsdp=2)` step, the
  tolerances of tests/test_torch_train_step.py (the metrics within 1e-3
  relative, parameters 1e-4, momentum 5e-3 of scale); trainers that keep
  the BN statistics or the loss normalisers per rank miss the
  single-process loss by more than 100 x LOSS_REL; every rank holds the
  same parameters; `detect_dp` against the unsharded detect (valid and
  classes equal, boxes within 1e-3 px, scores within 1e-5: a frame's
  rounding depends on the batch it is in);
- the CLI at `--dp 2 --fsdp 2 --device cpu` (4 processes; with --ema,
  --device-data and the default precise-BN, which a mesh turns off)
  writes the checkpoint of `--dp 1 --precise-bn 0` within PARAM_REL.

Every spawn has a timeout, so a hung rank fails its test.
"""

import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from hockey_tpu.core.mesh import make_mesh as jax_make_mesh
from hockey_tpu.models.yolov8 import YoloConfig as JYoloConfig
from hockey_tpu.parallel import sharding as JS
from hockey_tpu.train import trainer as J
from hockey_tpu_torch.core import mesh as M
from hockey_tpu_torch.models.checkpoint import flatten_tree, load_params
from hockey_tpu_torch.models.detector import DetectCore
from hockey_tpu_torch.models.layers import fuse_for_inference
from hockey_tpu_torch.models.yolov8 import build_model, init_params, params_to_jax
from hockey_tpu_torch.parallel import sharding as S
from hockey_tpu_torch.train import loop
from hockey_tpu_torch.train import trainer as T
from tests.test_torch_train_step import MOMENTUM_REL, REL, _check_metrics, _jax_trace
from tests.torch_mesh_ranks import CFG, DETECT, KEYS, TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JYoloConfig("n", num_classes=2)
LOSS_REL, PARAM_REL = 1e-5, 1e-4
RANK_TIMEOUT = 300  # s, for each spawn of processes


def unlike_batch(rng, b=4, m=6):
    """A batch whose dp halves differ: rows [0, b/2) dark with one small
    box each, rows [b/2, b) bright with four large ones (whose target
    scores sum to more than the normaliser's floor of 1 at the first
    step)."""
    images = np.empty((b, 64, 64, 3), np.float32)
    boxes = np.zeros((b, m, 4), np.float32)
    classes = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        bright = i >= b // 2
        images[i] = rng.uniform(0.55, 0.95, (64, 64, 3)) if bright \
            else rng.uniform(0.0, 0.15, (64, 64, 3))
        for j in range(4 if bright else 1):
            w, h = rng.integers(30, 60, 2) if bright else rng.integers(8, 16, 2)
            x, y = rng.integers(1, 64 - w), rng.integers(1, 64 - h)
            boxes[i, j] = [x, y, x + w, y + h]
            classes[i, j] = j % 2
            mask[i, j] = True
            images[i, y:y + h, x:x + w] = [0.9 - 0.8 * bright, 0.5, 0.2 + 0.6 * (j % 2)]
    return {"images": images, "boxes": boxes, "classes": classes, "mask": mask}


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(5)
    return [unlike_batch(rng) for _ in range(2)]


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(6).integers(0, 255, (8, 48, 96, 3), dtype=np.uint8)


COMMON = ["--variant", "n", "--imgsz", "64", "--batch", "4", "--steps", "2",
          "--warmup", "1", "--log-every", "1", "--save-every", "0",
          "--device", "cpu", "--seed", "3"]


def _run_ranks(batches, frames, d):
    """The 4-process gloo mesh of tests/torch_mesh_ranks.py: its outputs."""
    inp, out = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, frames=frames,
             **{f"{i}/{k}": b[k] for i, b in enumerate(batches) for k in KEYS})
    rc = M.launch(["-m", "tests.torch_mesh_ranks", inp, out], 4, "cpu",
                  timeout=RANK_TIMEOUT)
    assert rc == 0, f"a rank failed ({rc})"
    with np.load(out) as f:
        return dict(f)


def _run_cli(out):
    """The train CLI on a 2x2 mesh of CPU processes: (return code, log)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "hockey_tpu_torch.train.loop", *COMMON, "--dp", "2",
         "--fsdp", "2", "--ema", "0.999", "--device-data", "--out", out],
        cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the ranks too
        proc.communicate()
        return 124, "the mesh CLI run timed out"
    return proc.returncode, log


@pytest.fixture(scope="module", autouse=True)
def spawned(batches, frames, tmp_path_factory):
    """The two multi-process runs, started with the module so that they
    overlap the JAX compilation, each rank on one thread; each run has its
    own timeout."""
    d = tmp_path_factory.mktemp("mesh")
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(2) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield {"ranks": pool.submit(_run_ranks, batches, frames, d),
               "cli": pool.submit(_run_cli, str(d / "mesh.msgpack")),
               "cli_out": str(d / "mesh.msgpack")}


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned["ranks"].result()


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def single(batches):
    """The port's single-process step on the whole batches: (trainer, each
    step's metrics)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = T.Trainer(CFG, T.TrainConfig(**TC), build_model(CFG, init_params(CFG, seed=0)))
        ms = [{k: float(v) for k, v in tr.step(_torch(b)).items()} for b in batches]
    finally:
        torch.set_num_threads(n)
    return tr, ms


@pytest.fixture(scope="module")
def jax_mesh(batches):
    """JAX's dp 2 x fsdp 2 step from the same weights: (params, optimizer
    state, each step's metrics)."""
    tc = J.TrainConfig(**TC)
    opt = J.make_optimizer(tc)
    mesh = jax_make_mesh(4, dp=2, fsdp=2)
    ms, step = [], None
    with mesh:
        ps = JS.shard_params(mesh, jax.tree_util.tree_map(
            jnp.asarray, init_params(CFG, seed=0)))
        # the step's count replicated, as the step returns it: one compile
        st = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())) if x.ndim == 0
            else x, opt.init(ps))
        for b in batches:
            bs = JS.shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()})
            if step is None:
                step = JS.jit_train_step(J.make_train_step(JCFG, tc, opt), mesh,
                                         ps, st, bs)
            ps, st, m = step(ps, st, bs)
            ms.append(m)
    return ps, st, ms


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _rank_tree(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


# --------------------------------------------------------------------------
# the mesh, the leaf rule, the CLI's rule, the launcher

@pytest.mark.parametrize("dp,fsdp", [(2, 2), (4, 2), (8, 1), (1, 4)])
def test_mesh_layout_matches_jax(dp, fsdp):
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(dp * fsdp, dp=dp, fsdp=fsdp).devices)
    dp_groups, fsdp_groups = M.mesh_layout(dp, fsdp)
    assert fsdp_groups == ids.tolist()  # a dp row: the ranks sharing the rows
    assert dp_groups == ids.T.tolist()


def test_make_mesh_errors_and_the_trivial_mesh():
    with pytest.raises(ValueError) as want:
        jax_make_mesh(4, dp=3, fsdp=1)
    with pytest.raises(ValueError) as got:
        M.make_mesh(4, dp=3, fsdp=1)
    assert str(got.value) == str(want.value) == "dp(3) * fsdp(1) != n_devices(4)"
    with pytest.raises(ValueError, match="needs as many processes"):
        M.make_mesh(2, dp=2)  # no process group: one process
    mesh = M.make_mesh(1, device="cpu")
    assert (mesh.shape, mesh.coords, mesh.dp_group, mesh.fsdp_group) == (
        {"dp": 1, "fsdp": 1}, (0, 0), None, None)
    x = np.arange(6).reshape(3, 2)
    assert M.batch_sharding(mesh, 3) == slice(0, 3)
    assert torch.equal(M.shard_batch(mesh, x), torch.as_tensor(x))
    two = M.Mesh(2, 2, rank=3, device=torch.device("cpu"))
    assert two.coords == (1, 1) and M.batch_sharding(two, 6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        M.batch_sharding(two, 5)


@pytest.mark.parametrize("fsdp", [2, 4])
def test_param_pspec_matches_jax(fsdp):
    tree = init_params(CFG, seed=0)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            JS.param_pspec(path, leaf, fsdp)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    state = build_model(CFG, tree).state_dict()
    assert {n.replace(".", "/") for n in state} == set(want)
    sharded = 0
    for name, t in state.items():
        w, g = want[name.replace(".", "/")], S.param_pspec(name, t, fsdp)
        assert len(g) == (len(w) and t.dim()), name
        if w:  # JAX shards the last (output-channel) axis, the port dim 0
            assert tuple(w) == (None,) * (t.dim() - 1) + ("fsdp",), name
            assert g == ("fsdp",) + (None,) * (t.dim() - 1), name
            sharded += 1
    assert 0 < sharded < len(state)


@pytest.mark.parametrize("argv,device,world,want", [
    ([], "cpu", None, (1, 1, False)),
    (["--dp", "2", "--fsdp", "2", "--batch", "4"], "cpu", None, (4, 2, True)),
    (["--fsdp", "2"], "cpu", None, (2, 1, True)),
    (["--dp", "3", "--batch", "4"], "cpu", None, (3, 2, True)),  # shrunk to divide 4
    (["--dp", "1"], "cpu", None, (1, 1, False)),
    ([], "cpu", "4", (4, 4, True)),            # torchrun: its processes
    (["--batch", "6"], "cpu", "4", (4, 3, True)),
])
def test_mesh_plan_is_the_jax_rule(monkeypatch, argv, device, world, want):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if world:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", world)
    args = loop.build_parser().parse_args(argv)
    assert loop.mesh_plan(args, device) == want


def test_mesh_plan_on_cards(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert loop.mesh_plan(loop.build_parser().parse_args([]), "cuda") == (1, 1, False)
    # one device: no mesh, whatever --dp says (the JAX rule)
    assert loop.mesh_plan(loop.build_parser().parse_args(["--dp", "2"]), "cuda") \
        == (1, 2, False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 4 devices, 2 visible"):
        loop.mesh_plan(loop.build_parser().parse_args(["--dp", "4"]), "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert loop.mesh_plan(loop.build_parser().parse_args(["--fsdp", "2"]), "cuda") \
        == (4, 2, True)


def test_launch_stops_the_ranks():
    fail = ("import os, sys, time\n"
            "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(120)")
    assert M.launch(["-c", fail], 3, "cpu", timeout=60) == 3
    assert M.launch(["-c", "import time; time.sleep(120)"], 2, "cpu", timeout=2) == 124
    env = ("import os, sys; sys.exit(0 if (os.environ['OMP_NUM_THREADS'], "
           "os.environ['WORLD_SIZE']) == ('1', '2') else 5)")
    assert M.launch(["-c", env], 2, "cpu", timeout=60) == 0


# --------------------------------------------------------------------------
# a 1x1 mesh is the unsharded program

def test_one_by_one_mesh_is_the_trainer(batches, single):
    tr, ms = single
    mesh = M.make_mesh(1, device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sh = S.shard_train_step(mesh, CFG, T.TrainConfig(**TC),
                                build_model(CFG, init_params(CFG, seed=0)))
        got = [{k: float(v) for k, v in sh.step(M.shard_batch(mesh, b)).items()}
               for b in batches]
    finally:
        torch.set_num_threads(n)
    assert got == ms
    want = flatten_tree(params_to_jax(tr.model))
    for k, v in flatten_tree(S.gather_params(sh)).items():
        np.testing.assert_array_equal(v, want[k], err_msg="/".join(k))
    mom = tr.momentum()
    assert sh.momentum().keys() == mom.keys()
    for k, v in sh.momentum().items():
        assert torch.equal(v, mom[k]), k


def _detector():
    model = fuse_for_inference(build_model(CFG, init_params(CFG, seed=0)), torch.float32)
    core = DetectCore(CFG, **DETECT)

    def detect(fr):
        with torch.inference_mode():
            return core(model, torch.as_tensor(fr))

    return detect


def test_one_by_one_detect_dp_is_the_detect(frames):
    detect = _detector()
    got = S.detect_dp(detect, M.make_mesh(1, device="cpu"))(frames)
    want = detect(frames)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# --------------------------------------------------------------------------
# dp 2 x fsdp 2 on 4 gloo processes

def test_sharded_step_matches_single_process(ranks, single):
    tr, ms = single
    for i, want in enumerate(ms):
        got = {k: ranks[f"step{i}/{k}"] for k in want}
        for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_REL, err_msg=k)
        assert (got["num_fg"], got["skipped"]) == (want["num_fg"], 0.0)
    want = _flat(params_to_jax(tr.model))
    got = _rank_tree(ranks, "params")
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], PARAM_REL, k)
    mom = {n.replace(".", "/"): v.numpy() for n, v in tr.momentum().items()}
    got = _rank_tree(ranks, "momentum")
    assert got.keys() == mom.keys()
    for k in mom:
        _close(got[k], mom[k], PARAM_REL, k)


def test_sharded_step_matches_jax_mesh(ranks, jax_mesh):
    params, opt_state, ms = jax_mesh
    for i, want in enumerate(ms):
        got = {k: ranks[f"step{i}/{k}"] for k in
               ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm",
                "num_fg", "skipped")}
        _check_metrics(got, want)
    got = _rank_tree(ranks, "params")
    want = _flat(params)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], REL, k)
    trace = _flat(_jax_trace(opt_state))
    for k, v in _rank_tree(ranks, "momentum").items():
        hwio = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
        _close(hwio, trace[k], MOMENTUM_REL, k)


def test_unlike_halves_defeat_per_rank_quantities(ranks, single):
    """The batch tells sync-BN and global normalisers from per-rank ones:
    a trainer keeping either per rank misses the single-process loss by
    far more than the synced one's tolerance."""
    want = single[1][0]["loss"]
    assert abs(ranks["step0/loss"] - want) <= LOSS_REL * abs(want)
    for name in ("local_stats", "local_norm"):
        assert abs(ranks[f"{name}/loss"] - want) > 100 * LOSS_REL * abs(want), name


def test_ranks_hold_one_model(ranks):
    assert ranks["rank_param_diff"] == 0.0
    np.testing.assert_array_equal(ranks["coords"],
                                  [[0, 0, 0], [1, 0, 1], [2, 1, 0], [3, 1, 1]])


def test_detect_dp_matches_unsharded(ranks, frames):
    want = _detector()(frames)
    np.testing.assert_array_equal(ranks["detect/valid"], want.valid.numpy())
    np.testing.assert_array_equal(ranks["detect/classes"], want.classes.numpy())
    np.testing.assert_allclose(ranks["detect/boxes"], want.boxes.numpy(), atol=1e-3)
    np.testing.assert_allclose(ranks["detect/scores"], want.scores.numpy(), atol=1e-5)
    assert want.valid.any()


# --------------------------------------------------------------------------
# the CLI

def test_cli_mesh_writes_the_single_device_checkpoint(spawned, tmp_path):
    rc, log = spawned["cli"].result()
    assert rc == 0, log
    assert "starting 4 processes on cpu" in log and "'dp': 2, 'fsdp': 2" in log
    assert "--ema is single-device only" in log
    assert "--device-data is single-device only" in log
    assert log.count("saved ") == 1 and log.count("step      1 loss") == 1  # rank 0 alone
    one_out = str(tmp_path / "one.msgpack")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert loop.main(COMMON + ["--dp", "1", "--precise-bn", "0", "--out", one_out]) == 0
    finally:
        torch.set_num_threads(n)
    got = flatten_tree(load_params(spawned["cli_out"]))
    want = flatten_tree(load_params(one_out))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], PARAM_REL, "/".join(k))
