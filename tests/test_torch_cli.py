"""The rest of the port's serving entry points on the CPU: the model and
annotation managers (mirroring tests/test_manager.py), `prefetched`,
`device_trace`, and the CLI's `--sources`, `--save-state` / `--resume`,
`--json-metrics` (the JAX CLI's keys on the same clip) and `--profile`,
with stub detectors in both packages.
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import hockey_tpu.cli.main as jax_cli  # noqa: E402
import hockey_tpu.pipeline as jax_pipeline  # noqa: E402
import hockey_tpu_torch.cli.main as cli  # noqa: E402
import hockey_tpu_torch.multiclip as multiclip  # noqa: E402
import hockey_tpu_torch.pipeline as pipeline  # noqa: E402
from hockey_tpu_torch.annotate.manager import AnnotationManager  # noqa: E402
from hockey_tpu_torch.core.config import Config  # noqa: E402
from hockey_tpu_torch.models.manager import ModelManager  # noqa: E402
from hockey_tpu_torch.utils.profiling import annotate, device_trace  # noqa: E402
from hockey_tpu_torch.video.io import prefetched  # noqa: E402
from tests.test_pipeline import H, W, StubDetector, make_frame  # noqa: E402
from tests.test_torch_multiclip import PortMultiStubDetector  # noqa: E402
from tests.test_torch_session import (  # noqa: E402, F401
    PortStubDetector,
    one_torch_thread,
)


@pytest.fixture(autouse=True)
def headless_env(monkeypatch):
    monkeypatch.setenv("HOCKEY_TPU_HEADLESS", "1")


@pytest.fixture
def clip(tmp_path):
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for i in range(20):
        w.write(make_frame(i))
    w.release()
    return path


@pytest.fixture
def stubbed(monkeypatch):
    """Both CLIs build stub detectors instead of YOLOv8x."""
    monkeypatch.setattr(pipeline, "Detector", lambda *a, **k: PortStubDetector())
    monkeypatch.setattr(multiclip, "Detector", lambda *a, **k: PortMultiStubDetector())
    monkeypatch.setattr(jax_pipeline, "Detector", lambda *a, **k: StubDetector())


def frame_count(path) -> int:
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


# ---------------------------------------------------------------------------
# managers

def test_model_manager_missing_checkpoint_raises(tmp_path):
    mm = ModelManager(data_dir=str(tmp_path), device="cpu")
    for load in (mm.load_player_model, mm.load_rink_detector, mm.load_puck_pipeline):
        with pytest.raises(FileNotFoundError):
            load()


def test_model_manager_existing_checkpoint_loads(tmp_path):
    """`<data_dir>/<name>.msgpack` is the checkpoint the port loads, on the
    manager's device (a copy of the shipped puck weights)."""
    import shutil

    from hockey_tpu_torch.models.checkpoint import shipped_weights_path

    name = "hockey-puck-detection"
    path = tmp_path / f"{name}.msgpack"
    shutil.copyfile(shipped_weights_path(name), path)
    mm = ModelManager(data_dir=str(tmp_path), config=Config(puck_model_name=name),
                      device="cpu")
    assert mm._checkpoint_for(name) == str(path)
    pipe = mm.load_puck_pipeline(frame_hw=(256, 384))
    assert pipe is mm.puck_model
    w = next(pipe.sliced.detector.model.buffers())
    assert w.device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        mm.load_player_model()


def test_model_manager_random_init_allowed(tmp_path):
    mm = ModelManager(data_dir=str(tmp_path), allow_random_init=True, device="cpu")
    assert mm._checkpoint_for("anything") is None
    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            ModelManager()


def test_annotation_manager_draws():
    am = AnnotationManager(Config())
    frame = make_frame(0)
    boxes = np.array([[10, 20, 40, 90], [100, 30, 130, 100]], np.float32)
    out = am.annotate_frame(frame, boxes, ["A", "B"], np.array([0, 1]),
                            tracker_ids=np.array([1, 2]))
    assert out.shape == frame.shape and not np.array_equal(out, frame)
    assert np.array_equal(frame, make_frame(0))  # the input stays as it was


# ---------------------------------------------------------------------------
# prefetched, device_trace

def test_prefetched_keeps_order_and_raises_decode_errors():
    assert list(prefetched(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise OSError("decode failed")

    got = prefetched(broken())
    assert next(got) == 1
    with pytest.raises(OSError, match="decode failed"):
        next(got)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None):  # no directory: nothing is recorded
        pass
    d = str(tmp_path / "trace")
    with device_trace(d):
        with annotate("stage"):
            torch.ones(8).sum()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "stage" for e in events)


# ---------------------------------------------------------------------------
# the CLI

def test_parser_flags():
    args = cli.build_parser().parse_args(["--sources", "a.mp4,b.mp4"])
    assert args.source_path is None and args.sources == "a.mp4,b.mp4"
    assert args.save_state_every == 300 and args.device == "cuda"
    ours, jax_args = cli.build_parser().parse_args([]), jax_cli.build_parser().parse_args([])
    for flag in ("sources", "resume", "save_state", "save_state_every",
                 "json_metrics", "profile", "limit_frames", "source_path"):
        assert getattr(ours, flag) == getattr(jax_args, flag)  # JAX's defaults
    with pytest.raises(SystemExit):
        cli.main(["--headless"])  # neither --source_path nor --sources


def test_cli_json_metrics_has_jax_keys(clip, tmp_path, stubbed):
    """TEAM_CLASSIFICATION on the same clip through both CLIs: the same
    stages, each with the same keys, and the same counters."""
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "jax.json")
    common = ["--source_path", clip, "--headless", "--limit-frames", "6",
              "--team-names", "TOR,DET"]
    assert cli.main(common + ["--device", "cpu", "--json-metrics", ours]) == 0
    assert jax_cli.main(common + ["--json-metrics", theirs]) == 0
    with open(ours) as f:
        got = json.load(f)
    with open(theirs) as f:
        want = json.load(f)
    assert set(got) == set(want) and "detect" in got and "teams" in got
    for k in set(got) - {"counters", "gauges"}:
        assert set(got[k]) == set(want[k]) == {"total_s", "calls", "mean_ms"}
    assert set(got["counters"]) == set(want["counters"])


def test_cli_profile_writes_a_trace(clip, tmp_path, stubbed, capsys):
    d = str(tmp_path / "prof")
    assert cli.main(["--source_path", clip, "--headless", "--device", "cpu",
                     "--mode", "PLAYER_TRACKING", "--limit-frames", "3",
                     "--profile", d]) == 0
    assert "Processed 3 frames." in capsys.readouterr().out
    with open(os.path.join(d, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_cli_save_state_and_resume(clip, tmp_path, stubbed, capsys):
    state, out = str(tmp_path / "run.state"), str(tmp_path / "out.mp4")
    base = ["--source_path", clip, "--mode", "PLAYER_TRACKING", "--headless",
            "--device", "cpu"]
    assert cli.main(base + ["--limit-frames", "10", "--save-state", state,
                            "--save-state-every", "4", "--target_path", out]) == 0
    assert "Run state saved to" in capsys.readouterr().out
    assert frame_count(out) == 10
    assert cli.main(base + ["--resume", state, "--limit-frames", "5",
                            "--target_path", out]) == 0
    text = capsys.readouterr().out
    assert f"Resumed from {state} at frame 10" in text
    assert "Processed 5 frames." in text
    assert frame_count(out) == 5


def test_cli_sources_writes_one_target_per_clip(tmp_path, stubbed, capsys):
    paths = []
    for k, n in enumerate((9, 6)):
        p = str(tmp_path / f"c{k}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
        for i in range(n):
            w.write(make_frame(i))
        w.release()
        paths.append(p)
    target = str(tmp_path / "out.mp4")
    assert cli.main(["--sources", ",".join(paths), "--target_path", target,
                     "--mode", "PLAYER_TRACKING", "--headless", "--device", "cpu"]) == 0
    assert "Processed [9, 6] frames across 2 clips." in capsys.readouterr().out
    assert [frame_count(str(tmp_path / f"out_{i}.mp4")) for i in (0, 1)] == [9, 6]
    with pytest.raises(FileNotFoundError):
        cli.main(["--sources", paths[0] + ",missing.mp4", "--headless"])
