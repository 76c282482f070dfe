"""The import check: module names cut at the first dot and compared whole,
so neither jax nor the JAX package passes and hockey_tpu_torch is not
taken for hockey_tpu; and the reference holds nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import cell as cellmod

REFERENCE = os.path.join(cellmod.BENCH_DIR, "reference")


def test_forbidden_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hockey_tpu_torch_fake.x", object())
    assert "hockey_tpu_torch_fake" not in cellmod.forbidden_modules()
    for name in ("jax.numpy", "jaxlib", "flax.core", "hockey_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in cellmod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "jaxtyping" not in cellmod.forbidden_modules()


@pytest.mark.parametrize("path", sorted(
    f for f in os.listdir(REFERENCE) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(REFERENCE, path)).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"hockey_tpu_torch", "hockey_tpu", "jax", "jaxlib", "flax"}, tops


def test_reference_and_harness_load_no_jax():
    """A fresh process that imports the reference, the harness and the
    drivers holds no module of JAX, nor, from the reference, of the
    program."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.yolo, benchmark.reference.tracker, "
            "benchmark.reference.teams, benchmark.reference.puck\n"
            "assert not {m.split('.')[0] for m in sys.modules} & "
            "{'hockey_tpu_torch', 'hockey_tpu', 'jax', 'flax'}\n"
            "from benchmark.harness import cell\n"
            "cell.load_module(cell.BENCH_DIR + '/drivers/serve.py', 'd')\n"
            "import hockey_tpu_torch.pipeline\n"
            "print(cell.forbidden_modules())\n" % cellmod.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
