"""The PyTorch port stands alone: hockey_tpu_torch imports neither JAX nor
the JAX package, builds no kernel through torch.utils.cpp_extension, and
everything chip_smoke.py imports, the tracker, the PLAYER_TRACKING
modules with the jersey-number OCR, the team modules of
TEAM_CLASSIFICATION, the sliced puck detector, the dual step and the
rink, homography and 2D-map modules among it, also loads without cv2,
msgpack or sklearn (the GPU machine has none of them); so do
scripts/torch_e2e_puck.py and scripts/torch_e2e_homography.py."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hockey_tpu_torch")

_PRELUDE = """
import sys
blocked = set(sys.argv[1].split(","))
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
"""

_IMPORT_PACKAGE = """
import importlib, pkgutil
import hockey_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hockey_tpu_torch.__path__,
                                               "hockey_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(len(names))
"""

# the modules of each slice that chip_smoke.py drives
SMOKE_MODULES = (
    "hockey_tpu_torch.models.detector", "hockey_tpu_torch.ops.nms_kernel",
    "hockey_tpu_torch.pipeline", "hockey_tpu_torch.ops.assignment",
    "hockey_tpu_torch.tracking.device_tracker",
    "hockey_tpu_torch.tracking.bytetrack", "hockey_tpu_torch.tracking.kalman",
    "hockey_tpu_torch.annotate.smooth", "hockey_tpu_torch.annotate.stabilizers",
    "hockey_tpu_torch.annotate.draw", "hockey_tpu_torch.ops.color",
    "hockey_tpu_torch.ops.crop_resize", "hockey_tpu_torch.teams.base",
    "hockey_tpu_torch.teams.features", "hockey_tpu_torch.teams.kmeans",
    "hockey_tpu_torch.teams.segmentation", "hockey_tpu_torch.teams.simple",
    "hockey_tpu_torch.teams.facade", "hockey_tpu_torch.ui.team_selector",
    "hockey_tpu_torch.ocr.digits", "hockey_tpu_torch.ocr.jersey",
    "hockey_tpu_torch.slicing.sahi", "hockey_tpu_torch.models.dual",
    "hockey_tpu_torch.ops.gray", "hockey_tpu_torch.homography.keypoints",
    "hockey_tpu_torch.homography.calibrator",
    "hockey_tpu_torch.homography.ransac",
    "hockey_tpu_torch.homography.stabilizer",
    "hockey_tpu_torch.rinkmap.dimensions", "hockey_tpu_torch.rinkmap.renderer")

_IMPORT_SMOKE = f"""
import chip_smoke
missing = [m for m in {SMOKE_MODULES!r} if m not in sys.modules]
assert not missing, missing
print(len([m for m in sys.modules if m.startswith("hockey_tpu_torch")]))
"""

_CHECK = """
leaked = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
assert not leaked, leaked
"""

_IMPORT_HARNESS = """
import importlib.util
spec = importlib.util.spec_from_file_location(
    "{0}", sys.argv[2] + "/scripts/{0}.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len([m for m in sys.modules if m.startswith("hockey_tpu_torch")]))
"""

_BLOCKED = ("jax", "flax", "optax", "hockey_tpu", "cv2", "msgpack", "sklearn")
CASES = {
    "package_without_jax": (_BLOCKED, _IMPORT_PACKAGE),
    "chip_smoke_closure": (_BLOCKED, _IMPORT_SMOKE),
    "puck_harness": (_BLOCKED, _IMPORT_HARNESS.format("torch_e2e_puck")),
    "homography_harness": (_BLOCKED,
                           _IMPORT_HARNESS.format("torch_e2e_homography")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_imports_with_blocked_modules(case):
    blocked, body = CASES[case]
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + body + _CHECK, ",".join(blocked), ROOT],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 10  # the modules really loaded


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|hockey_tpu)(\.|\s|$)|cpp_extension",
    re.MULTILINE)


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "scripts", "torch_e2e_puck.py")
    yield os.path.join(ROOT, "scripts", "torch_e2e_homography.py")


def test_sources_name_no_forbidden_import():
    hits = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not hits, hits
