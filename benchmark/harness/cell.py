"""One run of one cell: what BENCHMARK.json and the cell's files say, the
driver's run, the per-layer readers, the checks that decide `correct`,
the import check and the result line.

A cell is found by its name alone: `workloads/<cell>.json` names its
configuration (`configs/<config>.json`) and its driver
(`drivers/<driver>.py`); each per-layer metric is `metrics/<name>.py`,
whose `read(run)` returns a number or None. So a later cell, traffic mix
or metric is new files and new entries in BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "hockey_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell as its files state it."""

    name: str
    chips: int
    workload: Dict
    config: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @classmethod
    def load(cls, name: str) -> "Cell":
        bench = load_json(ROOT, "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        workload = load_json(BENCH_DIR, "workloads", f"{name}.json")
        config = load_json(BENCH_DIR, "configs", f"{entry['config']}.json")
        e2e = [m for m in bench["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
        return cls(name, entry["chips"], workload, config, e2e, layer)


@dataclass
class Check:
    """One number compared with its limit: the run is correct where
    value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: end-to-end metrics by name, the checks,
    the frames or steps attempted and failed, the device's peak, and, in
    a traced run, the `Run` that the per-layer readers read."""

    metrics: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    run: Optional[Any] = None
    notes: Dict[str, Any] = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules, cut at the first dot and compared
    whole, that are FORBIDDEN (so `hockey_tpu_torch` is not `hockey_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def read_layers(cell: Cell, run) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        mod = load_module(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"),
                          f"bench_metric_{m['name'].replace('.', '_')}")
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(torch, chips: int, peak: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def result_line(cell: Cell, outcome: Outcome, device: Dict, trace: bool,
                breakdown: Optional[Dict]) -> Tuple[Dict, List[str]]:
    """(the JSON object of the last line, the check lines for stderr)."""
    if trace:
        metrics = read_layers(cell, outcome.run)
        device = dict(device, busy_s=outcome.run.busy_s,
                      window_s=outcome.run.window_s)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(outcome.metrics[k]), "unit": units[k]}
                   for k in units}
    correct = bool(outcome.checks) and all(c.ok for c in outcome.checks) \
        and outcome.failed == 0
    out = {"correct": correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    lines = [f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
             f"{'ok' if c.ok else 'FAILED'}" for c in outcome.checks]
    return out, lines
