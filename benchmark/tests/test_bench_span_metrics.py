"""The readers of the program's host spans: each returns its value on a
run whose trace holds its range and None on one that lacks it (a program
without the span), and a traced run of each cut cell on the CPU reads
them from the program itself."""

from types import SimpleNamespace

import pytest

from benchmark.harness.cell import BENCH_DIR, load_module, read_layers
from benchmark.tests.conftest import run_small

# reader: (range it reads, host ms in the fake trace, what it divides by)
READERS = {
    "tracker_sync_wait_ms": ("auction_sync", 36.0, "batches"),
    "batch_stack_ms": ("stack", 12.0, "batches"),
    "result_fetch_ms": ("fetch", 30.0, "batches"),
    "puck_tracker_host_ms": ("puck_track", 4.8, "frames"),
}


class FakeTrace:
    def __init__(self, ranges):
        self.ranges = ranges

    def range(self, name):
        r = self.ranges.get(name)
        return r if r and r["count"] else None


def fake_run(ranges):
    return SimpleNamespace(trace=FakeTrace(ranges), frames=16, batches=2)


def read(name, run):
    return load_module(f"{BENCH_DIR}/metrics/{name}.py", f"m_{name}").read(run)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_range(name):
    span, host_ms, per = READERS[name]
    run = fake_run({span: {"host_ms": host_ms, "device_ms": 0.0, "count": 3},
                    "tracker_scan": {"host_ms": 99.0, "device_ms": 1.0, "count": 2}})
    assert read(name, run) == pytest.approx(host_ms / getattr(run, per))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_none_without_its_range(name):
    span, _, _ = READERS[name]
    assert read(name, fake_run({"tracker_scan": {"host_ms": 99.0, "device_ms": 1.0,
                                                 "count": 2}})) is None
    # a range that was entered no time, or a window without batches
    assert read(name, fake_run({span: {"host_ms": 0.0, "device_ms": 0.0,
                                       "count": 0}})) is None
    empty = fake_run({span: {"host_ms": 1.0, "device_ms": 0.0, "count": 1}})
    empty.frames = empty.batches = 0
    assert read(name, empty) is None


@pytest.mark.parametrize("cell,names", [
    ("classify-fused", ("tracker_sync_wait_ms", "batch_stack_ms", "result_fetch_ms")),
    ("puck-sliced", ("puck_tracker_host_ms", "batch_stack_ms", "result_fetch_ms")),
    ("detect-only", ("batch_stack_ms", "result_fetch_ms")),
])
def test_traced_cell_reads_the_program_spans(cell, names):
    """Each cell reads its new metrics from the program's own spans, and
    only the cells listed for a metric read it."""
    c, out = run_small(cell, trace=True)
    got = read_layers(c, out.run)
    for name in names:
        assert got[name]["value"] > 0, name
    for name in set(READERS) - set(names):
        assert name not in got
    if cell == "classify-fused":
        # one `auction_sync` range per host sync of the auction
        assert out.run.trace.range("auction_sync")["count"] == \
            out.run.counters["assignment_syncs"]
        assert got["tracker_sync_wait_ms"]["value"] <= got["tracker_host_ms"]["value"]
