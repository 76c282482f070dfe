"""The reader of `conv_epilogue_ms` on small synthetic traces: nothing to
read where the program has no epilogue kernel, as a commit before it,
and the kernel's device ms per batch, found by its templated name, where
it has."""

from types import SimpleNamespace

import pytest

from benchmark.harness.trace import TraceSummary
from benchmark.tests.test_bench_trace import FakeProf, avg, read


class EpilogueProf(FakeProf):
    """FakeProf's window with two instances of the epilogue kernel."""

    def key_averages(self):
        return super().key_averages() + [
            avg("void (anonymous namespace)::conv_epilogue_kernel<__nv_bfloat16, 8, "
                "false>((anonymous namespace)::Params)", "CUDA", 4, self_device_us=90.0),
            avg("void (anonymous namespace)::conv_epilogue_kernel<__nv_bfloat16, 8, "
                "true>((anonymous namespace)::Params)", "CUDA", 2, self_device_us=30.0)]


def run_of(prof):
    return SimpleNamespace(trace=TraceSummary(prof), batches=2)


def test_no_kernel_no_reading():
    assert read("conv_epilogue_ms", run_of(FakeProf())) is None


def test_device_ms_per_batch():
    assert read("conv_epilogue_ms", run_of(EpilogueProf())) == pytest.approx(0.06)
