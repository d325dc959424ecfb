"""``collocfem_tpu_torch.utils.profiling``: the counterpart of
tests/test_debugging.py::test_profiler_trace, and ``timed``."""

import os

import pytest
import torch

from collocfem_tpu_torch.utils import timed, trace


def test_profiler_trace(tmp_path):
    logdir = os.path.join(tmp_path, "trace")
    with trace(logdir, device="cpu") as prof:
        y = torch.ones(8) + 1
    assert float(y.sum()) == 16.0
    # A trace directory with at least one event file was produced, and the
    # profile saw the region's operator.
    found = []
    for root, _, files in os.walk(logdir):
        found.extend(files)
    assert found, "no profiler output written"
    assert any("add" in evt.key for evt in prof.key_averages())


def test_timed_is_best_of_reps_after_warmup():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return x * scale

    seconds, out = timed(fn, torch.ones(3), device="cpu", reps=4, warmup=2,
                         scale=2.0)
    assert len(calls) == 6 and seconds >= 0.0
    assert torch.equal(out, torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="meta"):
        timed(fn, torch.ones(3), device="meta", reps=1, warmup=0)
