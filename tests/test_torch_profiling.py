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


def test_recording_off_records_and_allocates_nothing():
    """Spans are no-ops with recording off: the same null context for every
    span, no record, no device log, and only a named counter moves."""
    from collocfem_tpu_torch.utils import profiling

    before = profiling.counters()
    assert not profiling.marks_on() and profiling._ACTIVE is None
    assert profiling.span("solve") is profiling.device_span("kkt", "cpu")
    with profiling.span("solve"), profiling.device_span("kkt", "cpu"):
        torch.ones(3).sum()
    with profiling.span("graph.capture", "graph_setup_ns"):
        pass
    after = profiling.counters()
    assert after["graph_setup_ns"] > before["graph_setup_ns"]
    assert {k: v for k, v in after.items() if k != "graph_setup_ns"} == \
        {k: v for k, v in before.items() if k != "graph_setup_ns"}
    if not torch.cuda.is_available():
        assert profiling._LOG is None


def test_host_and_cpu_device_spans_nest_and_tie_to_their_solve():
    """Each span's parent is the innermost span open at its start, and its
    solve is the innermost host ``solve`` span's (a solve's is its own);
    a worker thread's spans start their own stack; a second recording
    inside the first raises."""
    import threading

    from collocfem_tpu_torch.utils import profiling

    def compile_():
        with profiling.span("build.compile"):
            pass

    with profiling.recording(device_marks=True) as rec:
        with profiling.span("ladder.level[0]"):
            with profiling.span("solve"):
                with profiling.device_span("lm.step", "cpu"):
                    with profiling.device_span("kkt", "cpu"):
                        pass
        worker = threading.Thread(target=compile_)
        with profiling.span("build.load"):
            worker.start()
            worker.join(timeout=30)
        assert not worker.is_alive()
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.recording():
                pass
    assert profiling._ACTIVE is None and rec.clock is None
    by = {s.name: s for s in rec.spans}
    level = by["ladder.level[0]"]
    assert level.parent == 0 and level.solve == 0
    assert by["solve"].parent == by["ladder.level[0]"].id
    assert by["solve"].solve == by["solve"].id
    assert by["lm.step"].parent == by["solve"].id and by["lm.step"].device
    assert by["kkt"].parent == by["lm.step"].id
    assert by["kkt"].solve == by["lm.step"].solve == by["solve"].id
    assert by["lm.step"].start <= by["kkt"].start <= by["kkt"].end \
        <= by["lm.step"].end
    assert not by["build.load"].device
    assert by["build.compile"].parent == 0
    assert by["build.load"].start <= by["build.compile"].start


def test_device_log_decodes_onto_the_host_clock():
    """The device log's rows pair each begin mark with its end in stream
    order (per solve), a graph mark's parent is the enclosing device span
    or the host span that caused the call, and the timer maps onto the host
    clock by the offset interpolated between the two calibrations."""
    from collocfem_tpu_torch.utils.profiling import Recorder, _code

    step, kkt, load = _code("lm.step"), _code("kkt"), _code("solve.load")
    # A later recording decodes the codes an earlier one gave a graph.
    rec = Recorder(device_marks=True)
    assert _code("kkt") == kkt
    rows = [(load, 7, 7, 1_000), (load + 1, 7, 7, 1_100),
            (step, 7, 7, 2_000), (kkt, 7, 7, 2_100), (kkt + 1, 7, 7, 2_500),
            (step + 1, 7, 7, 3_000), (step, 9, 11, 4_000),
            (step + 1, 9, 11, 5_000), (kkt + 1, 9, 11, 5_100)]
    cal0 = {"timer_ns": 0, "offset_ns": 500}
    cal1 = {"timer_ns": 10_000, "offset_ns": 600}
    spans = rec._decode(rows, cal0, cal1)
    by = {(s.name, s.solve): s for s in spans}
    assert len(spans) == 4          # the unmatched end is dropped
    assert by[("solve.load", 7)].parent == 7
    assert by[("lm.step", 7)].parent == 7
    assert by[("kkt", 7)].parent == by[("lm.step", 7)].id
    assert by[("lm.step", 9)].parent == 11
    assert (by[("kkt", 7)].start, by[("kkt", 7)].end) == (2_100 - 521,
                                                          2_500 - 525)
    assert all(s.device for s in spans)


def test_trace_writes_the_programs_spans(tmp_path):
    """``trace`` records the program's spans and writes them beside the
    profile as ``spans.json`` (Chrome trace format)."""
    import json

    from collocfem_tpu_torch.utils import profiling

    logdir = os.path.join(tmp_path, "trace")
    with trace(logdir, device="cpu"):
        with profiling.span("solve"):
            with profiling.device_span("lm.step", "cpu"):
                torch.ones(8).sum()
    events = json.load(open(os.path.join(logdir, "spans.json")))[
        "traceEvents"]
    assert [e["name"] for e in events] == ["solve", "lm.step"]
    assert events[1]["tid"] == "device" and events[1]["dur"] >= 0
    assert events[1]["args"]["parent"] == events[0]["args"]["id"]
