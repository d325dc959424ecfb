"""Timing and tracing helpers.

Counterpart of ``collocfem_tpu/utils/profiling.py``:

  * :func:`timed`: best-of-``reps`` wall time of a call after ``warmup``
    calls, each bracketed by ``torch.cuda.synchronize()`` when the work runs
    on a CUDA device (the counterpart of ``jax.block_until_ready``: the
    host clock then covers the device's work, not its enqueueing);
  * :func:`trace`: a context manager around ``torch.profiler`` that writes
    a Chrome/Perfetto trace into a directory (the counterpart of
    ``jax.profiler``'s trace directory), and the program's own spans beside
    it as ``spans.json``.

The program's spans, off by default: inside ``with recording(device_marks)
as rec:``, :func:`span` records a host span on ``time.perf_counter_ns`` and
:func:`device_span` a span of the device's work in stream order.  On a CUDA
device a device span is a pair of one-thread ``trace_mark`` kernels
(``csrc/graph_loop.cu``) launched on the current stream, so a CUDA-graph
capture records them with the rest: each appends (name, solve, cause,
``%globaltimer``) to a device log, which is read once, when the recording
ends, and mapped onto the host clock by two calibrations.  On the CPU a
device span reads ``time.perf_counter_ns`` at the same points.  With
recording off both are no-ops: no record, no kernel, no allocation, no graph
node.  A few integer counters of rare events (:data:`COUNTERS`) are always
on.

The solvers' stats carry per-iteration history tables beside these.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
import json
import math
import os
import threading
import time

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

# Always-on counts of rare events: CUDA-graph captures, kernel builds
# (nvcc runs) and library loads, device marks that found the log full, and
# the host nanoseconds spent in graph warm-ups, captures and instantiations.
COUNTERS = {"graph_captures": 0, "kernel_compiles": 0, "kernel_loads": 0,
            "marks_dropped": 0, "graph_setup_ns": 0, "assembly_fused": 0,
            "assembly_generic": 0}

# Records the device log holds (4 int64 each: code, solve, cause, time).
MARK_CAPACITY = 1 << 17
# Calibration: round trips of one mark (the shortest is kept), then a burst
# of back-to-back marks whose spacing shows the timer's resolution.
CAL_TRIPS, CAL_BURST = 32, 64


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


def counters() -> dict:
    """A copy of :data:`COUNTERS`."""
    return dict(COUNTERS)


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elif device.type != "cpu":
        raise ValueError(f"no timing for work on {device}")


def timed(fn, *args, device, reps: int = 5, warmup: int = 1, **kwargs):
    """Best-of-``reps`` wall time of ``fn(*args, **kwargs)``, whose work runs
    on ``device``, after ``warmup`` untimed calls.  Returns (seconds, last
    output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _sync(device)
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


@dataclasses.dataclass(frozen=True)
class Span:
    """One span: ``start`` and ``end`` in ns on ``time.perf_counter_ns``'s
    clock; ``parent`` the id of the span that caused it and ``solve`` that of
    the host ``solve`` span it belongs to (0: none; a ``solve`` span's is its
    own); ``device`` False for a host span."""

    name: str
    start: int
    end: int
    id: int
    parent: int
    solve: int
    device: bool


_IDS = itertools.count(1)
# Span names by mark code // 2.  A captured graph keeps its marks' codes for
# the process's life, so the table is the process's, not a recording's.
_NAMES: list[str] = []
_ACTIVE = None          # the Recorder of the recording in progress
_LOG = None             # the device log, allocated at the first recording
_NULL = contextlib.nullcontext()


class _Counted:
    """Recording off: only the counter's nanoseconds."""

    __slots__ = ("counter", "t0")

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        COUNTERS[self.counter] += time.perf_counter_ns() - self.t0


def span(name: str, counter: str | None = None):
    """A host span ``name`` while a recording is on, else a no-op; with
    ``counter``, the span's nanoseconds go to that counter either way."""
    rec = _ACTIVE
    if rec is None:
        return _NULL if counter is None else _Counted(counter)
    return _Open(rec, name, False, counter)


def spanned(name: str):
    """A decorator: each call of the function is a host span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def device_span(name: str, device):
    """A span of the work ``device`` runs for the block, in stream order,
    while a recording with device marks is on, else a no-op."""
    rec = _ACTIVE
    if rec is None or not rec.device_marks:
        return _NULL
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _Marks(rec, name, device)
    return _Open(rec, name, True, None)


def _code(name: str) -> int:
    """The begin mark's code of ``name`` (its end's is one more)."""
    if name not in _NAMES:
        _NAMES.append(name)
    return 2 * _NAMES.index(name)


def marks_on() -> bool:
    """Whether device marks are being recorded: part of a captured plan's
    key, so that marks on capture a marked plan beside the unmarked one."""
    return _ACTIVE is not None and _ACTIVE.device_marks


class _Open:
    """A span timed on the host: a host span, or a device span on the CPU."""

    __slots__ = ("rec", "name", "device", "counter", "id", "parent", "solve",
                 "start", "fn")

    def __init__(self, rec, name, device, counter):
        self.rec, self.name, self.device = rec, name, device
        self.counter = counter

    def __enter__(self):
        stack = self.rec._stack()
        top = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = top.id if top else 0
        self.solve = (self.id if self.name == "solve" and not self.device
                      else top.solve if top else 0)
        stack.append(self)
        self.fn = None
        if not self.device and torch._C._autograd._profiler_enabled():
            self.fn = record_function(self.name)
            self.fn.__enter__()
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        self.rec._stack().pop()
        self.rec._done.append(Span(self.name, self.start, end, self.id,
                                   self.parent, self.solve, self.device))
        if self.counter is not None:
            COUNTERS[self.counter] += end - self.start


class _Marks:
    """A device span on a CUDA device: a begin and an end mark."""

    __slots__ = ("rec", "code", "device")

    def __init__(self, rec, name, device):
        self.rec, self.code, self.device = rec, _code(name), device

    def __enter__(self):
        self.rec._log_for(self.device).mark(self.code, self.rec._stack())

    def __exit__(self, *exc):
        self.rec._log_for(self.device).mark(self.code + 1, self.rec._stack())


def _library():
    from collocfem_tpu_torch.ops import _build

    lib = _build.load(_build.Instance("graph_loop", 0, 0)).lib
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.trace_mark_launch.argtypes = [ptr, ptr, ll, ll, ll, ll, ptr]
    lib.trace_mark_launch.restype = ctypes.c_int
    lib.trace_sync.argtypes = [ptr]
    lib.trace_sync.restype = ctypes.c_int
    lib.graph_loop_error_string.argtypes = [ctypes.c_int]
    lib.graph_loop_error_string.restype = ctypes.c_char_p
    return lib


class _DeviceLog:
    """The device log of one CUDA device: ``state`` (cursor, dropped, the
    current solve and cause) and ``rows`` of (code, solve, cause, time), and
    a small pair of the same for the calibrations."""

    def __init__(self, device, capacity: int):
        self.device, self.capacity = device, capacity
        self.lib = _library()
        i64 = dict(dtype=torch.int64, device=device)
        self.state, self.rows = torch.zeros(4, **i64), \
            torch.zeros(capacity, 4, **i64)
        self.cal_state = torch.zeros(4, **i64)
        self.cal_rows = torch.zeros(CAL_TRIPS + CAL_BURST, 4, **i64)

    def _launch(self, state, rows, capacity, code, solve, cause):
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.lib.trace_mark_launch(state.data_ptr(), rows.data_ptr(),
                                        capacity, code, solve, cause, stream)
        if rc != 0:
            raise RuntimeError("trace_mark's launch failed: "
                               + self.lib.graph_loop_error_string(rc).decode())

    def mark(self, code: int, stack) -> None:
        """Append a mark on the current stream.  Outside a capture the mark
        sets the solve and cause to the innermost open host span's; a
        captured mark reads them from the device (the call's eager marks
        set them)."""
        if torch.cuda.is_current_stream_capturing():
            solve = cause = -1
        else:
            top = stack[-1] if stack else None
            solve, cause = (top.solve, top.id) if top else (0, 0)
        self._launch(self.state, self.rows, self.capacity, code, solve, cause)

    def calibrate(self) -> dict:
        """%globaltimer against ``time.perf_counter_ns``: the shortest of
        :data:`CAL_TRIPS` round trips of one mark (launch to
        ``cudaStreamSynchronize``), and the timer's resolution from a burst
        of back-to-back marks."""
        torch.cuda.synchronize(self.device)
        self.cal_state.zero_()
        n = self.cal_rows.shape[0]
        stream = torch.cuda.current_stream(self.device).cuda_stream
        trips = []
        for _ in range(CAL_TRIPS):
            t0 = time.perf_counter_ns()
            self._launch(self.cal_state, self.cal_rows, n, 0, 0, 0)
            rc = self.lib.trace_sync(stream)
            trips.append((t0, time.perf_counter_ns()))
            if rc != 0:
                raise RuntimeError("the calibration's synchronize failed: "
                                   + self.lib.graph_loop_error_string(rc)
                                   .decode())
        for _ in range(CAL_BURST):
            self._launch(self.cal_state, self.cal_rows, n, 0, 0, 0)
        torch.cuda.synchronize(self.device)
        g = self.cal_rows[:, 3].tolist()
        i = min(range(CAL_TRIPS), key=lambda k: trips[k][1] - trips[k][0])
        t0, t1 = trips[i]
        steps = [b - a for a, b in zip(g[CAL_TRIPS:], g[CAL_TRIPS + 1:])
                 if b > a]
        return {"timer_ns": g[i], "offset_ns": g[i] - (t0 + t1) // 2,
                "uncertainty_ns": (t1 - t0) / 2,
                "resolution_ns": math.gcd(*steps) if steps else None,
                "burst_step_ns": min(steps) if steps else None}

    def read(self):
        """(rows as lists, marks dropped); clears nothing."""
        torch.cuda.synchronize(self.device)
        n, dropped = self.state[:2].tolist()
        return self.rows[:n].tolist(), dropped


class Recorder:
    """What a recording keeps in memory.  ``spans`` (every :class:`Span`,
    by start) and ``clock`` (the calibrations of the device timer: the
    offset, its uncertainty (half the shortest round trip), the observed
    resolution, at the start and the end; None without a CUDA log) are set
    when the recording ends."""

    def __init__(self, device_marks: bool):
        self.device_marks = device_marks
        self.spans: list[Span] = []
        self.clock = None
        self._done: list[Span] = []
        self._local = threading.local()
        self._log = None
        self._cal0 = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _log_for(self, device):
        if self._log is None or self._log.device != device:
            where = None if self._log is None else self._log.device
            raise ValueError(f"device marks are recorded on {where}, not on "
                             f"{device}")
        return self._log

    def clear(self) -> None:
        """Forget what was recorded so far (host spans and the device log);
        spans still open are kept."""
        self._done = []
        if self._log is not None:
            torch.cuda.synchronize(self._log.device)
            self._log.state[:2].zero_()

    def _start(self) -> None:
        global _LOG
        if not (self.device_marks and torch.cuda.is_available()):
            return
        if _LOG is None:
            _LOG = _DeviceLog(torch.device("cuda",
                                           torch.cuda.current_device()),
                              MARK_CAPACITY)
        self._log = _LOG
        self._log.state.zero_()
        self._cal0 = self._log.calibrate()

    def _finish(self) -> None:
        spans = list(self._done)
        if self._log is not None:
            rows, dropped = self._log.read()
            cal1 = self._log.calibrate()
            COUNTERS["marks_dropped"] += dropped
            self.clock = {"start": self._cal0, "end": cal1,
                          "dropped": dropped}
            spans += self._decode(rows, self._cal0, cal1)
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))

    def _decode(self, rows, cal0, cal1) -> list[Span]:
        """Pair each begin mark with its end (marks nest in stream order, per
        solve), onto the host clock between the two calibrations."""
        g0, g1 = cal0["timer_ns"], cal1["timer_ns"]
        o0, o1 = cal0["offset_ns"], cal1["offset_ns"]
        slope = (o1 - o0) / (g1 - g0) if g1 > g0 else 0.0

        def host(g):
            return int(round(g - (o0 + slope * (g - g0))))

        out, open_ = [], {}
        for code, solve, cause, t in rows:
            stack = open_.setdefault(solve, [])
            if code % 2 == 0:
                stack.append((code, next(_IDS), stack[-1][1] if stack
                              else cause, host(t)))
            elif stack and stack[-1][0] == code - 1:
                _, sid, parent, start = stack.pop()
                out.append(Span(_NAMES[code // 2], start, host(t), sid,
                                parent, solve, True))
        return out


@contextlib.contextmanager
def recording(device_marks: bool = False):
    """Record the program's spans for the block; yields the
    :class:`Recorder`, whose ``spans`` are set when the block ends.

    With ``device_marks``, device spans are recorded too: on a machine with
    a CUDA device the log is allocated at the first such recording (on the
    current device, for :data:`MARK_CAPACITY` records; device spans on
    another device raise), and the device timer is calibrated at the start
    and at the end.  A captured solve keys its plans on whether marks are
    on, so the first call with marks on captures a marked plan beside the
    unmarked one.
    """
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a recording is already on")
    rec = Recorder(device_marks)
    rec._start()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec._finish()


def chrome_trace(spans) -> dict:
    """Spans in the Chrome trace format (µs): host spans on one row per
    process, device spans on another."""
    events = [{"name": s.name, "ph": "X", "ts": s.start / 1e3,
               "dur": (s.end - s.start) / 1e3, "pid": os.getpid(),
               "tid": "device" if s.device else "host",
               "args": {"id": s.id, "parent": s.parent, "solve": s.solve}}
              for s in spans]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


@contextlib.contextmanager
def trace(log_dir: str, *, device):
    """Profile a region into ``log_dir`` (a ``*.pt.trace.json`` file, for
    Perfetto or TensorBoard): host activity, and the card's kernels when
    ``device`` is a CUDA device; the program's spans, recorded with device
    marks on, go beside it as ``spans.json``.  Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum the region by
    operator and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with recording(device_marks=True) as rec:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)) \
                as prof:
            yield prof
            _sync(device)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(chrome_trace(rec.spans), f)
