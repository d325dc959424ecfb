"""The span pass of a traced run, and the arithmetic of the metrics that
read the port's own spans (``collocfem_tpu_torch.utils.profiling``).

After the profiled eager solve, the first of these metrics to be read runs
the pass once: with the port's device marks on it calls data set 0 (which
captures the marked plan: its CUDA graphs hold the ``trace_mark`` kernels),
then solves each data set of the pool once (a cell of one data set twice)
with recording off and at once again, recorded, each call timed from the
call to its ``synchronize()``: the spans are the recorded calls', and the
pairs give tracing's cost in one speed regime of the card.  The window and
the profiled eager solve ran before it with recording off, so every other
metric reads what it read before.  A port without the recorder, or a run on
the CPU, gives no pass, and the readers return None.

The pass reaches the system under test through the harness's frame (the
reader is handed only the ``Reading``); it keeps its result on the reading
as ``reading.spans`` and ``reading.span_pass``.  It prints on standard error
the counters across the window's reading (set-up included), the pass's own
checks, its idle time by the host span open at each gap, and what tracing
costs when on.
"""

from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass

# The device spans of an LM step that the per-step metrics split it into.
PARTS = ("kkt", "assemble", "shared")


@dataclass
class Call:
    dataset: int
    start: int                   # ns, time.perf_counter_ns
    end: int                     # after synchronize()
    steps: list                  # the harness's (elements, steps) a level
    iterations: int


@dataclass
class SpanPass:
    spans: list
    calls: list                  # the recorded calls
    off: list                    # (data set, s) of each call before it
    clocks: list                 # each recording's calibrations
    counters: dict               # the port's counters before the pass
    wall_s: float                # the whole pass, the marked capture in


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _harness_locals(reading):
    """The locals of the caller that holds ``reading`` and the system under
    test (``harness.run``'s), or None."""
    f = sys._getframe(1)
    while f is not None:
        found = f.f_locals
        if found.get("reading") is reading and "sut" in found:
            return found
        f = f.f_back
    return None


def of(reading):
    """The reading's span pass, run at the first call; None where the run
    has none (no CUDA device, or a port without the recorder)."""
    if hasattr(reading, "span_pass"):
        return reading.span_pass
    reading.span_pass = reading.spans = None
    env = _harness_locals(reading)
    try:
        from collocfem_tpu_torch.utils import profiling
    except ImportError:
        return None
    if env is None or not hasattr(profiling, "recording") \
            or str(env.get("device")) != "cuda":
        return None
    sp = run_pass(env["sut"], reading.cell.traffic, profiling)
    reading.span_pass, reading.spans = sp, sp.spans
    report(sp, env.get("records", []), reading)
    return sp


def run_pass(sut, traffic, profiling) -> SpanPass:
    """The pass itself (any device: on the CPU the device spans are host
    times of the eager work)."""
    import torch

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    counters = profiling.counters()
    n = int(traffic.get("datasets", 1))
    order = list(range(n)) if n > 1 else [0, 0]
    t0 = time.perf_counter()
    with profiling.recording(device_marks=True):
        sut(0)
        sync()
    spans, calls, off, clocks = [], [], [], []
    for k in order:
        ts = time.perf_counter()
        sut(k)
        sync()
        off.append((k, time.perf_counter() - ts))
        with profiling.recording(device_marks=True) as rec:
            ts = time.perf_counter_ns()
            with profiling.span("bench.call"):
                out = sut(k)
            with profiling.span("bench.sync"):
                sync()
            te = time.perf_counter_ns()
        spans += rec.spans
        clocks.append(rec.clock)
        calls.append(Call(k, ts, te, sut.steps(), int(out.iterations)))
    return SpanPass(spans, calls, off, clocks, counters,
                    time.perf_counter() - t0)


# -- the arithmetic, on a list of profiling.Span ---------------------------

def solves_of(spans, call):
    """Ids of the host ``solve`` spans inside a call."""
    return {s.id for s in spans if not s.device and s.name == "solve"
            and call.start <= s.start <= call.end}


def finest_solves(spans):
    """Ids of the solves the per-step metrics read: those under the last
    ``ladder.level[i]`` span of their ladder where there is one, else all."""
    by_id = {s.id: s for s in spans}
    solves = [s for s in spans if not s.device and s.name == "solve"]
    levels = [s for s in spans if not s.device
              and s.name.startswith("ladder.level[")]
    if not levels:
        return {s.id for s in solves}
    last = max(int(s.name[len("ladder.level["):-1]) for s in levels)
    name = f"ladder.level[{last}]"
    return {s.id for s in solves
            if s.parent in by_id and by_id[s.parent].name == name}


def step_table(spans, solves):
    """[(period, {part: ns})] of every ``lm.step`` device span of the given
    solves: its period runs from its start to the next step's start of the
    same solve (to its own end for the last); each part sums the step's
    direct child spans of that name."""
    steps = {}
    for s in spans:
        if s.device and s.name == "lm.step" and s.solve in solves:
            steps.setdefault(s.solve, []).append(s)
    children = {}
    for s in spans:
        if s.device and s.name in PARTS:
            children.setdefault(s.parent, []).append(s)
    rows = []
    for solve in sorted(steps):
        run = sorted(steps[solve], key=lambda s: s.start)
        for i, st in enumerate(run):
            end = run[i + 1].start if i + 1 < len(run) else st.end
            parts = dict.fromkeys(PARTS, 0)
            for c in children.get(st.id, ()):
                parts[c.name] += c.end - c.start
            rows.append((end - st.start, parts))
    return rows


def per_step_ms(spans, part):
    """Mean ms per LM step of ``part`` (``"update"``: the period less its
    kkt and assemble) over the finest solves; None without steps or where
    no step holds the part."""
    rows = step_table(spans, finest_solves(spans))
    if not rows:
        return None
    if part == "update":
        vals = [p - d["kkt"] - d["assemble"] for p, d in rows]
    else:
        vals = [d[part] for _, d in rows]
        if not any(vals):
            return None
    return 1e-6 * sum(vals) / len(vals)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def call_device(spans, call):
    """Merged device intervals of a call, clipped to its wall."""
    return _union([(max(s.start, call.start), min(s.end, call.end))
                   for s in spans if s.device and s.end > call.start
                   and s.start < call.end])


def idle_share(spans, calls):
    """Percent of the calls' walls in which no device span was open."""
    wall = sum(c.end - c.start for c in calls)
    if wall <= 0:
        return None
    busy = sum(b - a for c in calls for a, b in call_device(spans, c))
    return 100.0 * (1.0 - busy / wall)


def handoff_ms(spans, calls):
    """Mean over the calls of the summed device gaps between ladder levels:
    from the last device span of level i to the first of level i + 1."""
    by_id = {s.id: s for s in spans}

    def level(s):
        while s is not None:
            if not s.device and s.name.startswith("ladder.level["):
                return int(s.name[len("ladder.level["):-1])
            s = by_id.get(s.parent)
        return None

    sums = []
    for c in calls:
        ends = {}
        for s in spans:
            if s.device and c.start <= s.start <= c.end:
                i = level(s)
                if i is not None:
                    a, b = ends.get(i, (s.start, s.end))
                    ends[i] = (min(a, s.start), max(b, s.end))
        if len(ends) > 1:
            sums.append(sum(ends[i + 1][0] - ends[i][1]
                            for i in sorted(ends)[:-1] if i + 1 in ends))
    return 1e-6 * sum(sums) / len(sums) if sums else None


def idle_gaps(spans, calls):
    """{label: ns} of the calls' idle time: "graph" for a gap inside a
    solve's captured region (its ``lm.prelude`` to its last ``lm.step``),
    else the innermost host span open at the gap's middle."""
    regions = {}
    for s in spans:
        if s.device and s.name in ("lm.prelude", "lm.step"):
            a, b = regions.get(s.solve, (s.start, s.end))
            regions[s.solve] = (min(a, s.start), max(b, s.end))
    hosts = [s for s in spans if not s.device]
    out = {}
    for c in calls:
        busy = call_device(spans, c)
        edges = [c.start] + [x for iv in busy for x in iv] + [c.end]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            m = (a + b) // 2
            if any(r0 <= a and b <= r1 for r0, r1 in regions.values()):
                label = "graph"
            else:
                open_ = [h for h in hosts if h.start <= m <= h.end]
                label = min(open_, key=lambda h: h.end - h.start).name \
                    if open_ else "host"
            out[label] = out.get(label, 0) + (b - a)
    return out


def report(sp: SpanPass, records, reading) -> None:
    """Print the pass's counters, checks, idle gaps and tracing's cost."""
    from collocfem_tpu_torch.utils import profiling

    now = profiling.counters()
    _say(f"span pass: {len(sp.calls)} calls in {sp.wall_s:.3f} s; counters "
         f"before it {sp.counters}, moved by it "
         f"{ {k: now[k] - sp.counters[k] for k in now} }")
    cals = [c[k] for c in sp.clocks if c for k in ("start", "end")]
    unc = max((c["uncertainty_ns"] for c in cals), default=0)
    if cals:
        _say(f"  clock: {len(cals)} calibrations, offset "
             f"{min(c['offset_ns'] for c in cals)}-"
             f"{max(c['offset_ns'] for c in cals)} ns, uncertainty "
             f"{min(c['uncertainty_ns'] for c in cals) / 1e3:.1f}-"
             f"{unc / 1e3:.1f} us, resolution "
             f"{sorted({c['resolution_ns'] for c in cals})} ns, dropped "
             f"{sum(c['dropped'] for c in sp.clocks if c)}")
    rows = step_table(sp.spans, finest_solves(sp.spans))
    if rows:
        period = sum(p for p, _ in rows) / len(rows)
        parts = {k: sum(d[k] for _, d in rows) / len(rows) for k in PARTS}
        _say(f"  finest solves: {len(rows)} steps, period "
             f"{period * 1e-6:.6f} ms = kkt {parts['kkt'] * 1e-6:.6f} + "
             f"assemble {parts['assemble'] * 1e-6:.6f} + the rest "
             f"{(period - parts['kkt'] - parts['assemble']) * 1e-6:.6f} "
             f"(shared {parts['shared'] * 1e-6:.6f})")
    outside, counted, want = 0, [], []
    for c in sp.calls:
        ids = solves_of(sp.spans, c)
        dev = [s for s in sp.spans if s.device and s.solve in ids]
        outside += sum(s.start < c.start - unc or s.end > c.end + unc
                       for s in dev)
        counted.append(sum(s.name == "lm.step" for s in dev))
        want.append(sum(n for _, n in c.steps))
    _say(f"  device spans outside their call's wall (+- {unc / 1e3:.1f} us): "
         f"{outside}; steps from spans {counted}, the harness's steps "
         f"{want}, iterations {[c.iterations for c in sp.calls]}")
    first = next((c for c in sp.calls if c.dataset == 0), None)
    summary = getattr(reading, "summary", None)
    if first is not None and summary is not None and summary.busy_s > 0:
        u = sum(b - a for a, b in call_device(sp.spans, first)) * 1e-9
        _say(f"  data set 0: device spans' union {u:.6f} s, the profiled "
             f"eager solve's busy {summary.busy_s:.6f} s (ratio "
             f"{u / summary.busy_s:.4f})")
    gaps = idle_gaps(sp.spans, sp.calls)
    _say("  idle by host span: " + ", ".join(
        f"{k} {v * 1e-6:.4f} ms" for k, v in
        sorted(gaps.items(), key=lambda kv: -kv[1])))
    cost = []
    for k in sorted({c.dataset for c in sp.calls}):
        win = [r.wall for r in records if r.dataset == k and r.out is not None]
        mine = [(c.end - c.start) * 1e-9 for c in sp.calls if c.dataset == k]
        if win and mine:
            cost.append((statistics.mean(mine), statistics.median(win)))
    on = statistics.mean((c.end - c.start) * 1e-9 for c in sp.calls)
    before = statistics.mean(w for _, w in sp.off)
    _say(f"  tracing on: mean call {on:.6f} s against {before:.6f} s "
         f"unrecorded just before: {100.0 * (on / before - 1.0):+.3f} %")
    if cost:
        on = sum(a for a, _ in cost) / len(cost)
        off = sum(b for _, b in cost) / len(cost)
        _say(f"  tracing on: mean call {on:.6f} s against the window's "
             f"median {off:.6f} s over the same data sets: "
             f"{100.0 * (on / off - 1.0):+.3f} %")
