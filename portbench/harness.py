"""One run of one cell: set-up, the timed window, the traced solve, the
check against the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic (``workloads/<traffic>.json`` under the benchmark's folder).  The
traffic says which of the port's entries runs (``port.py``), at what mesh
size and precision, with which solver options, over how many data sets,
and the limits of the check.  The window is a closed loop with one caller:
solves run back to back, each from the cold initial guess of its data set,
the data sets in an order drawn from the seed, until ``seconds`` have
passed; each solve's wall runs from its call to a ``synchronize()`` after
its outputs.  A per-layer metric is ``metrics/<name>.py``, whose
``read(reading)`` returns a number or None; the harness lists the metrics
of a cell from ``BENCHMARK.json`` and loads each by name.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import data, reference, trace
from portbench.nojax import forbidden_modules


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports."""
    root = Path(root)
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench_dir = root / spec["paths"][0]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "workloads" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", cells)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                bench_dir)


def load_reader(bench_dir: Path, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    dataset: int
    wall: float
    out: object = None          # port.Output, None where the call raised
    error: str = ""


@dataclass
class Reading:
    """What a per-layer metric's reader reads."""

    cell: Cell
    summary: object             # trace.TraceSummary of the profiled solve
    steps: list                 # [(elements, LM steps run)] a level
    captured_wall: float        # mean window wall of the profiled data set
    iterations: list = field(default_factory=list)  # each window solve's

    @property
    def config(self):
        return self.cell.config

    @property
    def width(self) -> int:
        return 4 if self.cell.traffic["dtype"] == "float32" else 8

    @property
    def total_steps(self) -> int:
        return sum(s for _, s in self.steps)

    def family_seconds_per_step(self, family: str, level: int = -1):
        """Device seconds of ``family``'s kernels per LM step of ``level``
        (the levels before it run none), or None where none ran."""
        if self.summary is None:
            return None
        sec = self.summary.by_family.get(family, 0.0)
        steps = self.steps[level][1]
        return sec / steps if sec > 0 and steps else None


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def window(sut, n_sets: int, seconds: float, rng, device, keep_v):
    """The closed loop: returns (records, window seconds)."""
    order = rng.permutation(n_sets)
    seen = np.zeros(n_sets, dtype=np.int64)
    records = []
    _sync(device)
    t0 = time.perf_counter()
    while True:
        k = int(order[len(records) % n_sets])
        ts = time.perf_counter()
        try:
            out = sut(k)
            _sync(device)
            err = ""
        except Exception as exc:    # a failed solve is counted, not fatal
            out, err = None, f"{type(exc).__name__}: {exc}"
        te = time.perf_counter()
        rec = Record(k, te - ts, out, err)
        if out is not None:
            # One V of each data set is kept for the check, drawn from the
            # seed (reservoir sampling); every solve's p and cost are kept.
            seen[k] += 1
            keep = rng.random() * seen[k] < 1.0
            keep_v[k] = out.V if keep else keep_v.get(k)
            rec.out = out._replace(V=None)
        records.append(rec)
        if te - t0 >= seconds:
            return records, te - t0


def _answers(records):
    """Host copies of every recorded solve's (p, cost, iterations,
    converged)."""
    rows = []
    for rec in records:
        if rec.out is None:
            rows.append(None)
            continue
        o = rec.out
        rows.append((o.p.double().cpu().numpy(), float(o.cost),
                     int(o.iterations), bool(o.converged)))
    return rows


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / max(np.max(np.abs(b)), 1e-300))


def check(cell: Cell, records, rows, keep_v, refs):
    """(checks, failed): each number compared beside its limit, and the
    number of failed solves (raised, non-finite, or not converged where the
    traffic requires it)."""
    need_conv = bool(cell.traffic.get("require_converged", False))
    failed = 0
    p_gaps, cost_gaps, v_gaps = [0.0], [0.0], [0.0]
    for rec, row in zip(records, rows):
        if row is None:
            failed += 1
            continue
        p, cost, _, conv = row
        if not (np.all(np.isfinite(p)) and math.isfinite(cost)):
            failed += 1
            continue
        failed += need_conv and not conv
        ref = refs.get(rec.dataset)
        if ref is None:
            continue
        p_gaps.append(_rel(p, ref.p))
        cost_gaps.append(abs(cost - ref.cost) / abs(ref.cost))
    for k, V in keep_v.items():
        if V is not None and k in refs:
            v_gaps.append(_rel(V.double().cpu().numpy(), refs[k].V))
    # np.max keeps a NaN, which then fails its limit.
    p_rel, v_rel, cost_rel = (float(np.max(g)) for g in
                              (p_gaps, v_gaps, cost_gaps))
    lim = cell.traffic["limits"]
    checks = {"failed": {"value": failed, "limit": 0}}
    for name, value in (("p_rel", p_rel), ("V_rel", v_rel),
                        ("cost_rel", cost_rel)):
        checks[name] = {"value": value if math.isfinite(value) else None,
                        "limit": lim[name]}
    return checks, failed


def _passes(checks) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def _device_info(device):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def card_notes() -> None:
    """The card's name and power limit and the torch build, on standard
    error: a number kept from this run stands beside them."""
    import subprocess

    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f"nvidia-smi unavailable ({exc})"
    _say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")


def _prebuild(traffic, device):
    import torch

    if torch.device(device).type != "cuda" or not traffic.get("prebuild"):
        return
    from collocfem_tpu_torch.ops import _build

    _build.load_all([_build.Instance(*i) for i in traffic["prebuild"]])


def run(cell: Cell, seed: int, seconds: float, trace_on: bool,
        device: str, t_start: float, build=None) -> dict:
    """One run of ``cell`` (:func:`load_cell`); returns the result line's
    object.  ``t_start`` is the process's start on ``time.perf_counter``'s
    clock; ``build(config, traffic, data_sets, device)`` makes the system
    under test (``port.build`` unless given: the control puts another in
    its place)."""
    import torch

    from portbench import port

    t_run = time.perf_counter()
    cfg, tr = cell.config, cell.traffic
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _prebuild(tr, device)
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    sets = data.datasets(cfg, tr, seed)
    t_data = time.perf_counter() - t
    t = time.perf_counter()
    sut = (build or port.build)(cfg, tr, sets, device)
    t_sut = time.perf_counter() - t
    warm = []
    for _ in range(2):           # the capture, then one replay
        t = time.perf_counter()
        sut(0)
        _sync(device)
        warm.append(time.perf_counter() - t)
    gc.collect()
    t_setup = time.perf_counter() - t_start
    _say(f"set-up {t_setup:.3f} s: start and imports {t_run - t_start:.3f}, "
         f"kernels {t_build:.3f}, data {t_data:.3f}, problem and solver "
         f"{t_sut:.3f}, first solve (capture) {warm[0]:.3f}, second "
         f"{warm[1]:.3f}")

    rng = np.random.default_rng([int(seed) % 2 ** 63, 1 << 20])
    keep_v = {}
    records, win = window(sut, len(sets), seconds, rng, device, keep_v)
    walls = np.array([r.wall for r in records])
    dev = _device_info(device)
    rows = _answers(records)
    errors = sorted({r.error for r in records if r.error})
    for e in errors:
        _say(f"a solve raised: {e}")
    _say(f"window {win:.4f} s, {len(records)} solves; wall median "
         f"{np.median(walls):.6f} s, min {walls.min():.6f}, max "
         f"{walls.max():.6f}")
    for k in sorted({r.dataset for r in records}):
        w = np.array([r.wall for r in records if r.dataset == k])
        its = sorted({row[2] for r, row in zip(records, rows)
                      if r.dataset == k and row is not None})
        _say(f"  data set {k}: {w.size} solves, {its} iterations, wall "
             f"median {np.median(w):.6f} s, min {w.min():.6f}, max "
             f"{w.max():.6f}")

    metrics = {}
    breakdown = None
    if not trace_on:
        values = {
            "setup_s": t_setup,
            "solve_s": win / len(records),
            "peak_mem_GiB": (dev["memory_peak_bytes"] / 2 ** 30
                             if dev["platform"] == "gpu" else None),
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        on0 = [r.wall for r in records if r.dataset == 0]
        _, prof, pwall = trace.profile(lambda: sut.eager(0), device)
        summary = trace.summarize(prof, pwall, trace.families(cell.bench_dir))
        del prof
        reading = Reading(cell, summary, sut.steps(),
                          float(np.mean(on0 or walls)),
                          [row[2] for row in rows if row is not None])
        for m in cell.per_layer:
            value = load_reader(cell.bench_dir, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        breakdown = {"device_ops": summary.top_ops,
                     "idle_gaps": summary.idle_gaps}
        _say(f"profiled eager solve: wall {pwall:.4f} s, busy "
             f"{summary.busy_s:.4f} s, {summary.launches} kernels, by "
             f"family {summary.by_family}, other {summary.unmapped_s:.6f} s; "
             f"steps {reading.steps}")

    # The port's state goes before the reference runs.
    del sut
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    used = sorted({r.dataset for r in records})
    # The reference answers a sample of the data sets drawn from the seed;
    # every solve of a sampled set is compared.
    n_ref = int(tr.get("reference_sample", len(used)))
    used = sorted(rng.choice(used, size=min(n_ref, len(used)),
                             replace=False).tolist())
    refs = {k: reference.solve(cfg, tr, sets[k]) for k in used}
    _say(f"reference: {len(used)} data set(s) in "
         f"{time.perf_counter() - t:.3f} s; iterations "
         f"{[refs[k].iterations for k in used]}")
    checks, failed = check(cell, records, rows, keep_v, refs)
    its = sorted({row[2] for row in rows if row is not None})
    _say(f"LM iterations a solve: {its}")

    result = {"correct": _passes(checks), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def finish(result: dict) -> int:
    """Check that no JAX module was loaded, print the checks on standard
    error and the result line on standard output; returns the exit code."""
    found = forbidden_modules()
    if found:
        _say(f"JAX or the JAX package was loaded: {found}")
        return 4
    for name, c in result["checks"].items():
        _say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
