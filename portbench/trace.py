"""Device time of one profiled solve, by kernel, kernel family and idle gap.

``torch.profiler`` does not trace the kernels inside a CUDA graph's
conditional (WHILE) body, which is where a converging captured solve runs
its LM steps.  So the traced run profiles the same solve on the port's
eager loop, which runs the same kernels bit for bit, and the per-layer
metrics set its device time against the captured solve's wall.

A kernel family (``kernels/<family>.json``) lists the ``__global__`` names
of one library of the port's ``csrc/``; a kernel is matched by its base
name (the identifier before any template or argument list).  Device time
outside every family is the assembly and the LM step (cuBLAS, elementwise).
"""

from __future__ import annotations

import bisect
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

_NOT_KERNELS = ("Memcpy", "Memset")


def families(bench_dir: Path) -> dict[str, str]:
    """{kernel base name: family} from every ``kernels/*.json``."""
    out = {}
    for path in sorted((bench_dir / "kernels").glob("*.json")):
        for name in json.loads(path.read_text())["kernels"]:
            out[name] = path.stem
    return out


def base_name(kernel: str) -> str:
    """'void ns::tile_sweep<double, 8>(Args<double>)' -> 'tile_sweep'."""
    head = re.split(r"[<(]", kernel.strip(), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else kernel


@dataclass
class TraceSummary:
    window_s: float                      # wall of the profiled block
    busy_s: float = 0.0                  # union of device activity
    kernel_s: float = 0.0                # sum of kernel durations
    launches: int = 0                    # kernels (no copies, no memsets)
    by_family: dict = field(default_factory=dict)   # family -> seconds
    unmapped_s: float = 0.0              # kernels in no family
    top_ops: list = field(default_factory=list)     # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)   # [[host op, seconds]]


def profile(fn, device):
    """Run ``fn()`` under torch.profiler; returns (its result, the
    profiler, the wall of the block in seconds)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def summarize(prof, wall: float, fam: dict[str, str]) -> TraceSummary:
    from torch.autograd import DeviceType

    dev, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, evt.name))
        elif evt.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, evt.name))
    out = TraceSummary(window_s=wall)
    by_name = {}
    for start, end, name in dev:
        sec = (end - start) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + sec
        if name.startswith(_NOT_KERNELS):
            continue
        out.launches += 1
        out.kernel_s += sec
        f = fam.get(base_name(name))
        if f is None:
            out.unmapped_s += sec
        else:
            out.by_family[f] = out.by_family.get(f, 0.0) + sec
    out.top_ops = [[n[:120], s] for n, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    # Union of device intervals, and the gaps between them labelled by the
    # innermost host op running at the gap's middle.
    dev.sort()
    merged = []
    for start, end, _ in dev:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    out.busy_s = sum(e - s for s, e in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host"
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    out.idle_gaps = [[n[:120], s] for n, s in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:10]]
    return out
