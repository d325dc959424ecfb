"""A copy of the benchmark with tiny cells, for the CPU tests.

``tiny_root(tmp)`` copies BENCHMARK.json and the benchmark's folder into
``tmp`` and adds, as new files and new entries only, one tiny cell for each
real one: the same entry, options, check limits and control, at a mesh and
batch the CPU solves in seconds.  The ladder's tiny cell (N = 32) takes the
branch past ``refine.CR_DW_CHAIN`` once the test lowers that limit to 8.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny cell -> (real cell, config overrides, traffic overrides)
TINY = {
    "tiny.conv": ("vdp.n10k_conv_f64", {}, {"elements": 40, "datasets": 3,
                                             "reference_sample": 2}),
    "tiny.soa": ("batch.soa_conv_f64", {"experiments": 6}, {"datasets": 2}),
    "tiny.blocks": ("batch.blocks_conv_f64", {"experiments": 6},
                    {"datasets": 2}),
    "tiny.ladder": ("vdp.n100k_ladder", {}, {"elements": 32}),
}


def tiny_root(tmp: Path) -> Path:
    root = Path(tmp) / "bench"
    root.mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "portbench"
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for name, (real, cfg_over, tr_over) in TINY.items():
        w = cells[real]
        cfg_name = w["config"]
        if cfg_over:
            cfg_name = f"{name}.cfg"
            cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
            cfg.update(cfg_over)
            (bench / "configs" / f"{cfg_name}.json").write_text(
                json.dumps(cfg))
            spec["configs"].append(dict(configs[w["config"]], name=cfg_name,
                                        file=f"portbench/configs/{cfg_name}.json"))
        tr = json.loads((bench / "workloads" / f"{w['traffic']}.json")
                        .read_text())
        tr.update(tr_over)
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(tr))
        spec["workloads"].append(dict(w, name=name, config=cfg_name,
                                      traffic=name))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root: Path, cell: str, *, seed: int = 20261018, trace: bool = False,
        seconds: float = 0.2, build=None) -> dict:
    """One run of a tiny cell on the CPU, as ``portbench/run.py`` runs a
    real one on the card."""
    from portbench import harness

    return harness.run(harness.load_cell(root, cell), seed, seconds, trace,
                       "cpu", time.perf_counter(), build=build)
