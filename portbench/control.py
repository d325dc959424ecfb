"""Readings of a cell's check on many seeds in one process: the program's
own (``--mode program``, the lower readings of each limit) or the
control's (``--mode control``, the upper readings).

    python3 portbench/control.py --workload <cell> --mode control \
        --seeds 11,12,13 --seconds 2

The control is the cell's traffic ``control``: ``program_float32`` runs the
port's own float32 path in the program's place; ``reference_float32`` puts
the plain reference, computed in float32, in the program's place.  Each
seed runs a short window through the benchmark's own loop and check and
prints one JSON line of the numbers compared.  The benchmark's runs do not
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class ReferenceInPlace:
    """The plain reference in ``dtype``, answering as the port does."""

    def __init__(self, cfg, traffic, sets, device, dtype):
        self.cfg, self.traffic, self.sets = cfg, traffic, sets
        self.device, self.dtype, self.done = device, dtype, {}

    def __call__(self, k):
        import torch

        from portbench import reference
        from portbench.port import Output

        if k not in self.done:
            a = reference.solve(self.cfg, self.traffic, self.sets[k],
                                self.dtype)
            t = lambda x, dt=torch.float64: torch.as_tensor(
                np.asarray(x), dtype=dt, device=self.device)
            self.done[k] = Output(t(a.V.astype(np.float64)),
                                  t(a.p.astype(np.float64)), t(a.cost),
                                  t(a.iterations, torch.int64),
                                  t(a.converged, torch.bool))
        return self.done[k]


def builder(mode: str, control: str):
    from portbench import port

    if mode == "program":
        return port.build
    if control == "program_float32":
        return lambda cfg, tr, sets, dev: port.build(
            cfg, {**tr, "dtype": "float32", "cold_dtype": "float32"}, sets,
            dev)
    if control == "reference_float32":
        return lambda cfg, tr, sets, dev: ReferenceInPlace(
            cfg, tr, sets, dev, np.float32)
    raise ValueError(f"unknown control {control!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    build = builder(args.mode, cell.traffic.get("control", ""))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, "cuda", t0,
                          build=build)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "readings": {k: v["value"] for k, v in
                                       res["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
