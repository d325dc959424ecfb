"""Times of the converging captured solves on one GPU, for comparing two
trees of the port on the same card.

Usage (on a machine with a CUDA card):

    python3 collocfem_tpu_torch/tools/loop_exit.py [--root DIR] [--tag T]
        [--out FILE]

imports ``collocfem_tpu_torch`` from DIR (default: this checkout), so the
same script times another tree, e.g. an older commit unpacked with ``git
archive``; run the two in turns (old, new, new, old) in one call.  Cases,
each after a first call that captures:

  * the MHE serving stream of examples/mhe_online.py (testing.
    mhe_online_stream: 228 steps after the first window) in float64 and
    float32: every step's wall, bracketed by torch.cuda.synchronize(), as
    median and p90, and the device idle share over 20 steps;
  * config 3 at N = 25, float64 (make_ocp_solver, the AL homotopy): best
    of 3 walls and the idle share of the best;
  * the headline (Van der Pol, N = 10,000) in float64 to gtol 1e-10 and, as
    a control that reads nothing in either tree, in float32 at 15
    fixed-work iterations: best of 3 walls and idle shares.

An idle share is 1 - device time / the captured wall, the device time that
of the same kernels in one profiled eager run (``.eager``,
``step_eager``), in both trees: torch.profiler does not trace the kernels
inside a CUDA-graph conditional node.

Each record also holds ``loop_nodes``, the node counts of the graphs a
converging solve's loop graph is made of, where the tree builds one.
Prints one JSON line per case and the card's name and power limit; with
--out, appends the records to FILE as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def _wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_s(fn) -> float:
    """Device time of fn() in seconds by torch.profiler (kernels and
    copies), or 0.0 when the profiler shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += next((float(getattr(evt, n)) for n in (
                "device_time_total", "cuda_time_total")
                if getattr(evt, n, None)), 0.0)
    return total / 1e6


def _best_of_3(fn, eager):
    walls = [_wall(fn)[1] for _ in range(3)]
    best = min(walls)
    return dict(walls_s=walls, best_s=best,
                idle_share=1 - _device_s(eager) / best)


def _loop_nodes(solve):
    """The nodes of the graphs a tree's loop graph was built from (before,
    step, after; None where the tree has no loop graph)."""
    plan = next(iter(solve._plans.values()))
    return getattr(plan, "loop_nodes", None)


def _mhe(dtype, dev):
    import numpy as np

    from collocfem_tpu_torch.testing import MHE_HORIZON, mhe_online_stream

    mhe, _, ys = mhe_online_stream(dtype, dev)
    first = state = mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2))
    walls = []
    for k in range(MHE_HORIZON, ys.shape[0]):
        (state, _), wall = _wall(lambda: mhe.step(state, ys[k]))
        walls.append(wall)
    steps = walls[1:]                      # the first step captures

    def run20(step):
        st = first
        for k in range(MHE_HORIZON, MHE_HORIZON + 20):
            st, _ = step(st, ys[k])

    wall20 = _wall(lambda: run20(mhe.step))[1]
    w = np.asarray(steps) * 1e3
    return dict(first_step_s=walls[0], steps=len(steps),
                loop_nodes=_loop_nodes(mhe._solver),
                median_ms=float(np.median(w)),
                p90_ms=float(np.percentile(w, 90)), wall_20_s=wall20,
                idle_share_20=1 - _device_s(
                    lambda: run20(mhe.step_eager)) / wall20)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("loop_exit: no CUDA device", file=sys.stderr)
        return 2
    import collocfem_tpu_torch
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    dev = torch.device("cuda", 0)
    card = _card()
    rec = dict(tag=args.tag, root=os.path.abspath(args.root),
               package=os.path.dirname(collocfem_tpu_torch.__file__),
               card=card)
    print(f"loop_exit {args.tag}: {rec['package']} on {card}", flush=True)
    for name, dtype in (("float64", torch.float64),
                        ("float32", torch.float32)):
        rec[f"mhe {name}"] = _mhe(dtype, dev)
        print(json.dumps({f"mhe {name}": rec[f"mhe {name}"]}), flush=True)

    prob, z0 = configs.build_config3_problem(25, dtype=torch.float64,
                                             device=dev)
    solve = make_ocp_solver(prob, ALBarrierOptions())
    (_, st), first = _wall(lambda: solve(z0))
    r = rec["config 3 N=25 float64"] = dict(
        first_call_s=first, inner_iterations=int(st.history[:, 4].sum()),
        loop_nodes=_loop_nodes(solve),
        **_best_of_3(lambda: solve(z0), lambda: solve.eager(z0)))
    print(json.dumps({"config 3 N=25 float64": r}), flush=True)

    for name, dtype, opts in (
            ("headline float64 gtol", torch.float64,
             dict(maxiter=60, gtol=1e-10, xtol=1e-12)),
            ("headline float32 fixed", torch.float32,
             dict(maxiter=15, gtol=0.0, lam0=3e-6, lam_max=1e30))):
        prob, data, z0 = headline_problem(10000, dtype=dtype, device=dev)
        solve = make_gn_solver(prob, SolverOptions(**opts))
        (_, st), first = _wall(lambda: solve(z0, data))
        r = rec[name] = dict(first_call_s=first,
                             iterations=int(st.iterations),
                             loop_nodes=_loop_nodes(solve),
                             **_best_of_3(lambda: solve(z0, data),
                                          lambda: solve.eager(z0, data)))
        print(json.dumps({name: r}), flush=True)
    print(card)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
