"""Tile-plan sweep and time split of the SPIKE kernels #1 and #2 on one GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 -m collocfem_tpu_torch.tools.spike_tiles [--out DIR] [--solves]

Kernel #1 at K = 10,001 (b = 8, nq = 2: the headline's chain at N = 10,000)
and kernel #2 at K = 11,264 (r = 3: config 5's concatenated chain), on
seeded systems (the kernels do the same work whatever the values), in
float32 and float64.  For each tile count T of the sweep: the time per call
by CUDA events, and the device time of each launch (tile_sweep,
interface_solve, back_substitute, ...) by torch.profiler; from those the
cost of one block step of the tile phases and of the interface chain, and a
least-squares fit of time ~ a L + b T + c.  The plan ops/spike.py would pick
is timed too.  With --solves it also profiles one 15-iteration float32
fixed-work solve of the headline (chip_smoke.py phase 3) and of config 5's
soa layout (phase 5): device time by kernel, three unprofiled walls and
the device idle share of the best one.

Prints one line per measurement and, with --out, writes DIR/spike_tiles.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

from collocfem_tpu_torch.ops import _build, spike
from collocfem_tpu_torch.testing import random_chain, random_kkt_system

SWEEP = {10001: (40, 60, 80, 100, 125, 150, 200, 300),
         11264: (40, 60, 80, 100, 125, 150, 200, 300)}
PHASES = ("tile_sweep", "interface_solve", "back_substitute", "schur_solve",
          "compose")


def _cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def _split(fn, reps=10):
    """{phase: device µs per call} of fn() by torch.profiler, or {} when the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        for ph in PHASES:
            if ph in evt.key and "kkt::" in evt.key:
                out[ph] = out.get(ph, 0.0) + _device_us(evt) / reps
    return out


def _fit(points):
    """Least squares of ms ~ a L + b T + c over [(T, L, ms)]: (a, b, c) in
    µs."""
    A = torch.tensor([[L, T, 1.0] for T, L, _ in points], dtype=torch.float64)
    y = torch.tensor([ms * 1e3 for *_, ms in points], dtype=torch.float64)
    return torch.linalg.lstsq(A, y[:, None]).solution[:, 0].tolist()


def _cases(dtype, dev):
    s = random_kkt_system(10001, 8, 2, seed=1, dtype=dtype, device=dev)
    D, E, G = random_chain(11264, 8, 3, seed=2, boundary=11, dtype=dtype,
                           device=dev)
    return {
        "kkt_solve_spike_fused": (10001, lambda: spike.kkt_solve_spike_fused(
            s.D, s.E, s.B, s.gx, s.C, s.gp, 1e-3)),
        "blocktri_solve_spike_fused": (
            11264, lambda: spike.blocktri_solve_spike_fused(D, E, G)),
    }


def sweep(dev, record):
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        for kname, (K, call) in _cases(dtype, dev).items():
            points = []
            for T in (*SWEEP[K], None):
                plan = spike._plan(K, T)
                with mock.patch.object(spike, "_plan", lambda k, p=plan: p):
                    ms = _cuda_ms(call)
                    split = _split(call)
                Tp, L = plan
                M = L - 2
                row = dict(kernel=kname, dtype=dname, K=K, T=Tp, L=L, ms=ms,
                           split_us=split, chosen=T is None)
                if split:
                    row["step_us"] = dict(
                        tile_sweep=split.get("tile_sweep", 0) / (2 * M),
                        back_substitute=split.get("back_substitute", 0) / M,
                        interface_solve=split.get("interface_solve", 0)
                        / (2 * 2 * Tp))
                record.setdefault("sweep", []).append(row)
                if T is not None:
                    points.append((Tp, L, ms))
                print(f"{kname} {dname} K={K} T={Tp} L={L}"
                      f"{' (plan)' if T is None else ''}: {ms:.4f} ms; "
                      + ", ".join(f"{k} {v:.1f} us" for k, v in split.items())
                      + ("; per step " + ", ".join(
                          f"{k} {v:.3f} us" for k, v in row["step_us"].items())
                         if split else ""), flush=True)
            a, b, c = _fit(points)
            record.setdefault("fit", []).append(dict(
                kernel=kname, dtype=dname, K=K, a_us=a, b_us=b, c_us=c))
            print(f"{kname} {dname}: fit ms ~ {a:.3f} us L + {b:.3f} us T + "
                  f"{c:.1f} us", flush=True)


def _profile(label, run, record):
    """Walls (3 unprofiled runs after a warm-up) and one profiled run of
    run(): device time by kernel, kernel count, device idle share of the
    best wall."""
    from torch.profiler import ProfilerActivity, profile

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, n_kernels = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = us
            n_kernels += evt.count
    total = sum(by_name.values())
    idle = 1 - total / 1e6 / min(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    record[label] = dict(walls_s=walls, device_ms=total / 1e3,
                         device_kernels=n_kernels, idle_share=idle,
                         top_us=top)
    print(f"{label}: walls {walls} s; device time {total / 1e3:.3f} ms over "
          f"{n_kernels} kernels; idle share {idle:.3f}", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:8.3f} ms {100 * us / total:5.1f} %  {name[:90]}")


def solves(dev, record):
    """Profiles of the float32 fixed-work solves that run kernels #1 and
    #2: the headline at N = 10,000 (chip_smoke.py phase 3) and config 5's
    soa layout (phase 5)."""
    from collocfem_tpu_torch.batched import build_config5_problem
    from collocfem_tpu_torch.headline import build_headline_problem
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.parallel.batch import make_multi_experiment_solver
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    mesh, t_meas, y, u_nodes = build_headline_problem(10000)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=100.0, device=dev,
                                   dtype=torch.float32)
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
    solve = make_gn_solver(prob, SolverOptions(
        maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=0, lam0=3e-6,
        lam_max=1e30))
    _profile("headline fixed work float32", lambda: solve(z0, data), record)

    prob, z0, data, p_prior, p_w = build_config5_problem(
        1024, dtype=torch.float32, device=dev)
    solve = make_multi_experiment_solver(prob, SolverOptions(
        maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30), layout="soa")
    _profile("config 5 soa fixed work float32",
             lambda: solve(z0, data, p_prior, p_w), record)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--solves", action="store_true",
                    help="also profile the fixed-work solves")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spike_tiles: no CUDA device", file=sys.stderr)
        return 2
    import collocfem_tpu_torch  # noqa: F401  (applies the precision policy)

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    record = {"card": card}
    print(f"card {card}", flush=True)
    built = _build.load_all([spike.kkt_instance(8, 2),
                             spike.chain_instance(8, 3)])
    for inst, b in built.items():
        print(f"built {inst.name} in {b.seconds:.1f} s", flush=True)
    sweep(dev, record)
    if args.solves:
        solves(dev, record)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "spike_tiles.json"), "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
