"""Drive the PyTorch port's headline estimation on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--out DIR]

Phases, each printing its own line; any failure raises and exits non-zero:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the fused KKT kernel from csrc/ with nvcc (time, ptxas summary);
  2. hold the kernel against its plain PyTorch version on the card: on the
     headline system assembled at the initial guess (K = 10,001, b = 8,
     nq = 2) and on seeded SPD chains.  float64: max|dx - dx_ref| /
     max|dx_ref| <= 1e-9 and the same for dp.  float32 (the headline system
     is ill-conditioned): the kernel's relative KKT residual
     ||(A + lam I) dx + B dp + gx||_inf / ||gx||_inf, computed in float64,
     is at most 10x the plain version's.  Times both at the headline shape;
  3. the headline fixed work: Van der Pol, N = 10,000 elements, degree 4,
     float32, 15 LM iterations; the cost must fall more than 10x, p must be
     finite, and the kernel's launch count must rise by exactly 15 with no
     call of the plain version;
  4. the same problem in float64 to convergence: ||p - [1, 1]||_inf < 1e-4.

The second-to-last lines are the card's name and power limit and a JSON
object describing every kernel of the path; the last line is
{"ok": true, "device": {...}}.  With --out DIR the same records are also
written to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ELEMENTS = 10000
SPIKE_SOURCE = "collocfem_tpu_torch/csrc/kkt_spike.cu"
SPIKE_REPLACES = "collocfem_tpu/ops/spike_pallas.py:761"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

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


def _kkt_residual(sys_, dx, dp, lam, dmax):
    """Relative x-block residual ||(A + lam_abs I) dx + B dp + gx||_inf /
    ||gx||_inf of the damped system, in float64."""
    import torch

    D, E, B, _, gx, _ = (a.double() for a in sys_)
    dx, dp = dx.double(), dp.double()
    lam_abs = float(lam) * float(dmax)
    E = E[..., :-1]                            # E[..., K-1] is unused
    y = torch.einsum("ijk,jk->ik", D, dx) + lam_abs * dx
    y[:, :-1] += torch.einsum("ijk,jk->ik", E, dx[:, 1:])
    y[:, 1:] += torch.einsum("jik,jk->ik", E, dx[:, :-1])
    y += torch.einsum("iqk,q->ik", B, dp) + gx
    return float(y.abs().max() / gx.abs().max())


def _rel_diff(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _compare(sys_, lam, damp_scale, label):
    """Kernel vs plain version on one system; returns the max abs error."""
    import torch

    from collocfem_tpu_torch.ops import spike

    args = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam, damp_scale)
    got = spike.kkt_solve_spike_fused(*args)
    want = spike.kkt_solve_spike_fused_ref(*args)
    torch.cuda.synchronize()
    for x in got:
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{label}: the kernel returned non-finite values")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    if sys_.D.dtype == torch.float64:
        rel = [_rel_diff(g, w) for g, w in zip(got[:2], want[:2])]
        ok = max(rel) <= 1e-9
        print(f"  {label}: rel diff dx {rel[0]:.3e} dp {rel[1]:.3e} "
              f"(<= 1e-9) {'ok' if ok else 'FAIL'}")
    else:
        res_k = _kkt_residual(sys_, got[0], got[1], lam, got[2])
        res_p = _kkt_residual(sys_, want[0], want[1], lam, want[2])
        ok = res_k <= 10.0 * res_p
        print(f"  {label}: KKT residual kernel {res_k:.3e} plain {res_p:.3e} "
              f"(<= 10x) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the kernel disagrees with its plain "
                           "version")
    return err


def _headline(dtype, device):
    from collocfem_tpu_torch.headline import build_headline_problem
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.problem import EstimationProblem

    mesh, t_meas, y, u_nodes = build_headline_problem(ELEMENTS)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=100.0, device=device,
                                   dtype=dtype)
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
    return prob, data, z0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/chip_smoke.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import collocfem_tpu_torch  # noqa: F401  (applies the precision policy)
    from collocfem_tpu_torch.ops import spike
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.testing import random_kkt_system

    dev = torch.device("cuda", 0)
    card = _card()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"phase 0: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----------------------------------------------------
    built = spike.build_kernel()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if re.search(r"registers|spill", ln)]
    record["build_s"] = built.seconds
    record["ptxas"] = ptxas
    print(f"phase 1: built {built.path.name} in {built.seconds:.1f} s "
          f"({'fresh' if built.seconds else 'reused'})")
    for ln in ptxas:
        print(f"  {ln}")

    # ---- phase 2: kernel vs plain version ----------------------------------
    lam = 3e-6                                  # the fixed-work run's lam0
    max_err = 0.0
    times = {}
    print("phase 2: kernel vs plain version on the card")
    for dtype in (torch.float32, torch.float64):
        prob, data, z0 = _headline(dtype, dev)
        sys_ = assemble_gn_soa(prob, z0, data)
        name = str(dtype).split(".")[1]
        err = _compare(sys_, lam, None, f"headline {name} K={sys_.num_blocks}")
        if dtype == torch.float64:
            max_err = err
        call = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam)
        times[name] = (
            _cuda_ms(lambda: spike.kkt_solve_spike_fused(*call), 20),
            _cuda_ms(lambda: spike.kkt_solve_spike_fused_ref(*call), 3))
        print(f"  headline {name}: kernel {times[name][0]:.3f} ms/call, "
              f"plain {times[name][1]:.3f} ms/call")
        for k in (3, 7, 1000, 10001):
            for damp_scale in ((None, 50.0) if k == 1000 else (None,)):
                rs = random_kkt_system(k, 8, 2, seed=k, dtype=dtype,
                                       device=dev)
                _compare(rs, 1e-3, damp_scale,
                         f"random {name} K={k} damp_scale={damp_scale}")
    record["kernel_ms"] = {k: v[0] for k, v in times.items()}
    record["plain_ms"] = {k: v[1] for k, v in times.items()}

    # ---- phase 3: headline fixed work, float32 -----------------------------
    prob, data, z0 = _headline(torch.float32, dev)
    opts = SolverOptions(maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0,
                         kkt_refine=0, lam0=3e-6, lam_max=1e30)
    solve = make_gn_solver(prob, opts)
    spike.kkt_solve_spike_fused.launches = 0
    spike.kkt_solve_spike_fused_ref.launches = 0
    z, stats = solve(z0, data)
    torch.cuda.synchronize()
    launches = spike.kkt_solve_spike_fused.launches
    plain_calls = spike.kkt_solve_spike_fused_ref.launches
    c0, c_end = float(prob.cost(z0, data)), float(stats.cost)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(z0, data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    p = z.p.tolist()
    record.update(fixed_work_wall_s=min(walls), fixed_work_walls_s=walls,
                  fixed_work_cost=[c0, c_end], fixed_work_p=p,
                  fixed_work_accepts=stats.history[:, 4].tolist())
    print(f"phase 3: N={ELEMENTS} float32, 15 LM iterations: cost {c0:.6e} -> "
          f"{c_end:.6e}, p={p}, kernel launches {launches}, plain calls "
          f"{plain_calls}; best of 3 wall {min(walls):.4f} s on {card}")
    if not (c_end < 0.1 * c0 and all(math.isfinite(v) for v in p)):
        raise RuntimeError("the fixed-work solve did no useful work")
    if launches != 15 or plain_calls != 0:
        raise RuntimeError(f"expected 15 kernel launches and no plain calls, "
                           f"got {launches} and {plain_calls}")

    # ---- phase 4: float64 convergence --------------------------------------
    prob, data, z0 = _headline(torch.float64, dev)
    solve = make_gn_solver(prob, SolverOptions(maxiter=60, gtol=1e-10,
                                               xtol=1e-12))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, stats = solve(z0, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p = z.p.tolist()
    p_err = max(abs(v - 1.0) for v in p)
    its = int(stats.iterations)
    record.update(f64_wall_s=wall, f64_iterations=its, f64_p=p,
                  f64_p_err=p_err, f64_converged=bool(stats.converged))
    print(f"phase 4: N={ELEMENTS} float64: {its} iterations, p={p}, "
          f"p err {p_err:.3e}, wall {wall:.3f} s on {card}")
    if not p_err < 1e-4:
        raise RuntimeError("the float64 solve did not reach ||p - 1|| < 1e-4")

    kernels = {"kernels": [{
        "name": "kkt_solve_spike_fused", "route": "cuda",
        "source": SPIKE_SOURCE, "replaces": SPIKE_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": times["float32"][0], "plain_ms": times["float32"][1],
    }]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump({**record, **kernels, "device": device}, fh, indent=1)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
