"""Drive the PyTorch port's estimation paths on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--out DIR]

Phases, each printing its own line; any failure raises and exits non-zero:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every kernel library from csrc/ with nvcc, one process per
     library, all at once (time, ptxas registers and spills per kernel);
  2. hold each kernel against its plain PyTorch version on the card.
     float64: max|x - x_ref| / max|x_ref| <= 1e-9.  float32 (the systems
     are ill-conditioned): the kernel's relative residual, computed in
     float64, is at most 10x the plain version's.
       kernel #1 (fused damped KKT): the headline system at the initial
         guess (K = 10,001, b = 8, nq = 2) and seeded SPD chains; the
         residual is ||(A + lam I) dx + B dp + gx||_inf / ||gx||_inf;
       kernel #2 (SPIKE chain solve): config 5's concatenated chain at the
         initial guess after the per-experiment damping and scaling
         (K = 11,264, b = 8, r = 3) and seeded chains, K in {1, 3, 7, 1000,
         11264}, r in {1, 3}; residual ||AX - G||_inf / ||G||_inf;
       kernel #7 (batched block Thomas): config 5's damped block-major
         systems at the initial guess (1024 x 11 blocks, b = 8, r = 3) and
         seeded batches, n_exp in {1, 5, 1000}, K in {1, 2, 11}.
     Times each kernel and its plain version (CUDA events);
  3. the headline fixed work: Van der Pol, N = 10,000 elements, degree 4,
     float32, 15 LM iterations; the cost must fall more than 10x, p must be
     finite, and the kernel's launch count must rise by exactly 15 with no
     call of a plain version;
  4. the same problem in float64 to convergence: ||p - [1, 1]||_inf < 1e-4;
  5. config 5's fixed work: 1024 experiments x 10 elements, degree 4,
     float32, 15 LM iterations, in both layouts: "soa" (kernel #2) and
     "blocks" (kernel #7).  Each: the cost falls more than 10x, p is finite,
     the layout's kernel launches exactly 15 times and no plain version is
     called; p's error against (1.3, 0.5) and the best-of-3 wall;
  6. config 5 in float64 to convergence (soa): p within 1e-6 (relative,
     inf-norm) of the JAX package's float64 result on the same problem.

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
N_EXP = 1024
SPIKE_SOURCE = "collocfem_tpu_torch/csrc/kkt_spike.cu"
THOMAS_SOURCE = "collocfem_tpu_torch/csrc/thomas.cu"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "kkt_solve_spike_fused": (SPIKE_SOURCE,
                              "collocfem_tpu/ops/spike_pallas.py:761"),
    "blocktri_solve_spike_fused": (SPIKE_SOURCE,
                                   "collocfem_tpu/ops/spike_pallas.py:714"),
    "batched_thomas_solve": (THOMAS_SOURCE,
                             "collocfem_tpu/ops/blocktri_pallas.py:78"),
}
C5_FIXED = dict(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30)
C5_CONVERGED = dict(maxiter=60, gtol=1e-10, xtol=1e-12, lam0=1e-6,
                    lam_max=1e30)
# The JAX package's float64 converged p on config 5 with C5_CONVERGED (27 LM
# iterations on the CPU), produced from the root of the repo by
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax; jax.config.update("jax_enable_x64", True)
#   import jax.numpy as jnp
#   from baseline_cpu.configs_baseline import make_config5_data
#   from collocfem_tpu.models import VanDerPol
#   from collocfem_tpu.parallel.batch import (BatchDecision,
#                                             make_multi_experiment_solver)
#   from collocfem_tpu.problem import EstimationProblem
#   from collocfem_tpu.solve import SolverOptions
#   mesh, t, y, u = make_config5_data(1024, 10)
#   prob = EstimationProblem.build(VanDerPol(), mesh, t, defect_weight=300.0)
#   ds = [prob.pack_data(y[e], t, u_nodes=u[e], meas_weight=100.0)
#         for e in range(1024)]
#   v0 = [prob.initial_guess_from_data(t, y[e], p0=[0, 0]).V
#         for e in range(1024)]
#   z0 = BatchDecision(V=jnp.stack(v0), p=jnp.asarray([2.0, 0.2]))
#   data = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ds)
#   solve = make_multi_experiment_solver(prob, SolverOptions(
#       maxiter=60, gtol=1e-10, xtol=1e-12, lam0=1e-6, lam_max=1e30),
#       layout="soa")
#   z, st = solve(z0, data, jnp.zeros(2), jnp.full((2,), 1e-3))
#   print(repr(z.p.tolist()), int(st.iterations))
#   EOF
P_JAX_F64 = (1.247731543218769, 0.4868102224118944)


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


def _ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: its name, registers and spills."""
    names = {}
    try:
        mangled = sorted(set(re.findall(r"_Z\w+", log)))
        out = subprocess.run(["c++filt"], input="\n".join(mangled),
                             capture_output=True, text=True, timeout=60)
        names = dict(zip(mangled, out.stdout.splitlines()))
    except (OSError, subprocess.SubprocessError):
        pass
    lines, current, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(_Z\w+)",
                      ln)
        if m:
            current = m.group(1)
        elif "spill" in ln and current:
            spill = ln.strip()
        m = re.search(r"Used (\d+) registers", ln)
        if m and current:
            name = names.get(current, current).split("(")[0]
            lines.append(f"{name}: {m.group(1)} registers; {spill}")
            current, spill = None, ""
    return lines


def _hold(label, dtype, got, want, residual):
    """float64: relative difference <= 1e-9; float32: residual of the
    kernel's result at most 10x the plain version's.  Returns the max abs
    error."""
    import torch

    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: the kernel returned non-finite values")
    if dtype == torch.float64:
        rel = _rel_diff(got, want)
        ok = rel <= 1e-9
        print(f"  {label}: rel diff {rel:.3e} (<= 1e-9) "
              f"{'ok' if ok else 'FAIL'}")
    else:
        res_k, res_p = residual(got), residual(want)
        ok = res_k <= 10.0 * res_p
        print(f"  {label}: residual kernel {res_k:.3e} plain {res_p:.3e} "
              f"(<= 10x) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the kernel disagrees with its plain "
                           "version")
    return float((got - want).abs().max())


def _reset_counts():
    from collocfem_tpu_torch.ops import spike, thomas

    for fn in (spike.kkt_solve_spike_fused, spike.kkt_solve_spike_fused_ref,
               spike.blocktri_solve_spike_fused,
               spike.blocktri_solve_spike_fused_ref,
               thomas.batched_thomas_solve, thomas.batched_thomas_solve_ref):
        fn.launches = 0


def _counts():
    from collocfem_tpu_torch.ops import spike, thomas

    kernels = {"kkt_solve_spike_fused": spike.kkt_solve_spike_fused,
               "blocktri_solve_spike_fused": spike.blocktri_solve_spike_fused,
               "batched_thomas_solve": thomas.batched_thomas_solve}
    plain = sum(f.launches for f in (spike.kkt_solve_spike_fused_ref,
                                     spike.blocktri_solve_spike_fused_ref,
                                     thomas.batched_thomas_solve_ref))
    return {k: f.launches for k, f in kernels.items()}, plain


def _config5_systems(c5, lam):
    """Config 5 at its initial guess: the scaled concatenated chain of the
    soa layout (Dsc, Esc, rhs) and the damped block-major systems of the
    blocks layout (D, E, rhs)."""
    import torch

    from collocfem_tpu_torch.ops.assemble import (assemble_gn_batched,
                                                  assemble_gn_soa_batched)
    from collocfem_tpu_torch.parallel.batch import damp_blocks, scale_concat_chain

    prob, z0, data, _, _ = c5
    lam = torch.as_tensor(lam, dtype=z0.V.dtype, device=z0.V.device)
    sys_ = assemble_gn_soa_batched(prob, z0.V, z0.p, data)
    chain = scale_concat_chain(sys_, lam, z0.V.shape[0])[:3]
    sys_b = assemble_gn_batched(prob, z0.V, z0.p, data)
    d_damped = damp_blocks(sys_b.D, lam)[0]
    blocks = (d_damped, sys_b.E,
              torch.cat([sys_b.gx[..., None], sys_b.B], dim=-1).contiguous())
    return chain, blocks


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
    from collocfem_tpu_torch.batched import MU_TRUE, B_TRUE, build_config5_problem
    from collocfem_tpu_torch.ops import _build, spike, thomas
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.parallel.batch import (batch_cost,
                                                    make_multi_experiment_solver)
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.testing import (batch_residual, chain_residual,
                                             random_chain, random_chain_batch,
                                             random_kkt_system)

    dev = torch.device("cuda", 0)
    card = _card()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"phase 0: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    built = _build.load_all(["kkt_spike", "thomas"])
    record["build_wall_s"] = time.perf_counter() - t0
    record["build_s"], record["ptxas"] = {}, {}
    print(f"phase 1: built {len(built)} libraries in "
          f"{record['build_wall_s']:.1f} s (one nvcc each, concurrently)")
    for name, b in built.items():
        ptxas = _ptxas_summary(b.log)
        record["build_s"][name] = b.seconds
        record["ptxas"][name] = ptxas
        print(f"  {b.path.name}: {b.seconds:.1f} s "
              f"({'fresh' if b.seconds else 'reused'})")
        for ln in ptxas:
            print(f"    {ln}")

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

    c5 = {dt: build_config5_problem(N_EXP, dtype=dt, device=dev)
          for dt in (torch.float32, torch.float64)}
    errs, c5_ms = {}, {}
    for dtype, problem in c5.items():
        name = str(dtype).split(".")[1]
        (Dc, Ec, Gc), (Db, Eb, Gb) = _config5_systems(problem,
                                                      C5_FIXED["lam0"])
        errs[("chain", name)] = _hold(
            f"kernel #2 config 5 {name} K={Dc.shape[-1]} r={Gc.shape[1]}",
            dtype, spike.blocktri_solve_spike_fused(Dc, Ec, Gc),
            spike.blocktri_solve_spike_fused_ref(Dc, Ec, Gc),
            lambda X: chain_residual(Dc, Ec, Gc, X))
        errs[("thomas", name)] = _hold(
            f"kernel #7 config 5 {name} n_exp={Db.shape[0]} K={Db.shape[1]}",
            dtype, thomas.batched_thomas_solve(Db, Eb, Gb),
            thomas.batched_thomas_solve_ref(Db, Eb, Gb),
            lambda X: batch_residual(Db, Eb, Gb, X))
        c5_ms[name] = {
            "chain": (
                _cuda_ms(lambda: spike.blocktri_solve_spike_fused(Dc, Ec, Gc),
                         20),
                _cuda_ms(lambda: spike.blocktri_solve_spike_fused_ref(
                    Dc, Ec, Gc), 3)),
            "thomas": (
                _cuda_ms(lambda: thomas.batched_thomas_solve(Db, Eb, Gb), 20),
                _cuda_ms(lambda: thomas.batched_thomas_solve_ref(Db, Eb, Gb),
                         3)),
        }
        for key, (k_ms, p_ms) in c5_ms[name].items():
            print(f"  config 5 {name} {key}: kernel {k_ms:.3f} ms/call, "
                  f"plain {p_ms:.3f} ms/call")
        for k in (1, 3, 7, 1000, 11264):
            for r in (1, 3):
                D, E, G = random_chain(k, 8, r, seed=k + r, boundary=11,
                                       dtype=dtype, device=dev)
                _hold(f"kernel #2 random {name} K={k} r={r}", dtype,
                      spike.blocktri_solve_spike_fused(D, E, G),
                      spike.blocktri_solve_spike_fused_ref(D, E, G),
                      lambda X: chain_residual(D, E, G, X))
        for n_exp in (1, 5, 1000):
            for k in (1, 2, 11):
                D, E, G = random_chain_batch(n_exp, k, 8, 3, seed=n_exp + k,
                                             dtype=dtype, device=dev)
                _hold(f"kernel #7 random {name} n_exp={n_exp} K={k}", dtype,
                      thomas.batched_thomas_solve(D, E, G),
                      thomas.batched_thomas_solve_ref(D, E, G),
                      lambda X: batch_residual(D, E, G, X))
    record["config5_ms"] = c5_ms

    # ---- phase 3: headline fixed work, float32 -----------------------------
    prob, data, z0 = _headline(torch.float32, dev)
    opts = SolverOptions(maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0,
                         kkt_refine=0, lam0=3e-6, lam_max=1e30)
    solve = make_gn_solver(prob, opts)
    _reset_counts()
    z, stats = solve(z0, data)
    torch.cuda.synchronize()
    counts, plain_calls = _counts()
    launches = counts["kkt_solve_spike_fused"]
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

    # ---- phase 5: config 5 fixed work, float32, both layouts ---------------
    prob, z0, data, p_prior, p_w = c5[torch.float32]
    c0 = float(batch_cost(prob, z0, data, p_prior, p_w))
    main_launches = {"kkt_solve_spike_fused": launches}
    for layout, kname in (("soa", "blocktri_solve_spike_fused"),
                          ("blocks", "batched_thomas_solve")):
        solve = make_multi_experiment_solver(
            prob, SolverOptions(**C5_FIXED), layout=layout)
        _reset_counts()
        z, stats = solve(z0, data, p_prior, p_w)
        torch.cuda.synchronize()
        counts, plain_calls = _counts()
        main_launches[kname] = counts[kname]
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(z0, data, p_prior, p_w)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        p = z.p.tolist()
        c_end = float(stats.cost)
        p_rel = max(abs(p[0] / MU_TRUE - 1.0), abs(p[1] / B_TRUE - 1.0))
        record[f"config5_{layout}"] = dict(
            wall_s=min(walls), walls_s=walls, cost=[c0, c_end], p=p,
            p_rel_err=p_rel, launches=counts, plain_calls=plain_calls,
            accepts=stats.history[:, 4].tolist())
        print(f"phase 5: config 5 {layout} {N_EXP}x10 float32, 15 LM "
              f"iterations: cost {c0:.6e} -> {c_end:.6e}, p={p}, p rel err "
              f"{p_rel:.4e}, {kname} launches {counts[kname]}, plain calls "
              f"{plain_calls}; best of 3 wall {min(walls):.4f} s on {card}")
        if not (c_end < 0.1 * c0 and all(math.isfinite(v) for v in p)):
            raise RuntimeError(f"config 5 {layout} did no useful work")
        others = sum(v for k, v in counts.items() if k != kname)
        if counts[kname] != 15 or plain_calls != 0 or others != 0:
            raise RuntimeError(
                f"config 5 {layout}: expected 15 launches of {kname} and no "
                f"other kernel or plain call, got {counts}, plain "
                f"{plain_calls}")

    # ---- phase 6: config 5 float64 convergence -----------------------------
    prob, z0, data, p_prior, p_w = c5[torch.float64]
    solve = make_multi_experiment_solver(prob, SolverOptions(**C5_CONVERGED),
                                         layout="soa")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, stats = solve(z0, data, p_prior, p_w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p = z.p.tolist()
    p_dev = (max(abs(a - b) for a, b in zip(p, P_JAX_F64))
             / max(abs(b) for b in P_JAX_F64))
    its = int(stats.iterations)
    record.update(config5_f64_wall_s=wall, config5_f64_iterations=its,
                  config5_f64_p=p, config5_f64_p_vs_jax=p_dev)
    print(f"phase 6: config 5 float64 soa: {its} iterations, p={p}, "
          f"|p - p_jax|/|p_jax| {p_dev:.3e} (<= 1e-6), wall {wall:.3f} s "
          f"on {card}")
    if not p_dev <= 1e-6:
        raise RuntimeError("config 5 float64 p disagrees with the JAX "
                           "package's")

    ms = {"kkt_solve_spike_fused": times["float32"],
          "blocktri_solve_spike_fused": c5_ms["float32"]["chain"],
          "batched_thomas_solve": c5_ms["float32"]["thomas"]}
    err = {"kkt_solve_spike_fused": max_err,
           "blocktri_solve_spike_fused": errs[("chain", "float64")],
           "batched_thomas_solve": errs[("thomas", "float64")]}
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": main_launches[name], "max_abs_err": err[name],
        "ms": ms[name][0], "plain_ms": ms[name][1],
    } for name, (source, replaces) in KERNELS.items()]}
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
