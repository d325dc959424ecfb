"""Drive the PyTorch port's estimation paths on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--out DIR]

Phases, each printing its own line; any failure raises and exits non-zero:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every kernel instance the run uses from csrc/ with nvcc
     (ops/_build.py: one nvcc per (library, b, r), as many at once as the
     machine has cores): the prebuild set, the shapes of the benchmark
     problems (_prebuild_set), and the shapes this run adds
     (_new_instances); each instance's wall and its kernels' ptxas
     registers and spills;
  2. hold each kernel against its plain PyTorch version on the card.
     float64: max|x - x_ref| / max|x_ref| <= 1e-9.  float32 (the systems
     are ill-conditioned): the kernel's relative residual, computed in
     float64, is at most 10x the plain version's.
       kernel #1 (fused damped KKT): the headline system at the initial
         guess (K = 10,001, b = 8, nq = 2; two runs bit-identical) and
         seeded SPD chains, K in EDGES + {7, 1000, 10001}; the residual is
         ||(A + lam I) dx + B dp + gx||_inf / ||gx||_inf;
       kernel #2 (SPIKE chain solve): config 5's concatenated chain at the
         initial guess after the per-experiment damping and scaling
         (K = 11,264, b = 8, r = 3) and seeded chains, K in EDGES + {7,
         1000, 11264}, r in {1, 3}; residual ||AX - G||_inf / ||G||_inf;
       kernel #7 (batched block Thomas): config 5's damped block-major
         systems at the initial guess (1024 x 11 blocks, b = 8, r = 3) and
         seeded batches, n_exp in {1, 3, 5, 1000, 1023}, K in {1, 2, 11, 64};
       kernels #3-#6 (cyclic-reduction levels): the headline's
         equilibrated, damped chain at N = 20,000 (K = 20,001 padded to
         32,768), level by level down to 8 blocks (G = [gx | B], r = 3; the
         fused level #3 with G = B, r = 2, covariance's shape), and seeded
         chains, K in {16, 17, 130, 1000}, r in {1, 2, 3}, at their first
         level.  Per level, float32 is held against the float64 plain
         level: the kernel's error at most 10x the plain version's.  The
         sweeps of #4, #5 and #6 (one library call each, as the main path
         calls them) are held against the plain walk with the same bar
         (#4, #5 level by level, #6 on its result) and, bit for bit,
         against the per-level kernel calls; each sweep's device launches
         are printed, and #6's must be what its design says (one launch
         for the levels of at most cr.BACKSUB_SMALL_PAIRS pairs, one for
         each bigger level: fewer than the 12 levels).  Whole solves
         through blocktri_cr_factor_soa and blocktri_solve_cr are held
         against the plain chain solve (the float32 bar is the chain
         residual).
     At the optimal-control block size b = 12 (_phase2_ocp): kernel #2 at
     r = 1 on config 3's equilibrated, damped chain at the initial guess
     (N = 25 and 500: K = 26 and 501) and on seeded chains, K in EDGES +
     {26, 501}; kernel #1 at nq = 1 on the free-time OCP's system at its
     initial guess (K = 17) and on seeded systems, K in EDGES + {17, 501};
     at each problem's shape the kernel and plain times, the device time
     by phase, two runs bit-identical, the float32 bound and
     torch.linalg.solve on the dense damped matrix (312^2, 6,012^2; 205^2).
     At the moving-horizon estimator's block size b = 6 (_phase2_mhe):
     kernel #2 at r = 1 (an 8-lane group, lanes 6 and 7 idle) on the
     serving cell's damped, equilibrated window chain at its first solve
     (K = 12) and on seeded chains, K in EDGES + {8, 12}, with the same
     times, device time, bit-identity, bound and dense solve (72^2).
     At the sharded solve's interior shape (b = 8, r = 19, _phase2_sp):
     kernel #2 on the interior chain of a headline shard at the initial
     guess (N = 9,999, sp = 4: K = 2,498 against [gx | B | U | V]) and on
     seeded chains, K in EDGES + {2498, 4998}, with the same times, device
     time, bit-identity, bound and dense solve (19,984^2).
     At the shapes only per-shape builds run (_phase2_new_shapes): each
     problem's own system at its initial guess, timed with the dense
     torch.linalg.solve and the float32 bound beside (#1 at (4, 2), the
     degree-2 Van der Pol, and (9, 1), the free-time OCP at degree 3; #2
     and #7 at (4, 3), tests/test_multi_experiment.py's batch; #2 at (8,
     4) and (8, 6), configs 2 and 4 under kkt_refine, and (16, 1), the
     split actuator; #3-#6 at b = 12, config 3 with method='cr', and at b
     = 4 on the degree-2 Van der Pol), and seeded chains at b in
     SEEDED_BLOCKS (1, 2, 3, 4, 9, 16): #1, #2 at K in EDGES, #7, #3-#6.
     At the fine level of bench.py's ladder past refine.CR_DW_CHAIN
     (_phase2_cr_dw): kernels #3-#6 on the headline's equilibrated, damped
     chain at N = 100,000 (K = 100,001 padded to 131,072: 14 levels a
     sweep), level by level, the sweeps and whole solves, in both dtypes at
     the bars above, timed by CUDA events beside the float32 bound.
     At the shapes of configs 2 and 4 (_phase2_configs): kernel #1 at
     nq = 3 and 5 on each config's damped system at its initial guess (K =
     1,001 and 201) and on seeded chains, K in EDGES + {201, 1001}, timed
     beside its plain version, its device time by phase (torch.profiler),
     the dense library solve (torch.linalg.solve on the damped bordered KKT
     matrix, 8,011^2 and 1,611^2) and its bound; kernels #3-#6 at r = 4
     and 6 on each config's equilibrated chain (G = [gx | B], also the
     fused level's right-hand side), every level, the sweeps and whole
     solves, timed, and on seeded chains, K in {16, 17, 130, 1000}, with
     the bars above.
     The GN element kernel (ops/gn_elements.py gn_system, csrc/
     gn_elements.cu; _phase2_gn) against its plain version gn_system_ref on
     the same node values at the main path's shapes, the headline at its
     initial guess at N = 10,000 (the n10k cell's) and N = 100,000 (the
     ladder's fine level), both dtypes: every leaf of the system within
     1e-12 (float64) or 5e-5 (float32) of its largest entry, the float64
     cost likewise, two launches bit-identical, its ms beside the plain
     version's and its bound (_gn_bound).
     Times each kernel and its plain version (CUDA events; kernels #3-#6:
     the sum over the 12 levels of one headline solve at N = 20,000, #4,
     #5 and #6 through their sweeps, with the per-level calls' time
     beside), kernel #7's device time by torch.profiler, and kernel #7's
     library yardstick, torch.linalg.solve on the same 1024 systems
     assembled dense (88 x 88, r = 3); computes each kernel's bound from
     the bytes and operations of its float32 call;
  3. the headline fixed work: Van der Pol, N = 10,000 elements, degree 4,
     float32, 15 LM iterations; the cost must fall more than 10x, p must be
     finite, and the kernel's launch count must rise by exactly 15 (the GN
     element kernel's by 16) with no call of a plain version;
  4. the same problem in float64 to convergence: ||p - [1, 1]||_inf < 1e-4
     (printed beside the one-thread kernel's 2.95e-11);
  5. config 5's fixed work: 1024 experiments x 10 elements, degree 4,
     float32, 15 LM iterations, in both layouts: "soa" (kernel #2) and
     "blocks" (kernel #7).  Each: the cost falls more than 10x, p is finite,
     the layout's kernel launches exactly 15 times and no plain version is
     called; p's error against (1.3, 0.5) and the best-of-3 wall;
  6. config 5 in float64 to convergence (soa): p within 1e-6 (relative,
     inf-norm) of the JAX package's float64 result on the same problem
     (printed beside the one-thread kernel's 4.220e-11);
  7. the headline at N = 20,000 through the CR kernels: fixed work with
     method='cr' (kernels #4, #5 and #6 launch exactly 15 x 12 times, no
     other kernel or plain version; p finite and the cost falls), in
     float32 (its best-of-3 wall; the ratio is printed beside the JAX
     package's, with no 10x bar: float32 runs at its factorisation cliff
     at this N) and in float64 (cost falls more than 10x, p within 1e-6 of
     the JAX package's float64 run); the converged ladder (1,250 -> 5,000
     -> 20,000 elements, the fine level on 'cr') in float32, gated on
     ||p - [1, 1]||_inf < 1e-4, and in float64, p within 1e-6 of the JAX
     package's float64 ladder; parameter_std at the float64 solution
     (kernels #3 and #6, 12 launches each) against the plain CR solve of
     the same schedule, <= 1e-9; state_std at the coarse level, its wall;
  8. config 2 at full size (Duffing joint MAP, N = 1,000, b = 8, nq = 3;
     collocfem_tpu_torch.configs): (a) float32 fixed work, 40 LM
     iterations on 'auto' (kernel #1 launches exactly 40 times, no plain
     call), the cost falls and ||p / p_true - 1||_inf <= 0.15, its best-of-3
     wall and a torch.profiler breakdown; (b) the same in float64, p within
     1e-6 of the JAX package's; (c) (b) with method='cr' (kernels #4-#6
     launch 40 x 7 times); (d) the example's converged float64 run
     (converged, p within 1e-6 of the JAX package's); (e) IRLS in float64
     (irls_delta 2, 4 rounds; kernel #1 launches exactly once per LM
     iteration of the five inner solves), p within 1e-6 of the JAX
     package's;
  9. config 4 at full size (aircraft output error, N = 200, nq = 5), as
     phase 8 with r = 6 (5 CR levels), float32 gated on the cost falling
     and p finite, and (e) the exact-Newton run (hessian='newton') from the
     config's z0, converged, p within 1e-6 of the JAX package's;
 10. config 3, the pendulum swing-up (b = 12, nq = 0), through
     make_ocp_solver(prob, ALBarrierOptions()) on 'auto': (a) N = 25 in
     float64: cviol < 1e-8, x(0) and x(tf) within 1e-8 of [0, 0] and
     [pi, 0], u_max - 1e-2 < max|u| <= u_max + 1e-6, the objective and u at
     11 evenly spaced nodes within 1e-6 of the JAX package's float64 run;
     (b) N = 25 in float32: g < 0 everywhere, cviol <= 1e-3, the objective
     within 1% of (a)'s; (c) N = 500 in float64 and float32 with the same
     gates but u's (1e-5 there: C3_U_GATE), started from (a)'s / (b)'s N =
     25 solution (the nested protocol of docs/guide.md: a cold start at N =
     500 lands in an infeasible basin, the JAX package's too).  The solver
     replays its whole AL homotopy from CUDA graphs.  Each case runs
     captured (first call and a replay) and eagerly, once each:
     bit-identical (z and every OCPStats field), each run launching kernel
     #2 at (12, 1) exactly once per inner LM iteration and no plain
     version; the three walls, and for (a) a torch.profiler breakdown of
     one more eager run with the device idle share of the captured and of
     the eager wall (_profile_loop);
 11. the free-time OCP of examples/min_time_ocp.py (N = 16, n_outer 16,
     b = 12, nq = 1: kernel #1 once per inner iteration), float64: tf
     within 1e-6 of the JAX package's, 2 sqrt(d) - 1e-3 < tf < 1.06 x 2
     sqrt(d), g <= 1e-10; captured and eager as in phase 10;
 12. estimation under constraints, float64, each solver's whole barrier
     homotopy replayed from CUDA graphs: (a) the aircraft problem with
     examples/constrained_estimation.py's damping spec (kernel #1 at (8,
     5)): p within 1e-6 of the JAX package's, g_param(p) <= 0; (b)
     tests/test_bounds.py's active parameter bound on Van der Pol at degree
     4 (kernel #1 at (8, 2)) and at the test's own degree 2 (kernel #1 at
     (4, 2)): p within 1e-6 of the JAX package's.  Each case runs captured
     (first call and a replay) and eagerly, once each: bit-identical, the
     same launches; the walls, the first call's and, for (a), the idle
     shares;
 13. the serving path and the Kalman tier (_serving): (a)
     examples/mhe_online.py's moving-horizon estimator (Van der Pol,
     horizon 12, degree 3: kernel #2 at (6, 1)) over its 240-sample stream
     in float64: every 20th estimate and the last, and current_covariance,
     within 1e-6 of the JAX package's; kernel #2 launches exactly once per
     LM iteration of the 229 window solves, no plain version; RMSE against
     the truth, the per-step walls (median, p90) and the device idle share
     over 20 steps by torch.profiler; (b) the same in float32: position
     RMSE < 3 sig_v, velocity RMSE < 0.1, every estimate finite; (c)
     tests/test_mhe.py's linear MHE (horizon 8, degree 4: #2 at (8, 1))
     against the port's own kalman_filter on the card, estimates and the
     final covariance within 2e-6; (d) tests/test_kalman_parity.py's
     full-rule smoother problem (N = 59): converged, the MAP path within
     1.5e-3 of the numpy RTS smoother; (e) examples/pem_kalman.py (Duffing,
     400 samples) end to end from p0: the EKF NLL and its gradient through
     the captured scan (kalman/scan.py) at p0 within 1e-9 (relative) of the
     JAX package's; over the first 50 samples the captured scan
     bit-identical to the same scan uncaptured and within 1e-12 of the
     tape-recording loop, each within 1e-9 of JAX's; the PEM (run_lbfgs
     from p0, one replayed value and gradient an evaluation, torch.profiler
     over 40 samples) with p within 1e-6 and the
     NLL within 1e-9 of the JAX package's optimum; the NLL there within
     1e-9 and its gradient, rounding noise of ~2e-11, within 1e-11
     absolute; the UKF NLL and its gradient at p0 within 1e-9;
     smoother_initial_guess at the port's optimum within 1e-8, the MAP
     polish (kernel #1 at (8, 3)) converged with p within 1e-6 and
     parameter_std (kernels #3, #6) within 1e-6 of the JAX package's; then
     #1 at the polish's shape and #3-#6 at parameter_std's, held to their
     plain versions and timed (_pem_shapes);
 14. the multi-rank tier (parallel/; _phase14), every collective the peer
     all-reduce's kernel (csrc/peer_reduce.cu, parallel/peer.py): one world
     of 4 gloo ranks sharing the card (collocfem_tpu_torch.testing.run_world:
     the rank workers live in the package, so the spawned children import
     it and not this script) and an NCCL world of one in this process
     (_nccl_world_of_one).  In the world: the fixed-work cases below by the
     solver's ``.eager``; two solves to gtol 1e-10 captured
     (testing.captured_case: ``.eager``, the first call, a replay and
     ``.eager`` again on the same groups), their LM steps under the loop
     graph's WHILE node on 4 ranks: 0 host reads in the captured calls, the
     same iterations and bits as ``.eager`` on every rank, p within 1e-8 of
     the single-rank solver's, each wall beside ``.eager``'s and the idle
     share of the captured and of the eager wall from one profiled
     ``.eager`` run; the kernel against its plain version bit for bit at P
     = 4 for sum and max, at 1 element and at the SPIKE interface gather's
     size (P x 2 x 8 x 19), with its ms per call beside the plain version's
     and gloo's ``dist.all_reduce``'s on the same ranks.  In the world of
     one: each case's first call (0 host reads), a replay and ``.eager``
     give the same bits and the same launches, printed with the three
     walls and the idle share of the captured and of the eager wall.
     Every case's ranks must give the same bits.  (a) sp: make_sp_gn_solver
     on the headline at N = 9,999 (K = 10,000), 15 fixed-work LM
     iterations in float64 at sp = 1 (NCCL) and 2: p within 1e-8 of the
     single-rank make_gn_solver's, at sp = 4 within 1e-7 (P_BAR_SP4), V
     within 1e-6 (relative), the same
     accept history; to gtol 1e-10 at sp = 1 (NCCL) and sp = 4 (captured,
     under the WHILE node): converged, p within 1e-8 of the single-rank
     solver's; float32 at sp = 4: the cost falls more than 10x, p finite;
     every rank launches kernel #2 once at (8, 19) and once at (8, 3) per
     iteration, the peer kernel 9 times per iteration, twice before the
     loop and once a chunk of the gather of V after it, and no plain
     version.  (b) dp: config 5 at dp = 1 (NCCL), 2
     and 4 in both layouts, 15 iterations in float64: p within 1e-9 and V
     within 1e-8 of the unsharded solver's, the layout's kernel 15 times a
     rank; dp = 4 soa to gtol 1e-10 (captured): p within 1e-8 of the
     unsharded solver's.  (c) dp x sp = 2 x 2: four config-5 experiments of
     511 elements, blocks layout with spike_chain_solver, 5 iterations: p
     within 1e-9 of the unsharded solver's.  (d) IRLS (irls_delta 2, 2
     rounds) with the sp = 2 solver as the inner solver: p within 1e-6 of
     the single-rank IRLS.  (e) the Van der Pol model built by
     symbolic_model from strings through the captured make_gn_solver: N =
     10,000 float32, 15 iterations, kernel #1 exactly 15 times, the cost
     falls more than 10x; float64 to convergence, p within 1e-10 of the
     hand-written model's.  The ranks' walls are printed under a label that
     says they share one card: they take turns on it by time slicing.
 15. every shape (_phase15), float64, the JAX package's problems at block
     sizes only per-shape builds run, each within 1e-6 of the JAX
     package's float64 result (constants above): (a)
     tests/test_multi_experiment.py's batch through the captured
     make_multi_experiment_solver, #2 (soa) and #7 (blocks) at (4, 3);
     (b) the free-time OCP at degree 3, #1 at (9, 1); (c) the split
     actuator, #2 at (16, 1); (d) config 3 at N = 25 and 500 with
     method='cr', #4-#6 at b = 12; (e) configs 2 and 4 under
     kkt_refine=2, #2 at (8, 4) / (8, 6) and (8, 1); (f) parameter_std on
     the degree-2 Van der Pol, #3 and #6 at (4, 2), within 1e-9 of the
     plain solve.  Each prints its wall, launches by shape, construction
     and first-call walls and its instances' phase-1 build walls;
 16. bench.py past refine.CR_DW_CHAIN at N = 100,000 (_phase16), float64
     where the JAX package runs its double-word tiers: (a) run_fixed, 15 LM
     iterations on method='cr' (kernels #4-#6 launch exactly 15 x 14 times,
     no other kernel or plain version), float32 (best-of-3 wall; p finite,
     the cost falls) and float64 (p and the cost ratio within 1e-6 of the
     JAX package's float64 run: its ratio is 8.34x, below bench.py's 10x at
     this N); (b) headline.ConvergedLadder(100000, dtype=float32): 6,250
     elements in float32, the same mesh in float64 (state_dw's place), then
     100,000 elements in float64 on 'cr' (state_dw and cr_dw's place),
     captured and eager bit for bit, 0 host reads in each level, kernel #1
     60 + 80 times and #4-#6 40 x 14 times; p within 1e-6 of the JAX
     package's float64 run of the same levels and ||p - [1, 1]||_inf <
     1e-4 (printed beside the JAX package's 7.15e-7, measured on a TPU with
     its double-word tiers); the walls (captured, eager, first run, the
     per-level split), a torch.profiler run, the memory peak and the
     phase's wall.

Phases 3-9, 13 and 16 run each solve as it runs by default on a CUDA device:
from CUDA graphs captured at its first call (collocfem_tpu_torch/solve/
graph.py), and every launch count above is the captured run's (each replay
adds its graph's share).  Wherever a counted solve assembles an
EstimationProblem in the GN element kernel's range on the card (every
Gauss-Newton solve of phases 3, 7-9 and 12-16 does), the GN element kernel
is counted with the others: once an LM step and once at each solve's start
(make_gn_solver, make_irls_solver), once an inner step (the barrier solvers
of solve/bounds.py and constrained.py).  Each of these phases also runs
``solve.eager`` once
on the same inputs and raises unless it gives the captured result bit for
bit (z, cost, iterations, history and the other SolveStats fields, by
torch.equal on their bit patterns); phase 13 does so for the first 20 MHE
steps (``step_eager``) in both dtypes, and phases 7 and 16 for the ladder
(``ConvergedLadder.eager``).  A phase line's wall is the captured one, with
the eager wall beside it; phases 3, 5, 7 and 16 also profile one captured run
(device time, and the idle share of the captured and of the eager wall).
Phases 10-12 do the same with the constrained drivers (solve/auglag.py:
the AL homotopy captured; solve/bounds.py, constrained.py: the barrier
homotopy captured).  Phase 14's NCCL world of one and its two converging
cases on 4 ranks do the same with the sharded solves (their all-reduces
captured in the graphs); its other gloo cases run ``.eager``.

A solve with a tolerance runs its LM loop on the device: one graph whose
WHILE conditional node repeats the captured step while ~done & (it <
maxiter) (csrc/graph_loop.cu), so the host reads nothing during the solve.
Every converging captured solve of phases 4, 6, 8 (d), (e), 9 (d), (e),
10-12 and 13 (d), (e) counts the reads to the host of its first call
(solve.graph.HostReads: .item(), bool(t), a copy to the CPU) and raises
unless there are none (so does each level of phases 7 and 16's ladders,
warm start included, in the ladder's first run) (phase 14's sharded ones too, on one rank and on
4); phase 13 (a), (b) counts them over the 20 captured MHE steps it holds
to step_eager.  Phases 4, 6
and 10-12 print each converging solve's captured wall beside the parent's
(PARENT: PERF.md §5's figures, from runs in which every LM iteration read
done); phase 13 prints
the MHE step's median, p90 and idle share in both dtypes beside
PARENT_MHE.  torch.profiler does not trace the kernels inside a conditional
node, so a loop graph's idle share takes the device time of the same
kernels from a profiled eager run (_profile_loop): phase 10 (a), 11, 12 (a)
and 20 MHE steps in each dtype.  The steps a loop ran are counted on the device
and added to the launch counts when they are read (ops/_build.settle).

The second-to-last lines are the card's name and power limit and a JSON
object describing every kernel of the path (its numbers at the headline's
shape; ``shapes``: its main-path launches at each shape, as its wrapper
counted them; ``at_configs``: phase 2's numbers at configs 2, 3 and 4, the
free-time OCP, the MHE window and a headline shard's interior); the
last line is {"ok": true, "device": {...}}.  With --out DIR the same records are also
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
ELEMENTS_CR = 20000       # K = 20,001: past the TPU fused kernel's 16,384
ELEMENTS_DW = 100000      # K = 100,001: past refine.CR_DW_CHAIN (40,000)
ELEMENTS_SP = 9999        # K = 10,000 blocks: divides by sp = 1, 2 and 4
SP_MAX = 4                # ranks of phase 14's world, sharing the one card
N_EXP = 1024
SPIKE_SOURCE = "collocfem_tpu_torch/csrc/kkt_spike.cu"
THOMAS_SOURCE = "collocfem_tpu_torch/csrc/thomas.cu"
CR_SOURCE = "collocfem_tpu_torch/csrc/cr.cu"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "kkt_solve_spike_fused": (SPIKE_SOURCE,
                              "collocfem_tpu/ops/spike_pallas.py:761"),
    "blocktri_solve_spike_fused": (SPIKE_SOURCE,
                                   "collocfem_tpu/ops/spike_pallas.py:714"),
    "cr_level": (CR_SOURCE, "collocfem_tpu/ops/cr_pallas.py:221"),
    "cr_level_factor": (CR_SOURCE, "collocfem_tpu/ops/cr_pallas.py:275"),
    "cr_level_apply": (CR_SOURCE, "collocfem_tpu/ops/cr_pallas.py:318"),
    "cr_backsub": (CR_SOURCE, "collocfem_tpu/ops/cr_pallas.py:360"),
    "batched_thomas_solve": (THOMAS_SOURCE,
                             "collocfem_tpu/ops/blocktri_pallas.py:78"),
    # No Pallas kernel: the psum / pmax inside the JAX package's shard_map.
    "peer_reduce": ("collocfem_tpu_torch/csrc/peer_reduce.cu",
                    "collocfem_tpu/parallel/sharded.py:295"),
    # No Pallas kernel: vmap(jacfwd) and the einsums of assemble_gn_soa.
    "gn_system": ("collocfem_tpu_torch/csrc/gn_elements.cu",
                  "collocfem_tpu/ops/assemble.py:351"),
}
GN = "gn_system"
CR_NAMES = ("cr_level", "cr_level_factor", "cr_level_apply", "cr_backsub")
# Launches at each shape ((b, nq) for kernel #1, (b,) for #4, (b, r) for
# the others) over the main path's counted runs, as the wrappers recorded
# them: LAST_SHAPES is taken with the counts (_counts), MAIN_SHAPES adds
# up the runs whose launches join the kernels line (_keep_shapes).
LAST_SHAPES: dict = {}
MAIN_SHAPES: dict = {}
# Chain lengths at the edges of kernel #1's and #2's tile plan (one tile,
# L = 3, a last tile mostly padding, a tile count not a multiple of four).
EDGES = (1, 2, 3, 4, 5, 9, 13, 97)
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _cr_level_count(num_blocks: int) -> int:
    """Kernel levels of a CR solve: the chain padded to a power of two and
    halved down to the tail's 8 blocks (12 at K = 20,001, padded to
    32,768)."""
    from collocfem_tpu_torch.solve.blocktri import TAIL

    kp = 1 << (num_blocks - 1).bit_length()
    return max(0, (kp // TAIL).bit_length() - 1)


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
# The JAX package's converged ladder at N = 20,000 on the CPU (bench.py's
# run_converged schedule: 1,250 -> 5,000 -> 20,000 elements, maxiter 60 /
# 30 / 30, lam0 3e-6 / 1e-9 / 1e-9, gtol=0, prolongation by
# make_prolongation), produced from the root of the repo by
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax; jax.config.update("jax_enable_x64", True)  # False: float32
#   import numpy as np
#   from baseline_cpu.run_baseline import TF, build_headline_problem
#   from collocfem_tpu.models import VanDerPol
#   from collocfem_tpu.ops.mesh import make_prolongation, uniform_mesh
#   from collocfem_tpu.problem import Decision, EstimationProblem
#   from collocfem_tpu.solve import SolverOptions
#   from collocfem_tpu.solve.newton import make_gn_solver
#   _, t_meas, y, _ = build_headline_problem(20000)
#   z = prev = None
#   for i, n in enumerate([1250, 5000, 20000]):
#       mesh = uniform_mesh(0.0, TF, n, 4)
#       prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
#                                      defect_weight=100.0)
#       data = prob.pack_data(y, t_meas,
#                             u_nodes=np.sin(0.9 * mesh.elem_times)[..., None])
#       z0 = (prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
#             if z is None else Decision(V=make_prolongation(
#                 prev, mesh.node_times)(z.V).astype(prob.dtype), p=z.p))
#       z, st = make_gn_solver(prob, SolverOptions(
#           maxiter=60 if i == 0 else 30, gtol=0.0,
#           lam0=3e-6 if i == 0 else 1e-9))(z0, data)
#       prev = mesh
#   print(repr(np.asarray(z.p, np.float64).tolist()))
#   EOF
# (on the CPU 'auto' runs the XLA cyclic reduction at every level).
P_JAX_LADDER_F64 = (0.9999999999787036, 1.000000000003182)
# The same command in float32: p = (0.9999775290489197, 0.9999942183494568).
P_ERR_JAX_LADDER_F32 = 2.2470951080322266e-05
# The JAX package's fixed work at N = 20,000 on the CPU ('auto' is the XLA
# cyclic reduction there), produced from the root of the repo by
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax; jax.config.update("jax_enable_x64", True)  # False: float32
#   import numpy as np
#   from baseline_cpu.run_baseline import build_headline_problem
#   from collocfem_tpu.models import VanDerPol
#   from collocfem_tpu.problem import EstimationProblem
#   from collocfem_tpu.solve import SolverOptions
#   from collocfem_tpu.solve.newton import make_gn_solver
#   mesh, t_meas, y, u_nodes = build_headline_problem(20000)
#   prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
#                                  defect_weight=100.0)
#   data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
#   z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
#   z, st = make_gn_solver(prob, SolverOptions(
#       maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=0, lam0=3e-6,
#       lam_max=1e30))(z0, data)
#   print(repr(np.asarray(z.p).tolist()),
#         float(prob.cost(z0, data)) / float(st.cost))
#   EOF
CR_FIXED_JAX_F64_P = (2.855885277895221, -0.5179073605763589)
CR_FIXED_JAX_F32_RATIO = 36.434286928965115
# The same command at N = 100,000 (build_headline_problem(100000)) in
# float64: p and the cost ratio after 15 iterations (116 s on 8 CPU
# cores, beside the ladder's run below).
# The ratio is below bench.py's 10x: 15 cold iterations at this N have not
# reached the basin, in either package.
DW_FIXED_JAX_F64_P = (5.6987405391073835, -1.3892310783015092)
DW_FIXED_JAX_F64_RATIO = 8.335066494300493
# The JAX package's float64 run of bench.py's schedule past CR_DW_CHAIN
# (bench.py:142-158) at N = 100,000 with no double-word option (float64
# needs none): 6,250 elements, maxiter 60, lam0 3e-6; the same mesh warm
# started from that solution, 80, 1e-9; 100,000 elements through
# make_prolongation, 40, 1e-9; gtol=0 at every level.  Produced from the
# root of the repo by
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax; jax.config.update("jax_enable_x64", True)
#   import numpy as np
#   from baseline_cpu.run_baseline import TF, build_headline_problem
#   from collocfem_tpu.models import VanDerPol
#   from collocfem_tpu.ops.mesh import make_prolongation, uniform_mesh
#   from collocfem_tpu.problem import Decision, EstimationProblem
#   from collocfem_tpu.solve import SolverOptions
#   from collocfem_tpu.solve.newton import make_gn_solver
#   _, t_meas, y, _ = build_headline_problem(100000)
#   z = prev = None
#   for n, maxiter, lam0 in ((6250, 60, 3e-6), (6250, 80, 1e-9),
#                            (100000, 40, 1e-9)):
#       mesh = uniform_mesh(0.0, TF, n, 4)
#       prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
#                                      defect_weight=100.0)
#       data = prob.pack_data(y, t_meas,
#                             u_nodes=np.sin(0.9 * mesh.elem_times)[..., None])
#       if z is None:
#           z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
#       elif prev.num_elements == n:
#           z0 = z
#       else:
#           z0 = Decision(V=make_prolongation(prev, mesh.node_times)(
#               z.V).astype(prob.dtype), p=z.p)
#       z, st = make_gn_solver(prob, SolverOptions(
#           maxiter=maxiter, gtol=0.0, lam0=lam0))(z0, data)
#       prev = mesh
#   print(repr(np.asarray(z.p, np.float64).tolist()))
#   EOF
# (278 s on 8 CPU cores, the first 116 s beside the fixed work above; on
# the CPU 'auto' runs the XLA cyclic reduction.)
P_JAX_LADDER_DW_F64 = (0.9999999999962791, 1.0000000000000566)

# The JAX package's float64 p on configs 2 and 4 on the CPU (on the CPU
# 'auto' is its XLA cyclic reduction): the fixed work of
# benchmarks/configs_bench.py, the examples' converged runs
# (examples/duffing_joint.py, examples/aircraft_oe.py), config 2's IRLS
# (irls_delta 2.0, 4 rounds of the converged options) and config 4's exact
# Newton run (the converged options, hessian='newton', from the config's z0:
# converged in 49 iterations), produced from the root of the repo by
#   JAX_PLATFORMS=cpu python - 2 <<'EOF'   # then with 4 for config 4
#   import sys; sys.path[:0] = [".", "examples"]
#   import jax; jax.config.update("jax_enable_x64", True)
#   import numpy as np
#   from collocfem_tpu.models import AircraftLongitudinal, Duffing
#   from collocfem_tpu.ops.mesh import uniform_mesh
#   from collocfem_tpu.problem import EstimationProblem
#   from collocfem_tpu.solve import SolverOptions as O
#   from collocfem_tpu.solve.newton import make_gn_solver, make_irls_solver
#   from collocfem_tpu.utils.io import load_measurements
#   if sys.argv[1] == "2":
#       from duffing_joint import (GAMMA, MEAS_NOISE, OMEGA, PROC_NOISE, TF,
#                                  simulate_sde)
#       rng = np.random.default_rng(7)
#       ts, xs = simulate_sde(rng, TF)
#       t = np.linspace(0.05, TF - 0.05, 2000)
#       y = np.interp(t, ts, xs[:, 0])[:, None]
#       y += MEAS_NOISE * rng.standard_normal(y.shape)
#       prob = EstimationProblem.build(Duffing(gamma=GAMMA, omega=OMEGA),
#           uniform_mesh(0.0, TF, 1000, 4), t, defect_weight=1 / PROC_NOISE)
#       data = prob.pack_data(y, t, meas_weight=1 / MEAS_NOISE,
#                             p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
#       z0 = prob.initial_guess_from_data(t, y, p0=[0.5, 1.0, 0.5])
#       fixed = O(maxiter=40, gtol=0.0, lam0=1e-6)
#       conv = dict(maxiter=80, gtol=1e-6, xtol=1e-10)
#   else:
#       t, vals = load_measurements("examples/data/aircraft_doublet.csv")
#       y, u = vals[:, :3], vals[:, 3]
#       mesh = uniform_mesh(0.0, 8.0, 200, 4)
#       prob = EstimationProblem.build(AircraftLongitudinal(V=60.0, g0=9.81),
#                                      mesh, t, defect_weight=1e4)
#       data = prob.pack_data(y, t, u_nodes=np.interp(
#           mesh.elem_times, t, u)[..., None], meas_weight=1.0 / np.array(
#           [0.002, 0.005, 0.05]))
#       z0 = prob.initial_guess_from_data(t, y[:, :2],
#                                         p0=[-1.0, -5.0, -1.0, -0.1, -5.0])
#       fixed = O(maxiter=40, gtol=0.0, lam0=1e-6, lam_max=1e30)
#       conv = dict(maxiter=60, gtol=1e-6, xtol=1e-12)
#   runs = {"fixed": make_gn_solver(prob, fixed),
#           "converged": make_gn_solver(prob, O(**conv))}
#   if sys.argv[1] == "2":
#       runs["irls"] = make_irls_solver(prob, O(**conv, irls_delta=2.0), 4)
#   else:
#       runs["newton"] = make_gn_solver(prob, O(**conv, hessian="newton"))
#   for name, solve in runs.items():
#       z, st = solve(z0, data)[:2]
#       print(name, repr(np.asarray(z.p).tolist()), int(st.iterations))
#   EOF
C2_JAX_F64 = dict(
    fixed=(1.0042641985284104, 4.987648776798632, 0.18035889984194617),
    converged=(1.0042641985143999, 4.98764877681048, 0.18035889983543302),
    irls=(1.0052233327411957, 4.986979150612183, 0.1803701597779979))
C4_JAX_F64 = dict(
    fixed=(-1.2097362110617522, -8.228952931501478, -2.557399394867827,
           -0.14454344529385657, -12.355985957602279),
    converged=(-1.2097362110220928, -8.228952931861986, -2.557399395621171,
               -0.14454344521344795, -12.35598595983164),
    newton=(-1.2097362110140655, -8.228952931926878, -2.557399395758849,
            -0.14454344519782347, -12.355985960247033))

# The JAX package's float64 runs of config 3, the free-time OCP and the two
# constrained estimations on the CPU ('auto' is its cyclic reduction
# there): config 3's objective and u at 11 evenly spaced nodes (node
# indices linspace(0, 4 N, 11); N = 500 from the N = 25 solution, the
# nested protocol of docs/guide.md), the free-time horizon, and p,
# produced from the root of the repo by
#   JAX_PLATFORMS=cpu python - 25 <<'EOF'  # then 500, min_time, aircraft, vdp
#   import sys; sys.path[:0] = [".", "examples"]
#   import jax; jax.config.update("jax_enable_x64", True)
#   import jax.numpy as jnp, numpy as np
#   from scipy.integrate import solve_ivp
#   from collocfem_tpu import free_time_ocp
#   from collocfem_tpu.model import Model
#   from collocfem_tpu.models import AircraftLongitudinal, Pendulum, VanDerPol
#   from collocfem_tpu.ocp import OptimalControlProblem
#   from collocfem_tpu.ops.mesh import uniform_mesh
#   from collocfem_tpu.problem import EstimationProblem
#   from collocfem_tpu.solve import (BoundedOptions, ConstrainedOptions,
#       bounded_gauss_newton, constrained_gauss_newton, make_bounds)
#   from collocfem_tpu.solve.auglag import ALBarrierOptions, make_ocp_solver
#   from collocfem_tpu.utils.io import load_measurements
#   w = sys.argv[1]
#   if w in ("25", "500"):
#       from collocfem_tpu.ops.mesh import interpolate_trajectory
#       from collocfem_tpu.problem import Decision
#       build = lambda n: OptimalControlProblem.build(Pendulum(m=1.0, l=0.5,
#           grav=9.81, u_max=2.0), uniform_mesh(0.0, 2.5, n, 4),
#           x0=[0.0, 0.0], xf=[np.pi, 0.0])
#       prob = build(25)
#       z, st = make_ocp_solver(prob, ALBarrierOptions())(prob.initial_guess())
#       if w == "500":
#           fine = build(500)
#           V = np.array(interpolate_trajectory(prob.mesh, z.V,
#                                               fine.mesh.node_times))
#           V[:, 2] = np.clip(V[:, 2], -(2.0 - 1e-3), 2.0 - 1e-3)
#           prob = fine
#           z, st = make_ocp_solver(prob, ALBarrierOptions())(
#               Decision(V=jnp.asarray(V), p=z.p))
#       n = prob.mesh.num_elements
#       print(repr(float(st.objective)), repr(np.asarray(z.V[:, 2])[
#           np.linspace(0, 4 * n, 11).astype(int)].tolist()))
#   elif w == "min_time":
#       class DoubleIntegrator(Model):
#           nx, nu, nq, ng = 2, 1, 0, 2
#           def f(self, x, u, p, t): return jnp.stack([x[1], u[0]])
#           def g(self, x, u, p, t):
#               return jnp.stack([u[0] - 1.0, -u[0] - 1.0])
#       prob, ftm = free_time_ocp(DoubleIntegrator(), num_elements=16,
#           degree=4, x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
#           time_weight=1.0)
#       z, st = make_ocp_solver(prob, ALBarrierOptions(n_outer=16))(
#           prob.initial_guess())
#       print(repr(float(ftm.final_time(z.p))))
#   elif w == "aircraft":
#       t, vals = load_measurements("examples/data/aircraft_doublet.csv")
#       y, u = vals[:, :3], vals[:, 3]
#       mesh = uniform_mesh(0.0, 8.0, 200, 4)
#       prob = EstimationProblem.build(AircraftLongitudinal(V=60.0, g0=9.81),
#                                      mesh, t, defect_weight=1e4)
#       data = prob.pack_data(y, t, u_nodes=np.interp(mesh.elem_times, t,
#           u)[..., None], meas_weight=1.0 / np.array([0.002, 0.005, 0.05]))
#       z0 = prob.initial_guess_from_data(t, y[:, :2],
#                                         p0=[-1.0, -4.0, -4.0, -0.1, -5.0])
#       g = lambda p: jnp.atleast_1d(0.6 + (p[0] + p[2]) / (2.0 * jnp.sqrt(
#           p[0] * p[2] - p[1])))
#       z, st = constrained_gauss_newton(prob, z0, data, ConstrainedOptions(
#           n_outer=12, inner_maxiter=40, mu_min=1e-12), g_param=g)
#       print(repr(np.asarray(z.p).tolist()))
#   else:   # tests/test_bounds.py's active bound, on degree 4
#       u_fn = lambda t: 0.5 * np.sin(1.1 * t)
#       sol = solve_ivp(lambda t, x: [x[1], (1 - x[0] ** 2) * x[1] - x[0]
#           + 0.7 * u_fn(t)], (0.0, 8.0), (2.0, 0.0), rtol=1e-11, atol=1e-12,
#           dense_output=True)
#       mesh = uniform_mesh(0.0, 8.0, 60, 4)
#       t = np.linspace(0.025, 7.975, 160)
#       y = sol.sol(t)[0][:, None]
#       prob = EstimationProblem.build(VanDerPol(), mesh, t,
#                                      defect_weight=30.0)
#       data = prob.pack_data(y, t, u_nodes=u_fn(mesh.elem_times)[..., None])
#       z0 = prob.initial_guess_from_data(t, y, p0=[0.6, 0.4])
#       z, st = bounded_gauss_newton(prob, z0, data, make_bounds(prob,
#           p_lo=[0.0, None], p_hi=[0.8, None]), BoundedOptions(n_outer=12,
#           inner_maxiter=40, mu_min=1e-12))
#       print(repr(np.asarray(z.p).tolist()))
#   EOF
C3_JAX_F64 = {
    25: (2.587528839181777,
         (1.9999982630170214, 1.6161560699517052, -0.5197832446952959,
          -1.999995181620154, -1.4917095981462327, 0.47419801455858834,
          1.9999998784953348, 1.9676284160230422, 0.6078861690924288,
          -0.41727647783974897, -1.999977264516299)),
    500: (2.593346360092889,
          (1.9999841718388172, 1.5103673601488186, -0.7822400255559148,
           -1.9999945712114775, -1.379454638551206, 0.7011630140962711,
           1.9999960425761945, 1.8963428804803322, 0.5699458088636589,
           -0.37473670397527037, -1.822215767678795)),
}
# The limit on max |u - u_JAX| at the 11 nodes.  At N = 500 the AL homotopy
# ends unconverged in both packages (every outer round stops at the
# 40-iteration cap), so u is fixed there only to about 1e-6: the port on the
# CPU from the JAX package's own N = 25 solution reads 1.5e-6, the card
# 1.7e-6, and variants of the warm start move u by about 1e-4.  The limit
# sits between the two; the objective keeps its 1e-6 at both N.
C3_U_GATE = {25: 1e-6, 500: 1e-5}
MIN_TIME_JAX_TF = 2.0020638944797273
CONSTRAINED4_JAX_F64 = (-1.1993546178196046, -8.163503615725432,
                        -2.893695888103136, -0.1423811994384079,
                        -13.231877739359728)
BOUNDED_VDP_JAX_F64 = (0.7999999998603717, 0.7843172245985526)
# Phase 12 (b) at tests/test_bounds.py's own degree 2 (b = 4) and phase 15:
# the JAX package's float64 results on the CPU, produced from the root of
# the repo by ``JAX_PLATFORMS=cpu python - <case> <<'EOF'`` with case
# bounded2, multi, min_time3, split, refine2 and refine4 and the script
#
#   import sys; sys.path[:0] = [".", "examples"]
#   import jax; jax.config.update("jax_enable_x64", True)
#   import jax.numpy as jnp
#   import numpy as np
#   from scipy.integrate import solve_ivp
#   from collocfem_tpu.model import Model
#   from collocfem_tpu.ops.mesh import uniform_mesh
#   from collocfem_tpu.problem import EstimationProblem
#   from collocfem_tpu.solve import SolverOptions as O
#   w = sys.argv[1]
#   if w == "multi":      # tests/test_multi_experiment.py:50's batch
#       from collocfem_tpu.models import VanDerPol
#       from collocfem_tpu.parallel.batch import (BatchDecision,
#                                                 make_multi_experiment_solver)
#       mesh = uniform_mesh(0.0, 8.0, 48, 2)
#       t = np.linspace(0.05, 7.95, 80)
#       prob = EstimationProblem.build(VanDerPol(), mesh, t,
#                                      defect_weight=300.0)
#       rng = np.random.default_rng(42)
#       ds, v0 = [], []
#       for i in range(8):
#           x0, freq = rng.uniform(-2, 2, size=2), 0.7 + 0.15 * i
#           sol = solve_ivp(lambda s, x: [x[1], 1.3 * (1 - x[0] ** 2) * x[1]
#               - x[0] + 0.5 * np.sin(freq * s)], (0.0, 8.0), x0, rtol=1e-10,
#               atol=1e-11, dense_output=True)
#           y = sol.sol(t)[0][:, None]
#           u = np.sin(freq * mesh.elem_times)[..., None]
#           ds.append(prob.pack_data(y, t, u_nodes=u, p_weight=0.0))
#           v0.append(prob.initial_guess_from_data(t, y, p0=[0.0, 0.0]).V)
#       data = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ds)
#       z0 = BatchDecision(V=jnp.stack(v0), p=jnp.asarray([2.0, 0.2]))
#       for layout in ("soa", "blocks"):
#           solve = make_multi_experiment_solver(prob, O(maxiter=40, gtol=1e-9,
#               xtol=1e-10), layout=layout)
#           z, st = solve(z0, data, jnp.asarray([1.0, 1.0]),
#                         jnp.asarray([1e-3, 1e-3]))
#           print(layout, repr(np.asarray(z.p).tolist()), int(st.iterations))
#   elif w in ("min_time3", "split"):
#       from collocfem_tpu.ocp import OptimalControlProblem
#       from collocfem_tpu.ocp_time import free_time_ocp
#       from collocfem_tpu.solve.auglag import ALBarrierOptions, make_ocp_solver
#       if w == "min_time3":   # examples/min_time_ocp.py at degree 3
#           class DoubleIntegrator(Model):
#               nx, nu, nq, ng = 2, 1, 0, 2
#               def f(self, x, u, p, t): return jnp.stack([x[1], u[0]])
#               def g(self, x, u, p, t):
#                   return jnp.stack([u[0] - 1.0, -u[0] - 1.0])
#           prob, ftm = free_time_ocp(DoubleIntegrator(), num_elements=16,
#               degree=3, x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
#               time_weight=1.0)
#           z, st = make_ocp_solver(prob, ALBarrierOptions(n_outer=16))(
#               prob.initial_guess())
#           print(repr(float(ftm.final_time(z.p))), repr(float(st.objective)))
#       else:                  # tests/test_ocp.py:149's split actuator
#           class SplitActuator(Model):
#               nx, nu, nq, ng, ne = 2, 2, 0, 0, 1
#               def f(self, x, u, p, t): return jnp.stack([x[1], u[0] + u[1]])
#               def g_eq(self, x, u, p, t):
#                   return jnp.stack([u[0] - 2.0 * u[1]])
#               def running_cost_residual(self, x, u, p, t): return u
#           prob = OptimalControlProblem.build(SplitActuator(),
#               uniform_mesh(0.0, 1.0, 8, 4), x0=[0.0, 0.0], xf=[1.0, 0.0])
#           z, st = make_ocp_solver(prob, ALBarrierOptions(n_outer=16))(
#               prob.initial_guess())
#           print(repr(float(st.objective)), repr(np.asarray(z.V[:, 2])[
#               np.linspace(0, 32, 11).astype(int)].tolist()))
#   elif w in ("refine2", "refine4"):   # configs 2 and 4, kkt_refine=2
#       from collocfem_tpu.models import AircraftLongitudinal, Duffing
#       from collocfem_tpu.solve.newton import make_gn_solver
#       from collocfem_tpu.utils.io import load_measurements
#       if w == "refine2":
#           from duffing_joint import (GAMMA, MEAS_NOISE, OMEGA, PROC_NOISE, TF,
#                                      simulate_sde)
#           rng = np.random.default_rng(7)
#           ts, xs = simulate_sde(rng, TF)
#           t = np.linspace(0.05, TF - 0.05, 2000)
#           y = np.interp(t, ts, xs[:, 0])[:, None]
#           y += MEAS_NOISE * rng.standard_normal(y.shape)
#           prob = EstimationProblem.build(Duffing(gamma=GAMMA, omega=OMEGA),
#               uniform_mesh(0.0, TF, 1000, 4), t, defect_weight=1 / PROC_NOISE)
#           data = prob.pack_data(y, t, meas_weight=1 / MEAS_NOISE,
#                                 p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
#           z0 = prob.initial_guess_from_data(t, y, p0=[0.5, 1.0, 0.5])
#           fixed = O(maxiter=40, gtol=0.0, lam0=1e-6, kkt_refine=2)
#       else:
#           t, vals = load_measurements("examples/data/aircraft_doublet.csv")
#           y, u = vals[:, :3], vals[:, 3]
#           mesh = uniform_mesh(0.0, 8.0, 200, 4)
#           prob = EstimationProblem.build(AircraftLongitudinal(V=60.0,
#               g0=9.81), mesh, t, defect_weight=1e4)
#           data = prob.pack_data(y, t, u_nodes=np.interp(
#               mesh.elem_times, t, u)[..., None], meas_weight=1.0 / np.array(
#               [0.002, 0.005, 0.05]))
#           z0 = prob.initial_guess_from_data(t, y[:, :2],
#                                             p0=[-1.0, -5.0, -1.0, -0.1, -5.0])
#           fixed = O(maxiter=40, gtol=0.0, lam0=1e-6, lam_max=1e30,
#                     kkt_refine=2)
#       z, st = make_gn_solver(prob, fixed)(z0, data)
#       print(repr(np.asarray(z.p).tolist()))
#   else:   # "bounded2": tests/test_bounds.py's active bound at its degree 2
#       from collocfem_tpu.models import VanDerPol
#       from collocfem_tpu.solve.bounds import (
#           BoundedOptions, bounded_gauss_newton, make_bounds)
#       u_fn = lambda t: 0.5 * np.sin(1.1 * t)
#       sol = solve_ivp(lambda t, x: [x[1], (1 - x[0] ** 2) * x[1] - x[0]
#           + 0.7 * u_fn(t)], (0.0, 8.0), (2.0, 0.0), rtol=1e-11, atol=1e-12,
#           dense_output=True)
#       mesh = uniform_mesh(0.0, 8.0, 60, 2)
#       t = np.linspace(0.025, 7.975, 160)
#       y = sol.sol(t)[0][:, None]
#       prob = EstimationProblem.build(VanDerPol(), mesh, t, defect_weight=30.0)
#       data = prob.pack_data(y, t, u_nodes=u_fn(mesh.elem_times)[..., None])
#       z0 = prob.initial_guess_from_data(t, y, p0=[0.6, 0.4])
#       z, st = bounded_gauss_newton(prob, z0, data, make_bounds(prob,
#           p_lo=[0.0, None], p_hi=[0.8, None]), BoundedOptions(n_outer=12,
#           inner_maxiter=40, mu_min=1e-12))
#       print(repr(np.asarray(z.p).tolist()))
#   EOF
BOUNDED_VDP2_JAX_F64 = (0.7999999998571655, 0.7884131421637182)
MULTI_JAX_F64 = {"soa": (1.3197458351200613, 0.49703888655761824),
                 "blocks": (1.3197458351196327, 0.49703888655767664)}
MIN_TIME3_JAX = (2.005228809824622, 2.005228809824621)   # tf, objective
SPLIT_JAX_F64 = (3.3333333333333335,       # the objective and u1 at 11 nodes
                 (4.000000000094942, 3.1726731647052384, 2.499999999995641,
                  1.8273268352743526, 0.9999999999854937,
                  3.5199914890405334e-14, -0.8273268352870806,
                  -1.5000000000028142, -2.17267316473076, -3.0000000000429305,
                  -4.000000000094905))
REFINE_JAX_F64 = {
    "config 2": (1.0042641985187852, 4.987648776806841, 0.18035889983793357),
    "config 4": (-1.2097362110617522, -8.228952931501478, -2.557399394867827,
                 -0.14454344529385654, -12.355985957602279)}
# Phase 13 (a): examples/mhe_online.py unchanged, the JAX package's float64
# run on the CPU ('auto' is its XLA cyclic reduction there): position and
# velocity RMSE against the truth, the estimates at every 20th online sample
# and the last (229 in all), and current_covariance at the end, produced
# from the root of the repo by
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import sys; sys.path[:0] = [".", "examples"]
#   import jax; jax.config.update("jax_enable_x64", True)
#   import jax.numpy as jnp
#   import numpy as np
#   from mhe_online import DT, HORIZON, MU_TRUE, SIG_V, SIG_W, T_TOTAL
#   from collocfem_tpu.mhe import MovingHorizonEstimator
#   from collocfem_tpu.models.vdp import VanDerPol
#   from collocfem_tpu.solve.newton import SolverOptions
#   from collocfem_tpu.utils.simulate import rk4_trajectory
#   rng = np.random.default_rng(0)
#   n = int(T_TOTAL / DT)
#   ts = np.arange(n) * DT
#   xs = np.asarray(rk4_trajectory(VanDerPol().f, jnp.asarray([2.0, 0.0]),
#       jnp.asarray(ts), u_fn=lambda t: jnp.zeros((1,)),
#       p=jnp.asarray(MU_TRUE)))
#   ys = xs[:, :1] + SIG_V * rng.standard_normal((n, 1))
#   mhe = MovingHorizonEstimator(VanDerPol(), horizon=HORIZON, dt=DT,
#       sig_w=SIG_W, sig_v=SIG_V, degree=3, p_fixed=np.asarray(MU_TRUE),
#       options=SolverOptions(maxiter=20, gtol=1e-9))
#   state = mhe.init(ys[:HORIZON], m0=np.array([1.5, 0.5]), P0=np.eye(2))
#   ests = [np.asarray(mhe.estimate(state))]
#   for k in range(HORIZON, n):
#       state, est = mhe.step(state, ys[k])
#       ests.append(np.asarray(est))
#   ests = np.asarray(ests)
#   rmse = np.sqrt(((ests - xs[HORIZON - 1:n]) ** 2).mean(axis=0))
#   print(repr(rmse.tolist()))
#   print(repr({i: ests[i].tolist()
#               for i in [*range(0, len(ests), 20), len(ests) - 1]}))
#   print(repr(np.asarray(mhe.current_covariance(state)).tolist()))
#   EOF
MHE_DT, MHE_HORIZON, MHE_SIG_V = 0.05, 12, 0.02   # testing.mhe_online_stream
MHE_JAX_RMSE = (0.01985993353425002, 0.018215979048823907)
MHE_JAX_ESTIMATES = {
    0: (1.810819665982519, -0.4989054815769797),
    20: (0.9788778512973525, -1.1621466781555008),
    40: (-0.9977560398705008, -2.7203822439362),
    60: (-1.9525608227500795, 0.3329735689698644),
    80: (-1.2947502345450195, 0.9172762818529433),
    100: (0.1287968192416854, 2.3049681135624938),
    120: (2.0017063792110403, 0.24550569534830333),
    140: (1.5958019948644002, -0.7263323635062012),
    160: (0.5203582633517857, -1.6278410600506494),
    180: (-1.7482605356066674, -1.5516609350109112),
    200: (-1.764566591462723, 0.5796492686432914),
    220: (-1.0067568229492547, 1.164414481653236),
    228: (-0.42757634742554823, 1.7295015487079297),
}
MHE_JAX_COV = ((0.00038851490178060615, 0.00037059510721289116),
               (0.00037059510721289116, 0.24637606115308516))
# Phase 13 (e): examples/pem_kalman.py, the JAX package's float64 run on the
# CPU: the EKF NLL and its gradient at p0 and at the PEM optimum (18 L-BFGS
# iterations), the UKF NLL and its gradient at p0, the EKF NLL and its
# gradient over the first 50 samples at p0, the smoother warm start V0 at
# that optimum (every 50th of its 801 nodes, the sum of its entries and of
# their squares), the MAP polish's p (converged in 12 iterations) and
# parameter_std, produced from the root of the repo by
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import sys; sys.path[:0] = [".", "examples"]
#   import jax; jax.config.update("jax_enable_x64", True)
#   import jax.numpy as jnp
#   import numpy as np
#   from pem_kalman import (GAMMA, MEAS_NOISE, OMEGA, PROC_NOISE, TF,
#                           simulate_sde)
#   from collocfem_tpu.kalman import (make_ekf_nll, make_ukf_nll, run_lbfgs,
#                                     smoother_initial_guess)
#   from collocfem_tpu.models import Duffing
#   from collocfem_tpu.ops.mesh import uniform_mesh
#   from collocfem_tpu.problem import EstimationProblem
#   from collocfem_tpu.solve import SolverOptions
#   from collocfem_tpu.solve.covariance import parameter_std
#   from collocfem_tpu.solve.newton import make_gn_solver
#   rng = np.random.default_rng(11)
#   ts, xs = simulate_sde(rng, TF)
#   t_meas = np.linspace(0.05, TF - 0.05, 400)
#   y = np.interp(t_meas, ts, xs[:, 0])[:, None]
#   y += MEAS_NOISE * rng.standard_normal(y.shape)
#   model = Duffing(gamma=GAMMA, omega=OMEGA)
#   R = np.array([[MEAS_NOISE**2]]); Qc = np.diag([1e-8, PROC_NOISE**2])
#   m0 = np.array([float(y[0, 0]), 0.0]); P0 = np.diag([0.1, 4.0])
#   nll = make_ekf_nll(model, t_meas, y, R, Qc, m0, P0, substeps=4)
#   p0 = jnp.array([0.5, 1.0, 0.5])
#   p_pem, (val, gnorm, it) = run_lbfgs(jax.jit(nll), p0, maxiter=150)
#   for p in (p0, p_pem):
#       v, g = jax.jit(jax.value_and_grad(nll))(p)
#       print(repr(np.asarray(p).tolist()), repr(float(v)),
#             repr(np.asarray(g).tolist()))
#   unll = make_ukf_nll(model, t_meas, y, R, Qc, m0, P0, substeps=4)
#   v, g = jax.jit(jax.value_and_grad(unll))(p0)
#   print(repr(float(v)), repr(np.asarray(g).tolist()))
#   nll50 = make_ekf_nll(model, t_meas[:50], y[:50], R, Qc, m0, P0,
#                        substeps=4)
#   v, g = jax.jit(jax.value_and_grad(nll50))(p0)
#   print(repr(float(v)), repr(np.asarray(g).tolist()))
#   prob = EstimationProblem.build(model, uniform_mesh(0.0, TF, 200, 4),
#                                  t_meas, defect_weight=1.0 / PROC_NOISE)
#   data = prob.pack_data(y, t_meas, meas_weight=1.0 / MEAS_NOISE,
#                         p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
#   z0 = smoother_initial_guess(prob, t_meas, y, np.asarray(p_pem), R=R,
#                               Qc=Qc, m0=m0, P0=P0)
#   V0 = np.asarray(z0.V)
#   print(repr(V0[::50].tolist()), repr(float(V0.sum())),
#         repr(float((V0**2).sum())))
#   z, st = make_gn_solver(prob, SolverOptions(maxiter=60, gtol=1e-6,
#                                              xtol=1e-10))(z0, data)
#   print(repr(np.asarray(z.p).tolist()),
#         repr(np.asarray(parameter_std(prob, z, data)).tolist()))
#   EOF
PEM_ALPHA, PEM_BETA, PEM_DELTA = 1.0, 5.0, 0.2          # the truth
PEM_GAMMA, PEM_OMEGA, PEM_TF = 8.0, 0.5, 20.0            # known forcing
PEM_PROC_NOISE, PEM_MEAS_NOISE = 0.05, 0.01
PEM_P0 = (0.5, 1.0, 0.5)
PEM_JAX_NLL_P0 = (115939.01884093753,
                  (-40664.36120923414, -49556.84347002865,
                   1455.6702728816767))
PEM_JAX_OPT = (1.0114232502436258, 5.0020321609471985, 0.18893252321379087)
PEM_JAX_NLL_OPT = (-1220.9262145370647,
                   (-5.971195760068326e-12, 5.909148170779588e-12,
                    -2.2683431522008135e-11))
PEM_PREFIX = 50       # samples the uncaptured scan and the tape loop each run
# The eager loop's EKF NLL-and-gradient and smoother_initial_guess before the
# filters became captured scans, in s (H100 80GB HBM3, 700 W).
PEM_EAGER_S = (28.9, 15.5)
PEM_JAX_NLL_P0_PREFIX = (10443.741412233909,
                         (-4371.912119820258, -4624.906260142176,
                          324.9904667443012))
PEM_JAX_UKF_P0 = (115935.24072142856,
                  (-40663.37746928187, -49559.43523110624,
                   1456.3544849597672))
PEM_JAX_V0_EVERY_50 = (
    (0.9989534590756789, 0.11850282167989676),
    (0.9628485918225264, -0.47049497717544553),
    (0.8487494264420385, -0.5364551336598936),
    (-0.33746957994596716, -1.5263136352160473),
    (-0.7428647638324691, 0.7976196137317803),
    (-1.1858377422173463, 1.308188537338569),
    (-1.2958049750767773, 0.4300191753184395),
    (-0.7226501467714639, -0.5518370100552843),
    (0.08391613129914788, 1.851120860190397),
    (0.6693075746172733, -1.30562119193387),
    (1.2862953259614924, -1.7185167460264583),
    (1.399405254691222, 0.07291018246385522),
    (0.5263790377966423, 0.6840604530881876),
    (0.14146340374863842, -1.8353887894848782),
    (-0.7506728390297519, 1.8142874000606217),
    (-1.4598413369405674, 1.285214839040299),
    (-1.2981382382422317, -1.356983154008837))
PEM_JAX_V0_SUMS = (-118.88679337384738, 1790.87080727995)
PEM_JAX_MAP_P = (1.0054724173860383, 5.012419019090712, 0.19522483319732653)
PEM_JAX_STD = (0.08683179825030315, 0.07437388508049603, 0.02937604351618655)


# The captured figures PERF.md §5 recorded before converging solves decided
# their exits on the device (NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's: (wall s, idle share of the captured wall or None where
# it was not measured).  Those solves read ``done`` on the host before every
# LM iteration; this run's read nothing.
PARENT = {
    "phase 4": (0.1063, None),
    "phase 6": (0.1417, None),
    "phase 10 (a): config 3 N=25 float64": (0.3028, 0.132),
    "phase 10 (b): config 3 N=25 float32": (0.3311, 0.167),
    "phase 10 (c): config 3 N=500 float64": (0.7838, 0.073),
    "phase 10 (c): config 3 N=500 float32": (0.5051, 0.105),
    "phase 11: free-time OCP float64": (0.2265, 0.135),
    "phase 12 (a) aircraft, zeta >= 0.6": (0.316, 0.084),
    "phase 12 (b) Van der Pol degree 4, mu <= 0.8": (0.229, 0.186),
    "phase 12 (b) Van der Pol degree 2, mu <= 0.8": (0.200, 0.188),
}
# The MHE step's figures from the same source: (median ms, p90 ms, idle
# share over 20 captured steps or None).
PARENT_MHE = {"float64": (3.452, 8.026, 0.276), "float32": (8.144, 8.992,
                                                            None)}


def _beside_parent(tag, wall, idle):
    """Print a converging solve's captured wall and idle share (None: not
    measured) beside the parent's (PARENT)."""
    p_wall, p_idle = PARENT[tag]
    na = lambda v: "not measured" if v is None else f"{v:.3f}"
    print(f"  {tag}: captured wall {wall:.4f} s, idle share {na(idle)}; "
          f"the parent's (PERF.md §5) {p_wall} s, idle {na(p_idle)}")


def _no_reads(label, fn):
    """fn() with its reads to the host counted (solve.graph.HostReads on
    the card); prints them and raises unless there are none: a converging
    captured solve decides its loop exits on the device.  Returns fn()."""
    from collocfem_tpu_torch.solve.graph import HostReads

    with HostReads("cuda") as reads:
        out = fn()
    print(f"  {label}: host reads during the call {reads.count} (gate 0)")
    if reads.count:
        raise RuntimeError(f"{label}: {reads.count} host reads during the "
                           "call, first at\n" + reads.where[0])
    return out


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


def _device_us(fn, key, reps=10):
    """Device µs per call of fn()'s kernels whose name holds ``key``, by
    torch.profiler (0.0 when the profiler shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if key in evt.key:
            total += next((float(v) for v in (
                getattr(evt, "device_time_total", 0),
                getattr(evt, "cuda_time_total", 0)) if v), 0.0)
    return total / reps


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

    from collocfem_tpu_torch.testing import rel_err

    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: the kernel returned non-finite values")
    if dtype == torch.float64:
        rel = rel_err(got, want)
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


def _wrappers():
    """{kernel name: (wrapper, plain version)} for every kernel."""
    from collocfem_tpu_torch.ops import cr, gn_elements, spike, thomas
    from collocfem_tpu_torch.parallel import peer

    mods = {"kkt_solve_spike_fused": spike,
            "blocktri_solve_spike_fused": spike,
            "batched_thomas_solve": thomas, **{n: cr for n in CR_NAMES},
            "peer_reduce": peer, GN: gn_elements}
    return {name: (getattr(mod, name), getattr(mod, name + "_ref"))
            for name, mod in mods.items()}


def _reset_counts():
    from collocfem_tpu_torch.ops import _build

    _build.settle()      # the steps of device loops run before the reset
    for kernel, plain in _wrappers().values():
        kernel.launches = plain.launches = 0
        kernel.shapes = {}


def _counts():
    """({kernel name: launches}, calls of all plain versions together).
    Also takes each kernel's launches by shape into LAST_SHAPES.  Settles
    the steps that device loops ran (one read of each loop's counter)."""
    from collocfem_tpu_torch.ops import _build

    _build.settle()
    w = _wrappers()
    LAST_SHAPES.clear()
    LAST_SHAPES.update({name: dict(k.shapes) for name, (k, _) in w.items()})
    return ({name: k.launches for name, (k, _) in w.items()},
            sum(p.launches for _, p in w.values()))


def _keep_shapes(names):
    """Add the launches by shape of kernels ``names`` that the last
    _counts() read to MAIN_SHAPES: call it where their launches join the
    main path's."""
    for name in names:
        kept = MAIN_SHAPES.setdefault(name, {})
        for shape, n in LAST_SHAPES[name].items():
            kept[shape] = kept.get(shape, 0) + n


def _expect_only(counts, plain_calls, want, label):
    """Raise unless the kernels in ``want`` launched exactly that many times
    and every other kernel and every plain version not at all."""
    got = {k: v for k, v in counts.items() if v or k in want}
    if got != want or plain_calls != 0:
        raise RuntimeError(f"{label}: expected launches {want} and no plain "
                           f"call, got {got} and {plain_calls} plain calls")


def _assembled(want, steps, starts=1):
    """``want`` with the GN element kernel's launches of Gauss-Newton solves
    that took ``steps`` LM steps in all from ``starts`` starting points: one
    assembly a step and one at each start (make_gn_solver's prelude;
    ``starts`` = 0 for the barrier solvers, which assemble only in their
    steps)."""
    return {**want, GN: steps + starts}


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
    from collocfem_tpu_torch.testing import kkt_residual, rel_err

    args = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam, damp_scale)
    got = spike.kkt_solve_spike_fused(*args)
    want = spike.kkt_solve_spike_fused_ref(*args)
    torch.cuda.synchronize()
    for x in got:
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{label}: the kernel returned non-finite values")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    if sys_.D.dtype == torch.float64:
        rel = [rel_err(g, w) for g, w in zip(got[:2], want[:2])]
        ok = max(rel) <= 1e-9
        print(f"  {label}: rel diff dx {rel[0]:.3e} dp {rel[1]:.3e} "
              f"(<= 1e-9) {'ok' if ok else 'FAIL'}")
    else:
        res_k = kkt_residual(sys_, got[0], got[1], lam, got[2])
        res_p = kkt_residual(sys_, want[0], want[1], lam, want[2])
        ok = res_k <= 10.0 * res_p
        print(f"  {label}: KKT residual kernel {res_k:.3e} plain {res_p:.3e} "
              f"(<= 10x) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the kernel disagrees with its plain "
                           "version")
    return err


def _headline(dtype, device, elements=ELEMENTS):
    from collocfem_tpu_torch.headline import headline_problem

    return headline_problem(elements, dtype=dtype, device=device)


def _cr_chain(prob, data, z0, lam, covariance_rhs=True):
    """The equilibrated, damped chain of ``prob`` at z0, padded to a power
    of two: (Ds, Es (b, b, Kp), G = [gx | B] (b, 1 + nq, Kp), Bs (b, r,
    Kp)), and the unpadded (D, E, G, Bs).  Bs is B (covariance's shape)
    with ``covariance_rhs``, else G again."""
    import torch

    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.solve.kkt import _equilibrate_soa

    s, _, _, _ = _equilibrate_soa(assemble_gn_soa(prob, z0, data), lam)
    G = torch.cat([s.gx[:, None, :], s.B], dim=1).contiguous()
    B = s.B.contiguous() if covariance_rhs else G
    Ds, Es = bt._pad_pow2_soa(s.D, s.E)
    kp = Ds.shape[-1]
    return ((Ds, Es, bt._pad_rhs(G, kp), bt._pad_rhs(B, kp)),
            (s.D, s.E, G, B))


def _cr_headline_chain(dtype, device, lam):
    """The headline's chain at N = ELEMENTS_CR and the initial guess
    (:func:`_cr_chain`, G = [gx | B] with r = 3, B with r = 2)."""
    prob, data, z0 = _headline(dtype, device, ELEMENTS_CR)
    return _cr_chain(prob, data, z0, lam)


def _hold_cr(label, dtype, Ds, Es, Gs, Gs_level=None):
    """Every CR kernel against its plain version on one level (testing.
    level_bar); returns {kernel name: max abs error of its outputs}."""
    import torch

    from collocfem_tpu_torch.testing import cr_level_comparison, level_bar

    errs = {}
    for name, (got, want, exact) in cr_level_comparison(
            Ds, Es, Gs, Gs_level).items():
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise RuntimeError(f"{label} {name}: non-finite values")
        ok, worst = level_bar(got, want, exact)
        if not ok:
            raise RuntimeError(f"{label} {name}: the kernel disagrees with its "
                               f"plain version (worst ratio {worst:.3g})")
        errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return errs


def _hold_cr_solves(label, dtype, D, E, G, B):
    """Whole solves through the CR kernels against the plain solves of the
    same schedule: blocktri_cr_factor_soa on G, blocktri_solve_cr
    (block-major) on B."""
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.testing import chain_residual

    aos = lambda a: a.permute(2, 0, 1)
    for name, got, want, rhs in (
            ("blocktri_cr_factor_soa", bt.blocktri_cr_factor_soa(D, E)(G),
             bt.blocktri_cr_factor_plain(D, E)(G), G),
            ("blocktri_solve_cr", bt.blocktri_solve_cr(
                aos(D), aos(E), aos(B)).permute(1, 2, 0),
             bt.blocktri_solve_cr_plain(aos(D), aos(E), aos(B)).permute(
                 1, 2, 0), B)):
        _hold(f"{label} {name}", dtype, got, want,
              lambda X: chain_residual(D, E, rhs, X))


def _cr_levels(Ds, Es, Gs, Bs):
    """The inputs of every CR level of one solve of (Ds, Es) down to the
    tail, walked with the plain level: a list of (Ds, Es, Gs, Bs, factor,
    g_new, s_g), with G = [gx | B] and B carried side by side, and the
    tail's (Ds, Es, Gs)."""
    from collocfem_tpu_torch.ops import cr
    from collocfem_tpu_torch.solve.blocktri import TAIL

    levels = []
    while Ds.shape[-1] > TAIL:
        (dn, en), fac = cr.level_factor_plain(Ds, Es)
        g_new, s_g = cr.level_apply_plain(fac, Gs)
        levels.append((Ds, Es, Gs, Bs, fac, g_new.contiguous(), s_g))
        Bs = cr.level_apply_plain(fac, Bs)[0].contiguous()
        Ds, Es, Gs = dn.contiguous(), en.contiguous(), g_new.contiguous()
    return levels, (Ds, Es, Gs)


def _hold_cr_sweeps(label, levels, tail, exact_levels, exact_tail):
    """The sweeps of kernels #4 and #5 on the chain of ``levels``: each one
    library call and one device launch per level; every level's outputs
    against the plain walk (testing.level_bar, ``exact_*`` the float64
    walk) and, bit for bit, against the per-level kernel calls.  Returns
    the kernel factors and s_g of every level, and the tail's solution."""
    import torch

    from collocfem_tpu_torch.ops import cr
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.testing import level_bar

    Ds, Es, Gs = levels[0][:3]
    n0 = cr.device_launches()
    (dt, et), facs = cr.cr_factor_sweep(Ds, Es, bt.TAIL)
    n1 = cr.device_launches()
    gt, s_gs = cr.cr_apply_sweep(facs, Gs)
    n2 = cr.device_launches()
    torch.cuda.synchronize()
    print(f"  {label}: factor sweep {n1 - n0} device launches, apply sweep "
          f"{n2 - n1}, for {len(levels)} levels, one library call each")
    if (n1 - n0, n2 - n1) != (len(levels), len(levels)):
        raise RuntimeError(f"{label}: a sweep must launch once per level")

    def outputs(walk, end):
        return ([[lv[4].L, lv[4].s_up, lv[4].s_lo, lv[6]] for lv in walk]
                + [list(end)])

    got = ([[f.L, f.s_up, f.s_lo, sg] for f, sg in zip(facs, s_gs)]
           + [[dt, et, gt]])
    worst = 0.0
    for i, (g, w, x) in enumerate(zip(got, outputs(levels, tail),
                                      outputs(exact_levels, exact_tail))):
        if not all(bool(torch.isfinite(a).all()) for a in g):
            raise RuntimeError(f"{label} level {i}: non-finite values")
        ok, ratio = level_bar(g, w, x)
        worst = max(worst, ratio)
        if not ok:
            raise RuntimeError(f"{label} level {i}: the sweep disagrees with "
                               f"the plain walk (worst ratio {ratio:.3g})")
    d, e, g = Ds, Es, Gs
    for fac_s, sg_s in zip(facs, s_gs):
        (d, e), fac = cr.cr_level_factor(d, e)
        g, sg = cr.cr_level_apply(fac, g)
        if not all(torch.equal(a, b) for a, b in zip(
                (fac.L, fac.s_up, fac.s_lo, fac.E, sg), (*fac_s, sg_s))):
            raise RuntimeError(f"{label}: the sweep and the per-level calls "
                               "differ")
    if not (torch.equal(d, dt) and torch.equal(e, et) and torch.equal(g, gt)):
        raise RuntimeError(f"{label}: the sweep's tail and the per-level "
                           "calls' differ")
    print(f"  {label}: every level within the bar of the plain walk (worst "
          f"ratio {worst:.3g}); equal to the per-level calls bit for bit")
    return facs, s_gs, bt._tail_solve(bt._tail_factor(dt, et), gt).contiguous()


def _hold_backsub_sweep(label, facs, s_gs, X):
    """Kernel #6's sweep from the tail's solution X through the kernel
    factors and s_g of every level, as the main path calls it: one library
    call with the device launches of its design, within testing.level_bar
    of the plain walk on the same levels (float64 exact: that walk in
    float64) and bit for bit the per-level kernel calls.  Returns the max
    abs error against the plain walk."""
    import torch

    from collocfem_tpu_torch.ops import cr
    from collocfem_tpu_torch.testing import level_bar

    s_up, s_lo = cr.factor_columns(facs)
    levels, h0 = len(s_gs), X.shape[-1] << (len(s_gs) - 1)
    n0 = cr.device_launches()
    got = cr.cr_backsub_sweep(X, s_up, s_lo, s_gs)
    launches = cr.device_launches() - n0
    small = cr.backsub_small_pairs(X.shape[0], X.shape[1], X.element_size())
    want_launches = cr.backsub_sweep_launches(h0, levels, small)
    print(f"  {label}: backsub sweep {launches} device launches for {levels} "
          f"levels (one for the levels of at most {small} pairs, one for each "
          f"bigger level: {want_launches}), one library call")
    if launches != want_launches or launches >= levels > 1:
        raise RuntimeError(f"{label}: the backsub sweep made {launches} "
                           f"launches, its design {want_launches}")
    per_level = X
    for lv in reversed(range(levels)):
        per_level = cr.cr_backsub(per_level, s_up[lv], s_lo[lv], s_gs[lv])
    views = [list(a) for a in (s_up, s_lo, s_gs)]
    want = cr.backsub_sweep_plain(X, *views)
    exact = cr.backsub_sweep_plain(X.double(), *([v.double() for v in a]
                                                 for a in views))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: the backsub sweep returned non-finite "
                           "values")
    ok, worst = level_bar([got], [want], [exact])
    if not ok:
        raise RuntimeError(f"{label}: the backsub sweep disagrees with the "
                           f"plain walk (worst ratio {worst:.3g})")
    if not torch.equal(got, per_level):
        raise RuntimeError(f"{label}: the backsub sweep and the per-level "
                           "calls differ")
    print(f"  {label}: backsub sweep within the bar of the plain walk (ratio "
          f"{worst:.3g}); equal to the per-level calls bit for bit")
    return float((got - want).abs().max())


def _cr_times(levels, facs, s_gs, X):
    """CUDA-event ms of each CR kernel and its plain version, summed over
    the levels of one solve: ({name: (kernel ms, plain ms)}, {name: ms of
    the per-level kernel calls} for #4, #5 and #6).  #4, #5 and #6 are
    timed through their sweeps, as the main path calls them (``facs``,
    ``s_gs``: the kernel factors and s_g of the chain's levels, ``X`` the
    tail's solution).  The fused level #3 takes B (covariance's r = 2), the
    others G (r = 3)."""
    from collocfem_tpu_torch.ops import cr
    from collocfem_tpu_torch.solve.blocktri import TAIL

    Ds, Es, Gs = levels[0][:3]
    calls = {
        "cr_level": lambda f: [f(d, e, b) for d, e, _, b, *_ in levels],
        "cr_level_factor": lambda f: [f(d, e) for d, e, *_ in levels],
        "cr_level_apply": lambda f: [f(fac, g) for _, _, g, _, fac, _, _
                                     in levels],
        "cr_backsub": lambda f: [f(x, fac.s_up, fac.s_lo, sg) for
                                 *_, fac, x, sg in levels],
    }
    kernel = {name: (lambda name=name: calls[name](getattr(cr, name)))
              for name in calls}
    per_level = {name: _cuda_ms(kernel[name], 20)
                 for name in ("cr_level_factor", "cr_level_apply",
                              "cr_backsub")}
    kernel["cr_level_factor"] = lambda: cr.cr_factor_sweep(Ds, Es, TAIL)
    kernel["cr_level_apply"] = lambda: cr.cr_apply_sweep(facs, Gs)
    s_up, s_lo = cr.factor_columns(facs)
    kernel["cr_backsub"] = lambda: cr.cr_backsub_sweep(X, s_up, s_lo, s_gs)
    return ({name: (_cuda_ms(kernel[name], 20),
                    _cuda_ms(lambda: call(getattr(cr, name + "_ref")), 3))
             for name, call in calls.items()}, per_level)


def _bound(nbytes, flops):
    """(bound in ms, what binds it): the larger of the bytes over the HBM
    bandwidth and the operations over the float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _thomas_flops(b, r, blocks):
    """Operations of a block-tridiagonal solve by block Thomas: per block a
    Cholesky (b^3 / 3), W = S^-1 E and E^T W (4 b^3), and for the r
    right-hand sides the forward reduction, two triangular solves and the
    back-substitution (6 b^2 r)."""
    return blocks * (b ** 3 / 3 + 4 * b ** 3 + 6 * b * b * r)


def _kkt_bound(K, nq, b=8):
    """(bound ms, binding) of kernel #1's float32 call on a chain of K
    blocks of b with nq parameters: D, E, G = [gx | B], inv in, dx out;
    block Thomas with r = 1 + nq, and the Schur sums B^T X (2 b nq r a
    block)."""
    r, f = 1 + nq, 4
    return _bound(f * K * (2 * b * b + r * b + b + b),
                  _thomas_flops(b, r, K) + K * 2 * b * nq * r)


def _chain_bound(K, r, b=8):
    """(bound ms, binding) of kernel #2's float32 call on a chain of K
    blocks of b with r right-hand sides: D, E, G in, X out; block
    Thomas."""
    return _bound(4 * K * (2 * b * b + 2 * r * b), _thomas_flops(b, r, K))


def _cr_bounds(levels, r, r_cov):
    """{kernel #3-#6: (bound ms, binding)} of the float32 calls over the
    CR ``levels`` of one solve (the apply and back-substitution with r
    right-hand sides, the fused level #3 with r_cov).  Bytes: the level's
    inputs and outputs; operations: for a pair of blocks the odd block's
    Cholesky and four b x b products and solves (#4), 6 b^2 r for the
    right-hand sides (#5, #3) and 4 b^2 r for the back-substitution
    (#6)."""
    b, f = levels[0][0].shape[0], 4
    bb = b * b
    per_pair = {   # (elements moved, operations) per pair of blocks
        "cr_level_factor": (9 * bb, bb * b / 3 + 5 * 2 * bb * b),
        "cr_level_apply": (3 * bb + 4 * b * r, 6 * bb * r),
        "cr_level": (8 * bb + 4 * b * r_cov,
                     bb * b / 3 + 5 * 2 * bb * b + 6 * bb * r_cov),
        "cr_backsub": (2 * bb + 4 * b * r, 4 * bb * r),
    }
    pairs = sum(lv[0].shape[-1] // 2 for lv in levels)
    return {name: _bound(f * elems * pairs, ops * pairs)
            for name, (elems, ops) in per_pair.items()}


def _bounds(K1, K2, n_exp, k7, levels):
    """{kernel: (bound ms, binding)} of each kernel's float32 call at the
    shapes timed in phase 2.  Bytes: each input read once and each output
    written once (#1: D, E, G = [gx | B], inv in, dx out; #2, #7: D, E, G
    in, X out; #3-#6: the level's inputs and outputs, summed over the
    levels of one solve).  Operations: block Thomas for #1, #2, #7; the CR
    pair counts of :func:`_cr_bounds` for #3-#6 (r = 3, #3 timed with
    covariance's r = 2)."""
    b, f = 8, 4
    return {
        "kkt_solve_spike_fused": _kkt_bound(K1, 2),
        "blocktri_solve_spike_fused": _chain_bound(K2, 3),
        "batched_thomas_solve": _bound(
            f * n_exp * k7 * (2 * b * b + 2 * 3 * b),
            _thomas_flops(b, 3, n_exp * k7)),
        **_cr_bounds(levels, 3, 2),
    }


def _dense_batch(D, E, G):
    """The block-major chains (n, K, b, b) as dense (n, K b, K b) matrices
    with right-hand sides (n, K b, r)."""
    import torch

    n, K, b, _ = D.shape
    A = D.new_zeros((n, K * b, K * b))
    for k in range(K):
        s = slice(k * b, (k + 1) * b)
        A[:, s, s] = D[:, k]
        if k + 1 < K:
            t = slice((k + 1) * b, (k + 2) * b)
            A[:, s, t] = E[:, k]
            A[:, t, s] = E[:, k].transpose(1, 2)
    return A, G.reshape(n, K * b, G.shape[-1])


def _p_dev(p, ref):
    """max |p - ref| / max |ref|."""
    return (max(abs(a - b) for a, b in zip(p, ref))
            / max(abs(b) for b in ref))


def _timed(fn):
    """(result, wall in s) of fn() bracketed by torch.cuda.synchronize()."""
    from collocfem_tpu_torch.utils.profiling import timed

    wall, out = timed(fn, device="cuda", reps=1, warmup=0)
    return out, wall


def _profile_captured(label, run, wall, eager_wall):
    """_profile_run of one captured run, with the device idle share of the
    captured ``wall`` and of the ``eager_wall`` (the kernels are the same)."""
    prof = _profile_run(f"{label} captured", run, wall)
    prof["eager_idle_share"] = 1 - prof["device_ms"] / 1e3 / eager_wall
    print(f"    idle share of the eager wall {prof['eager_idle_share']:.3f}")
    return prof


def _profile_loop(label, eager_run, wall, eager_wall):
    """The device idle share of a converging captured solve's ``wall``,
    with the device time of its kernels from one profiled eager run
    (``eager_run``): the same kernels, less the loop's one-thread condition
    kernel and the captured steps' copies into the state buffers.
    torch.profiler does not trace the kernels inside a conditional node's
    body: on the card it dropped most of them or summed more device time
    than the wall, and once ended in an illegal address.  Also the idle
    share of the eager wall."""
    prof = _profile_run(f"{label} eager (the kernels of the captured run)",
                        eager_run, eager_wall)
    prof["eager_idle_share"] = prof["idle_share"]
    prof["idle_share"] = 1 - prof["device_ms"] / 1e3 / wall
    print(f"    idle share of the captured wall {prof['idle_share']:.3f} "
          f"(the eager run's device time)")
    return prof


def _vs_eager(label, solve, args, got):
    """Run the captured ``solve`` once more (a replay) and ``solve.eager``
    once on ``args``; raise unless both give ``got``, the captured solve's
    first result, bit for bit: z and every SolveStats field (cost,
    iterations, history, ...), by torch.equal on their bit patterns (a NaN
    in a rejected step's history row matches itself).  Returns (the
    replay's wall, the eager wall)."""
    from collocfem_tpu_torch.testing import bit_equal

    again, wall = _timed(lambda: solve(*args))
    want, eager_wall = _timed(lambda: solve.eager(*args))
    ok = bit_equal(again, got) and bit_equal(want, got)
    print(f"  {label}: captured and eager bit-identical (z, cost, "
          f"iterations, history) {'ok' if ok else 'FAIL'}; wall captured "
          f"{wall:.4f} s, eager {eager_wall:.4f} s")
    if not ok:
        raise RuntimeError(f"{label}: the captured solve differs from "
                           "solve.eager")
    return wall, eager_wall


def _run_ladder(ladder, label, card, main=None):
    """Run a ConvergedLadder once with the launch counts read after every
    level (each level's solve captures its graphs here), then once more
    without the reads for the wall, then eagerly (``ladder.eager``), which
    must give the captured run's finest (z, stats) bit for bit.  With gtol =
    0 every level runs all its maxiter trial solves (the lambda rail stops
    its progress, not its loop), so a level on 'auto' launches kernel #1
    maxiter times and a level on 'cr' launches kernels #4-#6 (levels x
    maxiter) times each, and the GN element kernel maxiter + 1 times;
    nothing else may launch and no plain version may run.
    The first run also counts each level's reads to the host (its warm start
    and its solve, solve.graph.HostReads) and raises unless there are none.
    With a dict ``main`` the levels' launches are added to it, and their
    shapes to MAIN_SHAPES.  Returns (z of every level, stats,
    per-level records (with the first run's wall of each level), wall,
    eager wall)."""
    import torch

    from collocfem_tpu_torch.solve.graph import HostReads

    zs, per_level, modes, marks = [], [], [], []

    def watch():
        modes.append(HostReads("cuda"))
        modes[-1].__enter__()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def on_level(i, z, stats):
        torch.cuda.synchronize()
        level_s = time.perf_counter() - marks[-1]
        modes[-1].__exit__(None, None, None)
        host_reads = modes[-1].count
        if host_reads:
            raise RuntimeError(f"{label} level {i}: {host_reads} host reads, "
                               "first at\n" + modes[-1].where[0])
        counts, plain = _counts()
        lvl = ladder.levels[i]
        n = lvl.options.maxiter
        want = _assembled({"kkt_solve_spike_fused": n}
                          if lvl.options.method == "auto" else
                          {k: _cr_level_count(lvl.elements + 1) * n
                           for k in CR_NAMES[1:]}, n)
        _expect_only(counts, plain, want, f"{label} level {i}")
        if main is not None:
            _keep_shapes(want)
            for k, v in want.items():
                main[k] = main.get(k, 0) + v
        per_level.append(dict(elements=lvl.elements,
                              dtype=str(lvl.problem.dtype).split(".")[1],
                              method=lvl.options.method,
                              iterations=int(stats.iterations),
                              launches=want, p=z.p.tolist(),
                              first_wall_s=level_s, host_reads=host_reads))
        zs.append(z)
        _reset_counts()
        if i + 1 < len(ladder.levels):
            watch()

    from collocfem_tpu_torch.testing import bit_equal

    _reset_counts()
    (z, stats), first = _timed(lambda: (watch(), ladder(on_level))[1])
    again, wall = _timed(ladder)
    want, eager_wall = _timed(ladder.eager)
    for r in per_level:
        print(f"  {label} level {r['elements']} {r['dtype']} "
              f"({r['method']}): {r['iterations']} iterations, launches "
              f"{r['launches']}, p={r['p']}; first run {r['first_wall_s']:.3f}"
              f" s, host reads {r['host_reads']} (gate 0)")
    ok = bit_equal(again, (z, stats)) and bit_equal(want, (z, stats))
    print(f"  {label}: wall {wall:.3f} s captured, {eager_wall:.3f} s eager "
          f"(first run, with the captures and per-level reads: {first:.3f} "
          f"s) on {card}; captured and eager bit-identical at the finest "
          f"level (z, cost, iterations, history) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{label}: the captured ladder differs from the "
                           "eager one")
    return zs, stats, per_level, wall, eager_wall


def _cr_fixed_work(label, elements, dtype, dev, card):
    """bench.py's run_fixed at ``elements`` on method='cr' (what the JAX
    package's 'auto' resolves to past its fused kernel's reach): 15 LM
    iterations with every tolerance 0, kkt_refine=0, lam0 3e-6 and the
    lambda rail off, captured.  Raises unless kernels #4-#6 launched 15 x
    levels times each, the GN element kernel 16 times and nothing else did,
    the captured run gives solve.eager's result bit for bit, p is finite
    and the cost falls.
    Returns (record, the first call's launch counts): the wall (best of 3 in
    float32, one run in float64), the eager wall, one captured run's
    profile, the cost before and after, p, accepts and lambdas."""
    import torch

    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    name = str(dtype).split(".")[1]
    prob, data, z0 = _headline(dtype, dev, elements)
    solve = make_gn_solver(prob, SolverOptions(
        maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=0,
        lam0=3e-6, lam_max=1e30, method="cr"))
    _reset_counts()
    z, stats = solve(z0, data)
    torch.cuda.synchronize()
    counts, plain_calls = _counts()
    walls = [_timed(lambda: solve(z0, data))[1]
             for _ in range(3 if dtype == torch.float32 else 1)]
    c0, c_end = float(prob.cost(z0, data)), float(stats.cost)
    p = z.p.tolist()
    print(f"{label}: N={elements} {name} method='cr', 15 LM "
          f"iterations: cost {c0:.6e} -> {c_end:.6e} ({c0 / c_end:.2f}x), "
          f"p={p}, accepted {int(stats.history[:, 4].sum())} of 15, "
          f"launches { {k: v for k, v in counts.items() if v} }, plain "
          f"calls {plain_calls}; wall {min(walls):.4f} s captured (best "
          f"of {len(walls)}) on {card}")
    _expect_only(counts, plain_calls,
                 _assembled({k: 15 * _cr_level_count(elements + 1)
                             for k in CR_NAMES[1:]}, 15),
                 f"{label} fixed work {name}")
    _, eager_wall = _vs_eager(f"{label} fixed work {name}", solve,
                              (z0, data), (z, stats))
    rec = dict(
        wall_s=min(walls), walls_s=walls, eager_wall_s=eager_wall,
        profile=_profile_captured(f"{label} fixed work {name}",
                                  lambda: solve(z0, data), min(walls),
                                  eager_wall),
        cost=[c0, c_end], p=p, launches=counts,
        accepts=stats.history[:, 4].tolist(),
        lam=stats.history[:, 2].tolist())
    if not (c_end < c0 and all(math.isfinite(v) for v in p)):
        raise RuntimeError(f"{label}: the CR fixed-work solve ({name}) did "
                           "no useful work")
    return rec, counts


def _phase7(dev, card, record):
    """Phase 7: the headline at N = ELEMENTS_CR through the CR kernels.
    Returns the launches of kernels #3-#6 and the GN element kernel on
    their main paths."""
    import torch

    from collocfem_tpu_torch.headline import ConvergedLadder
    from collocfem_tpu_torch.ops.assemble import assemble_gn
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.solve import covariance as cov
    from collocfem_tpu_torch.testing import rel_err

    n_levels = _cr_level_count(ELEMENTS_CR + 1)
    launches = {}
    # Fixed work with method='cr': float32 (best-of-3 wall), then float64
    # (held against the JAX package's float64 run).
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        rec, counts = _cr_fixed_work("phase 7", ELEMENTS_CR, dtype, dev, card)
        record[f"cr_fixed_work_{name}"] = rec
        c0, c_end = rec["cost"]
        if dtype == torch.float32:
            # No >10x bar here: at N = 20,000 the float32 LM drives lam
            # below the float32 rounding of the unit diagonal, and whether
            # a step's factorisation survives is a rounding coin flip.
            print(f"  (float32 at this N runs at the float32 factorisation "
                  f"cliff; the JAX package's CPU float32 run: "
                  f"{CR_FIXED_JAX_F32_RATIO:.2f}x)")
            launches.update({k: counts[k] for k in (*CR_NAMES[1:], GN)})
            _keep_shapes([*CR_NAMES[1:], GN])
        else:
            p_dev = _p_dev(rec["p"], CR_FIXED_JAX_F64_P)
            rec["p_vs_jax"] = p_dev
            print(f"  float64: |p - p_jax|/|p_jax| {p_dev:.3e} (<= 1e-6), "
                  f"cost falls more than 10x")
            if not (c_end < 0.1 * c0 and p_dev <= 1e-6):
                raise RuntimeError("the float64 CR fixed work disagrees with "
                                   "the JAX package's")

    # The converged ladder, float32 then float64.
    ladder = ConvergedLadder(ELEMENTS_CR, device=dev, dtype=torch.float32)
    _, _, per_level, wall, eager_wall = _run_ladder(ladder, "ladder float32",
                                                    card)
    p = per_level[-1]["p"]
    p_err = max(abs(v - 1.0) for v in p)
    record["ladder_f32"] = dict(wall_s=wall, eager_wall_s=eager_wall,
                                levels=per_level, p_err=p_err)
    print(f"  ladder float32: p={p}, ||p - 1||_inf {p_err:.3e} (< 1e-4; the "
          f"JAX package's CPU float32 ladder: {P_ERR_JAX_LADDER_F32:.3e})")
    if not p_err < 1e-4:
        raise RuntimeError("the float32 ladder did not reach ||p - 1|| < 1e-4")
    del ladder

    ladder = ConvergedLadder(ELEMENTS_CR, device=dev, dtype=torch.float64)
    zs, _, per_level, wall, eager_wall = _run_ladder(ladder, "ladder float64",
                                                     card)
    p = per_level[-1]["p"]
    p_dev = _p_dev(p, P_JAX_LADDER_F64)
    record["ladder_f64"] = dict(wall_s=wall, eager_wall_s=eager_wall,
                                levels=per_level, p_vs_jax=p_dev)
    print(f"  ladder float64: p={p}, |p - p_jax|/|p_jax| {p_dev:.3e} "
          f"(<= 1e-6)")
    if not p_dev <= 1e-6:
        raise RuntimeError("the float64 ladder's p disagrees with the JAX "
                           "package's")

    # Uncertainty at the float64 ladder's solutions.
    fine, coarse = ladder.levels[-1], ladder.levels[0]
    _reset_counts()
    std, wall = _timed(lambda: cov.parameter_std(fine.problem, zs[-1],
                                                 fine.data))
    counts, plain_calls = _counts()
    _expect_only(counts, plain_calls,
                 {"cr_level": n_levels, "cr_backsub": n_levels},
                 "phase 7 parameter_std")
    launches["cr_level"] = counts["cr_level"]
    _keep_shapes(["cr_level"])
    sys_ = assemble_gn(fine.problem, zs[-1], fine.data)
    a_b = bt.blocktri_solve_cr_plain(sys_.D, sys_.E, sys_.B)
    schur = sys_.C - torch.einsum("kbq,kbr->qr", sys_.B, a_b)
    want = torch.sqrt(torch.diagonal(torch.linalg.inv(schur)))
    rel = rel_err(std, want)
    record["parameter_std"] = dict(std=std.tolist(), rel_vs_plain=rel,
                                   wall_s=wall)
    print(f"  parameter_std at N={ELEMENTS_CR} float64: {std.tolist()}, "
          f"rel diff vs the plain solve {rel:.3e} (<= 1e-9), wall "
          f"{wall:.3f} s")
    if not rel <= 1e-9:
        raise RuntimeError("parameter_std disagrees with the plain solve")
    sstd, wall = _timed(lambda: cov.state_std(coarse.problem, zs[0],
                                              coarse.data))
    ok = bool(torch.isfinite(sstd).all()) and bool((sstd > 0).all())
    record["state_std"] = dict(elements=coarse.elements, wall_s=wall,
                               max=float(sstd.max()), min=float(sstd.min()))
    print(f"  state_std at N={coarse.elements} float64: shape "
          f"{tuple(sstd.shape)}, range [{float(sstd.min()):.3e}, "
          f"{float(sstd.max()):.3e}], wall {wall:.3f} s (the selected "
          f"inverse is a sequential recursion, no kernel)")
    if not ok or tuple(sstd.shape) != (coarse.problem.num_nodes, 2):
        raise RuntimeError("state_std returned no usable band")
    return launches


def _phase2_cr_dw(dev, card, lam):
    """Phase 2 at N = ELEMENTS_DW (K = 100,001, padded to 131,072: 14
    levels a sweep), float32 and float64: kernels #3-#5 level by level and
    the sweeps of #4, #5 and #6 on the headline's equilibrated, damped chain
    at the initial guess, against their plain versions at phase 2's bars,
    whole solves against the plain solves, and the times by CUDA events of
    one solve beside the float32 bound at 14 levels (_cr_bounds).  Returns
    {kernel #4-#6 name: [at_configs record]}."""
    import torch

    n_levels = _cr_level_count(ELEMENTS_DW + 1)
    errs, out = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        padded, unpadded = _cr_chain(*_headline(dtype, dev, ELEMENTS_DW), lam)
        levels, tail = _cr_levels(*padded)
        if len(levels) != n_levels:
            raise RuntimeError(f"CR at K={ELEMENTS_DW + 1}: {len(levels)} "
                               f"levels, _cr_level_count says {n_levels}")
        for i, (D, E, G, B, *_) in enumerate(levels):
            for k, v in _hold_cr(f"CR N={ELEMENTS_DW} {name} level {i} "
                                 f"m={D.shape[-1]}", dtype, D, E, G,
                                 B).items():
                errs[(k, name)] = max(errs.get((k, name), 0.0), v)
        label = f"CR sweeps N={ELEMENTS_DW} {name}"
        facs, s_gs, x_tail = _hold_cr_sweeps(
            label, levels, tail, *_cr_levels(*(a.double() for a in padded)))
        errs[("cr_backsub", name)] = max(
            errs[("cr_backsub", name)],
            _hold_backsub_sweep(label, facs, s_gs, x_tail))
        _hold_cr_solves(f"CR N={ELEMENTS_DW} {name} K={ELEMENTS_DW + 1}",
                        dtype, *unpadded)
        ms, per_level = _cr_times(levels, facs, s_gs, x_tail)
        bounds = _cr_bounds(levels, 3, 2)
        for k, (k_ms, p_ms) in ms.items():
            print(f"  {k} {name} at K={ELEMENTS_DW + 1} ({n_levels} levels): "
                  f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms per solve"
                  + (f" (one sweep call; {per_level[k]:.3f} ms through "
                     f"{n_levels} per-level calls)" if k in per_level else "")
                  + (f"; float32 bound {bounds[k][0] * 1e3:.2f} us "
                     f"({bounds[k][1]})" if dtype == torch.float32 else ""))
            if dtype == torch.float32 and k in CR_NAMES[1:]:
                out[k] = dict(config=f"headline N={ELEMENTS_DW}",
                              K=ELEMENTS_DW + 1, b=8, r=3, levels=n_levels,
                              ms=k_ms, plain_ms=p_ms,
                              per_level_calls_ms=per_level[k],
                              bound_ms=bounds[k][0], bound_by=bounds[k][1],
                              library_ms=None)
        del padded, unpadded, levels, tail, facs, s_gs, x_tail
        torch.cuda.empty_cache()
    print(f"  kernels #3-#6 at K={ELEMENTS_DW + 1}: every level, the sweeps "
          "and whole solves ok in both dtypes; max abs err (float64) "
          + ", ".join(f"{k} {errs[(k, 'float64')]:.3e}" for k in CR_NAMES))
    return {k: [dict(rec, max_abs_err=errs[(k, "float64")])]
            for k, rec in out.items()}


def _phase16(dev, card, record):
    """Phase 16: bench.py past refine.CR_DW_CHAIN at N = ELEMENTS_DW, with
    float64 where the JAX package runs its double-word tiers.  (a)
    run_fixed at N = 100,000 on method='cr' (_cr_fixed_work) in float32 and
    float64; float64 within 1e-6 of the JAX package's float64 run, p and the
    cost ratio.  (b) ConvergedLadder(ELEMENTS_DW, dtype=float32): 6,250
    float32 -> 6,250 float64 -> 100,000 float64 on 'cr', captured and
    eager bit for bit, 0 host reads in each level; p within 1e-6 of the JAX
    package's float64 run of the same levels, ||p - 1||_inf < 1e-4.
    Returns the launches of kernels #1, #4-#6 and the GN element kernel."""
    import torch

    from collocfem_tpu_torch.headline import ConvergedLadder

    t_phase = time.perf_counter()
    launches = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        rec, counts = _cr_fixed_work("phase 16", ELEMENTS_DW, dtype, dev, card)
        record[f"dw_fixed_work_{name}"] = rec
        _keep_shapes([*CR_NAMES[1:], GN])
        for k in (*CR_NAMES[1:], GN):
            launches[k] = launches.get(k, 0) + counts[k]
        if dtype == torch.float64:
            c0, c_end = rec["cost"]
            p_dev = _p_dev(rec["p"], DW_FIXED_JAX_F64_P)
            r_dev = abs(c0 / c_end / DW_FIXED_JAX_F64_RATIO - 1)
            rec.update(p_vs_jax=p_dev, ratio_vs_jax=r_dev)
            print(f"  float64: |p - p_jax|/|p_jax| {p_dev:.3e} (<= 1e-6); "
                  f"cost ratio {c0 / c_end:.6f}x, the JAX package's "
                  f"{DW_FIXED_JAX_F64_RATIO:.6f}x (within 1e-6 relative: "
                  f"{r_dev:.3e})")
            if not (p_dev <= 1e-6 and r_dev <= 1e-6):
                raise RuntimeError("the float64 fixed work at N="
                                   f"{ELEMENTS_DW} disagrees with the JAX "
                                   "package's")

    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    (ladder, build_s) = _timed(lambda: ConvergedLadder(
        ELEMENTS_DW, device=dev, dtype=torch.float32))
    print(f"phase 16: ladder at N={ELEMENTS_DW} built in {build_s:.3f} s: "
          + " -> ".join(f"{lv.elements} {str(lv.problem.dtype)[6:]} "
                        f"({lv.options.method}, maxiter "
                        f"{lv.options.maxiter}, lam0 {lv.options.lam0:g})"
                        for lv in ladder.levels))
    zs, _, per_level, wall, eager_wall = _run_ladder(
        ladder, "phase 16 ladder", card, main=launches)
    marks = []

    def mark(i, z, stats):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    ladder(mark)
    split = [b - a for a, b in zip(marks, marks[1:])]
    prof = _profile_captured("phase 16 ladder", ladder, wall, eager_wall)
    peak = torch.cuda.max_memory_allocated(dev)
    p = per_level[-1]["p"]
    p_dev = _p_dev(p, P_JAX_LADDER_DW_F64)
    p_err = max(abs(v - 1.0) for v in p)
    first = sum(r["first_wall_s"] for r in per_level)
    record["ladder_dw"] = dict(
        build_s=build_s, wall_s=wall, eager_wall_s=eager_wall,
        first_run_s=first, split_s=split, levels=per_level, profile=prof,
        p_vs_jax=p_dev, p_err=p_err, max_memory_allocated=peak,
        memory_held_before=held,
        replaced={"polish (6,250, float64)": "state_dw",
                  f"fine ({ELEMENTS_DW}, float64, 'cr')":
                      "state_dw + method='cr_dw'"})
    print(f"  phase 16 ladder: wall {wall:.4f} s captured, {eager_wall:.4f} s "
          f"eager, first run {first:.3f} s (captures, per-level reads); "
          f"per-level split of a captured run "
          + " / ".join(f"{t:.4f}" for t in split) + " s; peak memory "
          f"allocated {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB "
          f"above what the earlier phases held), on {card}")
    print(f"  phase 16 ladder: p={p}, |p - p_jax|/|p_jax| {p_dev:.3e} (<= "
          f"1e-6, the JAX package's float64 run of the same levels); "
          f"||p - 1||_inf {p_err:.3e} (< 1e-4; the JAX package measured "
          f"7.15e-7 with its double-word tiers on a TPU v5e, BASELINE.md: "
          f"information only)")
    print("  float64 took the place of: state_dw on the polish level, "
          "state_dw and method='cr_dw' on the fine level")
    if not (p_dev <= 1e-6 and p_err < 1e-4):
        raise RuntimeError(f"the ladder at N={ELEMENTS_DW} missed its gates")
    record["phase16_s"] = time.perf_counter() - t_phase
    print(f"phase 16: wall {record['phase16_s']:.1f} s (budget 60 s)")
    return launches


def _dense_kkt(sys_, lam_abs):
    """The damped bordered KKT matrix [[A + lam_abs I, B], [B^T, C +
    lam_abs I]] of an SoA system, dense ((K b + nq)^2, block-major order),
    and its right-hand side -[gx; gp] (K b + nq, 1)."""
    import torch

    D, E, B, C, gx, gp = sys_
    b, _, K = D.shape
    n, nq = K * b, C.shape[0]
    M = D.new_zeros((n + nq, n + nq))
    blocks = M[:n, :n].unflatten(0, (K, b)).unflatten(2, (K, b))
    k = torch.arange(K, device=D.device)
    blocks[k, :, k, :] = D.permute(2, 0, 1)
    blocks[k[:-1], :, k[:-1] + 1, :] = E[..., :-1].permute(2, 0, 1)
    blocks[k[:-1] + 1, :, k[:-1], :] = E[..., :-1].permute(2, 1, 0)
    M[:n, n:] = B.permute(2, 0, 1).reshape(n, nq)
    M[n:, :n] = M[:n, n:].T
    M[n:, n:] = C
    M.diagonal().add_(lam_abs)
    return M, -torch.cat([gx.T.reshape(n), gp])[:, None]


def _gn_bound(prob, z, data, vals, sys_):
    """(bound ms, binding) of one gn_system call: its operands read once (V,
    the node values, y, meas_w and the problem's mask, rows, widths and
    dscale) and D, E, B and gx written once; operations 2 m c^2 an element
    (J^T [J | r] of the element's m rows and c = (d + 1) nx + nq + 1
    columns) at the float32 peak."""
    read = [z.V, *vals, data.y, data.meas_w, prob.mmask, prob.mrows,
            prob.widths, prob.dscale]
    written = [sys_.D, sys_.E, sys_.B, sys_.gx]
    nbytes = sum(x.numel() * x.element_size() for x in read + written)
    m = (vals.fv.shape[1] * vals.fv.shape[2]
         + vals.hv.shape[1] * vals.hv.shape[2])
    c = (prob.mesh.degree + 1) * prob.model.nx + prob.model.nq + 1
    return _bound(nbytes, 2 * m * c * c * prob.mesh.num_elements)


def _phase2_gn(dev, card):
    """Phase 2 for the GN element kernel (ops/gn_elements.py gn_system):
    against its plain version gn_system_ref on the same node values, on the
    headline at its initial guess at N = ELEMENTS (the n10k cell's shape)
    and ELEMENTS_DW (the ladder's fine level), in both dtypes: every leaf of
    the system within 1e-12 (float64) or 5e-5 (float32) of its largest
    entry, the float64 cost within 1e-12 (1e-6) of it, two launches bit for
    bit; its ms and the plain version's by CUDA events, and its bound
    (_gn_bound).  Returns {(N, dtype name): record}."""
    import torch

    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.testing import bit_equal

    out = {}
    for n in (ELEMENTS, ELEMENTS_DW):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            label = f"GN element kernel headline N={n} {name}"
            prob, data, z0 = _headline(dtype, dev, n)
            if not ge.engages(prob, z0, data):
                raise RuntimeError(f"{label}: the kernel does not take it")
            vals = ge.node_values(prob, z0, data)
            kernel = lambda: ge.gn_system(prob, z0, data, vals)
            plain = lambda: ge.gn_system_ref(prob, z0, data, vals)
            got, again, (want, want_cost) = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if not bit_equal(got, again):
                raise RuntimeError(f"{label}: two launches differ")
            sys_, cost = got
            tol = 1e-12 if dtype == torch.float64 else 5e-5
            rel, err = {}, 0.0
            for leaf in ("D", "E", "B", "C", "gx", "gp"):
                g, w = getattr(sys_, leaf), getattr(want, leaf)
                if not bool(torch.isfinite(g).all()):
                    raise RuntimeError(f"{label}: {leaf} is not finite")
                diff = float((g - w).abs().max())
                rel[leaf] = diff / float(w.abs().max())
                err = max(err, diff)
            rel["cost"] = abs(float(cost - want_cost)) / float(want_cost)
            c_tol = 1e-12 if dtype == torch.float64 else 1e-6
            ok = (max(v for k, v in rel.items() if k != "cost") <= tol
                  and rel["cost"] <= c_tol)
            k_ms, p_ms = _cuda_ms(kernel, 20), _cuda_ms(plain, 3)
            bound = _gn_bound(prob, z0, data, vals, sys_)
            out[(n, name)] = dict(
                N=n, K=n + 1, b=sys_.D.shape[0], nq=sys_.C.shape[0],
                S=prob.mmask.shape[1], max_abs_err=err, rel_err=rel,
                ms=k_ms, plain_ms=p_ms, bound_ms=bound[0],
                bound_by=bound[1])
            print(f"  {label} (K={n + 1}, b={sys_.D.shape[0]}, "
                  f"S={prob.mmask.shape[1]}): leaves' rel diff "
                  + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
                  + f" (<= {tol:g}, cost {c_tol:g}) "
                  f"{'ok' if ok else 'FAIL'}; two launches bit-identical; "
                  f"kernel {k_ms:.4f} ms/call, plain {p_ms:.3f} ms/call, "
                  f"bound {bound[0] * 1e3:.2f} us ({bound[1]}) on {card}")
            if not ok:
                raise RuntimeError(f"{label}: the kernel disagrees with its "
                                   "plain version")
            del prob, data, z0, vals, got, again, want, sys_
    return out


def _phase2_configs(dev, card):
    """Phase 2 at the shapes of configs 2 and 4: kernel #1 at nq = 3 and 5
    on each config's damped system at its initial guess (timed beside its
    plain version, its device time by phase and the dense library solve)
    and on seeded chains; kernels #3-#6 at r = 4 and 6 on each config's
    equilibrated chain, level by level, its sweeps and whole solves (timed)
    and on seeded chains.  Returns the per-shape records."""
    import torch

    from collocfem_tpu_torch.ops import spike
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.solve.kkt import damping_scales
    from collocfem_tpu_torch.testing import random_chain, random_kkt_system
    from collocfem_tpu_torch.tools.spike_tiles import _split

    from collocfem_tpu_torch import configs

    out = {"kkt": {}, "cr": {}}
    for cname, build, lam in (
            ("config 2", configs.build_config2_problem,
             configs.C2_FIXED["lam0"]),
            ("config 4", configs.build_config4_problem,
             configs.C4_FIXED["lam0"])):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            prob, z0, data = build(dtype=dtype, device=dev)
            sys_ = assemble_gn_soa(prob, z0, data)
            K, nq = sys_.num_blocks, sys_.C.shape[0]
            label = f"kernel #1 {cname} {name} K={K} nq={nq}"
            err = _compare(sys_, lam, None, label)
            call = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam)
            k_ms = _cuda_ms(lambda: spike.kkt_solve_spike_fused(*call), 20)
            p_ms = _cuda_ms(lambda: spike.kkt_solve_spike_fused_ref(*call), 3)
            split = _split(lambda: spike.kkt_solve_spike_fused(*call))
            dx, dp, _ = spike.kkt_solve_spike_fused(*call)
            lib_ms, shape, lib_rel = _dense_solve(
                sys_, damping_scales(sys_.D, sys_.C, lam)[0],
                torch.cat([dx.T.reshape(-1), dp]))
            bound = _kkt_bound(K, nq)
            out["kkt"][f"{cname} {name}"] = dict(
                K=K, nq=nq, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                device_us=split, device_us_total=sum(split.values()),
                library_ms=lib_ms, library_rel_diff=lib_rel,
                bound_ms=bound[0], bound_by=bound[1])
            print(f"  {label}: kernel {k_ms:.3f} ms/call ("
                  f"{sum(split.values()):.1f} us on the device: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                  + f"), plain {p_ms:.3f} ms/call; torch.linalg.solve on the "
                  f"dense damped KKT matrix {shape} {lib_ms:.3f} "
                  f"ms/call (rel diff to the kernel {lib_rel:.2e}); float32 "
                  f"bound {bound[0] * 1e3:.3f} us ({bound[1]}) on {card}")

            padded, unpadded = _cr_chain(prob, data, z0, lam,
                                         covariance_rhs=False)
            r = padded[2].shape[1]
            clabel = f"CR {cname} {name} K={K} r={r}"
            levels, tail = _cr_levels(*padded)
            errs = {}
            for i, (D, E, G, B, *_) in enumerate(levels):
                for k, v in _hold_cr(f"{clabel} level {i}", dtype, D, E, G,
                                     B).items():
                    errs[k] = max(errs.get(k, 0.0), v)
            facs, s_gs, x_tail = _hold_cr_sweeps(
                clabel, levels, tail, *_cr_levels(*(a.double()
                                                    for a in padded)))
            errs["cr_backsub"] = max(errs["cr_backsub"], _hold_backsub_sweep(
                clabel, facs, s_gs, x_tail))
            _hold_cr_solves(clabel, dtype, *unpadded)
            ms, per_level = _cr_times(levels, facs, s_gs, x_tail)
            bounds = _cr_bounds(levels, r, r)
            out["cr"][f"{cname} {name}"] = dict(
                K=K, r=r, levels=len(levels), max_abs_err=errs,
                ms={k: v[0] for k, v in ms.items()},
                plain_ms={k: v[1] for k, v in ms.items()},
                per_level_calls_ms=per_level,
                bound_ms={k: v[0] for k, v in bounds.items()},
                bound_by={k: v[1] for k, v in bounds.items()})
            for k, (k_ms, p_ms) in ms.items():
                print(f"  {clabel} {k}: kernel {k_ms:.3f} ms, plain "
                      f"{p_ms:.3f} ms per solve ({len(levels)} levels"
                      + (f"; one sweep call, {per_level[k]:.3f} ms through "
                         "per-level calls" if k in per_level else "")
                      + f"); float32 bound {bounds[k][0] * 1e3:.3f} us")
            del prob, z0, data, sys_, padded, unpadded, levels, facs

        for k in (*EDGES, 201, 1001):
            for dtype in (torch.float32, torch.float64):
                rs = random_kkt_system(k, 8, nq, seed=k + nq, dtype=dtype,
                                       device=dev)
                _compare(rs, 1e-3, None, f"kernel #1 random "
                         f"{str(dtype).split('.')[1]} K={k} nq={nq}")

    for r in (4, 6):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[1]
            for k in (16, 17, 130, 1000):
                D, E, G = random_chain(k, 8, r, seed=k + r, dtype=dtype,
                                       device=dev)
                Dp, Ep = bt._pad_pow2_soa(D, E)
                Gp = bt._pad_rhs(G, Dp.shape[-1])
                label = f"CR random {name} K={k} r={r}"
                levels, tail = _cr_levels(Dp, Ep, Gp, Gp)
                for i, (Dl, El, Gl, Bl, *_) in enumerate(levels):
                    _hold_cr(f"{label} level {i}", dtype, Dl, El, Gl, Bl)
                facs, s_gs, x_tail = _hold_cr_sweeps(
                    label, levels, tail, *_cr_levels(
                        *(a.double() for a in (Dp, Ep, Gp, Gp))))
                _hold_backsub_sweep(label, facs, s_gs, x_tail)
                _hold_cr_solves(label, dtype, D, E, G, G)
        print(f"  kernels #3-#6 r={r}: seeded chains K in (16, 17, 130, "
              "1000), every level, the sweeps and whole solves ok")
    return out


# Block sizes of phase 2's seeded chains at the shapes the per-shape builds
# added: one lane (b = 1), groups of 2 and 4 (b = 3 with one lane idle), 9
# (16 lanes, 7 idle) and the range's largest, 16.
SEEDED_BLOCKS = (1, 2, 3, 4, 9, 16)


def _prebuild_set():
    """The instances of the benchmark problems' shapes, which the libraries
    were compiled for as fixed lists before per-shape builds: kernel #1 at
    (b, nq) (8, 2), (8, 3), (8, 5), (12, 1); #2 at (b, r) (6, 1), (8, 1),
    (8, 3), (8, 19), (12, 1); #7 at (8, 3); the CR kernels at b = 8 (the
    factor kernel, r = 0, and r = 1, 2, 3, 4, 6); csrc/graph_loop.cu, the
    converging solves' WHILE loop (solve/graph.py); and csrc/peer_reduce.cu,
    the multi-rank tier's collectives (parallel/peer.py)."""
    from collocfem_tpu_torch.ops import cr, spike, thomas
    from collocfem_tpu_torch.parallel import peer
    from collocfem_tpu_torch.solve.graph import LOOP_INSTANCE

    return ([LOOP_INSTANCE, peer.INSTANCE]
            + [spike.kkt_instance(b, nq) for b, nq in ((8, 2), (8, 3), (8, 5),
                                                       (12, 1))]
            + [spike.chain_instance(b, r) for b, r in
               ((6, 1), (8, 1), (8, 3), (8, 19), (12, 1))]
            + [thomas.instance(8, 3)]
            + [cr.instance(8, r) for r in (0, 1, 2, 3, 4, 6)])


def _new_instances():
    """The instances this run adds to the prebuild set: phase 2's seeded
    shapes at SEEDED_BLOCKS (#1 at nq = 2, #2 at r = 1 and 3, #7 at r = 3,
    the CR kernels at r = 0, 1, 3) and the shapes of the problems of phases
    2, 12 (b) and 15: #1 at (4, 2) (Van der Pol at degree 2) and (9, 1)
    (the free-time OCP at degree 3); #2 at (4, 3) and #7 at (4, 3)
    (tests/test_multi_experiment.py's batch), #2 at (8, 4) and (8, 6)
    (configs 2 and 4 with kkt_refine) and (16, 1) (the split actuator);
    the CR kernels at (4, 2) (parameter_std at degree 2) and b = 12 (config
    3 with method='cr'); the GN element kernel at the shapes of the
    Gauss-Newton problems (degree, nx, nq, samples per element, ny): the
    headline (4, 2, 2, 2, 1) and its ladders' coarse levels (S = 17 and 5),
    configs 2 (4, 2, 3, 3, 1) and 4 and the aircraft (4, 2, 5, 2, 3), the
    bounded Van der Pol at degrees 4 and 2 (S = 3) and the PEM's MAP polish
    (4, 2, 3, 2, 1)."""
    from collocfem_tpu_torch.ops import cr, gn_elements, spike, thomas

    out = []
    for b in SEEDED_BLOCKS:
        out += [spike.kkt_instance(b, 2), spike.chain_instance(b, 1),
                spike.chain_instance(b, 3), thomas.instance(b, 3),
                *(cr.instance(b, r) for r in (0, 1, 3))]
    out += [spike.kkt_instance(9, 1), spike.chain_instance(8, 4),
            spike.chain_instance(8, 6), spike.chain_instance(16, 1),
            cr.instance(4, 2), cr.instance(12, 0), cr.instance(12, 1)]
    out += [gn_elements.instance(*shape, False) for shape in (
        (4, 2, 2, 2, 1), (4, 2, 2, 17, 1), (4, 2, 2, 5, 1), (4, 2, 3, 3, 1),
        (4, 2, 5, 2, 3), (4, 2, 2, 3, 1), (2, 2, 2, 3, 1), (4, 2, 3, 2, 1))]
    prebuilt = set(_prebuild_set())
    return [i for i in dict.fromkeys(out) if i not in prebuilt]


def _thomas_bound(n_exp, K, b, r):
    """(bound ms, binding) of kernel #7's float32 call on n_exp chains of K
    blocks of b with r right-hand sides: D, E, G in, X out; block
    Thomas."""
    return _bound(4 * n_exp * K * (2 * b * b + 2 * r * b),
                  _thomas_flops(b, r, n_exp * K))


def _time_plain_kernel(label, card, kernel, plain, key, bound, dense, err):
    """Phase 2's record of kernel #7 or a CR solve at one problem's shape:
    kernel and plain version by CUDA events, the kernel's device time
    (torch.profiler, the kernels whose name holds ``key``), its float32
    bound and ``dense`` = (ms, shape, rel diff) of torch.linalg.solve."""
    k_ms, p_ms = _cuda_ms(kernel, 20), _cuda_ms(plain, 3)
    us = _device_us(kernel, key)
    lib_ms, shape, lib_rel = dense
    print(f"  {label}: kernel {k_ms:.3f} ms/call ({us:.1f} us on the "
          f"device), plain {p_ms:.3f} ms/call; torch.linalg.solve on the "
          f"dense matrix {shape} {lib_ms:.3f} ms/call (rel diff to the kernel "
          f"{lib_rel:.2e}); float32 bound {bound[0] * 1e3:.3f} us "
          f"({bound[1]}) on {card}")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, device_us_total=us,
                library_ms=lib_ms, library_shape=shape,
                library_rel_diff=lib_rel, bound_ms=bound[0],
                bound_by=bound[1])


def _phase2_new_shapes(dev, card):
    """Phase 2 at the shapes the per-shape builds added, float32 and
    float64, at phase 2's bars.  Each problem's own system at its initial
    guess, timed (kernel, plain version, device time, dense
    torch.linalg.solve with TF32 off, float32 bound):
      #1 at (4, 2): tests/test_bounds.py's Van der Pol at its degree 2;
      #1 at (9, 1): the free-time OCP at degree 3 (its first subproblem);
      #2 and #7 at (4, 3): tests/test_multi_experiment.py's batch, both
        layouts (as _config5_systems forms config 5's);
      #2 at (8, 4) and (8, 6): configs 2 and 4, the chain solve of
        kkt_refine's passes against [gx | B];
      #2 at (16, 1): the split actuator (its first subproblem);
      #3-#6 at (12, 1): config 3 at N = 25 with method='cr', every level,
        the sweeps and whole solves; and at b = 4 on the degree-2 Van der
        Pol (G = [gx | B], r = 3; #3 on B, r = 2: parameter_std's shape).
    Then seeded chains at every b of SEEDED_BLOCKS: #1 (nq = 2) and #2 (r
    = 1, 3) at K in EDGES, #7 (r = 3) on 37 chains of K in (1, 2, 11), the
    CR kernels (r = 1, 3) on the first level and whole solves of K in (16,
    17, 130).  Returns {kernel name: [at_configs records]}."""
    import torch

    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.ops import spike, thomas
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)
    from collocfem_tpu_torch.solve.kkt import _equilibrate_soa, damping_scales
    from collocfem_tpu_torch.solve.newton import SolverOptions
    from collocfem_tpu_torch.testing import (batch_residual, chain_residual,
                                             random_chain,
                                             random_chain_batch,
                                             random_kkt_system, rel_err)

    recs = {}
    timed = {"chain": {}, "kkt": {}}

    def keep(name, config, dtype, rec, **shape):
        if dtype == torch.float64:
            recs.setdefault(name, {}).setdefault(config, {})["err"] = \
                rec["max_abs_err"]
        else:
            recs.setdefault(name, {}).setdefault(config, {}).update(
                config=config, **shape, ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=rec["library_ms"])

    def kkt_case(config, dtype, sys_, lam):
        K, b, nq = sys_.num_blocks, sys_.D.shape[0], sys_.C.shape[0]
        name = str(dtype).split(".")[1]
        label = f"kernel #1 {config} {name} K={K} b={b} nq={nq}"
        err = _compare(sys_, lam, None, label)
        call = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam)
        dx, dp, _ = spike.kkt_solve_spike_fused(*call)
        _time_kernel(timed, card, ("kkt", f"{config} {name}"), label,
                     lambda: spike.kkt_solve_spike_fused(*call),
                     lambda: spike.kkt_solve_spike_fused_ref(*call),
                     _kkt_bound(K, nq, b),
                     _dense_solve(sys_, damping_scales(sys_.D, sys_.C,
                                                       lam)[0],
                                  torch.cat([dx.T.reshape(-1), dp])), err)
        keep("kkt_solve_spike_fused", config, dtype,
             timed["kkt"][f"{config} {name}"], K=K, b=b, nq=nq)

    def chain_case(config, dtype, D, E, G):
        (b, r, K), name = G.shape, str(dtype).split(".")[1]
        label = f"kernel #2 {config} {name} K={K} b={b} r={r}"
        X = spike.blocktri_solve_spike_fused(D, E, G)
        err = _hold(label, dtype, X,
                    spike.blocktri_solve_spike_fused_ref(D, E, G),
                    lambda X: chain_residual(D, E, G, X))
        _time_kernel(timed, card, ("chain", f"{config} {name}"), label,
                     lambda: spike.blocktri_solve_spike_fused(D, E, G),
                     lambda: spike.blocktri_solve_spike_fused_ref(D, E, G),
                     _chain_bound(K, r, b), _dense_chain_solve(D, E, G, X),
                     err)
        keep("blocktri_solve_spike_fused", config, dtype,
             timed["chain"][f"{config} {name}"], K=K, b=b, r=r)

    def cr_case(config, dtype, padded, unpadded):
        name = str(dtype).split(".")[1]
        b, r, K = unpadded[2].shape
        r_cov = padded[3].shape[1]
        label = f"CR {config} {name} K={K} b={b} r={r}"
        levels, tail = _cr_levels(*padded)
        errs = {}
        for i, (D, E, G, B, *_) in enumerate(levels):
            for k, v in _hold_cr(f"{label} level {i}", dtype, D, E, G,
                                 B).items():
                errs[k] = max(errs.get(k, 0.0), v)
        facs, s_gs, x_tail = _hold_cr_sweeps(
            label, levels, tail, *_cr_levels(*(a.double() for a in padded)))
        errs["cr_backsub"] = max(errs["cr_backsub"], _hold_backsub_sweep(
            label, facs, s_gs, x_tail))
        _hold_cr_solves(label, dtype, *unpadded)
        ms, _ = _cr_times(levels, facs, s_gs, x_tail)
        bounds = _cr_bounds(levels, r, r_cov)
        D, E, G = unpadded[:3]
        dense = _dense_chain_solve(D, E, G, bt.blocktri_cr_factor_soa(D, E)(G))
        print(f"  {label}: torch.linalg.solve on the dense chain "
              f"{dense[1]} {dense[0]:.3f} ms/call (rel diff {dense[2]:.2e})")
        for k, (k_ms, p_ms) in ms.items():
            print(f"  {label} {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                  f"per solve ({len(levels)} levels; #3 at r={r_cov}); "
                  f"float32 bound {bounds[k][0] * 1e3:.3f} us on {card}")
            keep(k, config, dtype, dict(
                max_abs_err=errs[k], ms=k_ms, plain_ms=p_ms,
                bound_ms=bounds[k][0], bound_by=bounds[k][1],
                library_ms=dense[0]), K=K, b=b,
                r=r_cov if k == "cr_level" else r)

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        lam = SolverOptions().lam0
        vdp, v0, vdata = configs.build_bounded_vdp_problem(2, dtype=dtype,
                                                           device=dev)
        kkt_case("Van der Pol degree 2", dtype,
                 assemble_gn_soa(vdp, v0, vdata), lam)
        cr_case("Van der Pol degree 2", dtype,
                *_cr_chain(vdp, vdata, v0, lam))
        prob, _, z0 = configs.build_min_time_problem(dtype=dtype, device=dev,
                                                     degree=3)
        opts = ALBarrierOptions(**configs.MIN_TIME_OPTIONS)
        kkt_case("free-time OCP degree 3", dtype,
                 make_ocp_solver(prob, opts).first_system(z0), opts.lam0)

        batch = configs.build_multi_experiment_problem(dtype=dtype,
                                                       device=dev)
        (Dc, Ec, Gc), (Db, Eb, Gb) = _config5_systems(batch, lam)
        chain_case("multi-experiment batch soa", dtype, Dc, Ec, Gc)
        label = (f"kernel #7 multi-experiment batch blocks {name} n_exp="
                 f"{Db.shape[0]} K={Db.shape[1]} b={Db.shape[2]} r=3")
        X = thomas.batched_thomas_solve(Db, Eb, Gb)
        err = _hold(label, dtype, X, thomas.batched_thomas_solve_ref(Db, Eb,
                                                                     Gb),
                    lambda X: batch_residual(Db, Eb, Gb, X))
        A, rhs = _dense_batch(Db, Eb, Gb)
        dense = (_cuda_ms(lambda: torch.linalg.solve(A, rhs), 5),
                 tuple(A.shape), rel_err(torch.linalg.solve(A, rhs)
                                         .reshape(Gb.shape), X))
        keep("batched_thomas_solve", "multi-experiment batch blocks", dtype,
             _time_plain_kernel(
                 label, card, lambda: thomas.batched_thomas_solve(Db, Eb, Gb),
                 lambda: thomas.batched_thomas_solve_ref(Db, Eb, Gb),
                 "batched_thomas", _thomas_bound(*Db.shape[:3], 3), dense,
                 err), K=Db.shape[1], b=Db.shape[2], r=3,
             n_exp=Db.shape[0])
        del batch, Dc, Ec, Gc, Db, Eb, Gb, A, rhs

        for cname, build, fixed in (
                ("config 2", configs.build_config2_problem, configs.C2_FIXED),
                ("config 4", configs.build_config4_problem,
                 configs.C4_FIXED)):
            prob, z0, data = build(dtype=dtype, device=dev)
            s = _equilibrate_soa(assemble_gn_soa(prob, z0, data),
                                 fixed["lam0"])[0]
            chain_case(f"{cname} kkt_refine", dtype, s.D, s.E, torch.cat(
                [s.gx[:, None, :], s.B], dim=1).contiguous())
            del prob, z0, data, s

        prob, z0 = configs.build_split_actuator_problem(dtype=dtype,
                                                        device=dev)
        opts = ALBarrierOptions(**configs.SPLIT_OPTIONS)
        s = _equilibrate_soa(make_ocp_solver(prob, opts).first_system(z0),
                             opts.lam0)[0]
        chain_case("split actuator", dtype, s.D, s.E,
                   s.gx[:, None, :].contiguous())
        prob, z0 = configs.build_config3_problem(configs.ELEMENTS3,
                                                 dtype=dtype, device=dev)
        opts = ALBarrierOptions(method="cr")
        s = _equilibrate_soa(make_ocp_solver(prob, opts).first_system(z0),
                             opts.lam0)[0]
        G = s.gx[:, None, :].contiguous()
        Ds, Es = bt._pad_pow2_soa(s.D, s.E)
        Gp = bt._pad_rhs(G, Ds.shape[-1])
        cr_case("config 3 N=25 method='cr'", dtype, (Ds, Es, Gp, Gp),
                (s.D, s.E, G, G))

        for b in SEEDED_BLOCKS:
            for k in EDGES:
                _compare(random_kkt_system(k, b, 2, seed=k + b, dtype=dtype,
                                           device=dev), 1e-3, None,
                         f"kernel #1 random {name} K={k} b={b} nq=2")
                for r in (1, 3):
                    D, E, G = random_chain(k, b, r, seed=k + r + b,
                                           boundary=11, dtype=dtype,
                                           device=dev)
                    _hold(f"kernel #2 random {name} K={k} b={b} r={r}", dtype,
                          spike.blocktri_solve_spike_fused(D, E, G),
                          spike.blocktri_solve_spike_fused_ref(D, E, G),
                          lambda X: chain_residual(D, E, G, X))
            for k in (1, 2, 11):
                D, E, G = random_chain_batch(37, k, b, 3, seed=k + b,
                                             dtype=dtype, device=dev)
                _hold(f"kernel #7 random {name} n_exp=37 K={k} b={b}", dtype,
                      thomas.batched_thomas_solve(D, E, G),
                      thomas.batched_thomas_solve_ref(D, E, G),
                      lambda X: batch_residual(D, E, G, X))
            for k in (16, 17, 130):
                for r in (1, 3):
                    D, E, G = random_chain(k, b, r, seed=k + r + b,
                                           dtype=dtype, device=dev)
                    Dp, Ep = bt._pad_pow2_soa(D, E)
                    label = f"CR random {name} K={k} b={b} r={r}"
                    _hold_cr(label, dtype, Dp, Ep,
                             bt._pad_rhs(G, Dp.shape[-1]))
                    _hold_cr_solves(label, dtype, D, E, G, G)
        print(f"  seeded {name}: #1, #2 at K in {EDGES}, #7 on 37 chains of K "
              f"in (1, 2, 11), #3-#6 at K in (16, 17, 130), at every b in "
              f"{SEEDED_BLOCKS}: ok")
    return {name: [dict(rec, max_abs_err=rec.pop("err")) for rec in
                   by_config.values()] for name, by_config in recs.items()}


def _main_shapes(name, launches):
    """The kernels line's ``shapes`` of kernel ``name``: its main-path
    launches at each shape, as its wrapper recorded them.  Raises unless
    they add up to ``launches``."""
    key = {"kkt_solve_spike_fused": ("b", "nq"), GN: ("b", "nq"),
           "peer_reduce": ("P", "n")}.get(name, ("b", "r"))
    out = [{**dict(zip(key, shape)), "launches": n}
           for shape, n in sorted(MAIN_SHAPES.get(name, {}).items())]
    if sum(e["launches"] for e in out) != launches:
        raise RuntimeError(f"{name}: launches by shape {out} do not add up "
                           f"to its {launches} main-path launches")
    return out


def _at_configs(name, measured, ocp, mhe, sp):
    """The kernels line's ``at_configs`` of kernel ``name``: what phase 2
    measured at the shapes of configs 2 and 4 (``measured``, from
    _phase2_configs), of config 3 and the free-time OCP (``ocp``, from
    _phase2_ocp), of the MHE window (``mhe``, from _phase2_mhe) and of a
    headline shard's interior (``sp``, from _phase2_sp): float32 times and
    bound, the float64 max abs error, and for kernels #1 and #2 the dense
    torch.linalg.solve."""
    out = []
    if name == "blocktri_solve_spike_fused":
        for cname, rec in (("MHE window", mhe), ("headline shard", sp)):
            f32, f64 = (rec["chain"][f"{cname} {d}"]
                        for d in ("float32", "float64"))
            out.append(dict(
                config=cname, K=f32["K"], b=f32["b"], r=f32["r"],
                max_abs_err=f64["max_abs_err"], ms=f32["ms"],
                plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                bound_by=f32["bound_by"], library_ms=f32["library_ms"]))
    keys = {"kkt_solve_spike_fused": ("kkt", ["free-time"], "nq"),
            "blocktri_solve_spike_fused": (
                "chain", ["config 3 N=25", "config 3 N=500"], "r")}
    if name in keys:
        kind, cnames, width = keys[name]
        for cname in cnames:
            f32, f64 = (ocp[kind][f"{cname} {d}"]
                        for d in ("float32", "float64"))
            out.append(dict(
                config=cname if cname != "free-time" else "free-time OCP",
                K=f32["K"], b=12, **{width: f32[width]},
                max_abs_err=f64["max_abs_err"], ms=f32["ms"],
                plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                bound_by=f32["bound_by"], library_ms=f32["library_ms"]))
    for cname in ("config 2", "config 4"):
        if name == "kkt_solve_spike_fused":
            f32, f64 = (measured["kkt"][f"{cname} {d}"]
                        for d in ("float32", "float64"))
            out.append(dict(
                config=cname, K=f32["K"], b=8, nq=f32["nq"],
                max_abs_err=f64["max_abs_err"], ms=f32["ms"],
                plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                bound_by=f32["bound_by"], library_ms=f32["library_ms"]))
        elif name in CR_NAMES:
            f32, f64 = (measured["cr"][f"{cname} {d}"]
                        for d in ("float32", "float64"))
            out.append(dict(
                config=cname, K=f32["K"], b=8, r=f32["r"],
                max_abs_err=f64["max_abs_err"][name], ms=f32["ms"][name],
                plain_ms=f32["plain_ms"][name],
                bound_ms=f32["bound_ms"][name],
                bound_by=f32["bound_by"][name], library_ms=None))
    return out


def _counted(label, fn, want):
    """Run fn() with every count set to 0 just before and read just after,
    and raise unless the kernels launched as ``want`` says and no plain
    version ran.  ``want``: {kernel: launches}, a function of fn()'s result
    that gives them, or a set of kernels that must each launch at least
    once.  Returns (result, wall, counts)."""
    _reset_counts()
    out, wall = _timed(fn)
    counts, plain = _counts()
    if isinstance(want, set):
        if not all(counts[k] for k in want):
            raise RuntimeError(f"{label}: {sorted(want)} did not launch")
        want = {k: counts[k] for k in want}
    elif callable(want):
        want = want(out)
    _expect_only(counts, plain, want, label)
    return out, wall, counts


def _config_phase(num, cname, build, fixed, converged, truth, jax_p,
                  robust, dev, card, record, f32_bar=None):
    """Phase 8 (config 2) or 9 (config 4) at full size:
      (a) float32 fixed work on 'auto' (kernel #1 once per LM iteration, no
          plain call), the cost falls and p is finite (and, with
          ``f32_bar``, max |p / truth - 1| <= f32_bar); its best-of-3 wall
          and a torch.profiler breakdown;
      (b) float64 fixed work on 'auto', p within 1e-6 of the JAX package's;
      (c) (b) with method='cr' (kernels #4-#6 once per level and
          iteration);
      (d) the example's converged run in float64: converged, p within 1e-6
          of the JAX package's;
      (e) ``robust``: 'irls' (irls_delta 2, 4 rounds of the converged
          options) or 'newton' (the converged options with
          hessian='newton'), float64, from z0: p within 1e-6 of the JAX
          package's.
    Each Gauss-Newton run launches the GN element kernel once an LM
    iteration and once at each solve's start.  Returns the launches of
    kernels #1, #4-#6 and the GN element kernel over (a)-(e)."""
    import torch

    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_gn_solver,
                                                  make_irls_solver)

    launches = {}
    rec = record.setdefault(cname.replace(" ", ""), {})
    tag = f"phase {num}: {cname}"
    maxiter = fixed["maxiter"]
    kkt = "kkt_solve_spike_fused"

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        _keep_shapes(counts)

    def only_kkt(out):   # once per LM iteration of an early-exit run
        return _assembled({kkt: int(out[1].iterations)},
                          int(out[1].iterations))

    # (a) float32 fixed work.
    prob, z0, data = build(dtype=torch.float32, device=dev)
    solve = make_gn_solver(prob, SolverOptions(**fixed))
    (z, st), _, counts = _counted(f"{tag} (a)", lambda: solve(z0, data),
                                  _assembled({kkt: maxiter}, maxiter))
    add(counts)
    walls = [_timed(lambda: solve(z0, data))[1] for _ in range(3)]
    c0, c_end, p = float(prob.cost(z0, data)), float(st.cost), z.p.tolist()
    p_err = max(abs(a / b - 1.0) for a, b in zip(p, truth))
    print(f"{tag} (a) K={prob.mesh.num_blocks} nq={prob.model.nq} float32, "
          f"{maxiter} LM iterations ({int(st.iterations)} counted): cost "
          f"{c0:.6e} -> {c_end:.6e}, p={p}, max|p/p_true - 1| {p_err:.4f}"
          + (f" (<= {f32_bar}; the JAX benchmark: ~0.098)" if f32_bar else "")
          + f", kernel #1 launches {counts[kkt]}, no plain call; best of 3 "
          f"wall {min(walls):.4f} s captured on {card}")
    if not (c_end < c0 and all(math.isfinite(v) for v in p)):
        raise RuntimeError(f"{tag} (a): the float32 solve did no useful work")
    if f32_bar is not None and not p_err <= f32_bar:
        raise RuntimeError(f"{tag} (a): p is {p_err:.4f} from the truth")
    _, eager_wall = _vs_eager(f"{tag} (a)", solve, (z0, data), (z, st))
    rec["fixed_float32"] = dict(wall_s=min(walls), walls_s=walls,
                                eager_wall_s=eager_wall, cost=[c0, c_end],
                                p=p, p_rel_err=p_err,
                                iterations=int(st.iterations),
                                launches=counts[kkt])
    rec["fixed_float32"]["profile"] = _profile_captured(
        f"{tag} (a)", lambda: solve(z0, data), min(walls), eager_wall)
    del prob, z0, data, solve

    # (b), (c) float64 fixed work on 'auto' and 'cr'; (d) converged.
    prob, z0, data = build(dtype=torch.float64, device=dev)
    n_levels = _cr_level_count(prob.mesh.num_blocks)
    c0 = float(prob.cost(z0, data))
    for part, opts, want, ref in (
            ("(b)", dict(fixed), _assembled({kkt: maxiter}, maxiter),
             jax_p["fixed"]),
            ("(c)", dict(fixed, method="cr"),
             _assembled({k: maxiter * n_levels for k in CR_NAMES[1:]},
                        maxiter), jax_p["fixed"]),
            ("(d)", dict(converged), only_kkt, jax_p["converged"])):
        solve = make_gn_solver(prob, SolverOptions(**opts))
        run = (lambda: solve(z0, data)) if part != "(d)" else (
            lambda: _no_reads(f"{tag} (d) first call",
                              lambda: solve(z0, data)))
        (z, st), first, counts = _counted(f"{tag} {part}", run, want)
        add(counts)
        p, dev_p = z.p.tolist(), _p_dev(z.p.tolist(), ref)
        print(f"{tag} {part} float64 {opts}: {int(st.iterations)} "
              f"iterations, converged {bool(st.converged)}, cost {c0:.6e} -> "
              f"{float(st.cost):.6e}, p={p}, |p - p_jax|/|p_jax| {dev_p:.3e} "
              f"(<= 1e-6), launches "
              f"{ {k: v for k, v in counts.items() if v} }, no plain call; "
              f"first call (with the capture) {first:.4f} s on {card}")
        if not (float(st.cost) < c0 and dev_p <= 1e-6):
            raise RuntimeError(f"{tag} {part}: p disagrees with the JAX "
                               "package's")
        if part == "(d)" and not bool(st.converged):
            raise RuntimeError(f"{tag} (d): the converged run did not "
                               "converge")
        wall, eager_wall = _vs_eager(f"{tag} {part}", solve, (z0, data),
                                     (z, st))
        rec[f"float64 {part} {opts.get('method', 'auto')}"] = dict(
            wall_s=wall, eager_wall_s=eager_wall, first_call_s=first,
            cost=[c0, float(st.cost)], p=p, p_vs_jax=dev_p,
            iterations=int(st.iterations), converged=bool(st.converged),
            launches={k: v for k, v in counts.items() if v})

    # (e) IRLS or exact Newton, float64.
    if robust == "irls":
        opts = SolverOptions(**converged, irls_delta=2.0)
        solve = make_irls_solver(prob, opts, n_rounds=4)
        out, first, counts = _counted(
            f"{tag} (e)", lambda: _no_reads(f"{tag} (e) first call",
                                            lambda: solve(z0, data)),
            lambda out: _assembled(
                {kkt: sum(int(r.iterations) for r in out[1])},
                sum(int(r.iterations) for r in out[1]), len(out[1])))
        z, rounds, _ = out
        st = rounds[-1]
    else:
        solve = make_gn_solver(prob, SolverOptions(**converged,
                                                   hessian="newton"))
        # hessian='newton' assembles by assemble_newton: no GN element kernel.
        out, first, counts = _counted(
            f"{tag} (e)", lambda: _no_reads(f"{tag} (e) first call",
                                            lambda: solve(z0, data)),
            lambda out: {kkt: int(out[1].iterations)})
        z, st = out
        rounds = (st,)
        if not bool(st.converged):
            raise RuntimeError(f"{tag} (e): the Newton run did not converge")
    add(counts)
    p, dev_p = z.p.tolist(), _p_dev(z.p.tolist(), jax_p[robust])
    its = [int(r.iterations) for r in rounds]
    print(f"{tag} (e) float64 {robust}: LM iterations {its} (one entry per "
          f"solve), last solve converged {bool(st.converged)}, p={p}, "
          f"|p - p_jax|/|p_jax| {dev_p:.3e} (<= 1e-6), kernel #1 launches "
          f"{counts[kkt]} (one per iteration), no plain call; first call "
          f"(with the captures) {first:.4f} s on {card}")
    if not dev_p <= 1e-6:
        raise RuntimeError(f"{tag} (e): p disagrees with the JAX package's")
    wall, eager_wall = _vs_eager(f"{tag} (e)", solve, (z0, data), out)
    rec[f"float64 (e) {robust}"] = dict(
        wall_s=wall, eager_wall_s=eager_wall, first_call_s=first, p=p,
        p_vs_jax=dev_p, iterations=its, converged=bool(st.converged),
        launches=counts[kkt])
    return launches


def _dense_solve(sys_, lam_abs, x):
    """torch.linalg.solve of the dense damped bordered matrix of ``sys_``
    (:func:`_dense_kkt`): (ms a call by CUDA events, its size, its result's
    relative difference to ``x`` = the kernel's [dx; dp] flattened)."""
    import torch

    from collocfem_tpu_torch.testing import rel_err

    M, rhs = _dense_kkt(sys_, lam_abs)
    ms = _cuda_ms(lambda: torch.linalg.solve(M, rhs), 5)
    rel = rel_err(torch.linalg.solve(M, rhs)[:, 0], x)
    return ms, tuple(M.shape), rel


def _time_kernel(out, card, key, label, kernel, plain, bound, dense, err):
    """Phase 2's record of a kernel at one problem's shape, into
    out[key[0]][key[1]]: the kernel and its plain version by CUDA events,
    the kernel's device time by phase (torch.profiler), two runs
    bit-identical, its float32 bound and ``dense`` = _dense_solve's
    (ms, shape, rel diff) of torch.linalg.solve on the dense damped
    matrix."""
    import torch

    from collocfem_tpu_torch.tools.spike_tiles import _split

    k_ms, p_ms = _cuda_ms(kernel, 20), _cuda_ms(plain, 3)
    split = _split(kernel)
    first, again = kernel(), kernel()
    torch.cuda.synchronize()
    first, again = ((first,), (again,)) if torch.is_tensor(first) else \
        (first[:2], again[:2])
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise RuntimeError(f"{label}: two runs of the kernel differ")
    lib_ms, shape, lib_rel = dense
    out[key[0]][key[1]] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, device_us=split,
        device_us_total=sum(split.values()), library_ms=lib_ms,
        library_shape=shape, library_rel_diff=lib_rel,
        bound_ms=bound[0], bound_by=bound[1])
    print(f"  {label}: kernel {k_ms:.3f} ms/call ("
          f"{sum(split.values()):.1f} us on the device: "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"), plain {p_ms:.3f} ms/call, two runs bit-identical; "
          f"torch.linalg.solve on the dense damped matrix {shape} "
          f"{lib_ms:.3f} ms/call (rel diff to the kernel {lib_rel:.2e});"
          f" float32 bound {bound[0] * 1e3:.3f} us ({bound[1]}) on "
          f"{card}")


def _phase2_ocp(dev, card):
    """Phase 2 at the optimal-control shapes (b = 12): kernel #2 at r = 1 on
    config 3's equilibrated, damped chain at the initial guess (N = 25 and
    500: K = 26 and 501) and on seeded chains, K in EDGES + {26, 501};
    kernel #1 at nq = 1 on the free-time OCP's system at its initial guess
    (K = 17) and on seeded systems, K in EDGES + {17, 501}.  At each
    problem's shape: the kernel and its plain version by CUDA events, the
    kernel's device time by phase (torch.profiler), its float32 bound, two
    runs bit-identical, and torch.linalg.solve on the dense damped matrix.
    Returns the per-shape records."""
    import torch

    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.ops import spike
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)
    from collocfem_tpu_torch.solve.kkt import _equilibrate_soa, damping_scales
    from collocfem_tpu_torch.testing import (chain_residual, random_chain,
                                             random_kkt_system)

    out = {"chain": {}, "kkt": {}}
    opts = ALBarrierOptions()
    lam = opts.lam0
    timed = lambda *a: _time_kernel(out, card, *a)

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for n in (configs.ELEMENTS3, configs.ELEMENTS3_LARGE):
            prob, z0 = configs.build_config3_problem(n, dtype=dtype,
                                                     device=dev)
            s = _equilibrate_soa(
                make_ocp_solver(prob, opts).first_system(z0), lam)[0]
            D, E, G = s.D, s.E, s.gx[:, None, :].contiguous()
            K = D.shape[-1]
            label = f"kernel #2 config 3 N={n} {name} K={K} b=12 r=1"
            X = spike.blocktri_solve_spike_fused(D, E, G)
            err = _hold(label, dtype, X,
                        spike.blocktri_solve_spike_fused_ref(D, E, G),
                        lambda X: chain_residual(D, E, G, X))
            timed(("chain", f"config 3 N={n} {name}"), label,
                  lambda: spike.blocktri_solve_spike_fused(D, E, G),
                  lambda: spike.blocktri_solve_spike_fused_ref(D, E, G),
                  _chain_bound(K, 1, 12),
                  _dense_solve(s, 0.0, -X[:, 0, :].T.reshape(-1)), err)
            out["chain"][f"config 3 N={n} {name}"].update(K=K, b=12, r=1)
        for k in (*EDGES, 26, 501):
            D, E, G = random_chain(k, 12, 1, seed=k + 1, dtype=dtype,
                                   device=dev)
            _hold(f"kernel #2 random {name} K={k} b=12 r=1", dtype,
                  spike.blocktri_solve_spike_fused(D, E, G),
                  spike.blocktri_solve_spike_fused_ref(D, E, G),
                  lambda X: chain_residual(D, E, G, X))

        prob, _, z0 = configs.build_min_time_problem(dtype=dtype, device=dev)
        sys_ = make_ocp_solver(
            prob, ALBarrierOptions(**configs.MIN_TIME_OPTIONS)).first_system(
                z0)
        K = sys_.num_blocks
        label = f"kernel #1 free-time OCP {name} K={K} b=12 nq=1"
        err = _compare(sys_, lam, None, label)
        call = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam)
        dx, dp, _ = spike.kkt_solve_spike_fused(*call)
        timed(("kkt", f"free-time {name}"), label,
              lambda: spike.kkt_solve_spike_fused(*call),
              lambda: spike.kkt_solve_spike_fused_ref(*call),
              _kkt_bound(K, 1, 12),
              _dense_solve(sys_, damping_scales(sys_.D, sys_.C, lam)[0],
                           torch.cat([dx.T.reshape(-1), dp])), err)
        out["kkt"][f"free-time {name}"].update(K=K, b=12, nq=1)
        for k in (*EDGES, 17, 501):
            rs = random_kkt_system(k, 12, 1, seed=k + 1, dtype=dtype,
                                   device=dev)
            _compare(rs, 1e-3, None, f"kernel #1 random {name} K={k} b=12 "
                     "nq=1")
    print("  kernels #1 and #2 at b=12: seeded systems, K in "
          f"{(*EDGES, 17, 26, 501)}, ok")
    return out


def _profile_run(label, run, best_wall):
    """One run of run() under torch.profiler: device time by kernel, the
    kernel count, and the device idle share of ``best_wall``.  Device
    activity only: a solve of ~10^5 launches makes millions of host events,
    whose post-processing takes minutes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from collocfem_tpu_torch.tools.spike_tiles import _device_us

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, n_kernels = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = us
            n_kernels += evt.count
    total = sum(by_name.values())
    idle = 1 - total / 1e6 / best_wall
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"  {label}: device time {total / 1e3:.3f} ms over {n_kernels} "
          f"kernels; idle share of the best wall {idle:.3f}")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms {100 * us / total:5.1f} %  {name[:80]}")
    return dict(device_ms=total / 1e3, device_kernels=n_kernels,
                idle_share=idle, top_us=top)


def _captured_and_eager(tag, solve, args, kernel, shape, iters,
                        assembled=False):
    """Run the captured ``solve`` on ``args`` twice (the first call: warm-up,
    capture and replays; then a replay) and ``solve.eager`` once, each
    counted: each must launch ``kernel`` ``iters(result)`` times, all at
    ``shape`` (with ``assembled``, the GN element kernel as often: a barrier
    solver assembles once an inner step), and no plain version.  The first
    call's launches join the main path's.  Returns (the first call's result, its counts, {run:
    wall}, whether the three runs launched alike and the replay and the
    eager run gave the first call's result bit for bit: z and every stats
    field, by torch.equal on their bit patterns)."""
    from collocfem_tpu_torch.testing import bit_equal

    runs = {}
    for name, run in (("first call", lambda: _no_reads(
            f"{tag} first call", lambda: solve(*args))),
                      ("captured", lambda: solve(*args)),
                      ("eager", lambda: solve.eager(*args))):
        runs[name] = _counted(
            f"{tag} {name}", run, lambda out: (
                _assembled({kernel: iters(out)}, iters(out), 0)
                if assembled else {kernel: iters(out)}))
        if LAST_SHAPES[kernel] != {shape: runs[name][2][kernel]}:
            raise RuntimeError(f"{tag} {name}: launches by shape "
                               f"{LAST_SHAPES[kernel]}, expected {shape}")
        if name == "first call":
            _keep_shapes(runs[name][2])
    out, _, counts = runs["first call"]
    same = (all(bit_equal(runs[n][0], out) for n in ("captured", "eager"))
            and all(runs[n][2] == counts for n in runs))
    return out, counts, {n: r[1] for n, r in runs.items()}, same


def _three_walls(walls, same, card):
    """The three walls of _captured_and_eager and its verdict, for a phase
    line."""
    return (f"captured and eager bit-identical with the same launches "
            f"{'ok' if same else 'FAIL'}; wall captured "
            f"{walls['captured']:.4f} s (first call, with the capture, "
            f"{walls['first call']:.4f} s), eager {walls['eager']:.4f} s on "
            f"{card}")


def _ocp_solves(dev, card, record):
    """Phase 10, config 3 (the pendulum swing-up) through
    make_ocp_solver(prob, ALBarrierOptions()) on 'auto', and phase 11, the
    free-time OCP of examples/min_time_ocp.py (N = 16, n_outer 16), float64.
    Each solver replays its whole AL homotopy from CUDA graphs.  Each case
    runs captured twice and eagerly once (_captured_and_eager): each run
    launches its SPIKE kernel (#2 at (12, 1) for config 3, #1 at (12, 1)
    for the free-time OCP) exactly once per inner LM iteration (the sum of
    the history's inner_iters) and no plain version, and the three agree
    bit for bit.  Prints the walls and profiles one more captured run.
    Returns the first calls' launches."""
    import torch

    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)

    launches = {}
    inner = lambda out: int(out[1].history[:, 4].sum())

    def three_runs(tag, solve, z0, kernel):
        (z, st), counts, walls, same = _captured_and_eager(
            tag, solve, (z0,), kernel, (12, 1), inner)
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        return z, st, counts[kernel], walls, same

    def profile(tag, solve, z0, walls, measure):
        """The idle share (with ``measure``: _profile_loop) beside the
        parent's figures."""
        prof = (_profile_loop(tag, lambda: solve.eager(z0), walls["captured"],
                              walls["eager"]) if measure else None)
        _beside_parent(tag, walls["captured"],
                       prof and prof["idle_share"])
        return prof

    rec = record.setdefault("config3", {})
    chain = "blocktri_solve_spike_fused"
    f64_obj, coarse = {}, {}
    for part, n, dtype in (("(a)", configs.ELEMENTS3, torch.float64),
                           ("(b)", configs.ELEMENTS3, torch.float32),
                           ("(c)", configs.ELEMENTS3_LARGE, torch.float64),
                           ("(c)", configs.ELEMENTS3_LARGE, torch.float32)):
        name = str(dtype).split(".")[1]
        tag = f"phase 10 {part}: config 3 N={n} {name}"
        prob, z0 = configs.build_config3_problem(n, dtype=dtype, device=dev)
        if n != configs.ELEMENTS3:
            # The nested protocol: from the N = 25 solution of (a) / (b).
            z0 = configs.config3_warm_start(*coarse[dtype], prob)
        solve = make_ocp_solver(prob, ALBarrierOptions())
        z, st, n_launch, walls, same = three_runs(tag, solve, z0, chain)
        if n == configs.ELEMENTS3:
            coarse[dtype] = (prob, z)
        x, u = z.V[:, :2].double(), z.V[:, 2].double()
        obj, cviol, gviol = (float(st.objective), float(st.cviol),
                             float(st.gviol))
        umax = float(u.abs().max())
        r = dict(objective=obj, cviol=cviol, gviol=gviol, max_abs_u=umax,
                 inner_iters=n_launch, launches=n_launch,
                 wall_s=walls["captured"], first_call_s=walls["first call"],
                 eager_wall_s=walls["eager"], bit_identical=same)
        print(f"{tag}: objective {obj:.10f}, cviol {cviol:.3e}, gviol "
              f"{gviol:.3e}, max|u| {umax:.8f}, {n_launch} inner LM "
              f"iterations = kernel #2 launches at (12, 1) in each run, no "
              f"plain call; " + _three_walls(walls, same, card))
        if dtype == torch.float64:
            ref_obj, ref_u = C3_JAX_F64[n]
            nodes = torch.linspace(0, 4 * n, 11).long()
            u11 = u[nodes].tolist()
            d_obj = abs(obj - ref_obj)
            d_u = max(abs(a - b) for a, b in zip(u11, ref_u))
            u_bar = C3_U_GATE[n]
            bc = max(float(x[0].abs().max()),
                     float((x[-1] - torch.tensor([math.pi, 0.0],
                                                 dtype=x.dtype,
                                                 device=x.device))
                           .abs().max()))
            r.update(u11=u11, obj_vs_jax=d_obj, u11_vs_jax=d_u,
                     boundary_err=bc)
            print(f"  |objective - JAX| {d_obj:.3e} (<= 1e-6), max |u - u_JAX| "
                  f"at 11 nodes {d_u:.3e} (<= {u_bar:g}), boundary error "
                  f"{bc:.3e} (<= 1e-8)")
            ok = (cviol < 1e-8 and bc <= 1e-8 and d_obj <= 1e-6
                  and d_u <= u_bar
                  and configs.U_MAX3 - 1e-2 < umax <= configs.U_MAX3 + 1e-6)
            f64_obj[n] = obj
        else:
            rel = abs(obj / f64_obj[n] - 1.0)
            r.update(obj_vs_float64=rel)
            print(f"  |objective / float64's - 1| {rel:.3e} (<= 0.01)")
            ok = gviol < 0 and cviol <= 1e-3 and rel <= 0.01
        rec[f"N={n} {name}"] = r
        if not (ok and same):
            raise RuntimeError(f"{tag}: a gate failed")
        r["profile"] = profile(tag, solve, z0, walls, part == "(a)")
        del prob, z0, solve, z, st

    prob, ftm, z0 = configs.build_min_time_problem(dtype=torch.float64,
                                                   device=dev)
    solve = make_ocp_solver(prob, ALBarrierOptions(**configs.MIN_TIME_OPTIONS))
    tag = "phase 11: free-time OCP float64"
    z, st, n_launch, walls, same = three_runs(tag, solve, z0,
                                              "kkt_solve_spike_fused")
    tf = float(ftm.final_time(z.p))
    t_star = 2.0 * math.sqrt(configs.DIST / configs.U_MAX_MT)
    d_tf = abs(tf - MIN_TIME_JAX_TF)
    gviol = float(st.gviol)
    r = record["free_time"] = dict(
        tf=tf, tf_vs_jax=d_tf, gviol=gviol, cviol=float(st.cviol),
        launches=n_launch, wall_s=walls["captured"],
        first_call_s=walls["first call"], eager_wall_s=walls["eager"],
        bit_identical=same)
    print(f"{tag} (N={configs.ELEMENTS_MT}, b=12, nq=1): tf {tf:.10f} "
          f"(bang-bang {t_star}), |tf - tf_JAX| {d_tf:.3e} (<= 1e-6), gviol "
          f"{gviol:.3e} (<= 1e-10), {n_launch} inner LM iterations = kernel "
          f"#1 launches at (12, 1) in each run, no plain call; "
          + _three_walls(walls, same, card))
    if not (d_tf <= 1e-6 and t_star - 1e-3 < tf < 1.06 * t_star
            and gviol <= 1e-10 and same):
        raise RuntimeError(f"{tag}: a gate failed")
    r["profile"] = profile(tag, solve, z0, walls, True)
    return launches


def _constrained_estimation(dev, card, record):
    """Phase 12, float64 on 'auto': (a) the aircraft output-error problem
    with examples/constrained_estimation.py's damping spec g_param (kernel
    #1 at (8, 5)): p within 1e-6 of the JAX package's and g_param(p) <= 0;
    (b) tests/test_bounds.py's active parameter bound on Van der Pol, on 60
    elements of degree 4 (kernel #1 at (8, 2)) and of the test's own
    degree 2 (kernel #1 at (4, 2)): p within 1e-6 of the JAX package's.
    Each solver replays its whole barrier homotopy from CUDA graphs
    (solve.bounds.barrier_homotopy).  Each case runs captured twice and
    eagerly once (_captured_and_eager): each run launches kernel #1 and the
    GN element kernel once per inner LM iteration (the sum of history[:,
    3]), #1 at the case's shape, and no plain version, and the three agree
    bit for bit.  Prints the
    three walls and the idle share of the captured and of the eager wall
    (one more captured run under torch.profiler).  Returns the first calls'
    launches."""
    import torch

    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve import (BoundedOptions,
                                           ConstrainedOptions,
                                           make_bounded_solver, make_bounds,
                                           make_constrained_solver,
                                           project_interior)

    kkt = "kkt_solve_spike_fused"
    launches = {}
    prob, z0, data = configs.build_constrained_aircraft_problem(
        dtype=torch.float64, device=dev)
    solve_a = make_constrained_solver(
        prob, ConstrainedOptions(**configs.CONSTRAINED4_OPTIONS),
        g_param=configs.zeta_constraint)
    bounded = {}
    for degree in (4, 2):
        vdp, v0, vdata = configs.build_bounded_vdp_problem(
            degree, dtype=torch.float64, device=dev)
        bounds = make_bounds(vdp, p_lo=[0.0, None],
                             p_hi=[configs.MU_CAP, None])
        bounded[degree] = (make_bounded_solver(
            vdp, bounds, BoundedOptions(**configs.BOUNDED_VDP_OPTIONS)),
            (project_interior(v0, bounds), vdata))
    for part, (solve, args), shape, ref in (
            ("(a) aircraft, zeta >= 0.6", (solve_a, (z0, data)), (8, 5),
             CONSTRAINED4_JAX_F64),
            ("(b) Van der Pol degree 4, mu <= 0.8", bounded[4], (8, 2),
             BOUNDED_VDP_JAX_F64),
            ("(b) Van der Pol degree 2, mu <= 0.8", bounded[2], (4, 2),
             BOUNDED_VDP2_JAX_F64)):
        tag = f"phase 12 {part}"
        (z, st), counts, walls, same = _captured_and_eager(
            tag, solve, args, kkt, shape,
            lambda out: int(out[1].history[:, 3].sum()), assembled=True)
        first_wall, wall = walls["first call"], walls["captured"]
        eager_wall = walls["eager"]
        for k in (kkt, GN):
            launches[k] = launches.get(k, 0) + counts[k]
        p = z.p.tolist()
        d_p = _p_dev(p, ref)
        extra = ""
        ok = d_p <= 1e-6 and same
        if part.startswith("(a)"):
            g = float(configs.zeta_constraint(z.p)[0])
            extra = f", g_param(p) {g:.3e} (<= 0)"
            ok = ok and g <= 0
        print(f"{tag}: p={p}, |p - p_JAX|/|p_JAX| {d_p:.3e} (<= 1e-6){extra},"
              f" {counts[kkt]} inner LM iterations = kernel #1 launches at "
              f"{shape} = GN element kernel launches in each run, no plain "
              "call; "
              + _three_walls(walls, same, card))
        prof = (_profile_loop(tag, lambda: solve.eager(*args), wall,
                              eager_wall) if part.startswith("(a)") else None)
        _beside_parent(tag, wall, prof and prof["idle_share"])
        record[f"phase12 {part}"] = dict(
            p=p, p_vs_jax=d_p, wall_s=wall, first_call_s=first_wall,
            eager_wall_s=eager_wall, launches=counts[kkt],
            bit_identical=same, profile=prof)
        if not ok:
            raise RuntimeError(f"{tag}: a gate failed")
    return launches


def _gate(tag, ok, rec, **values):
    """Print a case's ``values`` into its line, keep them in ``rec`` and
    raise unless ``ok``."""
    rec.update(values)
    print(f"  {tag}: " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                                   else f"{k} {v}" for k, v in values.items()))
    if not ok:
        raise RuntimeError(f"{tag}: a gate failed")


def _phase15(dev, card, record):
    """Phase 15, every shape: the JAX package's problems at block sizes that
    only per-shape builds run on the card, float64, each held to the JAX
    package's float64 result within 1e-6 (the bar of phases 8-12; constants
    above) or to the plain solve:
      (a) tests/test_multi_experiment.py's batch (8 experiments x 48
          elements of degree 2) through the captured
          make_multi_experiment_solver in both layouts: #2 at (4, 3) (soa),
          #7 at (4, 3) (blocks); p;
      (b) the free-time OCP of examples/min_time_ocp.py at degree 3: #1 at
          (9, 1); tf and the objective;
      (c) tests/test_ocp.py's split actuator (N = 8): #2 at (16, 1); the
          objective and u1 at 11 nodes;
      (d) config 3 at N = 25 and 500 with method='cr' (N = 500 from the N =
          25 solution): #4-#6 at b = 12; the objective and u at 11 nodes
          (C3_U_GATE at N = 500);
      (e) configs 2 and 4, the fixed work with kkt_refine=2 (captured): #2
          at (8, 1 + nq) once and (8, 1) twice an iteration; p;
      (f) parameter_std on the degree-2 Van der Pol at its converged float64
          estimate (#1 at (4, 2)): #3 and #6 at (4, 2), within 1e-9 of the
          plain solve.
    Every kernel launches as its design says and no plain version runs.
    Each case prints its wall, its launches by shape, its solver's
    construction and first-call walls, and the build walls of its instances
    (phase 1, where they were built).  Returns the launches."""
    import torch

    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.ops import cr, spike, thomas
    from collocfem_tpu_torch.ops.assemble import assemble_gn
    from collocfem_tpu_torch.parallel.batch import make_multi_experiment_solver
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.solve import covariance as cov
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.testing import rel_err

    f64 = dict(dtype=torch.float64, device=dev)
    launches, rec = {}, record.setdefault("phase15", {})
    inner = lambda st: int(st.history[:, 4].sum())

    def case(tag, make, run, want, instances):
        """Make the solver (its construction builds and loads what it runs),
        run it once counted (``want``: as _counted takes it), keep its
        launches; returns (solver, run's result, record)."""
        solver, made = _timed(make)
        out, first, counts = _counted(tag, lambda: run(solver), want)
        _keep_shapes(counts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        shapes = {k: LAST_SHAPES[k] for k, v in counts.items() if v}
        builds = {i.name: record["build_s"].get(i.name, 0.0)
                  for i in instances}
        r = rec[tag] = dict(construction_s=made, first_call_s=first,
                            launches={k: v for k, v in counts.items() if v},
                            shapes={k: {str(s): n for s, n in v.items()}
                                    for k, v in shapes.items()},
                            build_s=builds)
        print(f"{tag}: launches by shape "
              + "; ".join(f"{k} {v}" for k, v in shapes.items())
              + f", no plain call; construction {made:.3f} s, first call "
              f"{first:.4f} s; its instances' build walls in phase 1: "
              + ", ".join(f"{n} {w:.1f} s" for n, w in builds.items())
              + f" on {card}")
        return solver, out, r

    gate = lambda tag, ok, **values: _gate(tag, ok, rec[tag], **values)

    # (a) the multi-experiment batch, both layouts, captured.
    prob, *batch = configs.build_multi_experiment_problem(**f64)
    for layout, kname, inst in (
            ("soa", "blocktri_solve_spike_fused", spike.chain_instance(4, 3)),
            ("blocks", "batched_thomas_solve", thomas.instance(4, 3))):
        tag = f"phase 15 (a) multi-experiment batch {layout}"
        solve, (z, st), _ = case(
            tag, lambda: make_multi_experiment_solver(
                prob, SolverOptions(**configs.MULTI_OPTIONS), layout=layout),
            lambda solve: solve(*batch), {kname}, [inst])
        wall = _timed(lambda: solve(*batch))[1]
        p, ref = z.p.tolist(), MULTI_JAX_F64[layout]
        d_p = _p_dev(p, ref)
        gate(tag, d_p <= 1e-6 and bool(st.converged), p=p, p_vs_jax=d_p,
             iterations=int(st.iterations), wall_s=wall)

    # (b) the free-time OCP at degree 3.
    tag = "phase 15 (b) free-time OCP degree 3"
    prob, ftm, z0 = configs.build_min_time_problem(degree=3, **f64)
    _, (z, st), _ = case(
        tag, lambda: make_ocp_solver(
            prob, ALBarrierOptions(**configs.MIN_TIME_OPTIONS)),
        lambda solve: solve(z0),
        lambda out: {"kkt_solve_spike_fused": inner(out[1])},
        [spike.kkt_instance(9, 1)])
    tf, obj = float(ftm.final_time(z.p)), float(st.objective)
    d_tf = abs(tf / MIN_TIME3_JAX[0] - 1)
    d_obj = abs(obj / MIN_TIME3_JAX[1] - 1)
    gate(tag, d_tf <= 1e-6 and d_obj <= 1e-6 and float(st.gviol) <= 1e-10,
         tf=tf, tf_vs_jax=d_tf, objective_vs_jax=d_obj,
         gviol=float(st.gviol))

    # (c) the split actuator.
    tag = "phase 15 (c) split actuator"
    prob, z0 = configs.build_split_actuator_problem(**f64)
    _, (z, st), _ = case(
        tag, lambda: make_ocp_solver(
            prob, ALBarrierOptions(**configs.SPLIT_OPTIONS)),
        lambda solve: solve(z0),
        lambda out: {"blocktri_solve_spike_fused": inner(out[1])},
        [spike.chain_instance(16, 1)])
    n = configs.ELEMENTS_SPLIT
    u11 = z.V[torch.linspace(0, 4 * n, 11).long(), 2].tolist()
    d_obj = abs(float(st.objective) - SPLIT_JAX_F64[0])
    d_u = max(abs(a - b) for a, b in zip(u11, SPLIT_JAX_F64[1]))
    gate(tag, d_obj <= 1e-6 and d_u <= 1e-6 and float(st.cviol) < 1e-8,
         objective=float(st.objective), objective_vs_jax=d_obj,
         u11_vs_jax=d_u, cviol=float(st.cviol))

    # (d) config 3 with method='cr'.
    coarse = None
    for n in (configs.ELEMENTS3, configs.ELEMENTS3_LARGE):
        tag = f"phase 15 (d) config 3 N={n} method='cr'"
        prob, z0 = configs.build_config3_problem(n, **f64)
        if coarse is not None:
            z0 = configs.config3_warm_start(*coarse, prob)
        lv = _cr_level_count(n + 1)
        _, (z, st), _ = case(
            tag, lambda: make_ocp_solver(prob, ALBarrierOptions(method="cr")),
            lambda solve: solve(z0),
            lambda out: {k: inner(out[1]) * lv for k in (
                "cr_level_factor", "cr_level_apply", "cr_backsub")},
            [cr.instance(12, 0), cr.instance(12, 1)])
        coarse = (prob, z)
        ref_obj, ref_u = C3_JAX_F64[n]
        u11 = z.V[torch.linspace(0, 4 * n, 11).long(), 2].tolist()
        d_obj = abs(float(st.objective) - ref_obj)
        d_u = max(abs(a - b) for a, b in zip(u11, ref_u))
        gate(tag, d_obj <= 1e-6 and d_u <= C3_U_GATE[n]
             and float(st.cviol) < 1e-8, objective=float(st.objective),
             objective_vs_jax=d_obj, u11_vs_jax=d_u, levels=lv,
             cviol=float(st.cviol))

    # (e) configs 2 and 4 with kkt_refine=2, captured.
    for cname, build, fixed, nq in (
            ("config 2", configs.build_config2_problem, configs.C2_FIXED, 3),
            ("config 4", configs.build_config4_problem, configs.C4_FIXED, 5)):
        tag = f"phase 15 (e) {cname} kkt_refine=2"
        prob, z0, data = build(**f64)
        opts = SolverOptions(**fixed, kkt_refine=2)
        its = opts.maxiter
        solve, (z, st), r = case(
            tag, lambda: make_gn_solver(prob, opts),
            lambda solve: solve(z0, data),
            _assembled({"blocktri_solve_spike_fused": 3 * its}, its),
            [spike.chain_instance(8, 1 + nq), spike.chain_instance(8, 1)])
        want = {(8, 1 + nq): its, (8, 1): 2 * its}
        wall = _timed(lambda: solve(z0, data))[1]
        p = z.p.tolist()
        d_p = _p_dev(p, REFINE_JAX_F64[cname])
        gate(tag, d_p <= 1e-6 and LAST_SHAPES["blocktri_solve_spike_fused"]
             == want, p=p, p_vs_jax=d_p, wall_s=wall)
        del prob, z0, data, solve

    # (f) parameter_std on the degree-2 Van der Pol.
    tag = "phase 15 (f) parameter_std, Van der Pol degree 2"
    prob, z0, data = configs.build_bounded_vdp_problem(2, **f64)
    _, (z, st), _ = case(
        f"{tag}: the estimate", lambda: make_gn_solver(
            prob, SolverOptions(maxiter=60, gtol=1e-10, xtol=1e-12)),
        lambda solve: solve(z0, data),
        lambda out: _assembled({"kkt_solve_spike_fused": int(
            out[1].iterations)}, int(out[1].iterations)),
        [spike.kkt_instance(4, 2)])
    lv = _cr_level_count(prob.mesh.num_elements + 1)
    _, std, _ = case(tag, lambda: None,
                     lambda _: cov.parameter_std(prob, z, data),
                     {"cr_level": lv, "cr_backsub": lv}, [cr.instance(4, 2)])
    sys_ = assemble_gn(prob, z, data)
    a_b = bt.blocktri_solve_cr_plain(sys_.D, sys_.E, sys_.B)
    schur = sys_.C - torch.einsum("kbq,kbr->qr", sys_.B, a_b)
    rel = rel_err(std, torch.sqrt(torch.diagonal(torch.linalg.inv(schur))))
    gate(tag, rel <= 1e-9 and bool(st.converged), std=std.tolist(),
         rel_vs_plain=rel, p=z.p.tolist())
    return launches


def _mhe_stream(dtype, dev):
    """examples/mhe_online.py's estimator and stream
    (``testing.mhe_online_stream``): (mhe, truth (240, 2), ys (240, 1))."""
    from collocfem_tpu_torch.testing import mhe_online_stream

    return mhe_online_stream(dtype, dev)


def _phase2_mhe(dev, card):
    """Phase 2 at the moving-horizon estimator's shape (b = 6, r = 1):
    kernel #2 on the serving cell's damped, equilibrated window chain at
    its first solve (K = 12) and on seeded chains, K in EDGES + {8, 12};
    at the window's shape the kernel and plain times, the device time by
    phase, two runs bit-identical, the float32 bound and
    torch.linalg.solve on the dense 72^2 damped matrix.  Returns the
    per-shape records."""
    import numpy as np
    import torch

    from collocfem_tpu_torch.ops import spike
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve.kkt import _equilibrate_soa
    from collocfem_tpu_torch.testing import chain_residual, random_chain

    out = {"chain": {}}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        mhe, _, ys = _mhe_stream(dtype, dev)
        prob, h = mhe.problem, MHE_HORIZON
        z0 = prob.initial_guess_from_data(mhe._t_samples, ys[:h], np.zeros(0))
        data = mhe._data(prob._tensor(ys[:h]), prob._tensor(np.zeros((h - 1,
                                                                      1))),
                         prob._tensor([1.5, 0.5]), prob._tensor(np.eye(2)))
        lam = max(mhe.options.lam0, torch.finfo(dtype).eps)
        s = _equilibrate_soa(assemble_gn_soa(prob, z0, data), lam)[0]
        D, E, G = s.D, s.E, s.gx[:, None, :].contiguous()
        K, b = D.shape[-1], D.shape[0]
        label = f"kernel #2 MHE window {name} K={K} b={b} r=1"
        X = spike.blocktri_solve_spike_fused(D, E, G)
        err = _hold(label, dtype, X,
                    spike.blocktri_solve_spike_fused_ref(D, E, G),
                    lambda X: chain_residual(D, E, G, X))
        _time_kernel(out, card, ("chain", f"MHE window {name}"), label,
                     lambda: spike.blocktri_solve_spike_fused(D, E, G),
                     lambda: spike.blocktri_solve_spike_fused_ref(D, E, G),
                     _chain_bound(K, 1, b),
                     _dense_solve(s, 0.0, -X[:, 0, :].T.reshape(-1)), err)
        out["chain"][f"MHE window {name}"].update(K=K, b=b, r=1)
        for k in (*EDGES, 8, 12):
            D, E, G = random_chain(k, 6, 1, seed=k + 6, dtype=dtype,
                                   device=dev)
            _hold(f"kernel #2 random {name} K={k} b=6 r=1", dtype,
                  spike.blocktri_solve_spike_fused(D, E, G),
                  spike.blocktri_solve_spike_fused_ref(D, E, G),
                  lambda X: chain_residual(D, E, G, X))
    print(f"  kernel #2 at b=6: seeded chains, K in {(*EDGES, 8, 12)}, ok")
    return out


def _dense_chain_solve(D, E, G, X):
    """torch.linalg.solve of the dense SoA chain (D, E (b, b, K)) against G
    (b, r, K): (ms a call by CUDA events, its size, its result's relative
    difference to ``X``, the kernel's)."""
    import torch

    from collocfem_tpu_torch.testing import rel_err

    blocks = lambda a: a.permute(2, 0, 1)[None]
    A, rhs = _dense_batch(blocks(D), blocks(E), blocks(G))
    ms = _cuda_ms(lambda: torch.linalg.solve(A, rhs), 5)
    rel = rel_err(torch.linalg.solve(A, rhs).reshape(blocks(G).shape),
                  blocks(X))
    return ms, tuple(A.shape[1:]), rel


def _phase2_sp(dev, card):
    """Phase 2 at the sharded solve's interior shape (b = 8, r = 19):
    kernel #2 on the interior chain of a headline shard at the initial
    guess (N = 9,999, K = 10,000, sp = 4: rank 1's 2,498 blocks of the
    damped, equilibrated chain against [gx | B | U | V],
    ``testing.shard_interior_chain``) and on seeded chains, K in EDGES +
    {2498, 4998} (the interiors at sp = 4 and 2); at the shard's shape the
    kernel and plain times, the device time by phase, two runs
    bit-identical, the float32 bound and torch.linalg.solve on the dense
    19,984^2 chain.  Returns the per-shape records."""
    import torch

    from collocfem_tpu_torch.ops import spike
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.solve.kkt import _equilibrate_soa
    from collocfem_tpu_torch.testing import (chain_residual, random_chain,
                                             shard_interior_chain)

    out = {"chain": {}}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        prob, data, z0 = _headline(dtype, dev, ELEMENTS_SP)
        s = _equilibrate_soa(assemble_gn_soa(prob, z0, data), 3e-6)[0]
        D, E, G = shard_interior_chain(
            s.D, s.E, torch.cat([s.gx[:, None, :], s.B], dim=1), SP_MAX, 1)
        K, r = D.shape[-1], G.shape[1]
        label = f"kernel #2 headline shard {name} K={K} b=8 r={r}"
        X = spike.blocktri_solve_spike_fused(D, E, G)
        err = _hold(label, dtype, X,
                    spike.blocktri_solve_spike_fused_ref(D, E, G),
                    lambda X: chain_residual(D, E, G, X))
        _time_kernel(out, card, ("chain", f"headline shard {name}"), label,
                     lambda: spike.blocktri_solve_spike_fused(D, E, G),
                     lambda: spike.blocktri_solve_spike_fused_ref(D, E, G),
                     _chain_bound(K, r), _dense_chain_solve(D, E, G, X), err)
        out["chain"][f"headline shard {name}"].update(K=K, b=8, r=r)
        for k in (*EDGES, 2498, 4998):
            D, E, G = random_chain(k, 8, 19, seed=k + 19, dtype=dtype,
                                   device=dev)
            _hold(f"kernel #2 random {name} K={k} r=19", dtype,
                  spike.blocktri_solve_spike_fused(D, E, G),
                  spike.blocktri_solve_spike_fused_ref(D, E, G),
                  lambda X: chain_residual(D, E, G, X))
    print(f"  kernel #2 at (8, 19): seeded chains, K in "
          f"{(*EDGES, 2498, 4998)}, ok")
    return out


# Phase 14's LM options: the headline's fixed work (phase 3's), config 5's,
# five iterations for dp x sp, and IRLS to convergence (tests/
# test_sharded_sp.py's IRLS options).
SP_FIXED = dict(maxiter=15, gtol=0.0, lam0=3e-6, lam_max=1e30)
SP_CONVERGED = dict(maxiter=60, gtol=1e-10, xtol=1e-12)    # phase 4's
DPSP_FIXED = dict(C5_FIXED, maxiter=5)
SP_IRLS = dict(maxiter=40, gtol=1e-9, xtol=1e-12, irls_delta=2.0)
VDP_SYM = dict(name="VanDerPolSym", states="x0 x1", inputs="u0",
               params="mu b", f=["x1", "mu*(1 - x0**2)*x1 - x0 + b*u0"],
               h=["x0"])


# The peer all-reduce's payloads held and timed in phase 14, in doubles a
# rank: one element, and the whole SPIKE interface gather at sp = 4 and (8,
# 19), P x 2 x b x r; and the calls each timing averages.
PEER_SIZES = (1, SP_MAX * 2 * 8 * 19)
PEER_REPS = 20
# The world's converging cases, captured: name -> the single-rank
# reference's name in _phase14_refs.
CAPTURED = {"sp=4 converging": "sp converging",
            "dp=4 soa converging": "soa converging"}
# The peer kernel's launches a rank makes: an sp LM step's 9 collectives
# (tests/test_torch_sharded.py names them), a prelude's 2 and the gather of
# V after the solve (the headline's K d nv / sp doubles, in chunks of
# peer.CAPACITY); a dp step's 4 and a prelude's 1; dp x sp adds the chain
# solver's 2 (SPIKE's interface gather and the gather of X) a step.
SP_STEP_PEER, SP_PRELUDE_PEER, DP_STEP_PEER, DPSP_STEP_PEER = 9, 2, 4, 6
HEADLINE_DEGREE, HEADLINE_NV = 4, 2
# Phase 14 (a)'s bar on the fixed-work p at sp = 4 against one rank's.  The
# rank-ordered sums of four shards round the parameter Schur sums otherwise
# than one rank's chain does, and after 15 iterations p has read 5.196e-08
# from one rank's on an H100 (PERF.md §6); sp = 1 and 2 read ~4e-10 and
# keep 1e-8.  A wrong collective (a rank's part dropped or stale) changes
# the normal equations themselves, not their last bits, and moves p by
# orders of magnitude more than this bar.
P_BAR_SP4 = 1e-7


def _its(st) -> int:
    """The iteration count of a SolveStats or of its dict on the host."""
    return int(st["iterations"] if isinstance(st, dict) else st.iterations)


def _peer_calls(name, stats) -> int:
    """The peer kernel's launches a rank of phase 14's case ``name`` makes
    in a run whose SolveStats (a list of them for IRLS) is ``stats``; an sp
    case's name holds "sp=<ranks>"."""
    from collocfem_tpu_torch.parallel import peer

    if name.startswith("dp x sp"):
        return 1 + DPSP_STEP_PEER * _its(stats)
    if name.startswith("dp"):
        return 1 + DP_STEP_PEER * _its(stats)
    sp = int(re.search(r"sp=(\d+)", name).group(1))
    v_local = (ELEMENTS_SP + 1) * HEADLINE_DEGREE * HEADLINE_NV // sp
    around = SP_PRELUDE_PEER + math.ceil(v_local / peer.CAPACITY)
    rounds = stats if isinstance(stats, list) else [stats]   # IRLS: a list
    return sum(around + SP_STEP_PEER * _its(st) for st in rounds)


def _world_cases():
    """Phase 14's cases for the world of SP_MAX gloo ranks sharing the card
    (a 2 x 2 grid runs each sp = 2 or dp = 2 case on both of its rows or
    columns): the fixed-work cases and IRLS by the solver's ``.eager``, the
    converging cases of CAPTURED captured (testing.captured_case), and the
    peer kernel against its plain version (testing.peer_case)."""
    import torch

    from collocfem_tpu_torch import testing

    f64 = torch.float64
    head = dict(kind="headline", elements=ELEMENTS_SP)
    c5 = dict(kind="config5", n_exp=N_EXP, elements=10)
    sp = lambda grid, dtype=f64: (testing.sp_gn_case, dict(
        mesh=grid, spec=head, options=SP_FIXED, dtype=dtype, mode="eager"))
    dp = lambda grid, layout: (testing.dp_case, dict(
        mesh=grid, spec=c5, options=C5_FIXED, layout=layout, dtype=f64,
        mode="eager"))
    return {
        "sp=4 float64": sp((1, 4)), "sp=2 float64": sp((2, 2)),
        "sp=4 float32": sp((1, 4), torch.float32),
        **{f"dp={n} {layout}": dp(grid, layout)
           for n, grid in ((4, (4, 1)), (2, (2, 2)))
           for layout in ("soa", "blocks")},
        "dp x sp": (testing.dp_case, dict(
            mesh=(2, 2), spec=dict(kind="config5", n_exp=4, elements=511),
            options=DPSP_FIXED, layout="blocks", dtype=f64, sp_chain=True,
            mode="eager")),
        "irls sp=2": (testing.sp_gn_case, dict(
            mesh=(2, 2), spec=head, options=SP_IRLS, dtype=f64,
            irls_rounds=2, mode="eager")),
        "sp=4 converging": (testing.captured_case, dict(
            kind="sp", mesh=(1, SP_MAX), spec=head, options=SP_CONVERGED,
            dtype=f64, profile=True)),
        "dp=4 soa converging": (testing.captured_case, dict(
            kind="dp", mesh=(SP_MAX, 1), spec=c5, options=C5_CONVERGED,
            layout="soa", dtype=f64, profile=True)),
        "peer": (testing.peer_case, dict(mesh=(1, SP_MAX), seed=3,
                                         sizes=PEER_SIZES, reps=PEER_REPS)),
    }


def _nccl_world_of_one(dev, card, record):
    """Phase 14's NCCL world of one in this process (NCCL takes one rank a
    card): make_sp_gn_solver on the headline at N = 9,999, float64, at
    SP_FIXED and to SP_CONVERGED (its steps under the loop graph's WHILE
    node, as on several ranks), and make_multi_experiment_solver on config
    5 with dp_axis in both layouts at C5_FIXED, each replaying CUDA graphs
    with its collectives (the peer kernel at P = 1) inside.  Each case's
    first call (warm-up, capture, replay; its reads to the host gated at
    0 by _no_reads), a replay and ``solve.eager`` are counted: the three
    give the same bits and the same launches.  Prints each case's walls,
    launches and the idle share of the captured and of the eager wall.
    Returns {case: {"out": the first call's result on the host, "counts":
    {kernel: (launches, {shape: n})}, "wall": the replay's}}, as a world's
    ranks report them."""
    import tempfile

    import torch
    import torch.distributed as dist

    from collocfem_tpu_torch.parallel import make_device_mesh, peer
    from collocfem_tpu_torch.parallel.batch import \
        make_multi_experiment_solver
    from collocfem_tpu_torch.parallel.sharded import make_sp_gn_solver
    from collocfem_tpu_torch.solve.newton import SolverOptions
    from collocfem_tpu_torch.testing import (_host, batch_inputs, bit_equal,
                                             estimation_inputs)

    f64 = torch.float64
    out, rec = {}, record.setdefault("phase14_nccl_one", {})
    with tempfile.TemporaryDirectory() as wd:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{wd}/init", world_size=1, rank=0)
        try:
            dm = make_device_mesh(1, 1, device=dev)
            prob, z0, data = estimation_inputs(
                dict(kind="headline", elements=ELEMENTS_SP), dtype=f64,
                device=dev)
            c5 = batch_inputs(dict(kind="config5", n_exp=N_EXP,
                                   elements=10), dtype=f64, device=dev)
            sp = lambda opts: make_sp_gn_solver(prob, dm,
                                                SolverOptions(**opts))
            chain = lambda o: {"blocktri_solve_spike_fused":
                               2 * _its(o[1]),
                               "peer_reduce": _peer_calls("sp=1", o[1])}
            cases = {
                "sp=1 float64": (sp(SP_FIXED), (z0, data), chain),
                "sp=1 converging": (sp(SP_CONVERGED), (z0, data), chain),
                **{f"dp=1 {layout}": (make_multi_experiment_solver(
                    c5[0], SolverOptions(**C5_FIXED), dp_axis=dm.dp_group,
                    layout=layout), c5[1:], lambda o, k=kernel: {
                        k: 15, "peer_reduce": _peer_calls("dp", o[1])})
                   for layout, kernel in (
                       ("soa", "blocktri_solve_spike_fused"),
                       ("blocks", "batched_thomas_solve"))}}
            for name, (solve, args, want) in cases.items():
                tag = f"phase 14 NCCL world of one {name}"
                runs = {}
                for run, fn in (
                        ("first call", lambda: _no_reads(
                            f"{tag} first call", lambda: solve(*args))),
                        ("captured", lambda: solve(*args)),
                        ("eager", lambda: solve.eager(*args))):
                    res, wall, counts = _counted(f"{tag} {run}", fn, want)
                    runs[run] = (res, wall, {k: (n, dict(LAST_SHAPES[k]))
                                             for k, n in counts.items() if n})
                first, walls = runs["first call"], {
                    r: v[1] for r, v in runs.items()}
                same = all(bit_equal(v[0], first[0]) and v[2] == first[2]
                           for v in runs.values())
                profile = _profile_captured(tag, lambda: solve(*args),
                                            walls["captured"], walls["eager"])
                print(f"  {tag}: {_three_walls(walls, same, card)}; host "
                      f"reads 0; launches {first[2]}; idle share of the "
                      f"captured wall {profile['idle_share']:.3f}, of the "
                      f"eager wall {profile['eager_idle_share']:.3f}")
                if not same:
                    raise RuntimeError(f"{tag}: the captured solve differs "
                                       "from solve.eager")
                rec[name] = dict(walls_s=walls, launches={
                    k: [n, {str(shape): m for shape, m in shapes.items()}]
                    for k, (n, shapes) in first[2].items()},
                                 iterations=_its(first[0][1]), host_reads=0,
                                 idle_share=profile["idle_share"],
                                 eager_idle_share=profile[
                                     "eager_idle_share"])
                out[name] = {"out": _host(first[0]), "counts": first[2],
                             "wall": walls["captured"]}
            peer.release()
        finally:
            dist.destroy_process_group()
    return out


def _rank_results(ranks, one):
    """{case: [each rank's result]}: the world's ranks and the world of one,
    every case's ranks bit-identical (raises otherwise)."""
    from collocfem_tpu_torch.testing import bit_equal

    out = {name: [r[name] for r in ranks] for name in ranks[0]}
    out.update({name: [res] for name, res in one.items()})
    for name, rs in out.items():
        if not all(bit_equal(r["out"], rs[0]["out"]) for r in rs[1:]):
            raise RuntimeError(f"phase 14 {name}: the ranks' results differ")
    return out


def _phase14_refs(dev):
    """The single-rank runs phase 14 holds the sharded ones against: the
    captured make_gn_solver on the headline at N = 9,999 (fixed work on
    'auto' and on 'cr', and to SP_CONVERGED),
    make_multi_experiment_solver on config 5 in each
    layout at C5_FIXED and in the soa layout to C5_CONVERGED, and on the
    four experiments of 511 elements, and make_irls_solver; each (z,
    stats)."""
    import torch

    from collocfem_tpu_torch.parallel.batch import \
        make_multi_experiment_solver
    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_gn_solver,
                                                  make_irls_solver)
    from collocfem_tpu_torch.testing import batch_inputs, estimation_inputs

    f64 = torch.float64
    prob, z0, data = estimation_inputs(
        dict(kind="headline", elements=ELEMENTS_SP), dtype=f64, device=dev)
    refs = {"sp": make_gn_solver(prob, SolverOptions(**SP_FIXED))(z0, data),
            "sp cr": make_gn_solver(prob, SolverOptions(
                **SP_FIXED, method="cr"))(z0, data),
            "sp converging": make_gn_solver(
                prob, SolverOptions(**SP_CONVERGED))(z0, data),
            "irls": make_irls_solver(prob, SolverOptions(**SP_IRLS), 2)(
                z0, data)}
    c5 = batch_inputs(dict(kind="config5", n_exp=N_EXP, elements=10),
                      dtype=f64, device=dev)
    for layout in ("soa", "blocks"):
        refs[layout] = make_multi_experiment_solver(
            c5[0], SolverOptions(**C5_FIXED), layout=layout)(*c5[1:])
    refs["soa converging"] = make_multi_experiment_solver(
        c5[0], SolverOptions(**C5_CONVERGED), layout="soa")(*c5[1:])
    dpsp = batch_inputs(dict(kind="config5", n_exp=4, elements=511),
                        dtype=f64, device=dev)
    refs["dp x sp"] = make_multi_experiment_solver(
        dpsp[0], SolverOptions(**DPSP_FIXED))(*dpsp[1:])
    return refs


def _phase14_captured(captured, refs, card, record):
    """Phase 14's converging solves on SP_MAX ranks sharing the card
    (CAPTURED; testing.captured_case's four runs on every rank): raises
    unless on every rank the four give the same bits, iterations and
    launches (the chain kernel once per iteration per chain solve, the peer
    kernel as _peer_calls says, no plain version), the captured calls read
    nothing to the host, the ranks agree bit for bit, and p is within 1e-8
    of the single-rank solver's.  Prints the walls (the slowest rank's)
    and the idle shares of the captured and of the eager wall, with rank
    0's profiled ``.eager`` run's device time.  Returns {kernel: the first
    calls' launches summed over the ranks} (by shape into MAIN_SHAPES)."""
    from collocfem_tpu_torch.testing import bit_equal

    launches, rec = {}, record.setdefault("phase14_captured", {})
    for name, ref in CAPTURED.items():
        ranks = captured[name]
        first = ranks[0]["runs"]["first call"]["out"]
        its = _its(first[1])
        chain = {"blocktri_solve_spike_fused":
                 (2 if name.startswith("sp") else 1) * its,
                 "peer_reduce": _peer_calls(name, first[1])}
        for r, res in enumerate(ranks):
            runs = res["runs"]
            for run, v in runs.items():
                got = {k: n for k, (n, _) in v["counts"].items()}
                if not bit_equal(v["out"], first) or got != chain:
                    raise RuntimeError(
                        f"phase 14 {name} rank {r} {run}: not the first "
                        f"call's bits, or launches {got} and not {chain}")
            reads = [runs[n]["host_reads"] for n in ("first call",
                                                     "captured")]
            if any(reads):
                raise RuntimeError(f"phase 14 {name} rank {r}: host reads "
                                   f"{reads} during the captured calls, "
                                   "not 0")
            for k, (n, shapes) in runs["first call"]["counts"].items():
                launches[k] = launches.get(k, 0) + n
                kept = MAIN_SHAPES.setdefault(k, {})
                for shape, m in shapes.items():
                    kept[shape] = kept.get(shape, 0) + m
        z, st = first
        dp_abs = float((z["p"] - refs[ref][0].p.cpu()).abs().max())
        walls = {run: max(r["runs"][run]["wall"] for r in ranks)
                 for run in ranks[0]["runs"]}
        prof = ranks[0]["profile"]
        idle = 1 - prof["device_ms"] / 1e3 / walls["captured"]
        eager_idle = 1 - prof["device_ms"] / 1e3 / walls["eager"]
        print(f"  {name} ({SP_MAX} ranks sharing {card}): {its} iterations "
              f"(the single-rank solver's {_its(refs[ref][1])}), "
              f"converged {bool(st['converged'])}; host reads during the "
              f"captured calls 0 on every rank (gate 0); .eager, first "
              f"call, replay and .eager again bit-identical with the same "
              f"launches {chain} on every rank; |p - p_1rank| {dp_abs:.3e} "
              f"(<= 1e-8); walls (slowest rank) captured "
              f"{walls['captured']:.4f} s (first call "
              f"{walls['first call']:.4f} s), eager {walls['eager']:.4f} s "
              f"(again {walls['eager again']:.4f} s); idle share of the "
              f"captured wall {idle:.3f}, of the eager wall "
              f"{eager_idle:.3f} (rank 0's profiled .eager run: "
              f"{prof['device_ms']:.3f} ms of device time over "
              f"{prof['kernels']} kernels)")
        if not (dp_abs <= 1e-8 and bool(st["converged"])):
            raise RuntimeError(f"phase 14 {name} disagrees with the "
                               "single-rank solver")
        rec[name] = dict(walls_s=walls, iterations=its, p_vs_1rank=dp_abs,
                         idle_share=idle, eager_idle_share=eager_idle,
                         profile=prof, launches_per_rank=chain)
    return launches


def _phase14_peer(runs, card, record):
    """Phase 14's peer kernel against its plain version at P = SP_MAX on
    the card (testing.peer_case on every rank): raises unless every
    comparison is bit for bit and the kernel launched.  Prints each op and
    size's ms a call (rank 0's) of the kernel, the plain version and gloo's
    dist.all_reduce, and returns the kernels line's numbers at the SPIKE
    gather's size: {"ms", "plain_ms", "library_ms", "bound": (ms, by)}.
    Bound: each rank's call reads the P payloads and writes its n doubles
    (8 n (P + 1) bytes) and adds (P - 1) n times."""
    for r, res in enumerate(runs):
        bad = [k for k, v in res.items() if k != "launches" and not v["same"]]
        if bad or res["launches"] < 1:
            raise RuntimeError(f"phase 14 peer rank {r}: the kernel differs "
                               f"from its plain version at {bad}, or did "
                               f"not launch ({res['launches']})")
    zero = runs[0]
    for (op, n), v in ((k, v) for k, v in zero.items() if k != "launches"):
        print(f"  peer kernel P={SP_MAX} {op} n={n}: bit-identical to its "
              f"plain version on every rank; {v['kernel_ms']:.4f} ms a call,"
              f" plain {v['plain_ms']:.4f} ms, gloo dist.all_reduce "
              f"{v['library_ms']:.4f} ms ({SP_MAX} ranks sharing {card})")
    n = PEER_SIZES[-1]
    at = zero[("sum", n)]
    out = dict(ms=at["kernel_ms"], plain_ms=at["plain_ms"],
               library_ms=at["library_ms"],
               bound=_bound(8 * n * (SP_MAX + 1), (SP_MAX - 1) * n))
    record["phase14_peer"] = {f"{op} n={m}": v for (op, m), v in
                              ((k, v) for k, v in zero.items()
                               if k != "launches")}
    return out


def _phase14(dev, card, record):
    """Phase 14: the multi-rank tier (parallel/), one world of SP_MAX gloo
    ranks sharing the card (testing.run_world) and an NCCL world of one in
    this process, held against single-rank runs; then the symbolic model.
    Returns the kernels' launches ({kernel: n}; by shape into MAIN_SHAPES),
    summed over every rank (the captured cases and the world of one: their
    first calls'), and puts the peer kernel's numbers in
    record["peer_kernel"]."""
    import tempfile

    import torch

    from collocfem_tpu_torch import symbolic_model, testing
    from collocfem_tpu_torch.headline import build_headline_problem
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        ranks = testing.run_world(
            SP_MAX, [(n, fn, kw) for n, (fn, kw) in _world_cases().items()],
            wd, device=str(dev))
    world_wall = time.perf_counter() - t_start
    print(f"phase 14: {SP_MAX} gloo ranks sharing {card} ({world_wall:.1f} s "
          "with the spawn; fixed work by .eager, the converging solves "
          "captured) and an NCCL world of one (captured); every collective "
          "the peer kernel")
    captured = {n: [r.pop(n) for r in ranks] for n in CAPTURED}
    record["peer_kernel"] = _phase14_peer([r.pop("peer") for r in ranks],
                                          card, record)
    res = _rank_results(ranks, _nccl_world_of_one(dev, card, record))
    refs = _phase14_refs(dev)
    print("  every case's ranks bit-identical")
    walls = {n: [r["wall"] for r in rs] for n, rs in res.items()}
    record["phase14_walls_s"] = walls
    print("  walls of ranks sharing one card (they measure correctness, not "
          "speed across cards): " + "; ".join(
              f"{n} {max(w):.3f} s" for n, w in walls.items()))
    launches = {}

    def counted(name, want):
        """Raise unless every rank of ``name`` launched the kernels as
        ``want`` ({kernel: (n, {shape: n})}) says, the peer kernel as
        _peer_calls says, and no plain version; add the launches up."""
        for r in res[name]:
            counts = dict(r["counts"])
            got = {k: v for k, v in counts.items() if not k.endswith("_ref")}
            peer_n = got.pop("peer_reduce", (0, {}))[0]
            if (any(k.endswith("_ref") for k in counts) or got != want
                    or peer_n != _peer_calls(name, r["out"][1])):
                raise RuntimeError(
                    f"phase 14 {name}: expected launches {want}, "
                    f"{_peer_calls(name, r['out'][1])} of the peer kernel "
                    f"and no plain call, got {counts}")
            got = {k: v for k, v in counts.items() if not k.endswith("_ref")}
            for k, (n, shapes) in got.items():
                launches[k] = launches.get(k, 0) + n
                kept = MAIN_SHAPES.setdefault(k, {})
                for shape, m in shapes.items():
                    kept[shape] = kept.get(shape, 0) + m

    def two_shapes(n):
        return {"blocktri_solve_spike_fused": (2 * n, {(8, 19): n,
                                                       (8, 3): n})}

    # (a) sp: fixed work against the single-rank solver.  The single-rank
    # solver's own p on its two chain methods, which round differently, is
    # printed beside the bars (not a bar): after 15 fixed-work iterations
    # the parameter Schur complement cancels, and a last-bit change in its
    # sums moves p by about that much.
    z_ref, st_ref = refs["sp"]
    spread = float((refs["sp cr"][0].p - z_ref.p).abs().max())
    print(f"  (a) the single-rank solver's p on 'auto' and on 'cr' differ by "
          f"{spread:.3e}")
    for name in ("sp=1 float64", "sp=2 float64", "sp=4 float64"):
        p_bar = P_BAR_SP4 if name.startswith("sp=4") else 1e-8
        z, st = res[name][0]["out"]
        dp_abs = float((z["p"] - z_ref.p.cpu()).abs().max())
        dv = float((z["V"] - z_ref.V.cpu()).abs().max()
                   / z_ref.V.abs().max())
        same = torch.equal(st["history"][:, 4], st_ref.history[:, 4].cpu())
        print(f"  (a) {name}: p {z['p'].tolist()}, |p - p_1rank| {dp_abs:.3e}"
              f" (<= {p_bar:.3e}), V rel {dv:.3e} (<= 1e-6), accept history "
              f"{'same' if same else 'DIFFERENT'}")
        if not (dp_abs <= p_bar and dv <= 1e-6 and same):
            raise RuntimeError(f"phase 14 (a) {name} disagrees with the "
                               "single-rank solver")
        counted(name, two_shapes(15))
    z, st = res["sp=1 converging"][0]["out"]
    its = int(st["iterations"])
    dp_abs = float((z["p"] - refs["sp converging"][0].p.cpu()).abs().max())
    print(f"  (a) sp=1 converging: {its} iterations, |p - p_1rank| "
          f"{dp_abs:.3e} (<= 1e-8), the single-rank solver's "
          f"{int(refs['sp converging'][1].iterations)}")
    if not (dp_abs <= 1e-8 and bool(st["converged"]) and its < 60):
        raise RuntimeError("phase 14 (a) sp=1 converging disagrees with the "
                           "single-rank solver")
    counted("sp=1 converging", two_shapes(its))
    z, st = res["sp=4 float32"][0]["out"]
    c0, c_end = float(st["history"][0, 0]), float(st["cost"])
    print(f"  (a) sp=4 float32: cost {c0:.6e} -> {c_end:.6e}, p "
          f"{z['p'].tolist()}")
    if not (c_end < 0.1 * c0 and bool(torch.isfinite(z["p"]).all())):
        raise RuntimeError("phase 14 (a) float32 did no useful work")
    counted("sp=4 float32", two_shapes(15))
    # (b) dp: config 5 against the unsharded solver, each layout.
    for layout, kernel in (("soa", "blocktri_solve_spike_fused"),
                           ("blocks", "batched_thomas_solve")):
        z_ref, _ = refs[layout]
        for n in (1, 2, 4):
            name = f"dp={n} {layout}"
            z, _ = res[name][0]["out"]
            dp_abs = float((z["p"] - z_ref.p.cpu()).abs().max())
            dv = float((z["V"] - z_ref.V.cpu()).abs().max())
            print(f"  (b) config 5 {name}: |p - p_unsharded| {dp_abs:.3e} "
                  f"(<= 1e-9), |V - V_unsharded| {dv:.3e} (<= 1e-8)")
            if not (dp_abs <= 1e-9 and dv <= 1e-8):
                raise RuntimeError(f"phase 14 (b) {name} disagrees with the "
                                   "unsharded solver")
            shapes = res[name][0]["counts"].get(kernel, (0, {}))[1]
            counted(name, {kernel: (15, shapes)})
    # (c) dp x sp.
    z, _ = res["dp x sp"][0]["out"]
    dp_abs = float((z["p"] - refs["dp x sp"][0].p.cpu()).abs().max())
    print(f"  (c) dp x sp = 2 x 2, 4 x 511 elements: |p - p_unsharded| "
          f"{dp_abs:.3e} (<= 1e-9)")
    if not dp_abs <= 1e-9:
        raise RuntimeError("phase 14 (c) disagrees with the unsharded solver")
    counted("dp x sp", two_shapes(5))
    # (d) IRLS with the sharded inner solver.
    z, stats, _ = res["irls sp=2"][0]["out"]
    z_ref = refs["irls"][0]
    its = sum(int(s["iterations"]) for s in stats)
    dp_abs = float((z["p"] - z_ref.p.cpu()).abs().max())
    print(f"  (d) IRLS sp=2, 2 rounds: {its} LM iterations, |p - p_1rank| "
          f"{dp_abs:.3e} (<= 1e-6)")
    if not dp_abs <= 1e-6:
        raise RuntimeError("phase 14 (d) disagrees with the single-rank IRLS")
    counted("irls sp=2", two_shapes(its))
    # The converging solves captured on SP_MAX ranks.
    for k, n in _phase14_captured(captured, refs, card, record).items():
        launches[k] = launches.get(k, 0) + n

    # (e) the symbolic model through the captured make_gn_solver.
    mesh, t_meas, y, u_nodes = build_headline_problem(ELEMENTS)
    sym = symbolic_model(**VDP_SYM)()
    ps = {}
    for dtype in (torch.float32, torch.float64):
        prob = EstimationProblem.build(sym, mesh, t_meas, defect_weight=100.0,
                                       device=dev, dtype=dtype)
        data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
        z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
        if dtype == torch.float32:
            solve = make_gn_solver(prob, SolverOptions(**SP_FIXED))
            (z, st), wall, counts = _counted(
                "phase 14 (e)", lambda: solve(z0, data),
                _assembled({"kkt_solve_spike_fused": 15}, 15))
            c0, c_end = float(prob.cost(z0, data)), float(st.cost)
            print(f"  (e) symbolic model N={ELEMENTS} float32, 15 LM "
                  f"iterations captured: cost {c0:.6e} -> {c_end:.6e}, "
                  f"kernel #1 launches {counts['kkt_solve_spike_fused']}, "
                  f"wall {wall:.4f} s")
            if not (c_end < 0.1 * c0 and bool(torch.isfinite(z.p).all())):
                raise RuntimeError("phase 14 (e) float32 did no useful work")
            launches.update({"kkt_solve_spike_fused": 15, GN: 16})
            _keep_shapes(["kkt_solve_spike_fused", GN])
        else:
            opts = SolverOptions(maxiter=60, gtol=1e-10, xtol=1e-12)
            hand, hdata, hz0 = _headline(dtype, dev, ELEMENTS)
            ps = {"symbolic": make_gn_solver(prob, opts)(z0, data)[0].p,
                  "hand-written": make_gn_solver(hand, opts)(hz0, hdata)[0].p}
    d_sym = float((ps["symbolic"] - ps["hand-written"]).abs().max())
    print(f"  (e) symbolic model float64 to convergence: p "
          f"{ps['symbolic'].tolist()}, |p - p_hand-written| {d_sym:.3e} "
          "(<= 1e-10)")
    if not d_sym <= 1e-10:
        raise RuntimeError("phase 14 (e) the symbolic model's p differs")
    record["phase14_wall_s"] = time.perf_counter() - t_start
    print(f"  phase 14 took {record['phase14_wall_s']:.1f} s on {card}")
    return launches


def _serve(mhe, ys, m0, P0, iterations):
    """Run the stream through ``mhe`` (init on the first window from the
    prior (m0, P0), then one step a sample), each step bracketed by
    torch.cuda.synchronize().  ``iterations`` collects every window solve's
    LM iteration count (a tensor, read at the end).  Returns (estimates (T,
    nx) on the host, per-step walls, the final state)."""
    import time

    import torch

    solver = mhe._solver

    def counting(z0, data):
        z, st = solver(z0, data)
        iterations.append(st.iterations)
        return z, st

    mhe._solver = counting
    state = mhe.init(ys[:mhe.horizon], m0=m0, P0=P0)
    ests, walls = [mhe.estimate(state)], []
    for k in range(mhe.horizon, ys.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = mhe.step(state, ys[k])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ests.append(est)
    mhe._solver = solver
    return torch.stack(ests).double().cpu().numpy(), walls, state


def _mhe_vs_eager(tag, mhe, ys, walls, n=20):
    """The first ``n`` steps from the first window, captured
    (``mhe.step``) and eager (``mhe.step_eager``) from the same state:
    raise unless every step's state (z, m, P, y, u) and estimate agree bit
    for bit.  Prints the eager steps' walls beside the captured stream's
    (``walls``).  Returns the record."""
    import numpy as np

    from collocfem_tpu_torch.testing import bit_equal

    from collocfem_tpu_torch.solve.graph import HostReads

    a = b = mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2))
    eager_walls, ok, reads = [], True, 0
    for k in range(MHE_HORIZON, MHE_HORIZON + n):
        with HostReads("cuda") as r:
            a, est_a = mhe.step(a, ys[k])
        reads += r.count
        (b, est_b), wall = _timed(lambda: mhe.step_eager(b, ys[k]))
        eager_walls.append(wall)
        ok = ok and bit_equal((a.z, a.m, a.P, a.y, a.u, est_a),
                              (b.z, b.m, b.P, b.y, b.u, est_b))
    print(f"  {tag}: {n} steps captured and eager bit-identical (z, m, P, "
          f"y, u, estimate) {'ok' if ok else 'FAIL'}; host reads in the {n} "
          f"captured steps {reads} (gate 0); captured {_walls_line(walls)}; "
          f"eager {_walls_line(eager_walls)}")
    if not ok:
        raise RuntimeError(f"{tag}: the captured step differs from "
                           "step_eager")
    if reads:
        raise RuntimeError(f"{tag}: {reads} host reads in the captured steps")
    return dict(eager_walls_s=eager_walls, host_reads=reads)


def _walls_line(walls):
    import numpy as np

    w = np.asarray(walls) * 1e3
    return (f"per-step wall median {np.median(w):.3f} ms, p90 "
            f"{np.percentile(w, 90):.3f} ms, max {w.max():.3f} ms over "
            f"{w.size} steps")


def _simulate_and_smooth_linear():
    """tests/test_kalman_parity.py's linear-Gaussian problem: an
    Euler-Maruyama truth (default_rng(7)), 60 noisy samples of x1 and the
    numpy Kalman filter / RTS smoother over them (exact Van Loan
    discretization).  Returns (A, sig_w, sig_v, t_meas, y, smoothed path
    (60, 2))."""
    import numpy as np
    from scipy.linalg import expm

    A = np.array([[0.0, 1.0], [-4.0, -0.4]])
    sig_w, sig_v, tf, nt = 0.15, 0.05, 6.0, 60
    rng = np.random.default_rng(7)
    t_meas = np.linspace(0.08, tf - 0.02, nt)
    dt = 1e-4
    ts = np.arange(0.0, tf + dt, dt)
    x = np.zeros((ts.size, 2))
    x[0] = [1.0, 0.0]
    for i in range(ts.size - 1):
        x[i + 1] = x[i] + dt * (A @ x[i])
        x[i + 1, 1] += sig_w * np.sqrt(dt) * rng.standard_normal()
    y = np.interp(t_meas, ts, x[:, 0]) + sig_v * rng.standard_normal(nt)
    Qc = np.array([[0.0, 0.0], [0.0, sig_w**2]])

    def disc(dtk):
        M = np.zeros((4, 4))
        M[:2, :2] = A * dtk
        M[:2, 2:] = Qc * dtk
        M[2:, 2:] = -A.T * dtk
        EM = expm(M)
        Ad = EM[:2, :2]
        Qd = EM[:2, 2:] @ Ad.T
        return Ad, (Qd + Qd.T) / 2

    H = np.array([[1.0, 0.0]])
    R = np.array([[sig_v**2]])
    mk, Pk = np.zeros(2), np.eye(2) * 1e6
    ms_f, Ps_f, ms_p, Ps_p, Ads = [], [], [], [], []
    for i in range(nt):
        if i > 0:
            Ad, Qd = disc(t_meas[i] - t_meas[i - 1])
            mk = Ad @ mk
            Pk = Ad @ Pk @ Ad.T + Qd
        else:
            Ad = np.eye(2)
        ms_p.append(mk.copy())
        Ps_p.append(Pk.copy())
        Ads.append(Ad)
        S = H @ Pk @ H.T + R
        K = Pk @ H.T @ np.linalg.inv(S)
        mk = mk + (K @ (y[i] - H @ mk)).ravel()
        Pk = (np.eye(2) - K @ H) @ Pk
        ms_f.append(mk.copy())
        Ps_f.append(Pk.copy())
    xs = [None] * nt
    xs[-1] = ms_f[-1]
    for i in range(nt - 2, -1, -1):
        Ck = Ps_f[i] @ Ads[i + 1].T @ np.linalg.inv(Ps_p[i + 1])
        xs[i] = ms_f[i] + Ck @ (xs[i + 1] - ms_p[i + 1])
    return A, sig_w, sig_v, t_meas, y, np.asarray(xs)


def _pem_data():
    """examples/pem_kalman.py's data: the Euler-Maruyama Duffing path
    (dt 1e-3, default_rng(11)) and 400 noisy samples of x1."""
    import numpy as np

    rng = np.random.default_rng(11)
    dt = 1e-3
    n = int(PEM_TF / dt)
    ts = np.linspace(0.0, PEM_TF, n + 1)
    x = np.zeros((n + 1, 2))
    x[0] = [1.0, 0.0]
    for i in range(n):
        t, (x1, x2) = ts[i], x[i]
        drift = np.array([
            x2,
            -PEM_DELTA * x2 - PEM_ALPHA * x1 - PEM_BETA * x1**3
            + PEM_GAMMA * np.cos(PEM_OMEGA * t),
        ])
        x[i + 1] = x[i] + dt * drift
        x[i + 1, 1] += PEM_PROC_NOISE * np.sqrt(dt) * rng.standard_normal()
    t_meas = np.linspace(0.05, PEM_TF - 0.05, 400)
    y = np.interp(t_meas, ts, x[:, 0])[:, None]
    y += PEM_MEAS_NOISE * rng.standard_normal(y.shape)
    return t_meas, y


def _serving(dev, card, record):
    """Phase 13: the serving path (the moving-horizon estimator) and the
    Kalman tier at the examples' full sizes.  (a) examples/mhe_online.py in
    float64: every 20th estimate and the last within 1e-6 of the JAX
    package's, current_covariance within 1e-6, kernel #2 at (6, 1) exactly
    once per LM iteration of every window solve and no plain version; the
    RMSE against the truth, the per-step walls and, by torch.profiler, the
    device idle share over 20 steps.  (b) the same stream in float32:
    position RMSE < 3 sig_v and velocity RMSE < 0.1, every estimate
    finite.  (c) tests/test_mhe.py's linear set-up on 'auto' (kernel #2 at
    (8, 1)): the estimates and the final covariance within 2e-6 of the
    port's own kalman_filter on the card.  (d) tests/test_kalman_parity.py's
    full-rule smoother problem: converged, the MAP path within 1.5e-3 of
    the numpy RTS smoother.  (e) examples/pem_kalman.py from p0: the EKF
    NLL and its gradient through the captured scan against the uncaptured
    scan, the tape-recording loop and the JAX package's; the PEM from p0;
    the NLL at the JAX package's optimum; the UKF NLL at p0; the smoother
    warm start at the port's optimum, the MAP polish (kernel #1 at (8, 3))
    and parameter_std (kernels #3 and #6) against the JAX package's.
    Returns the launches."""
    import numpy as np
    import torch

    from collocfem_tpu_torch import kalman
    from collocfem_tpu_torch.mhe import MovingHorizonEstimator
    from collocfem_tpu_torch.models import LinearSystem
    from collocfem_tpu_torch.ops.basis import make_basis
    from collocfem_tpu_torch.ops.mesh import Mesh, interpolate_trajectory
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    chain = "blocktri_solve_spike_fused"
    launches = {}
    rec = record.setdefault("serving", {})

    def keep(label, counts, plain, want, shape):
        _expect_only(counts, plain, want, label)
        for k in want:
            if LAST_SHAPES[k] != {shape: want[k]}:
                raise RuntimeError(f"{label}: launches by shape "
                                   f"{LAST_SHAPES[k]}, expected {shape}")
        _keep_shapes(want)
        for k, v in want.items():
            launches[k] = launches.get(k, 0) + v

    # ---- (a), (b): the serving cell in float64 and float32 -----------------
    f64_ests = None
    for part, dtype in (("(a)", torch.float64), ("(b)", torch.float32)):
        name = str(dtype).split(".")[1]
        tag = f"phase 13 {part}: MHE serving {name}"
        mhe, xs, ys = _mhe_stream(dtype, dev)
        its = []
        _reset_counts()
        ests, walls, state = _serve(mhe, ys, [1.5, 0.5], np.eye(2), its)
        torch.cuda.synchronize()
        counts, plain = _counts()
        n_its = int(torch.stack(its).sum())
        keep(tag, counts, plain, {chain: n_its}, (6, 1))
        truth = xs[MHE_HORIZON - 1:]
        rmse = np.sqrt(((ests - truth) ** 2).mean(axis=0))
        steps = len(walls)
        r = dict(rmse=rmse.tolist(), walls_s=walls, iterations=n_its,
                 launches=counts[chain], launches_per_step=n_its / (steps + 1),
                 finite=bool(np.isfinite(ests).all()))
        print(f"{tag}: {steps + 1} online samples (window {MHE_HORIZON}, dt "
              f"{MHE_DT}, degree 3, b = 6, K = {MHE_HORIZON}); RMSE position "
              f"{rmse[0]:.6f} velocity {rmse[1]:.6f} (JAX: "
              f"{MHE_JAX_RMSE[0]:.6f} {MHE_JAX_RMSE[1]:.6f}); {n_its} LM "
              f"iterations over {steps + 1} window solves = kernel #2 "
              f"launches at (6, 1) ({n_its / (steps + 1):.2f} a solve), no "
              f"plain call; captured {_walls_line(walls)} on {card}")
        if dtype == torch.float64:
            d_est = max(abs(ests[i] - np.asarray(v)).max()
                        for i, v in MHE_JAX_ESTIMATES.items())
            cov = mhe.current_covariance(state).cpu().numpy()
            d_cov = float(np.abs(cov - np.asarray(MHE_JAX_COV)).max())
            r.update(est_vs_jax=d_est, cov=cov.tolist(), cov_vs_jax=d_cov)
            print(f"  max |estimate - JAX| at every 20th sample and the last "
                  f"{d_est:.3e} (<= 1e-6); max |current_covariance - JAX| "
                  f"{d_cov:.3e} (<= 1e-6)")
            ok = len(ests) == 229 and d_est <= 1e-6 and d_cov <= 1e-6
            f64_ests = ests
        else:
            dev_a = float(np.abs(ests - f64_ests).max())
            r["max_dev_from_float64"] = dev_a
            print(f"  max |estimate - float64's| {dev_a:.3e}; gates: RMSE "
                  f"position < {3 * MHE_SIG_V} and velocity < 0.1, every "
                  "estimate finite")
            ok = (r["finite"] and rmse[0] < 3 * MHE_SIG_V and rmse[1] < 0.1)
        # The device idle share over the first 20 steps: one unprofiled run
        # for the wall, one profiled.
        first = mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2))
        run20 = lambda: _steps(mhe, first, ys, MHE_HORIZON, 20)
        eager20 = lambda: _steps(mhe, first, ys, MHE_HORIZON, 20, eager=True)
        wall20 = _timed(run20)[1]
        r["profile_20_steps"] = _profile_loop(
            f"MHE serving {name}, 20 steps", eager20, wall20,
            _timed(eager20)[1])
        r["wall_20_steps_s"] = wall20
        w = np.asarray(walls) * 1e3
        med, p90, idle = PARENT_MHE[name]
        print(f"  {tag}: per-step median {np.median(w):.3f} ms, p90 "
              f"{np.percentile(w, 90):.3f} ms, idle share over 20 steps "
              f"{r['profile_20_steps']['idle_share']:.3f}; the parent's "
              f"(PERF.md §5) {med} ms, {p90} ms, idle "
              f"{'not measured' if idle is None else idle}")
        r["vs_eager_20_steps"] = _mhe_vs_eager(tag, mhe, ys, walls)
        rec[f"{part} {name}"] = r
        if not ok:
            raise RuntimeError(f"{tag}: a gate failed")
        del mhe

    # ---- (c): MHE against the Kalman filter, float64 -----------------------
    tag = "phase 13 (c): linear MHE against the Kalman filter float64"
    f64 = torch.float64
    rng = np.random.default_rng(7)
    A = np.array([[0.0, 1.0], [-2.0, -0.4]])
    C = np.array([[1.0, 0.0]])
    dt, sig_w, sig_v, T, H = 0.1, 0.4, 0.05, 24, 8
    Qc = np.diag([sig_w**2, sig_w**2])
    Ad, Qd = kalman.van_loan(torch.as_tensor(A, device=dev),
                             torch.as_tensor(Qc, device=dev), dt)
    Ad_np, Qd_np = Ad.cpu().numpy(), Qd.cpu().numpy()
    R = np.array([[sig_v**2]])
    m0, P0 = np.array([0.3, -0.2]), 0.5 * np.eye(2)
    x = rng.multivariate_normal(m0, P0)
    ys = []
    for _ in range(T):
        ys.append(C @ x + rng.multivariate_normal(np.zeros(1), R))
        x = Ad_np @ x + rng.multivariate_normal(np.zeros(2), Qd_np)
    ys = np.asarray(ys)
    kf = kalman.kalman_filter(
        torch.cat([torch.eye(2, dtype=f64, device=dev)[None],
                   Ad.expand(T - 1, 2, 2)]),
        torch.cat([torch.zeros(1, 2, 2, dtype=f64, device=dev),
                   Qd.expand(T - 1, 2, 2)]),
        C, R, torch.as_tensor(ys, device=dev), m0, P0, device=dev)
    mhe = MovingHorizonEstimator(
        LinearSystem(A, C=C), horizon=H, dt=dt, sig_w=sig_w, sig_v=sig_v,
        degree=4, substeps=8, options=SolverOptions(maxiter=30, gtol=1e-12),
        device=dev)
    its = []
    _reset_counts()
    ests, _, state = _serve(mhe, ys, m0, P0, its)
    cov = mhe.current_covariance(state).cpu().numpy()
    torch.cuda.synchronize()
    counts, plain = _counts()
    n_its = int(torch.stack(its).sum())
    keep(tag, counts, plain, {chain: n_its}, (8, 1))
    d_est = float(np.abs(ests - kf.mean_f[H - 1:].cpu().numpy()).max())
    d_cov = float(np.abs(cov - kf.cov_f[-1].cpu().numpy()).max())
    rec["(c) float64"] = dict(est_vs_kf=d_est, cov_vs_kf=d_cov,
                              iterations=n_its)
    print(f"{tag} (horizon {H}, degree 4, b = 8, T = {T}): max |estimate - "
          f"KF mean| {d_est:.3e} (<= 2e-6), max |covariance - KF's| "
          f"{d_cov:.3e} (<= 2e-6); {n_its} LM iterations = kernel #2 "
          f"launches at (8, 1), no plain call")
    if not (d_est <= 2e-6 and d_cov <= 2e-6):
        raise RuntimeError(f"{tag}: a gate failed")

    # ---- (d): the full-rule smoother parity, float64 -----------------------
    tag = "phase 13 (d): full-rule MAP path against the RTS smoother float64"
    A, sig_w, sig_v, t_meas, y, x_smooth = _simulate_and_smooth_linear()
    mesh = Mesh(make_basis(4), t_meas)
    prob = EstimationProblem.build(
        LinearSystem(A, C=np.array([[1.0, 0.0]])), mesh, t_meas,
        defect_weight=[1e3, 1.0 / sig_w], defect_rule="full", device=dev,
        dtype=f64)
    data = prob.pack_data(y[:, None], t_meas, meas_weight=1.0 / sig_v)
    z0 = prob.initial_guess_from_data(t_meas, y[:, None], p0=np.zeros(0))
    solve = make_gn_solver(prob, SolverOptions(maxiter=30, gtol=1e-8,
                                               xtol=1e-12))
    (z, st), first, counts = _counted(
        tag, lambda: _no_reads(f"{tag} first call", lambda: solve(z0, data)),
        lambda out: {chain: int(out[1].iterations)})
    keep(tag, counts, 0, {chain: counts[chain]}, (8, 1))
    x_map = interpolate_trajectory(mesh, z.V, t_meas).cpu().numpy()
    err = float(np.abs(x_map - x_smooth).max())
    print(f"{tag} (N = {mesh.num_elements}, degree 4, b = 8): converged "
          f"{bool(st.converged)} in {counts[chain]} iterations = kernel #2 "
          f"launches at (8, 1); max |x_MAP - x_RTS| {err:.3e} (< 1.5e-3); "
          f"first call (with the capture) {first:.4f} s")
    if not (bool(st.converged) and err < 1.5e-3):
        raise RuntimeError(f"{tag}: a gate failed")
    wall, eager_wall = _vs_eager(tag, solve, (z0, data), (z, st))
    rec["(d) float64"] = dict(converged=bool(st.converged), err=err,
                              iterations=counts[chain], wall_s=wall,
                              eager_wall_s=eager_wall, first_call_s=first)

    _pem_pipeline(dev, card, rec, keep, launches)
    return launches


def _pem_pipeline(dev, card, rec, keep, launches):
    """Phase 13 (e), examples/pem_kalman.py end to end from p0 (see
    _serving); ``keep`` records the MAP polish's launches into
    ``launches``."""
    import numpy as np
    import torch

    from collocfem_tpu_torch import kalman
    from collocfem_tpu_torch.models import Duffing
    from collocfem_tpu_torch.ops.mesh import uniform_mesh
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.solve.covariance import parameter_std
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    f64, kkt = torch.float64, "kkt_solve_spike_fused"
    tag = "phase 13 (e): Kalman/PEM pipeline float64"
    t_meas, y = _pem_data()
    model = Duffing(gamma=PEM_GAMMA, omega=PEM_OMEGA)
    R = np.array([[PEM_MEAS_NOISE**2]])
    Qc = np.diag([1e-8, PEM_PROC_NOISE**2])
    m0, P0 = np.array([float(y[0, 0]), 0.0]), np.diag([0.1, 4.0])
    nll = kalman.make_ekf_nll(model, t_meas, y, R, Qc, m0, P0, substeps=4,
                              device=dev)
    r = {}

    def value_and_grad(fn, p):
        x = torch.tensor(p, dtype=f64, device=dev, requires_grad=True)
        v = fn(x)
        return v.detach(), torch.autograd.grad(v, x)[0]

    def vs_jax(v, g, ref, absolute=False):
        """|rel diff| of the value, and of the gradient relative to max
        |g_JAX| (absolute where the JAX gradient is rounding noise)."""
        ref_g = np.asarray(ref[1])
        d_g = float(np.abs(g.cpu().numpy() - ref_g).max())
        return (abs(float(v) - ref[0]) / abs(ref[0]),
                d_g if absolute else d_g / float(np.abs(ref_g).max()))

    # At p0 over the whole record: the first call (it captures the EKF step
    # and its VJP) and a replay.  No kernel of the seven runs in the filter.
    _reset_counts()
    (v, g), first = _timed(lambda: value_and_grad(nll, PEM_P0))
    (v2, g2), wall = _timed(lambda: value_and_grad(nll, PEM_P0))
    _expect_only(*_counts(), {}, f"{tag} NLL")
    replayed = torch.equal(v, v2) and torch.equal(g, g2)
    d_jax = vs_jax(v, g, PEM_JAX_NLL_P0)
    print(f"{tag}: EKF NLL-and-gradient at p0 (400 samples, 4 RK4 "
          f"substeps) through the captured scan: {float(v)!r}, gradient "
          f"{g.tolist()}, against JAX {d_jax[0]:.3e} / {d_jax[1]:.3e} (<= "
          f"1e-9), a replay bit-identical {'ok' if replayed else 'FAIL'}; "
          f"wall {wall:.3f} s (first call, with the captures, {first:.3f} "
          f"s; the eager loop before the scan: {PEM_EAGER_S[0]} s) on "
          f"{card}")
    r["p0"] = dict(nll=float(v), grad=g.tolist(), nll_vs_jax=d_jax[0],
                   grad_vs_jax=d_jax[1], wall_s=wall, first_call_s=first)
    if not (replayed and max(d_jax) <= 1e-9):
        raise RuntimeError(f"{tag}: the NLL at p0 disagrees")

    # The same scan uncaptured and the tape-recording loop launch every op
    # from the host (tens of seconds each over the whole record), so they
    # run on the first PEM_PREFIX samples: captured =
    # uncaptured bit for bit, the loop within 1e-12, each within 1e-9 of the
    # JAX package's NLL of that prefix.
    nll_pre = kalman.make_ekf_nll(model, t_meas[:PEM_PREFIX], y[:PEM_PREFIX],
                                  R, Qc, m0, P0, substeps=4, device=dev)
    _reset_counts()
    (v, g), pre_first = _timed(lambda: value_and_grad(nll_pre, PEM_P0))
    (ve, ge), eager_wall = _timed(lambda: value_and_grad(nll_pre.eager,
                                                         PEM_P0))
    (vp, gp), plain_wall = _timed(lambda: value_and_grad(nll_pre.plain,
                                                         PEM_P0))
    _expect_only(*_counts(), {}, f"{tag} NLL of the prefix")
    same = torch.equal(v, ve) and torch.equal(g, ge)
    d_plain = (abs(float(v - vp)) / abs(float(vp)),
               float((g - gp).abs().max() / gp.abs().max()))
    d_pre = [vs_jax(a_, b_, PEM_JAX_NLL_P0_PREFIX)
             for a_, b_ in ((v, g), (vp, gp))]
    print(f"{tag}: the first {PEM_PREFIX} samples at p0: captured = "
          f"uncaptured scan bit for bit (value and gradient) "
          f"{'ok' if same else 'FAIL'}; the tape-recording loop within "
          f"{d_plain[0]:.3e} / {d_plain[1]:.3e} (<= 1e-12); against JAX (<= "
          f"1e-9): scan {d_pre[0][0]:.3e} / {d_pre[0][1]:.3e}, loop "
          f"{d_pre[1][0]:.3e} / {d_pre[1][1]:.3e}; wall captured (first "
          f"call) {pre_first:.3f} s, uncaptured {eager_wall:.3f} s, loop "
          f"{plain_wall:.3f} s")
    r["p0_prefix"] = dict(samples=PEM_PREFIX, captured_equals_eager=same,
                          plain_vs_scan=d_plain, scan_vs_jax=d_pre[0],
                          plain_vs_jax=d_pre[1], first_call_s=pre_first,
                          eager_wall_s=eager_wall, plain_wall_s=plain_wall)
    if not (same and max(d_plain) <= 1e-12 and max(d_pre[0] + d_pre[1])
            <= 1e-9):
        raise RuntimeError(f"{tag}: the NLL of the prefix disagrees")
    # torch.profiler takes minutes to process the whole record's ~1.6 M
    # kernels: profile 40 samples.
    nll40 = kalman.make_ekf_nll(model, t_meas[:40], y[:40], R, Qc, m0, P0,
                                substeps=4, device=dev)
    run40 = lambda: value_and_grad(nll40, PEM_P0)
    run40()
    r["profile_40_samples"] = _profile_run(
        "EKF NLL and gradient, 40 samples, captured", run40,
        _timed(run40)[1])

    # The PEM from p0, as the example runs it, every evaluation one replayed
    # value and gradient.
    evals = []

    def counted(x):
        evals.append(1)
        return nll(x)

    _reset_counts()
    (p_pem, (val, gnorm, its)), pem_wall = _timed(lambda: kalman.run_lbfgs(
        counted, PEM_P0, maxiter=150, device=dev))
    _expect_only(*_counts(), {}, f"{tag} PEM")
    p_pem = p_pem.tolist()
    d_pem = _p_dev(p_pem, PEM_JAX_OPT)
    d_val = abs(float(val) - PEM_JAX_NLL_OPT[0]) / abs(PEM_JAX_NLL_OPT[0])
    print(f"{tag}: PEM from p0 = {PEM_P0}: run_lbfgs(maxiter=150) took {its} "
          f"L-BFGS iterations and {len(evals)} NLL-and-gradient evaluations "
          f"(the JAX package: 18 iterations), |grad| {float(gnorm):.3e}; p = "
          f"{p_pem}, |p - p_JAX|/|p_JAX| {d_pem:.3e} (<= 1e-6), NLL "
          f"{float(val)!r}, |rel diff to JAX| {d_val:.3e} (<= 1e-9); wall "
          f"{pem_wall:.3f} s")
    r["pem"] = dict(p=p_pem, p_vs_jax=d_pem, nll=float(val),
                    nll_vs_jax=d_val, grad_norm=float(gnorm), iterations=its,
                    evaluations=len(evals), wall_s=pem_wall)
    if not (d_pem <= 1e-6 and d_val <= 1e-9):
        raise RuntimeError(f"{tag}: the PEM optimum disagrees")

    # At the JAX package's optimum, where the gradient is rounding noise
    # (~2e-11): held absolutely, at 1e-11.
    (v, g), wall = _timed(lambda: value_and_grad(nll, PEM_JAX_OPT))
    d_opt = vs_jax(v, g, PEM_JAX_NLL_OPT, absolute=True)
    print(f"{tag}: EKF NLL at the JAX optimum {float(v)!r} (|rel diff to "
          f"JAX| {d_opt[0]:.3e} <= 1e-9), gradient {g.tolist()} (max diff "
          f"absolute {d_opt[1]:.3e} <= 1e-11); captured {wall:.3f} s")
    r["optimum"] = dict(nll=float(v), grad=g.tolist(), nll_vs_jax=d_opt[0],
                        grad_vs_jax=d_opt[1], wall_s=wall)
    if not (d_opt[0] <= 1e-9 and d_opt[1] <= 1e-11):
        raise RuntimeError(f"{tag}: the NLL at the optimum disagrees")

    # The UKF NLL at p0 through its captured scan.
    unll = kalman.make_ukf_nll(model, t_meas, y, R, Qc, m0, P0, substeps=4,
                               device=dev)
    _reset_counts()
    _, ufirst = _timed(lambda: value_and_grad(unll, PEM_P0))
    (v, g), uwall = _timed(lambda: value_and_grad(unll, PEM_P0))
    _expect_only(*_counts(), {}, f"{tag} UKF NLL")
    d_ukf = vs_jax(v, g, PEM_JAX_UKF_P0)
    print(f"{tag}: UKF NLL at p0 {float(v)!r}, gradient {g.tolist()}; "
          f"against JAX {d_ukf[0]:.3e} / {d_ukf[1]:.3e} (<= 1e-9); captured "
          f"{uwall:.3f} s (first call {ufirst:.3f} s)")
    r["ukf_p0"] = dict(nll=float(v), grad=g.tolist(), nll_vs_jax=d_ukf[0],
                       grad_vs_jax=d_ukf[1], wall_s=uwall,
                       first_call_s=ufirst)
    if max(d_ukf) > 1e-9:
        raise RuntimeError(f"{tag}: the UKF NLL at p0 disagrees")

    mesh = uniform_mesh(0.0, PEM_TF, 200, 4)
    prob = EstimationProblem.build(model, mesh, t_meas,
                                   defect_weight=1.0 / PEM_PROC_NOISE,
                                   device=dev, dtype=f64)
    data = prob.pack_data(y, t_meas, meas_weight=1.0 / PEM_MEAS_NOISE,
                          p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
    # The rest of the path from the port's own PEM optimum: the captured
    # EKF and smoother scans, then the MAP polish.
    z0, wall = _timed(lambda: kalman.smoother_initial_guess(
        prob, t_meas, y, np.asarray(p_pem), R=R, Qc=Qc, m0=m0, P0=P0))
    V0 = z0.V.cpu().numpy()
    d_v0 = max(float(np.abs(V0[::50] - np.asarray(PEM_JAX_V0_EVERY_50)).max()),
               abs(float(V0.sum()) - PEM_JAX_V0_SUMS[0]) / abs(
                   PEM_JAX_V0_SUMS[0]),
               abs(float((V0**2).sum()) - PEM_JAX_V0_SUMS[1])
               / PEM_JAX_V0_SUMS[1])
    print(f"{tag}: smoother_initial_guess at the port's PEM optimum (the "
          f"JAX package's at its own): max diff of V0 at every 50th node and "
          f"of its sums to JAX {d_v0:.3e} (<= 1e-8); wall {wall:.3f} s (the "
          f"captured EKF and smoother scans; eager before the scan: "
          f"{PEM_EAGER_S[1]} s)")
    r["smoother_wall_s"] = wall
    options = SolverOptions(maxiter=60, gtol=1e-6, xtol=1e-10)
    solve = make_gn_solver(prob, options)
    (z, st), first, counts = _counted(
        f"{tag} MAP polish", lambda: _no_reads(
            f"{tag} MAP polish first call", lambda: solve(z0, data)),
        lambda out: _assembled({kkt: int(out[1].iterations)},
                               int(out[1].iterations)))
    keep(f"{tag} MAP polish", counts, 0, {kkt: counts[kkt], GN: counts[GN]},
         (8, 3))
    n_map = counts[kkt]
    wall, eager_wall = _vs_eager(f"{tag} MAP polish", solve, (z0, data),
                                 (z, st))
    p = z.p.tolist()
    d_p = _p_dev(p, PEM_JAX_MAP_P)
    (sd, sd_wall, counts) = _counted(
        f"{tag} parameter_std", lambda: parameter_std(prob, z, data),
        {"cr_level", "cr_backsub"})
    for k in ("cr_level", "cr_backsub"):
        launches[k] = launches.get(k, 0) + counts[k]
    _keep_shapes(["cr_level", "cr_backsub"])
    d_sd = _p_dev(sd.tolist(), PEM_JAX_STD)
    r.update(v0_vs_jax=d_v0, map_p=p, map_p_vs_jax=d_p,
             map_converged=bool(st.converged), map_iterations=n_map,
             map_wall_s=wall, map_eager_wall_s=eager_wall,
             map_first_call_s=first, std=sd.tolist(), std_vs_jax=d_sd,
             std_wall_s=sd_wall)
    rec["(e) float64"] = r
    print(f"{tag}: MAP polish (N = 200, b = 8, nq = 3) converged "
          f"{bool(st.converged)} in {n_map} iterations = kernel "
          f"#1 launches at (8, 3), p={p}, |p - p_JAX|/|p_JAX| {d_p:.3e} (<= "
          f"1e-6), wall {wall:.4f} s captured, {eager_wall:.4f} s eager "
          f"(first call, with the capture: {first:.4f} s); parameter_std "
          f"{sd.tolist()} (|rel diff "
          f"to JAX| {d_sd:.3e} <= 1e-6; kernels #3 and #6 {counts['cr_level']}"
          f" and {counts['cr_backsub']} launches), wall {sd_wall:.4f} s")
    if not (d_v0 <= 1e-8 and bool(st.converged) and d_p <= 1e-6
            and d_sd <= 1e-6):
        raise RuntimeError(f"{tag}: a gate failed")
    r["kernels_at_this_problem"] = _pem_shapes(prob, z0, z, data,
                                               options.lam0, card)


def _pem_shapes(prob, z0, z, data, lam, card):
    """Kernel #1 at the MAP polish's shape and kernels #3-#6 at
    parameter_std's, on examples/pem_kalman.py's problem (N = 200, degree 4,
    nq = 3: K = 201 blocks of b = 8), the float64 systems and the same cast
    to float32: #1 on the polish's damped KKT system at its initial guess
    z0 (dimensionless damping ``lam``) against its plain version by CUDA
    events, its device time by phase, its bound and the dense solve;
    #3-#6 on parameter_std's chain A X = B (r = nq) at the MAP solution z,
    every level and the sweeps held to their plain versions, timed with
    their bounds (#3 per level and #6 a sweep, as parameter_std calls
    them).  Returns the records."""
    import torch

    from collocfem_tpu_torch.ops import spike
    from collocfem_tpu_torch.ops.assemble import assemble_gn, assemble_gn_soa
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.solve.kkt import damping_scales
    from collocfem_tpu_torch.tools.spike_tiles import _split

    kkt64 = assemble_gn_soa(prob, z0, data)
    chain = assemble_gn(prob, z, data)
    Ds, Es = bt._pad_pow2_soa(chain.D.permute(1, 2, 0),
                              chain.E.permute(1, 2, 0))
    Bs = bt._pad_rhs(chain.B.permute(1, 2, 0), Ds.shape[-1]).contiguous()
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        sys_ = type(kkt64)(*(t.to(dtype) for t in kkt64))
        K, nq = sys_.num_blocks, sys_.C.shape[0]
        label = f"kernel #1 PEM MAP polish {name} K={K} nq={nq}"
        err = _compare(sys_, lam, None, label)
        call = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam)
        k_ms = _cuda_ms(lambda: spike.kkt_solve_spike_fused(*call), 20)
        p_ms = _cuda_ms(lambda: spike.kkt_solve_spike_fused_ref(*call), 3)
        split = _split(lambda: spike.kkt_solve_spike_fused(*call))
        dx, dp, _ = spike.kkt_solve_spike_fused(*call)
        lib_ms, shape, lib_rel = _dense_solve(
            sys_, damping_scales(sys_.D, sys_.C, lam)[0],
            torch.cat([dx.T.reshape(-1), dp]))
        bound = _kkt_bound(K, nq)
        rec = dict(K=K, nq=nq, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                   device_us=split, device_us_total=sum(split.values()),
                   library_ms=lib_ms, library_rel_diff=lib_rel,
                   bound_ms=bound[0], bound_by=bound[1])
        print(f"  {label}: kernel {k_ms:.3f} ms/call ("
              f"{sum(split.values()):.1f} us on the device: "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
              + f"), plain {p_ms:.3f} ms/call; torch.linalg.solve on the dense"
              f" damped KKT matrix {shape} (TF32 off) {lib_ms:.3f} ms/call "
              f"(rel diff to the kernel {lib_rel:.2e}); float32 bound "
              f"{bound[0] * 1e3:.3f} us ({bound[1]}) on {card}")

        padded = tuple(a.to(dtype) for a in (Ds, Es, Bs, Bs))
        r = padded[2].shape[1]
        clabel = f"CR parameter_std chain {name} K={K} r={r}"
        levels, tail = _cr_levels(*padded)
        for i, (D, E, G, B, *_) in enumerate(levels):
            _hold_cr(f"{clabel} level {i}", dtype, D, E, G, B)
        facs, s_gs, x_tail = _hold_cr_sweeps(
            clabel, levels, tail, *_cr_levels(*(a.double() for a in padded)))
        _hold_backsub_sweep(clabel, facs, s_gs, x_tail)
        ms, _ = _cr_times(levels, facs, s_gs, x_tail)
        bounds = _cr_bounds(levels, r, r)
        rec["cr"] = dict(levels=len(levels),
                         ms={k: v[0] for k, v in ms.items()},
                         plain_ms={k: v[1] for k, v in ms.items()},
                         bound_ms={k: v[0] for k, v in bounds.items()},
                         bound_by={k: v[1] for k, v in bounds.items()})
        for k, (k_ms, p_ms) in ms.items():
            print(f"  {clabel} {k}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
                  f"ms per solve ({len(levels)} levels); float32 bound "
                  f"{bounds[k][0] * 1e3:.3f} us ({bounds[k][1]})")
        out[name] = rec
    return out


def _steps(mhe, state, ys, k0, n, eager=False):
    """``n`` steps (``step_eager`` ones with ``eager``) from ``state`` on
    ys[k0:k0 + n]; returns the state."""
    step = mhe.step_eager if eager else mhe.step
    for k in range(k0, k0 + n):
        state, _ = step(state, ys[k])
    return state


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
    from collocfem_tpu_torch.solve import blocktri as bt
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.parallel.batch import (batch_cost,
                                                    make_multi_experiment_solver)
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.testing import (batch_residual, chain_residual,
                                             random_chain, random_chain_batch,
                                             random_kkt_system, rel_err)

    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    elapsed = lambda: print(f"  (elapsed {time.perf_counter() - start:.1f} s)",
                            flush=True)
    card = _card()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"phase 0: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----------------------------------------------------
    prebuild, new = _prebuild_set(), _new_instances()
    t0 = time.perf_counter()
    built = _build.load_all(prebuild + new)
    record["build_wall_s"] = time.perf_counter() - t0
    record["build_s"], record["ptxas"] = {}, {}
    print(f"phase 1: built {len(built)} instances ({len(prebuild)} of the "
          f"prebuild set, {len(new)} new) in {record['build_wall_s']:.1f} s "
          f"(one nvcc each, {os.cpu_count()} at once)")
    for inst, b in built.items():
        ptxas = _ptxas_summary(b.log)
        record["build_s"][inst.name] = b.seconds
        record["ptxas"][inst.name] = ptxas
        print(f"  {b.path.name}: {b.seconds:.1f} s "
              f"({'fresh' if b.seconds else 'reused'}"
              f"{'' if inst in prebuild else '; new'})")
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
        first = spike.kkt_solve_spike_fused(*call)
        again = spike.kkt_solve_spike_fused(*call)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first[:2], again[:2])):
            raise RuntimeError(f"headline {name}: two runs of kernel #1 "
                               "differ")
        print(f"  headline {name}: two runs bit-identical")
        for k in (*EDGES, 7, 1000, 10001):
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
        us = _device_us(lambda: thomas.batched_thomas_solve(Db, Eb, Gb),
                        "batched_thomas")
        record.setdefault("thomas_device_us", {})[name] = us
        print(f"  config 5 {name} thomas: {us:.1f} us on the device "
              "(torch.profiler)")
        if dtype == torch.float32:
            A, rhs = _dense_batch(Db, Eb, Gb)
            lib_ms = _cuda_ms(lambda: torch.linalg.solve(A, rhs), 20)
            lib_err = rel_err(torch.linalg.solve(A, rhs).reshape(Gb.shape),
                              thomas.batched_thomas_solve(Db, Eb, Gb))
            k7_shape = Db.shape[:2]
            print(f"  config 5 {name}: torch.linalg.solve on the dense "
                  f"{tuple(A.shape)} batch {lib_ms:.3f} ms/call (rel diff "
                  f"to kernel #7 {lib_err:.2e})")
            del A, rhs
        for k in (*EDGES, 7, 1000, 11264):
            for r in (1, 3):
                D, E, G = random_chain(k, 8, r, seed=k + r, boundary=11,
                                       dtype=dtype, device=dev)
                _hold(f"kernel #2 random {name} K={k} r={r}", dtype,
                      spike.blocktri_solve_spike_fused(D, E, G),
                      spike.blocktri_solve_spike_fused_ref(D, E, G),
                      lambda X: chain_residual(D, E, G, X))
        for n_exp in (1, 3, 5, 1000, 1023):
            for k in (1, 2, 11, 64):
                D, E, G = random_chain_batch(n_exp, k, 8, 3, seed=n_exp + k,
                                             dtype=dtype, device=dev)
                _hold(f"kernel #7 random {name} n_exp={n_exp} K={k}", dtype,
                      thomas.batched_thomas_solve(D, E, G),
                      thomas.batched_thomas_solve_ref(D, E, G),
                      lambda X: batch_residual(D, E, G, X))
    record["config5_ms"] = c5_ms

    cr_errs, cr_ms = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        padded, unpadded = _cr_headline_chain(dtype, dev, lam)
        levels, tail = _cr_levels(*padded)
        for i, (D, E, G, B, *_) in enumerate(levels):
            for k, v in _hold_cr(f"CR headline {name} level {i} "
                                 f"m={D.shape[-1]}", dtype, D, E, G,
                                 B).items():
                cr_errs[(k, name)] = max(cr_errs.get((k, name), 0.0), v)
        print(f"  kernels #3-#6 {name}: {len(levels)} levels of the headline "
              f"chain at N={ELEMENTS_CR} ok; max abs err "
              + ", ".join(f"{k} {v:.3e}" for (k, n), v in cr_errs.items()
                          if n == name))
        facs, s_gs, x_tail = _hold_cr_sweeps(
            f"CR sweeps {name}", levels, tail,
            *_cr_levels(*(a.double() for a in padded)))
        err = _hold_backsub_sweep(f"CR sweeps {name}", facs, s_gs, x_tail)
        cr_errs[("cr_backsub", name)] = max(cr_errs[("cr_backsub", name)],
                                            err)
        _hold_cr_solves(f"CR headline {name} K={unpadded[0].shape[-1]}",
                        dtype, *unpadded)
        cr_ms[name], per_level = _cr_times(levels, facs, s_gs, x_tail)
        record.setdefault("cr_per_level_calls_ms", {})[name] = per_level
        if dtype == torch.float32:
            bounds = _bounds(sys_.num_blocks, Dc.shape[-1], *k7_shape,
                             levels)
        for k, (k_ms, p_ms) in cr_ms[name].items():
            print(f"  {k} {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                  f"per solve ({len(levels)} levels)"
                  + (f"; one sweep call, against {per_level[k]:.3f} ms "
                     f"through {len(levels)} per-level calls"
                     if k in per_level else ""))
        del padded, unpadded, levels, tail, facs, s_gs, x_tail
        for k in (16, 17, 130, 1000):
            for r in (1, 2, 3):
                D, E, G = random_chain(k, 8, r, seed=k + r, dtype=dtype,
                                       device=dev)
                Dp, Ep = bt._pad_pow2_soa(D, E)
                _hold_cr(f"CR random {name} K={k} r={r}", dtype, Dp, Ep,
                         bt._pad_rhs(G, Dp.shape[-1]))
                _hold_cr_solves(f"CR random {name} K={k} r={r}", dtype,
                                D, E, G, G)
        print(f"  kernels #3-#6 {name}: seeded chains K in (16, 17, 130, "
              "1000), r in (1, 2, 3) ok")
    record["cr_ms"] = cr_ms
    record["config_shapes"] = _phase2_configs(dev, card)
    record["ocp_shapes"] = _phase2_ocp(dev, card)
    record["mhe_shapes"] = _phase2_mhe(dev, card)
    record["sp_shapes"] = _phase2_sp(dev, card)
    new_shapes = _phase2_new_shapes(dev, card)
    record["new_shapes"] = new_shapes
    dw_shapes = _phase2_cr_dw(dev, card, lam)
    record["dw_shapes"] = dw_shapes
    for k, v in dw_shapes.items():
        new_shapes.setdefault(k, []).extend(v)
    gn = _phase2_gn(dev, card)
    record["gn_shapes"] = {f"N={n} {d}": r for (n, d), r in gn.items()}
    fine = gn[(ELEMENTS_DW, "float32")]
    new_shapes[GN] = [dict(
        config=f"ladder fine level N={ELEMENTS_DW}", K=fine["K"], b=fine["b"],
        r=fine["nq"], max_abs_err=gn[(ELEMENTS_DW, "float64")]["max_abs_err"],
        ms=fine["ms"], plain_ms=fine["plain_ms"], bound_ms=fine["bound_ms"],
        bound_by=fine["bound_by"], library_ms=None)]
    elapsed()

    # ---- phase 3: headline fixed work, float32 -----------------------------
    prob, data, z0 = _headline(torch.float32, dev)
    opts = SolverOptions(maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0,
                         kkt_refine=0, lam0=3e-6, lam_max=1e30)
    solve = make_gn_solver(prob, opts)
    _reset_counts()
    z, stats = solve(z0, data)
    torch.cuda.synchronize()
    counts, plain_calls = _counts()
    _keep_shapes(["kkt_solve_spike_fused", GN])
    launches = counts["kkt_solve_spike_fused"]
    gn_launches = counts[GN]
    c0, c_end = float(prob.cost(z0, data)), float(stats.cost)
    walls = [_timed(lambda: solve(z0, data))[1] for _ in range(3)]
    p = z.p.tolist()
    print(f"phase 3: N={ELEMENTS} float32, 15 LM iterations: cost {c0:.6e} -> "
          f"{c_end:.6e}, p={p}, kernel launches {launches}, plain calls "
          f"{plain_calls}; best of 3 wall {min(walls):.4f} s captured on "
          f"{card}")
    if not (c_end < 0.1 * c0 and all(math.isfinite(v) for v in p)):
        raise RuntimeError("the fixed-work solve did no useful work")
    _expect_only(counts, plain_calls,
                 _assembled({"kkt_solve_spike_fused": 15}, 15), "phase 3")
    _, eager_wall = _vs_eager("phase 3", solve, (z0, data), (z, stats))
    record.update(fixed_work_wall_s=min(walls), fixed_work_walls_s=walls,
                  fixed_work_eager_wall_s=eager_wall,
                  fixed_work_profile=_profile_captured(
                      "phase 3", lambda: solve(z0, data), min(walls),
                      eager_wall),
                  fixed_work_cost=[c0, c_end], fixed_work_p=p,
                  fixed_work_accepts=stats.history[:, 4].tolist())

    # ---- phase 4: float64 convergence --------------------------------------
    prob, data, z0 = _headline(torch.float64, dev)
    solve = make_gn_solver(prob, SolverOptions(maxiter=60, gtol=1e-10,
                                               xtol=1e-12))
    (z, stats), first = _timed(lambda: _no_reads(
        "phase 4 first call", lambda: solve(z0, data)))
    p = z.p.tolist()
    p_err = max(abs(v - 1.0) for v in p)
    its = int(stats.iterations)
    print(f"phase 4: N={ELEMENTS} float64: {its} iterations, p={p}, "
          f"p err {p_err:.3e} (one-thread kernel: 2.95e-11); first call "
          f"(with the capture) {first:.3f} s on {card}")
    if not p_err < 1e-4:
        raise RuntimeError("the float64 solve did not reach ||p - 1|| < 1e-4")
    wall, eager_wall = _vs_eager("phase 4", solve, (z0, data), (z, stats))
    _beside_parent("phase 4", wall, None)
    record.update(f64_wall_s=wall, f64_eager_wall_s=eager_wall,
                  f64_first_call_s=first, f64_iterations=its, f64_p=p,
                  f64_p_err=p_err, f64_converged=bool(stats.converged))

    # ---- phase 5: config 5 fixed work, float32, both layouts ---------------
    prob, z0, data, p_prior, p_w = c5[torch.float32]
    c0 = float(batch_cost(prob, z0, data, p_prior, p_w))
    main_launches = {"kkt_solve_spike_fused": launches, GN: gn_launches}
    for layout, kname in (("soa", "blocktri_solve_spike_fused"),
                          ("blocks", "batched_thomas_solve")):
        solve = make_multi_experiment_solver(
            prob, SolverOptions(**C5_FIXED), layout=layout)
        _reset_counts()
        z, stats = solve(z0, data, p_prior, p_w)
        torch.cuda.synchronize()
        counts, plain_calls = _counts()
        _keep_shapes([kname])
        main_launches[kname] = counts[kname]
        c5_args = (z0, data, p_prior, p_w)
        walls = [_timed(lambda: solve(*c5_args))[1] for _ in range(3)]
        p = z.p.tolist()
        c_end = float(stats.cost)
        p_rel = max(abs(p[0] / MU_TRUE - 1.0), abs(p[1] / B_TRUE - 1.0))
        print(f"phase 5: config 5 {layout} {N_EXP}x10 float32, 15 LM "
              f"iterations: cost {c0:.6e} -> {c_end:.6e}, p={p}, p rel err "
              f"{p_rel:.4e}, {kname} launches {counts[kname]}, plain calls "
              f"{plain_calls}; best of 3 wall {min(walls):.4f} s captured "
              f"on {card}")
        if not (c_end < 0.1 * c0 and all(math.isfinite(v) for v in p)):
            raise RuntimeError(f"config 5 {layout} did no useful work")
        _expect_only(counts, plain_calls, {kname: 15}, f"phase 5 {layout}")
        _, eager_wall = _vs_eager(f"phase 5 {layout}", solve, c5_args,
                                  (z, stats))
        record[f"config5_{layout}"] = dict(
            wall_s=min(walls), walls_s=walls, eager_wall_s=eager_wall,
            profile=_profile_captured(f"phase 5 {layout}",
                                      lambda: solve(*c5_args), min(walls),
                                      eager_wall),
            cost=[c0, c_end], p=p, p_rel_err=p_rel, launches=counts,
            plain_calls=plain_calls, accepts=stats.history[:, 4].tolist())

    # ---- phase 6: config 5 float64 convergence -----------------------------
    prob, z0, data, p_prior, p_w = c5[torch.float64]
    solve = make_multi_experiment_solver(prob, SolverOptions(**C5_CONVERGED),
                                         layout="soa")
    c5_args = (z0, data, p_prior, p_w)
    (z, stats), first = _timed(lambda: _no_reads(
        "phase 6 first call", lambda: solve(*c5_args)))
    p = z.p.tolist()
    p_dev = _p_dev(p, P_JAX_F64)
    its = int(stats.iterations)
    print(f"phase 6: config 5 float64 soa: {its} iterations, p={p}, "
          f"|p - p_jax|/|p_jax| {p_dev:.3e} (<= 1e-6; one-thread kernel: "
          f"4.220e-11); first call (with the capture) {first:.3f} s on "
          f"{card}")
    if not p_dev <= 1e-6:
        raise RuntimeError("config 5 float64 p disagrees with the JAX "
                           "package's")
    wall, eager_wall = _vs_eager("phase 6", solve, c5_args, (z, stats))
    _beside_parent("phase 6", wall, None)
    record.update(config5_f64_wall_s=wall, config5_f64_eager_wall_s=eager_wall,
                  config5_f64_first_call_s=first, config5_f64_iterations=its,
                  config5_f64_p=p, config5_f64_p_vs_jax=p_dev)

    elapsed()
    for k, v in _phase7(dev, card, record).items():
        main_launches[k] = main_launches.get(k, 0) + v
    elapsed()

    # ---- phases 8, 9: configs 2 and 4 at full size -------------------------
    from collocfem_tpu_torch import configs

    for num, cname, build, fixed, converged, truth, jax_p, robust, bar in (
            (8, "config 2", configs.build_config2_problem, configs.C2_FIXED,
             configs.C2_CONVERGED, configs.P2_TRUE, C2_JAX_F64, "irls",
             0.15),
            (9, "config 4", configs.build_config4_problem, configs.C4_FIXED,
             configs.C4_CONVERGED, configs.P4_TRUE, C4_JAX_F64, "newton",
             None)):
        for k, v in _config_phase(num, cname, build, fixed, converged, truth,
                                  jax_p, robust, dev, card, record,
                                  bar).items():
            main_launches[k] = main_launches.get(k, 0) + v

    # ---- phases 10-13: config 3, the free-time OCP, constrained estimation,
    # the serving path and the Kalman tier ----------------------------------
    elapsed()
    for phase in (_ocp_solves, _constrained_estimation, _serving, _phase14,
                  _phase15, _phase16):
        for k, v in phase(dev, card, record).items():
            main_launches[k] = main_launches.get(k, 0) + v
        elapsed()

    peer_k = record["peer_kernel"]
    ms = {"kkt_solve_spike_fused": times["float32"],
          "blocktri_solve_spike_fused": c5_ms["float32"]["chain"],
          "batched_thomas_solve": c5_ms["float32"]["thomas"],
          **cr_ms["float32"],
          "peer_reduce": (peer_k["ms"], peer_k["plain_ms"]),
          GN: (gn[(ELEMENTS, "float32")]["ms"],
               gn[(ELEMENTS, "float32")]["plain_ms"])}
    err = {"kkt_solve_spike_fused": max_err,
           "blocktri_solve_spike_fused": errs[("chain", "float64")],
           "batched_thomas_solve": errs[("thomas", "float64")],
           **{k: cr_errs[(k, "float64")] for k in CR_NAMES},
           "peer_reduce": 0.0,    # bit for bit, or phase 14 raised
           GN: gn[(ELEMENTS, "float64")]["max_abs_err"]}
    bounds["peer_reduce"] = peer_k["bound"]
    bounds[GN] = (gn[(ELEMENTS, "float32")]["bound_ms"],
                  gn[(ELEMENTS, "float32")]["bound_by"])
    library = {"batched_thomas_solve": lib_ms,
               "peer_reduce": peer_k["library_ms"]}
    kernels = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": main_launches[name], "max_abs_err": err[name],
        "ms": ms[name][0], "plain_ms": ms[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": library.get(name),
        "shapes": _main_shapes(name, main_launches[name]),
        "at_configs": _at_configs(name, record["config_shapes"],
                                  record["ocp_shapes"],
                                  record["mhe_shapes"],
                                  record["sp_shapes"])
        + new_shapes.get(name, []),
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
