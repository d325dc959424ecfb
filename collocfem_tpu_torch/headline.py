"""The headline estimation problem: Van der Pol on a uniform LGL mesh.

:func:`build_headline_problem` is the counterpart of
``baseline_cpu/run_baseline.py::build_headline_problem``, in numpy and scipy
only: the same horizon, measurement times, reference trajectory
(``solve_ivp`` at rtol 1e-10, atol 1e-11) and input at the collocation
nodes.  :func:`converged_schedule` is the per-level schedule of ``bench.py``'s
converged run (``run_converged``), with float64 levels where the JAX package
runs its double-word tiers past :data:`refine.CR_DW_CHAIN`, and
:class:`ConvergedLadder` runs it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.integrate import solve_ivp

from collocfem_tpu_torch import refine
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.mesh import make_prolongation, uniform_mesh
from collocfem_tpu_torch.problem import Decision, EstimationProblem, ProblemData
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
from collocfem_tpu_torch.utils.profiling import device_span, span

MU_TRUE, B_TRUE = 1.0, 1.0
TF = 10.0


def build_headline_problem(num_elements: int, degree: int = 4):
    """Returns (mesh, t_meas (N,), y (N, 1), u_nodes (N, d+1, 1))."""
    mesh = uniform_mesh(0.0, TF, num_elements, degree)
    t_meas = np.linspace(0.02, TF - 0.02, num_elements)
    sol = solve_ivp(
        lambda t, x: [
            x[1],
            MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * np.sin(0.9 * t),
        ],
        (0, TF), [1.0, 0.0], rtol=1e-10, atol=1e-11, dense_output=True,
    )
    y = sol.sol(t_meas)[0][:, None]
    u_nodes = np.sin(0.9 * mesh.elem_times)[..., None]
    return mesh, t_meas, y, u_nodes


def headline_problem(num_elements: int, *, dtype, device):
    """``bench.py``'s headline estimation at ``num_elements``: (prob, data,
    z0), defect weight 100, the initial guess from the data with p0 =
    (0.5, 0.5)."""
    mesh, t_meas, y, u_nodes = build_headline_problem(num_elements)
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=100.0, device=device,
                                   dtype=dtype)
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    return prob, data, prob.initial_guess_from_data(t_meas, y,
                                                    p0=[0.5, 0.5])


# The TPU's fused SPIKE kernel holds the chain in VMEM up to 16,384 blocks
# at b = 8, r = 3 (collocfem_tpu/ops/spike_pallas.py:60,65-73); 'auto' runs
# longer chains through the per-level cyclic reduction
# (collocfem_tpu/solve/kkt.py:21-37).  The ladder gives each level that
# method, so the fine level at N = 20,000 runs 'cr' here too.
TPU_SPIKE_CHAIN = 16_384


class ScheduledLevel(NamedTuple):
    elements: int
    dtype: torch.dtype
    options: SolverOptions


def _method(elements: int) -> str:
    return "cr" if elements + 1 > TPU_SPIKE_CHAIN else "auto"


def converged_schedule(elements: int, dtype) -> list[ScheduledLevel]:
    """``bench.run_converged``'s levels at ``elements``, coarsest first,
    every one with ``gtol=0`` (the lambda rail ends each level).

    Up to :data:`refine.CR_DW_CHAIN` blocks: three uniform meshes, each 4x
    coarser than the next (:func:`refine.level_sizes`), 60 / 30 / 30 LM
    iterations, lam0 3e-6 on the cold level and 1e-9 on the warm ones, all
    in ``dtype``.  Past it (``bench.py:142-158``): a cold level at
    ``elements // 16`` (60 iterations, lam0 3e-6) in ``dtype``, a polish on
    the same mesh (80, 1e-9) and the fine level (40, 1e-9) on
    ``method='cr'``.  Where the JAX package runs the polish with
    ``state_dw=True`` and the fine level with ``state_dw=True`` and
    ``method='cr_dw'``, both levels here are float64.  A level whose chain
    exceeds the TPU's fused kernel (:data:`TPU_SPIKE_CHAIN`) runs 'cr', as
    the JAX package's 'auto' does there; the others 'auto'.
    """
    if elements + 1 > refine.CR_DW_CHAIN:
        nc = max(2, elements // 16)
        return [
            ScheduledLevel(nc, dtype, SolverOptions(
                maxiter=60, gtol=0.0, lam0=3e-6, method=_method(nc))),
            ScheduledLevel(nc, torch.float64, SolverOptions(
                maxiter=80, gtol=0.0, lam0=1e-9, method=_method(nc))),
            ScheduledLevel(elements, torch.float64, SolverOptions(
                maxiter=40, gtol=0.0, lam0=1e-9, method="cr")),
        ]
    return [ScheduledLevel(n, dtype, SolverOptions(
        maxiter=60 if i == 0 else 30, gtol=0.0, lam0=3e-6 if i == 0 else 1e-9,
        method=_method(n))) for i, n in enumerate(refine.level_sizes(elements))]


class LadderLevel(NamedTuple):
    elements: int
    options: SolverOptions
    problem: EstimationProblem
    data: ProblemData
    solve: object        # make_gn_solver(problem, options)
    prolong: object      # previous level's V -> this level's V0, or None


class ConvergedLadder:
    """``bench.run_converged``'s warm-started nested iteration on the
    headline problem, level by level as :func:`converged_schedule` gives
    it: each level in its own dtype, warm-started from the previous one's
    solution cast to that dtype (on the same mesh as it is, else through
    the device prolongation).

    Every level's problem, data, solver and prolongation is built here, up
    front, in that level's dtype; calling the ladder runs it from the cold
    initial guess and returns (z, stats) of the finest level.
    """

    def __init__(self, elements: int, *, device, dtype):
        _, self.t_meas, self.y, _ = build_headline_problem(elements)
        self.levels = []
        prev = None
        for n, level_dtype, opts in converged_schedule(elements, dtype):
            mesh = uniform_mesh(0.0, TF, n, 4)
            prob = EstimationProblem.build(VanDerPol(), mesh, self.t_meas,
                                           defect_weight=100.0, device=device,
                                           dtype=level_dtype)
            data = prob.pack_data(
                self.y, self.t_meas,
                u_nodes=np.sin(0.9 * mesh.elem_times)[..., None])
            prolong = (None if prev is None
                       or prev.num_elements == mesh.num_elements
                       else make_prolongation(prev, mesh.node_times,
                                              device=device,
                                              dtype=level_dtype))
            self.levels.append(LadderLevel(n, opts, prob, data,
                                           make_gn_solver(prob, opts),
                                           prolong))
            prev = mesh

    def __call__(self, on_level=None):
        """Run every level; ``on_level(index, z, stats)`` is called after
        each one.  Returns (z, stats) of the last level.  Each level's solve
        replays its CUDA graphs on a CUDA device (captured at its first
        call); the casts and the prolongation between levels run eagerly.
        Level i is the host span ``ladder.level[i]``, the cold initial guess
        ``ladder.initial_guess`` and the casts and prolongation the device
        span ``ladder.prolong``."""
        return self._run(on_level, lambda lvl: lvl.solve)

    def eager(self, on_level=None):
        """The ladder with every level on its solve's eager loop: the same
        result bit for bit."""
        return self._run(on_level, lambda lvl: lvl.solve.eager)

    def _run(self, on_level, solver_of):
        z = None
        for i, lvl in enumerate(self.levels):
            with span(f"ladder.level[{i}]"):
                z, stats = self._level(lvl, z, solver_of)
            if on_level is not None:
                on_level(i, z, stats)
        return z, stats

    def _level(self, lvl, z, solver_of):
        dtype, device = lvl.problem.dtype, lvl.problem.device
        if z is None:
            with span("ladder.initial_guess"):
                z0 = lvl.problem.initial_guess_from_data(self.t_meas, self.y,
                                                         p0=[0.5, 0.5])
        else:
            with device_span("ladder.prolong", device):
                V = z.V.to(dtype)
                # The same mesh (a polish level) takes V as it is.
                z0 = Decision(V=V if lvl.prolong is None
                              else lvl.prolong(V), p=z.p.to(dtype))
        return solver_of(lvl)(z0, lvl.data)
