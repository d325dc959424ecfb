"""Gauss-Newton / Levenberg-Marquardt driver.

Counterpart of the plain Gauss-Newton branch of
``collocfem_tpu/solve/newton.py``.  Each iteration solves the damped KKT
system assembled at the current iterate, assembles at the trial iterate, and
reads the trial cost off that assembly's own residuals; the assembled system
rides the LM carry, so an accepted step starts the next iteration with its
system already built.  The accept/damping logic is
:func:`collocfem_tpu_torch.solve.lm_core.lm_loop`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from collocfem_tpu_torch.ops.assemble import assemble_gn_soa, blocks_to_nodes_soa
from collocfem_tpu_torch.problem import Decision
from collocfem_tpu_torch.solve.kkt import (
    require_cr_shapes,
    resolve_auto_method,
    solve_kkt_soa,
)
from collocfem_tpu_torch.solve.lm_core import (
    HISTORY_COLS,
    LMAux,
    fused_quadforms,
    grad_inf_norm,
    lm_loop,
)

__all__ = ["HISTORY_COLS", "SolverOptions", "SolveStats", "make_gn_solver"]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration."""

    maxiter: int = 50
    gtol: float = 1e-10
    ftol: float = 0.0
    xtol: float = 0.0
    # lam is DIMENSIONLESS: the damping added is lam * max(diag(H)) * I.
    lam0: float = 1e-9
    lam_min: float = 1e-14
    lam_max: float = 1e12
    # 'auto': the SPIKE CUDA kernels on a CUDA device, cyclic reduction on
    # the CPU.  'cr': the per-level CR kernels on a CUDA device.  'cr_dw'
    # (double-word CR) is not ported: float64 takes its place.
    method: str = "auto"     # 'auto' | 'spike' | 'cr'
    kkt_refine: int = 0      # iterative-refinement passes per KKT solve
    hessian: str = "gn"      # only 'gn' is ported
    state_dw: bool = False   # not ported


class SolveStats(NamedTuple):
    iterations: torch.Tensor  # () int
    converged: torch.Tensor   # () bool
    cost: torch.Tensor        # () final cost, float64
    grad_norm: torch.Tensor   # () final gradient inf-norm
    lam: torch.Tensor         # () final damping
    history: torch.Tensor     # (maxiter, 5) per-iteration table


def make_gn_solver(problem, options: SolverOptions = SolverOptions()):
    """Build ``solve(z0, data) -> (z, SolveStats)`` for ``problem``."""
    opt = options
    if opt.hessian != "gn":
        raise NotImplementedError(
            "hessian='newton' is not ported yet (ROADMAP queue A, Newton and "
            "IRLS)")
    if opt.state_dw:
        raise NotImplementedError(
            "state_dw is not ported: float64 takes its place (ROADMAP queue "
            "A, Newton and IRLS)")
    if opt.method == "cr_dw":
        raise NotImplementedError(
            "method='cr_dw' is not ported: float64 takes the place of the "
            "double-word factorisation (ROADMAP queue A)")
    method = opt.method
    block_size = problem.mesh.degree * problem.nv
    if method == "auto":
        method = resolve_auto_method(block_size, problem.model.nq,
                                     problem.device, opt.kkt_refine)
    if method not in ("spike", "cr"):
        raise ValueError(f"unknown method {method!r}")
    if method == "cr":
        require_cr_shapes(block_size, problem.model.nq, problem.device,
                          opt.kkt_refine)
    nv = problem.nv
    num_nodes = problem.num_nodes

    def solve(z0: Decision, data):
        def trial_fn(z, sys, lam):
            gnorm = grad_inf_norm(sys.gx, sys.gp)
            dx, dp, dmax = solve_kkt_soa(sys, lam, opt.kkt_refine,
                                         spike=method == "spike",
                                         with_dmax=True)
            z_try = Decision(V=z.V + blocks_to_nodes_soa(dx, num_nodes, nv),
                             p=z.p + dp)
            sys_try, ct = assemble_gn_soa(problem, z_try, data,
                                          with_cost=True)
            gdot, snorm2 = fused_quadforms(sys.gx.reshape(-1), sys.gp,
                                           dx.reshape(-1), dp)
            aux = LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                        step_norm=torch.sqrt(snorm2))
            return z_try, sys_try, ct, aux

        sys0, c0 = assemble_gn_soa(problem, z0, data, with_cost=True)
        st = lm_loop(
            z0, sys0, c0, trial_fn,
            maxiter=opt.maxiter, lam0=opt.lam0,
            gtol=opt.gtol, ftol=opt.ftol, xtol=opt.xtol,
            lam_min=opt.lam_min, lam_max=opt.lam_max, dtype=z0.V.dtype,
        )
        return st.z, SolveStats(
            iterations=st.it, converged=st.done, cost=st.cost,
            grad_norm=st.gnorm, lam=st.lam, history=st.history,
        )

    return solve
