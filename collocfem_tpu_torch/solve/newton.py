"""Gauss-Newton / Newton / IRLS Levenberg-Marquardt solvers.

Counterpart of ``collocfem_tpu/solve/newton.py`` (all but the double-word
state tier).  In the Gauss-Newton branch each iteration solves the damped
KKT system assembled at the current iterate, assembles at the trial
iterate, and reads the trial cost off that assembly's own residuals; the
assembled system rides the LM carry, so an accepted step starts the next
iteration with its system already built.  The exact-Newton branch
(``hessian='newton'``) assembles the full Hessian at the current iterate and
takes the trial cost from a separate float64 residual pass
(``problem.cost``, in place of the JAX package's double-word ``cost_dw``).
:func:`make_irls_solver` wraps either in Huber reweighting rounds.  The
accept/damping logic is :func:`collocfem_tpu_torch.solve.lm_core.lm_loop`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from collocfem_tpu_torch.ops.assemble import (
    assemble_gn_soa,
    assemble_newton,
    blocks_to_nodes_soa,
)
from collocfem_tpu_torch.problem import Decision
from collocfem_tpu_torch.solve.kkt import resolve_method, solve_kkt_soa
from collocfem_tpu_torch.solve.lm_core import (
    HISTORY_COLS,
    LMAux,
    fused_quadforms,
    grad_inf_norm,
    lm_loop,
)

__all__ = ["HISTORY_COLS", "SolverOptions", "SolveStats", "make_gn_solver",
           "make_irls_solver"]


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
    irls_delta: float = 0.0  # > 0 enables Huber IRLS reweighting
    # 'gn' drops the curvature term sum_i r_i hess(r_i); 'newton' assembles
    # the exact per-element Hessian (ops.assemble.assemble_newton).
    hessian: str = "gn"      # 'gn' | 'newton'
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
    if opt.hessian not in ("gn", "newton"):
        raise ValueError(f"hessian must be 'gn' or 'newton', not "
                         f"{opt.hessian!r}")
    if opt.state_dw:
        raise NotImplementedError(
            "state_dw is not ported: float64 takes its place (ROADMAP queue "
            "A)")
    method = resolve_method(problem, opt.method, opt.kkt_refine)
    nv = problem.nv
    num_nodes = problem.num_nodes

    def step(z, sys, lam):
        """The damped KKT step from z on the assembled ``sys``: (z_try,
        LMAux)."""
        gnorm = grad_inf_norm(sys.gx, sys.gp)
        dx, dp, dmax = solve_kkt_soa(sys, lam, opt.kkt_refine,
                                     spike=method == "spike", with_dmax=True)
        z_try = Decision(V=z.V + blocks_to_nodes_soa(dx, num_nodes, nv),
                         p=z.p + dp)
        gdot, snorm2 = fused_quadforms(sys.gx.reshape(-1), sys.gp,
                                       dx.reshape(-1), dp)
        return z_try, LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                            step_norm=torch.sqrt(snorm2))

    def solve(z0: Decision, data):
        if opt.hessian == "newton":
            # The exact-Newton assembly has no residual vector to reuse, so
            # the trial cost is a separate float64 residual pass.
            def trial_fn(z, carry, lam):
                z_try, aux = step(z, assemble_newton(problem, z, data), lam)
                return z_try, carry, problem.cost(z_try, data), aux

            carry0, c0 = (), problem.cost(z0, data)
        else:
            def trial_fn(z, sys, lam):
                z_try, aux = step(z, sys, lam)
                sys_try, ct = assemble_gn_soa(problem, z_try, data,
                                              with_cost=True)
                return z_try, sys_try, ct, aux

            carry0, c0 = assemble_gn_soa(problem, z0, data, with_cost=True)
        st = lm_loop(
            z0, carry0, c0, trial_fn,
            maxiter=opt.maxiter, lam0=opt.lam0,
            gtol=opt.gtol, ftol=opt.ftol, xtol=opt.xtol,
            lam_min=opt.lam_min, lam_max=opt.lam_max, dtype=z0.V.dtype,
        )
        return st.z, SolveStats(
            iterations=st.it, converged=st.done, cost=st.cost,
            grad_norm=st.gnorm, lam=st.lam, history=st.history,
        )

    return solve


def make_irls_solver(problem, options: SolverOptions = SolverOptions(),
                     n_rounds: int = 4):
    """Huber-robust estimation: iteratively reweighted Gauss-Newton.

    Counterpart of the JAX package's ``make_irls_solver``.  Each round
    solves the weighted least-squares problem with :func:`make_gn_solver`,
    then recomputes per-sample Huber weights w = min(1, delta / |r|) from
    the measurement residuals under the BASE weights, damping outliers.
    ``options.irls_delta`` is the Huber threshold in units of weighted
    residual (sigmas when ``meas_weight`` is 1 / sigma).

    Returns ``solve(z0, data) -> (z, stats, data_weighted)``.  ``stats`` is
    the tuple of every round's :class:`SolveStats` (``n_rounds + 1`` of
    them; the JAX package returns only the last), so a caller can count the
    LM iterations of the whole run.  ``data_weighted`` carries the final
    per-sample weights (N, S, ny).
    """
    if options.irls_delta <= 0:
        raise ValueError("set options.irls_delta > 0 for IRLS")
    delta = options.irls_delta
    inner = make_gn_solver(problem, options)

    def reweight(z, data, base_w):
        r = problem.measurement_residuals(z, data._replace(meas_w=base_w))
        w = torch.clamp(delta / torch.clamp(r.abs(), min=1e-30), max=1.0)
        return data._replace(meas_w=base_w * torch.sqrt(w))

    def solve(z0, data):
        base_w = data.meas_w.expand(*problem.mmask.shape, problem.model.ny)
        z, stats = inner(z0, data)
        rounds = [stats]
        for _ in range(n_rounds):
            data = reweight(z, data, base_w)
            z, stats = inner(z, data)
            rounds.append(stats)
        return z, tuple(rounds), data

    return solve
