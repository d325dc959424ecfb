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
accept/damping logic is :func:`collocfem_tpu_torch.solve.lm_core.lm_step`.
Where the JAX package jits the solve, the port replays it from CUDA graphs
on a CUDA device (:mod:`collocfem_tpu_torch.solve.graph`); each solve keeps
its eager loop (:func:`~collocfem_tpu_torch.solve.lm_core.lm_loop`) as
``solve.eager``.
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
from collocfem_tpu_torch.solve.graph import CapturedSolve
from collocfem_tpu_torch.solve.kkt import resolve_method, solve_kkt_soa
from collocfem_tpu_torch.solve.lm_core import (
    HISTORY_COLS,
    LMAux,
    fused_quadforms,
    grad_inf_norm,
    lm_constants,
    lm_init,
    lm_loop,
    lm_step,
    stops_early,
)
from collocfem_tpu_torch.utils.profiling import device_span

__all__ = ["HISTORY_COLS", "SolverOptions", "SolveStats", "captured_lm_solve",
           "make_gn_solver", "make_irls_solver"]


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


def captured_lm_solve(initial, trial, options: SolverOptions, *,
                      refused=None):
    """A :class:`solve.graph.CapturedSolve` of the LM loop whose initial
    (carry, cost) is ``initial(*inputs)`` and whose trial function is
    ``trial(*inputs)``; the first input is z0.  It returns (z,
    :class:`SolveStats`), and ``.eager`` runs :func:`lm_core.lm_loop`.  The
    initial state's constants are made once per dtype and device.  The
    initial state is the device span ``lm.prelude``, each iteration
    ``lm.step`` (:class:`solve.graph.CapturedSolve`, :func:`lm_core.lm_loop`)
    and the outputs ``lm.finish``.
    ``refused``: see :class:`solve.graph.CapturedSolve`."""
    opt = options
    lm_args = dict(gtol=opt.gtol, ftol=opt.ftol, xtol=opt.xtol,
                   lam_min=opt.lam_min, lam_max=opt.lam_max)
    consts = {}

    def finish(st):
        with device_span("lm.finish", st.lam.device):
            return st.z, SolveStats(iterations=st.it, converged=st.done,
                                    cost=st.cost, grad_norm=st.gnorm,
                                    lam=st.lam, history=st.history)

    def eager(z0, *inputs):
        with device_span("lm.prelude", z0.V.device):
            carry0, c0 = initial(z0, *inputs)
        return finish(lm_loop(z0, carry0, c0, trial(z0, *inputs),
                              maxiter=opt.maxiter, lam0=opt.lam0,
                              dtype=z0.V.dtype, **lm_args))

    def prelude(z0, *inputs):
        key = (z0.V.dtype, z0.V.device)
        if key not in consts:
            consts[key] = lm_constants(opt.lam0, maxiter=opt.maxiter,
                                       dtype=z0.V.dtype, device=z0.V.device)
        return lm_init(z0, *initial(z0, *inputs), consts[key])

    def step(st, *inputs):
        return lm_step(st, trial(*inputs), **lm_args)

    return CapturedSolve(prelude, step, finish, eager, maxiter=opt.maxiter,
                         early_exit=stops_early(opt.gtol, opt.ftol, opt.xtol),
                         refused=refused)


def make_gn_solver(problem, options: SolverOptions = SolverOptions()):
    """Build ``solve(z0, data) -> (z, SolveStats)`` for ``problem``.

    Counterpart of the JAX package's jitted ``solve``: on a CUDA device a
    call replays CUDA graphs of the assembly at z0 and of one LM iteration
    (captured at the first call of each input shape, :mod:`solve.graph`);
    on the CPU it runs the eager loop, which ``solve.eager(z0, data)`` runs
    on any device with the same result bit for bit.
    """
    opt = options
    if opt.hessian not in ("gn", "newton"):
        raise ValueError(f"hessian must be 'gn' or 'newton', not "
                         f"{opt.hessian!r}")
    if opt.state_dw:
        raise NotImplementedError(
            "state_dw is not ported: a float64 level takes its place, as "
            "headline.ConvergedLadder runs its polish and fine levels past "
            "refine.CR_DW_CHAIN")
    method = resolve_method(problem, opt.method, opt.kkt_refine)
    nv = problem.nv
    num_nodes = problem.num_nodes

    def step(z, sys, lam):
        """The damped KKT step from z on the assembled ``sys``: (z_try,
        LMAux)."""
        gnorm = grad_inf_norm(sys.gx, sys.gp)
        with device_span("kkt", lam.device):
            dx, dp, dmax = solve_kkt_soa(sys, lam, opt.kkt_refine,
                                         spike=method == "spike",
                                         with_dmax=True)
        z_try = Decision(V=z.V + blocks_to_nodes_soa(dx, num_nodes, nv),
                         p=z.p + dp)
        gdot, snorm2 = fused_quadforms(sys.gx.reshape(-1), sys.gp,
                                       dx.reshape(-1), dp)
        return z_try, LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                            step_norm=torch.sqrt(snorm2))

    if opt.hessian == "newton":
        # The exact-Newton assembly has no residual vector to reuse, so the
        # trial cost is a separate float64 residual pass.
        def initial(z0, data):
            return (), problem.cost(z0, data)

        def trial(z0, data):
            def trial_fn(z, carry, lam):
                with device_span("assemble", lam.device):
                    sys = assemble_newton(problem, z, data)
                z_try, aux = step(z, sys, lam)
                with device_span("assemble", lam.device):
                    ct = problem.cost(z_try, data)
                return z_try, carry, ct, aux
            return trial_fn
    else:
        def initial(z0, data):
            with device_span("assemble", z0.V.device):
                return assemble_gn_soa(problem, z0, data, with_cost=True)

        def trial(z0, data):
            def trial_fn(z, sys, lam):
                z_try, aux = step(z, sys, lam)
                return (z_try, *initial(z_try, data), aux)
            return trial_fn

    return captured_lm_solve(initial, trial, opt)


def gauss_newton(problem, z0, data, options: SolverOptions = SolverOptions()):
    """One-shot wrapper around :func:`make_gn_solver`: (z, SolveStats)."""
    return make_gn_solver(problem, options)(z0, data)


def make_irls_solver(problem, options: SolverOptions = SolverOptions(),
                     n_rounds: int = 4, inner_solver=None):
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
    per-sample weights (N, S, ny).  Each round's solve is
    :func:`make_gn_solver`'s (captured on a CUDA device); the reweighting
    between rounds runs eagerly.  ``solve.eager`` runs every round on the
    inner solver's eager loop (``inner.eager``, or the inner solver itself
    where it has none).

    ``inner_solver`` swaps the per-round solver, e.g.
    ``parallel.sharded.make_sp_gn_solver(problem, dev_mesh, options)`` for
    element-chain-sharded robust estimation (the reweighting works on
    global tensors either way).
    """
    if options.irls_delta <= 0:
        raise ValueError("set options.irls_delta > 0 for IRLS")
    delta = options.irls_delta
    inner = inner_solver or make_gn_solver(problem, options)

    def reweight(z, data, base_w):
        r = problem.measurement_residuals(z, data._replace(meas_w=base_w))
        w = torch.clamp(delta / torch.clamp(r.abs(), min=1e-30), max=1.0)
        return data._replace(meas_w=base_w * torch.sqrt(w))

    def rounds_of(inner_solve):
        def solve(z0, data):
            base_w = data.meas_w.expand(*problem.mmask.shape,
                                        problem.model.ny)
            z, stats = inner_solve(z0, data)
            rounds = [stats]
            for _ in range(n_rounds):
                data = reweight(z, data, base_w)
                z, stats = inner_solve(z, data)
                rounds.append(stats)
            return z, tuple(rounds), data
        return solve

    solve = rounds_of(inner)
    solve.eager = rounds_of(getattr(inner, "eager", inner))
    return solve
