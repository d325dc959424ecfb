"""Inequality-constrained estimation: a log-barrier interior point over GN/LM.

Counterpart of ``collocfem_tpu/solve/constrained.py``.  Estimation with

  * nonlinear path constraints g(x, u, p, t) <= 0 (``model.g``, ng > 0)
    at every global collocation node (u from the experiment data), and
  * parameter-only constraints g_p(p) <= 0 (a ``g_param`` callable), e.g.
    stability or handling-quality specs on identified derivatives:

  outer o = 1..n_outer:
      inner: damped Gauss-Newton (``lm_loop``, gain mode) on
          Phi(z) = 0.5 ||r(z)||^2 - mu sum log(-g)     (all groups)
        with a linearized fraction-to-boundary + feasibility backtracking
        line search;
      mu <- max(mu mu_factor, mu_min).

The barrier's Gauss-Newton Hessian is per-node PSD and every node belongs to
one chain block, so the KKT keeps its block-tridiagonal + arrowhead
structure and the step solve is the estimation KKT solve.  The merit is the
float64 ``problem.cost`` plus the barrier, summed in float64 (in place of
the JAX package's double-word ``cost_dw``).  The outer loop is
``solve.bounds.barrier_homotopy``'s: on a CUDA device it replays from CUDA
graphs, and ``solve.eager`` runs it eagerly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from collocfem_tpu_torch.ops.assemble import (
    assemble_gn_soa,
    blocks_to_nodes_soa,
    node_block_scatter_soa,
)
from collocfem_tpu_torch.problem import Decision
from collocfem_tpu_torch.solve.auglag import (
    _barrier_value,
    backtrack_halvings,
    first_feasible_alpha,
)
from collocfem_tpu_torch.solve.bounds import (
    barrier_homotopy,
    pre_barrier_dmax,
)
from collocfem_tpu_torch.solve.kkt import resolve_method, solve_kkt_soa
from collocfem_tpu_torch.solve.lm_core import (
    LMAux,
    fused_quadforms,
    grad_inf_norm,
)

CONSTRAINED_HISTORY_COLS = ("cost", "grad_norm", "mu", "inner_iters")


@dataclasses.dataclass(frozen=True)
class ConstrainedOptions:
    """Static configuration of the inequality-constrained estimator."""

    n_outer: int = 10
    inner_maxiter: int = 30
    gtol: float = 1e-8        # inner gradient tolerance (floored at 0.1 mu)
    mu0: float = 1e-2
    mu_factor: float = 0.2
    mu_min: float = 1e-10
    lam0: float = 1e-6
    lam_min: float = 1e-14
    lam_max: float = 1e12
    ftb: float = 0.995        # fraction-to-boundary factor
    max_backtrack: int = 30   # feasibility-restoring halvings per step
    method: str = "auto"      # 'auto' | 'spike' | 'cr'


class ConstrainedStats(NamedTuple):
    cost: torch.Tensor       # () final estimation cost, float64 (no barrier)
    grad_norm: torch.Tensor  # () final barrier-augmented gradient inf-norm
    gviol: torch.Tensor      # () final max g (<= 0 means feasible)
    mu: torch.Tensor         # () the barrier parameter of the LAST
    #                          subproblem, which the returned iterate solves:
    #                          its multiplier estimates are nu_i = mu / -g_i
    history: torch.Tensor    # (n_outer, 4) per-outer table


def make_constrained_solver(problem,
                            options: ConstrainedOptions = ConstrainedOptions(),
                            *, g_param: Callable | None = None):
    """Build ``solve(z0, data) -> (z, ConstrainedStats)``.

    Constraints (all as <= 0): ``problem.model.g(x, u, p, t)`` at every
    global collocation node when the model declares ng > 0, and
    ``g_param(p)`` when given (a torch function (nq,) -> (m,) that works
    under ``torch.func.vmap`` and ``jacfwd``).  ``z0`` must be strictly
    feasible: the barrier merit is +inf outside, so an infeasible start
    takes no step.  On a CUDA device a call replays the whole homotopy from
    CUDA graphs (``solve.bounds.barrier_homotopy``); ``solve.eager(z0,
    data)`` runs the eager loop, with the same result bit for bit.
    """
    opt = options
    method = resolve_method(problem, opt.method)
    model, mesh = problem.model, problem.mesh
    d = mesh.degree
    nx, nq, nv = model.nx, model.nq, problem.nv
    num_nodes = problem.num_nodes
    dtype, device = problem.dtype, problem.device
    ng = int(model.ng)
    ngp = 0
    if g_param is not None:
        ngp = int(g_param(torch.zeros(nq, dtype=dtype, device=device))
                  .shape[0])
    if ng == 0 and ngp == 0:
        raise ValueError(
            "no constraints: model.ng == 0 and g_param is None; use the "
            "unconstrained solver (solve.newton) instead")
    node_times = torch.as_tensor(mesh.node_times, dtype=dtype, device=device)
    halvings = backtrack_halvings(opt.max_backtrack, dtype, device)

    def u_nodes(data):
        """(M, nu) input at the global nodes from the per-element table
        (a shared endpoint takes the left element's copy)."""
        u = data.u                                       # (N, d+1, nu)
        return torch.cat([u[:, :d].reshape(-1, u.shape[-1]), u[-1, d:]],
                         dim=0)[:num_nodes]

    def node_gvals(V, p, data):
        return vmap(model.g, in_dims=(0, 0, None, 0))(
            V[:, :nx], u_nodes(data), p, node_times)

    def all_g(z, data):
        """Stacked constraint values (M ng + ngp,), node-major."""
        parts = []
        if ng:
            parts.append(node_gvals(z.V, z.p, data).reshape(-1))
        if ngp:
            parts.append(g_param(z.p))
        return torch.cat(parts)

    def merit(z, data, mu):
        return problem.cost(z, data) + _barrier_value(
            all_g(z, data).double(), mu.double())

    def barrier_derivs(z, data):
        """Constraint values and Jacobians at z."""
        out = {}
        if ng:
            gv = node_gvals(z.V, z.p, data)                  # (M, ng)
            # Cast: forward-mode AD of 0-d scalar arithmetic can come out
            # float64 for float32 inputs.
            jgx, jgp = (j.to(dtype) for j in vmap(
                jacfwd(model.g, argnums=(0, 2)), in_dims=(0, 0, None, 0))(
                    z.V[:, :nx], u_nodes(data), z.p, node_times))
            out["node"] = (gv, jgx, jgp)        # (M, ng, nx), (M, ng, nq)
        if ngp:
            out["param"] = (g_param(z.p), jacfwd(g_param)(z.p).to(dtype))
        return out

    def add_barrier_terms(sys, derivs, mu):
        """Barrier gradient + PSD Gauss-Newton Hessian into the KKT."""
        if ng:
            gv, jgx, jgp = derivs["node"]
            w1 = mu / (-gv)                                  # (M, ng) > 0
            w2 = w1 / (-gv)
            sys = node_block_scatter_soa(
                sys, torch.einsum("mgi,mg,mgj->ijm", jgx, w2, jgx),
                torch.einsum("mgi,mg,mgq->iqm", jgx, w2, jgp),
                torch.einsum("mgi,mg->im", jgx, w1), d)
            sys = sys._replace(
                C=sys.C + torch.einsum("mgq,mg,mgr->qr", jgp, w2, jgp),
                gp=sys.gp + torch.einsum("mgq,mg->q", jgp, w1))
        if ngp:
            gp_v, jp = derivs["param"]
            w1 = mu / (-gp_v)
            w2 = w1 / (-gp_v)
            sys = sys._replace(
                C=sys.C + torch.einsum("gq,g,gr->qr", jp, w2, jp),
                gp=sys.gp + torch.einsum("gq,g->q", jp, w1))
        return sys

    def line_search_alpha(z, data, dV, dp, derivs):
        """Linearized fraction-to-boundary + feasibility backtracking."""
        dirs, gvs = [], []
        if ng:
            gv, jgx, jgp = derivs["node"]
            dg = torch.einsum("mgi,mi->mg", jgx, dV[:, :nx])
            if nq:
                dg = dg + torch.einsum("mgq,q->mg", jgp, dp)
            dirs.append(dg.reshape(-1))
            gvs.append(gv.reshape(-1))
        if ngp:
            gp_v, jp = derivs["param"]
            dirs.append(jp @ dp)
            gvs.append(gp_v)
        dgdir, gval = torch.cat(dirs), torch.cat(gvs)
        ratio = torch.where(
            dgdir > 0, opt.ftb * (-gval) / torch.clamp(dgdir, min=1e-300),
            torch.full_like(gval, math.inf))
        alpha0 = torch.clamp(ratio.min(), max=1.0)

        def infeasible(alphas):
            g_try = vmap(lambda a: all_g(
                Decision(V=z.V + a * dV, p=z.p + a * dp), data))(alphas)
            return (g_try >= 0).any(dim=1)

        return first_feasible_alpha(alpha0, halvings, infeasible)

    def trial(data, mu):
        """The inner LM's trial function on the barrier subproblem at mu
        (gain mode), with the line search above."""

        def trial_fn(z, carry, lam):
            derivs = barrier_derivs(z, data)
            sys_est = assemble_gn_soa(problem, z, data)
            # The damping scale from the estimation diagonal (see
            # solve.bounds.pre_barrier_dmax): the constrained optimum is
            # reached along the constraint surface.
            dmax = pre_barrier_dmax(sys_est)
            sys = add_barrier_terms(sys_est, derivs, mu)
            gnorm = grad_inf_norm(sys.gx, sys.gp)
            dx, dp = solve_kkt_soa(sys, lam, spike=method == "spike",
                                   damp_scale=dmax)
            dV = blocks_to_nodes_soa(dx, num_nodes, nv)
            alpha = line_search_alpha(z, data, dV, dp, derivs)
            z_try = Decision(V=z.V + alpha * dV, p=z.p + alpha * dp)
            gdot, snorm2 = fused_quadforms(sys.gx.reshape(-1), sys.gp,
                                           dx.reshape(-1), dp)
            aux = LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                        step_norm=alpha * torch.sqrt(snorm2), alpha=alpha)
            return z_try, carry, merit(z_try, data, mu), aux

        return trial_fn

    def finish(z, data, mu, hist):
        return z, ConstrainedStats(
            cost=problem.cost(z, data), grad_norm=hist[-1, 1],
            gviol=all_g(z, data).max(), mu=hist[-1, 2], history=hist)

    return barrier_homotopy(problem, opt, merit, trial, finish)


def constrained_gauss_newton(problem, z0, data,
                             options: ConstrainedOptions = ConstrainedOptions(),
                             *, g_param: Callable | None = None):
    """One-shot convenience wrapper around :func:`make_constrained_solver`."""
    return make_constrained_solver(problem, options, g_param=g_param)(z0,
                                                                      data)
