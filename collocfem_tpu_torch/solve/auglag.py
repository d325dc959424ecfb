"""Augmented-Lagrangian + log-barrier solver for constrained OCPs.

Counterpart of ``collocfem_tpu/solve/auglag.py``.  Equality constraints
(collocation defects, boundary conditions, equality path constraints
g_eq(x, u, p, t) = 0 at every node) enter through an augmented Lagrangian in
least-squares form, inequality path constraints g <= 0 through a log barrier
whose Gauss-Newton Hessian is per-node PSD, so every inner iteration is the
same damped block-tridiagonal (+ arrowhead) solve as estimation:

  outer k = 1..n_outer:
      inner: damped Gauss-Newton (``lm_loop`` in "decrease" mode) on
          Phi(z) = 0.5 ||sqrt(rho) c(z) + lam / sqrt(rho)||^2   (equalities)
                 + 0.5 ||cost residuals(z)||^2                  (objective)
                 - mu sum log(-g(z))                            (barrier)
        with a fraction-to-boundary + feasibility backtracking line search;
      lam <- lam + rho c(z);  mu <- max(mu mu_factor, mu_min);
      rho <- rho rho_up if ||c|| stalled.

The port has one layout, structure of arrays: every method runs the JAX
package's SoA branch (the block-major ``_node_block_scatter`` is not
ported).  The merit is float64 in place of the JAX package's double-word
``merit_dw``: the residuals stay in the working dtype, their squares and the
barrier are summed in float64.  On a CUDA device 'auto' runs the SPIKE
kernels (kernel #2 at nq = 0, kernel #1 with parameters); on the CPU, the
plain cyclic reduction.

Where the JAX package jits the whole homotopy (``fori_loop`` over the outer
rounds, ``while_loop`` inside), the port replays it from CUDA graphs on a
CUDA device (:class:`~collocfem_tpu_torch.solve.graph.CapturedOuterLoop`,
the outer carry an :class:`ALCarry`), and keeps the eager loop as
``solve.eager``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.func import jacfwd, vmap
from torch.utils._pytree import tree_map

from collocfem_tpu_torch.ops.assemble import (
    blocks_to_nodes_soa,
    node_block_scatter_soa,
    scatter_gn_blocks_soa,
)
from collocfem_tpu_torch.problem import Decision
from collocfem_tpu_torch.solve.graph import CapturedOuterLoop
from collocfem_tpu_torch.solve.kkt import resolve_method, solve_kkt_soa
from collocfem_tpu_torch.solve.lm_core import (
    LMAux,
    fused_quadforms,
    grad_inf_norm,
    lm_constants,
    lm_init,
    lm_loop,
    lm_step,
)

OUTER_HISTORY_COLS = (
    "objective", "cviol", "mu", "rho", "inner_iters", "grad_norm"
)


@dataclasses.dataclass(frozen=True)
class ALBarrierOptions:
    """Static configuration of the AL + barrier OCP solver.  (The JAX
    package's ``ctol``, ``lam_up`` and ``lam_down`` are read by nothing
    there: the inner ladder is lm_core's fixed x0.2 / x5.  Not ported.)"""

    n_outer: int = 14
    inner_maxiter: int = 40
    gtol: float = 1e-8        # inner gradient tolerance (floored at 0.1 mu)
    # rho0 = 100 with mu0 = 0.1 reaches the swing-up's global basin in both
    # precisions (the JAX package's measurement; rho0 = 10, mu0 = 1 falls
    # into an infeasible local minimizer of ||c||^2 in float32).
    rho0: float = 100.0
    rho_up: float = 10.0
    rho_max: float = 1e8
    cviol_ratio: float = 0.25  # required violation decrease before rho_up
    mu0: float = 0.1
    mu_factor: float = 0.2
    mu_min: float = 1e-9
    lam0: float = 1e-3
    lam_min: float = 1e-14
    lam_max: float = 1e12
    ftb: float = 0.995        # fraction-to-boundary factor
    max_backtrack: int = 30
    # 'auto': the SPIKE CUDA kernels on a CUDA device, the plain cyclic
    # reduction on the CPU.  'cr': the CR kernels on a CUDA device.
    method: str = "auto"      # 'auto' | 'spike' | 'cr'


class OCPStats(NamedTuple):
    objective: torch.Tensor  # () final objective (no constraint terms)
    cviol: torch.Tensor      # () final max |c|
    gviol: torch.Tensor      # () final max g (<= 0 means feasible)
    grad_norm: torch.Tensor  # () final inner gradient inf-norm
    history: torch.Tensor    # (n_outer, 6) per-outer-iteration table
    multipliers: Any         # final equality multipliers (Multipliers)
    mu: torch.Tensor         # () final barrier parameter (nu_i = mu / -g_i)


class ALCarry(NamedTuple):
    """The outer carry of the AL homotopy (:func:`make_ocp_solver`)."""

    z: Decision
    mult: Any              # equality multipliers (Multipliers)
    rho: torch.Tensor      # () penalty of the next subproblem
    mu: torch.Tensor       # () barrier parameter of the next subproblem
    lam: torch.Tensor      # () the next inner solve's warm-start damping
    cviol: torch.Tensor    # () max |c| after the last round (inf at first)
    history: torch.Tensor  # (n_outer, 6) per-outer table
    o: torch.Tensor        # () int64 index of the next outer round


def _barrier_value(g, mu):
    """-mu sum log(-g); +inf when any g >= 0, so infeasible trials reject."""
    safe = torch.where(g < 0, -g, torch.ones_like(g))
    val = -mu * torch.sum(torch.log(safe))
    return torch.where(torch.any(g >= 0), torch.full_like(val, math.inf),
                       val)


def _amax_abs(x):
    """max |x| over every entry, 0 for an empty x (shape-only branch)."""
    return x.abs().max() if x.numel() else x.new_zeros(())


def backtrack_halvings(max_backtrack: int, dtype, device):
    """The (max_backtrack + 1,) factors 2^-j of :func:`first_feasible_alpha`.
    Building them copies from the host, so a solver builds them once."""
    return torch.tensor([0.5**j for j in range(max_backtrack + 1)],
                        dtype=dtype, device=device)


def first_feasible_alpha(alpha0, halvings, infeasible):
    """alpha0 halved until ``infeasible(alpha)`` is False, at most
    max_backtrack times: the JAX package's ``while_loop``, as one batched
    test of the max_backtrack + 1 candidates alpha0 2^-j (``halvings``, from
    :func:`backtrack_halvings`).  The first feasible candidate wins; when
    none of the first max_backtrack is feasible, the last one is taken,
    feasible or not.  ``infeasible`` maps (J,) candidates to (J,) flags.  No
    copy from the host and no read to it, so a CUDA graph can capture it:
    the last flag is set by a fill (``stop[-1] = True`` copies a host
    scalar) and the winner picked by ``index_select`` (indexing by a 0-d
    tensor reads the index back)."""
    alphas = alpha0 * halvings
    feasible = ~infeasible(alphas)
    stop = torch.cat([feasible[:-1], feasible.new_ones(1)])
    first = torch.argmax(stop.to(torch.int32)).reshape(1)
    return alphas.index_select(0, first).reshape(())


def make_ocp_solver(problem, options: ALBarrierOptions = ALBarrierOptions()):
    """Build ``solve(z0) -> (z, OCPStats)`` for ``problem`` (an
    :class:`~collocfem_tpu_torch.ocp.OptimalControlProblem`);
    ``solve.first_system(z)`` gives the KKT system its first inner
    iteration would solve at z.

    ``z0`` must be strictly feasible for the path constraints (g(z0) < 0 at
    every node); use ``problem.initial_guess()``.  On a CUDA device a call
    replays the whole homotopy from CUDA graphs (captured at the first call
    of each input shape); on the CPU it runs the eager loop, which
    ``solve.eager(z0)`` runs on any device with the same result bit for bit.
    """
    opt = options
    method = resolve_method(problem, opt.method)
    model, mesh = problem.model, problem.mesh
    n, d = mesh.num_elements, mesh.degree
    nv, nx, nq = problem.nv, model.nx, model.nq
    ng, ne = model.ng, model.ne
    k = n + 1
    num_nodes = problem.num_nodes
    dtype, device = problem.dtype, problem.device
    # Every constant is made here, once: a copy from the host inside a
    # captured function is what a CUDA graph capture refuses.
    scalar = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt, device=device)
    halvings = backtrack_halvings(opt.max_backtrack, dtype, device)
    rho0, mu0, lam0 = scalar(opt.rho0), scalar(opt.mu0), scalar(opt.lam0)
    inf, neg_inf = scalar(math.inf), scalar(-math.inf)
    o0 = scalar(0, torch.int64)
    hist0 = torch.zeros((opt.n_outer, len(OUTER_HISTORY_COLS)), dtype=dtype,
                        device=device)
    mult0 = problem.zero_multipliers()
    consts = lm_constants(opt.lam0, maxiter=opt.inner_maxiter, dtype=dtype,
                          device=device)
    eps = torch.finfo(dtype).eps
    lm_args = dict(xtol=1e-15, lam_min=opt.lam_min, lam_max=opt.lam_max,
                   accept_mode="decrease")

    # -- element residual in AL least-squares form ---------------------------
    def elem_res(ve_flat, p, lam_e, sqrt_rho, width, times, cscale, qscale):
        c = problem.elem_constraints(ve_flat, p, width, times, cscale)
        r_al = sqrt_rho * c + lam_e / sqrt_rho
        lr = problem.elem_cost_residual(ve_flat, p, times, qscale)
        return torch.cat([r_al.reshape(-1), lr.reshape(-1)])

    def elem_residuals(z, mult, sr):
        return vmap(elem_res, in_dims=(0, None, 0, None, 0, 0, 0, 0))(
            problem.gather_elements(z.V), z.p, mult.defect, sr,
            problem.widths, problem.elem_times, problem.cscale,
            problem.qscale)

    def boundary_terms(z, mult, rho):
        """AL residuals of the two boundary-condition groups."""
        x, _ = problem.split(z.V)
        sr = torch.sqrt(rho)
        r0 = sr * problem.x0_mask * (x[0] - problem.x0_val) + mult.b0 / sr
        rf = sr * problem.xf_mask * (x[-1] - problem.xf_val) + mult.bf / sr
        return r0 * problem.x0_mask, rf * problem.xf_mask

    def node_g(v_n, p, t_n):
        return model.g(v_n[:nx], v_n[nx:], p, t_n)

    def node_eq_res(v_n, p, lam_n, sr, t_n):
        return sr * model.g_eq(v_n[:nx], v_n[nx:], p, t_n) + lam_n / sr

    # -- merit: float64 sums (must stay gradient-consistent with assemble) ----
    def merit(z, mult, rho, mu):
        sr = torch.sqrt(rho)
        r0, rf = boundary_terms(z, mult, rho)
        x, _ = problem.split(z.V)
        parts = [elem_residuals(z, mult, sr).reshape(-1), r0, rf,
                 model.terminal_cost_residual(x[-1], z.p)]
        if ne:
            parts.append(vmap(node_eq_res, in_dims=(0, None, 0, None, 0))(
                z.V, z.p, mult.path_eq, sr, problem.node_times).reshape(-1))
        r = torch.cat(parts).double()
        g = problem.path_constraints(z).double()
        return 0.5 * torch.sum(r * r) + _barrier_value(g, mu.double())

    # -- assembly -------------------------------------------------------------
    def assemble(z, mult, rho, mu):
        sr = torch.sqrt(rho)

        def per_elem(ve_flat, lam_e, width, times, cscale, qscale):
            def res_aux(ve_, p_):
                r = elem_res(ve_, p_, lam_e, sr, width, times, cscale,
                             qscale)
                return r, r

            (jx, jp), r = jacfwd(res_aux, argnums=(0, 1), has_aux=True)(
                ve_flat, z.p)
            return r, jx.to(dtype), jp.to(dtype)

        r, jx, jp = vmap(per_elem)(
            problem.gather_elements(z.V), mult.defect, problem.widths,
            problem.elem_times, problem.cscale, problem.qscale)
        # Element- and node-last contractions, scattered by static slices.
        sys = scatter_gn_blocks_soa(
            torch.einsum("emi,emj->ije", jx, jx),
            torch.einsum("emi,emq->iqe", jx, jp),
            torch.einsum("emq,emr->qr", jp, jp),
            torch.einsum("emi,em->ie", jx, r),
            torch.einsum("emq,em->q", jp, r),
            num_blocks=k, nv=nv, overlap=nv, dtype=dtype)

        # Boundary conditions: analytic diagonal terms.  Node 0 -> block 0;
        # node M-1 = N d -> block K-1 at offset 0.
        r0, rf = boundary_terms(z, mult, rho)
        x, _ = problem.split(z.V)
        D, B, C, gx, gp = sys.D, sys.B, sys.C, sys.gx, sys.gp
        ix = torch.arange(nx, device=D.device)
        D[ix, ix, 0] += rho * problem.x0_mask
        D[ix, ix, k - 1] += rho * problem.xf_mask
        gx[:nx, 0] += sr * r0
        tr = model.terminal_cost_residual(x[-1], z.p)
        if tr.numel():
            jt_x, jt_p = (j.to(dtype) for j in jacfwd(
                model.terminal_cost_residual, argnums=(0, 1))(x[-1], z.p))
            D[:nx, :nx, k - 1] += torch.einsum("mi,mj->ij", jt_x, jt_x)
            B[:nx, :, k - 1] += torch.einsum("mi,mq->iq", jt_x, jt_p)
            C = C + torch.einsum("mq,mr->qr", jt_p, jt_p)
            gp = gp + torch.einsum("mq,m->q", jt_p, tr)
            gx[:nx, k - 1] += sr * rf + torch.einsum("mi,m->i", jt_x, tr)
        else:
            gx[:nx, k - 1] += sr * rf
        sys = sys._replace(C=C, gp=gp)

        # Log barrier: per-node gradient and PSD Gauss-Newton Hessian.  (Every
        # Jacobian here is cast to the working dtype: forward-mode AD of a
        # model's 0-d scalar arithmetic, u[0] - u_max, can come out float64
        # for float32 inputs.)
        gvals = vmap(node_g, in_dims=(0, None, 0))(z.V, z.p,
                                                   problem.node_times)
        jgv, jgp = (j.to(dtype) for j in vmap(
            jacfwd(node_g, argnums=(0, 1)), in_dims=(0, None, 0))(
                z.V, z.p, problem.node_times))
        if ng:
            w1 = mu / (-gvals)                               # (M, ng) > 0
            w2 = w1 / (-gvals)                               # mu / g^2
            sys = node_block_scatter_soa(
                sys, torch.einsum("mgi,mg,mgj->ijm", jgv, w2, jgv),
                torch.einsum("mgi,mg,mgq->iqm", jgv, w2, jgp),
                torch.einsum("mgi,mg->im", jgv, w1), d)
            sys = sys._replace(
                C=sys.C + torch.einsum("mgq,mg,mgr->qr", jgp, w2, jgp),
                gp=sys.gp + torch.einsum("mgq,mg->q", jgp, w1))

        # Equality path constraints: per-node AL residuals, Gauss-Newton
        # terms in the same block-diagonal landing zone as the barrier.
        if ne:
            def per_node(v_n, lam_n, t_n):
                def res_aux(v_, p_):
                    r_n = node_eq_res(v_, p_, lam_n, sr, t_n)
                    return r_n, r_n

                (jv, jp_n), r_n = jacfwd(res_aux, argnums=(0, 1),
                                         has_aux=True)(v_n, z.p)
                return r_n, jv.to(dtype), jp_n.to(dtype)

            r_eq, jev, jep = vmap(per_node)(z.V, mult.path_eq,
                                            problem.node_times)
            sys = node_block_scatter_soa(
                sys, torch.einsum("mei,mej->ijm", jev, jev),
                torch.einsum("mei,meq->iqm", jev, jep),
                torch.einsum("mei,me->im", jev, r_eq), d)
            sys = sys._replace(
                C=sys.C + torch.einsum("meq,mer->qr", jep, jep),
                gp=sys.gp + torch.einsum("meq,me->q", jep, r_eq))
        return sys, gvals, jgv, jgp

    # -- fraction-to-boundary + feasibility backtracking ----------------------
    def line_search_alpha(z, dV, dp, gvals, jgv, jgp):
        dgdir = torch.einsum("mgi,mi->mg", jgv, dV)
        if nq:
            dgdir = dgdir + torch.einsum("mgq,q->mg", jgp, dp)
        ratio = torch.where(
            dgdir > 0, opt.ftb * (-gvals) / torch.clamp(dgdir, min=1e-300),
            torch.full_like(gvals, math.inf))
        alpha0 = torch.clamp(ratio.min() if ratio.numel() else inf, max=1.0)

        def infeasible(alphas):
            g_try = vmap(lambda a: problem.path_constraints(
                Decision(V=z.V + a * dV, p=z.p + a * dp)))(alphas)
            return (g_try >= 0).flatten(1).any(dim=1)

        return first_feasible_alpha(alpha0, halvings, infeasible)

    # -- inner damped GN loop -------------------------------------------------
    def trial(mult, rho, mu):
        """The inner LM's trial function on the AL/barrier subproblem at
        (mult, rho, mu), in decrease mode on the float64 merit with the
        fixed damping ladder: the step is fraction-to-boundary and
        feasibility clipped, and alpha enters the predicted decrease."""

        def trial_fn(z, carry, lam):
            sys, gvals, jgv, jgp = assemble(z, mult, rho, mu)
            gnorm = grad_inf_norm(sys.gx, sys.gp)
            dx, dp, dmax = solve_kkt_soa(sys, lam, spike=method == "spike",
                                         with_dmax=True)
            dV = blocks_to_nodes_soa(dx, num_nodes, nv)
            alpha = line_search_alpha(z, dV, dp, gvals, jgv, jgp)
            z_try = Decision(V=z.V + alpha * dV, p=z.p + alpha * dp)
            gdot, snorm2 = fused_quadforms(sys.gx.reshape(-1), sys.gp,
                                           dx.reshape(-1), dp)
            aux = LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                        step_norm=alpha * torch.sqrt(snorm2), alpha=alpha)
            return z_try, carry, merit(z_try, mult, rho, mu), aux

        return trial_fn

    def inner_gtol(mu):
        # The inner tolerance loosens with mu: no point polishing a barrier
        # subproblem below its own bias.
        return torch.clamp(0.1 * mu, min=opt.gtol)

    # -- outer AL loop: the five functions CapturedOuterLoop captures ---------
    def prelude(z0):
        return ALCarry(z=z0, mult=mult0, rho=rho0, mu=mu0, lam=lam0,
                       cviol=inf, history=hist0, o=o0)

    def begin(carry, z0):
        st = lm_init(carry.z, (),
                     merit(carry.z, carry.mult, carry.rho, carry.mu),
                     consts._replace(lam=torch.clamp(carry.lam, min=eps)))
        return st, inner_gtol(carry.mu)

    def step(inner, carry, z0):
        st, gtol = inner
        return lm_step(st, trial(carry.mult, carry.rho, carry.mu), gtol=gtol,
                       **lm_args), gtol

    def end(inner, carry, z0):
        """Multipliers by the old rho, the history row (the old mu and
        rho), then rho if ||c|| stalled, then mu; the warm start is the
        inner solve's damping clamped to 1e3."""
        st = inner[0]
        z, rho = st.z, carry.rho
        c = problem.constraints(z)
        cviol = torch.stack([_amax_abs(c.defect), _amax_abs(c.b0),
                             _amax_abs(c.bf), _amax_abs(c.path_eq)]).max()
        row = torch.stack([problem.objective(z), cviol, carry.mu, rho,
                           st.it.to(dtype), st.gnorm])
        return ALCarry(
            z=z, mult=tree_map(lambda l, ci: l + rho * ci, carry.mult, c),
            rho=torch.where(cviol > opt.cviol_ratio * carry.cviol,
                            torch.clamp(rho * opt.rho_up, max=opt.rho_max),
                            rho),
            mu=torch.clamp(carry.mu * opt.mu_factor, min=opt.mu_min),
            lam=torch.clamp(st.lam, max=1e3), cviol=cviol,
            history=carry.history.index_copy(0, carry.o.reshape(1),
                                             row[None]),
            o=carry.o + 1)

    def finish(carry, z0):
        g = problem.path_constraints(carry.z)
        return carry.z, OCPStats(
            objective=problem.objective(carry.z), cviol=carry.cviol,
            gviol=g.max() if g.numel() else neg_inf,
            grad_norm=carry.history[-1, 5], history=carry.history,
            multipliers=carry.mult, mu=carry.mu)

    def eager(z0):
        """The same outer functions around the eager inner loop."""
        carry = prelude(z0)
        for _ in range(opt.n_outer):
            st = lm_loop(carry.z, (),
                         merit(carry.z, carry.mult, carry.rho, carry.mu),
                         trial(carry.mult, carry.rho, carry.mu),
                         maxiter=opt.inner_maxiter, lam0=carry.lam,
                         gtol=inner_gtol(carry.mu), dtype=dtype, **lm_args)
            carry = end((st, None), carry, z0)
        return finish(carry, z0)

    def first_system(z):
        """The undamped KKT system of the first subproblem at ``z`` (zero
        multipliers, rho0, mu0): what its first inner iteration solves."""
        return assemble(z, mult0, rho0, mu0)[0]

    solve = CapturedOuterLoop(prelude, begin, step, end, finish, eager,
                              n_outer=opt.n_outer, maxiter=opt.inner_maxiter)
    solve.first_system = first_system
    return solve


def solve_ocp(problem, z0=None, options: ALBarrierOptions = ALBarrierOptions()):
    """One-shot convenience wrapper around :func:`make_ocp_solver`."""
    if z0 is None:
        z0 = problem.initial_guess()
    return make_ocp_solver(problem, options)(z0)
