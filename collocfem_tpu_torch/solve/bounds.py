"""Bound-constrained estimation: a log-barrier interior point around GN/LM.

Counterpart of ``collocfem_tpu/solve/bounds.py``:

  outer o = 1..n_outer:
      inner: damped Gauss-Newton (``lm_loop``, gain mode) on
          Phi(z) = 0.5 ||r(z)||^2                        (estimation cost)
                 - mu sum log(p - p_lo) + log(p_hi - p)   (parameter bounds)
                 - mu sum log(x - x_lo) + log(x_hi - x)   (per-node states)
        with the exact fraction-to-boundary step clip of box bounds;
      mu <- max(mu mu_factor, mu_min).

The barrier Hessian of box bounds is diagonal: a diagonal add to the D
blocks (one slot per collocation node) and to the corner C, so the step
solve is the estimation KKT solve.  The merit is the float64
``problem.cost`` (in place of the JAX package's double-word ``cost_dw``)
plus the barrier, summed in float64.

Where the JAX package jits the whole homotopy (``fori_loop`` over the outer
iterations, ``while_loop`` inside), the port replays it from CUDA graphs on
a CUDA device (:func:`barrier_homotopy`, shared with
``solve.constrained``; :class:`~collocfem_tpu_torch.solve.graph.
CapturedOuterLoop`), and keeps the eager loop as ``solve.eager``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from collocfem_tpu_torch.ops.assemble import (
    assemble_gn_soa,
    blocks_to_nodes_soa,
    node_block_scatter_soa,
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

BOUNDS_HISTORY_COLS = ("cost", "grad_norm", "mu", "inner_iters")


class Bounds(NamedTuple):
    """Box bounds; entries are +-inf where unconstrained.

    p_lo/p_hi: (nq,) parameter bounds.
    x_lo/x_hi: (nx,) state bounds, enforced at every collocation node.
    """

    p_lo: np.ndarray
    p_hi: np.ndarray
    x_lo: np.ndarray
    x_hi: np.ndarray


def make_bounds(problem, p_lo=None, p_hi=None, x_lo=None, x_hi=None) -> Bounds:
    """Build a :class:`Bounds` for ``problem``; ``None`` entries (whole
    argument or per component) mean unbounded."""
    nq, nx = problem.model.nq, problem.model.nx

    def fill(spec, n, sign, name):
        out = np.full((n,), sign * np.inf)
        if spec is not None:
            flat = np.ravel(np.asarray(spec, dtype=object))
            if np.ndim(spec) == 0:
                # A bare scalar bounds every component, explicitly.
                flat = np.broadcast_to(flat, (n,))
            elif flat.size != n:
                raise ValueError(
                    f"{name} has {flat.size} entries but needs {n} "
                    "(one per component; use None for unbounded entries)")
            out[:] = [sign * np.inf if s is None else s for s in flat]
        return out

    b = Bounds(
        p_lo=fill(p_lo, nq, -1.0, "p_lo"), p_hi=fill(p_hi, nq, +1.0, "p_hi"),
        x_lo=fill(x_lo, nx, -1.0, "x_lo"), x_hi=fill(x_hi, nx, +1.0, "x_hi"),
    )
    if np.any(b.p_lo >= b.p_hi) or np.any(b.x_lo >= b.x_hi):
        raise ValueError("lower bounds must be strictly below upper bounds")
    return b


def project_interior(z0: Decision, b: Bounds, margin: float = 1e-2) -> Decision:
    """Clip ``z0`` into the strict interior of ``b``.

    The barrier needs a strictly feasible start; components outside (or on)
    a bound are pulled in by ``margin`` (absolute for one-sided bounds,
    relative to the box width for two-sided)."""

    def pull(v, lo, hi):
        width = np.where(np.isfinite(lo) & np.isfinite(hi), hi - lo, 1.0)
        eps = margin * width
        lo_in = np.where(np.isfinite(lo), lo + eps, -np.inf)
        hi_in = np.where(np.isfinite(hi), hi - eps, np.inf)
        as_t = lambda a: torch.as_tensor(a, dtype=v.dtype, device=v.device)
        return torch.clamp(v, min=as_t(lo_in), max=as_t(hi_in))

    return Decision(V=pull(z0.V, b.x_lo, b.x_hi), p=pull(z0.p, b.p_lo, b.p_hi))


@dataclasses.dataclass(frozen=True)
class BoundedOptions:
    """Static configuration of the bounded estimation solver (the JAX
    package's unused ``lam_up`` / ``lam_down`` are not ported)."""

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
    method: str = "auto"      # 'auto' | 'spike' | 'cr'


class BoundedStats(NamedTuple):
    cost: torch.Tensor       # () final estimation cost, float64 (no barrier)
    grad_norm: torch.Tensor  # () final barrier-augmented gradient inf-norm
    mu: torch.Tensor         # () final barrier parameter
    history: torch.Tensor    # (n_outer, 4) per-outer table


def pre_barrier_dmax(sys):
    """The damping scale from the estimation diagonal, before the barrier:
    its 1 / slack^2 wall inflates the diagonal by ~1 / mu at active
    constraints, and lam times that wall would crush progress along the
    free coordinates."""
    dmax = torch.diagonal(sys.D, dim1=0, dim2=1).max()
    return torch.maximum(dmax, torch.diagonal(sys.C).max()) if \
        sys.C.shape[0] else dmax


class BarrierCarry(NamedTuple):
    """The outer carry of the barrier homotopy (:func:`barrier_homotopy`)."""

    z: Decision
    mu: torch.Tensor       # () barrier parameter of the next subproblem
    lam: torch.Tensor      # () the next inner solve's warm-start damping
    history: torch.Tensor  # (n_outer, 4) per-outer table
    o: torch.Tensor        # () int64 index of the next outer iteration


def barrier_homotopy(problem, opt, merit, trial, finish):
    """The interior-point drivers' outer loop, captured: n_outer barrier
    subproblems, each an inner gain-mode LM solve warm-started at the last
    one's damping (clamped to 1e3) with gtol = max(0.1 mu, opt.gtol), then
    mu <- max(mu mu_factor, mu_min).

    ``merit(z, data, mu)`` is the float64 merit, ``trial(data, mu)`` the
    inner LM's trial function and ``finish(z, data, mu, history)`` what the
    solve returns.  Returns a :class:`solve.graph.CapturedOuterLoop` of
    (z0, data) whose ``.eager`` is the Python loop over ``lm_loop``.  The
    initial mu, lam and history, and the inner solves' constants, are made
    here, once; the captured functions copy nothing from the host."""
    dtype, device = problem.dtype, problem.device
    scalar = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt, device=device)
    mu0, lam0, o0 = scalar(opt.mu0), scalar(opt.lam0), scalar(0, torch.int64)
    hist0 = torch.zeros((opt.n_outer, len(BOUNDS_HISTORY_COLS)), dtype=dtype,
                        device=device)
    consts = lm_constants(opt.lam0, maxiter=opt.inner_maxiter, dtype=dtype,
                          device=device)
    eps = torch.finfo(dtype).eps
    lm_args = dict(xtol=1e-15, lam_min=opt.lam_min, lam_max=opt.lam_max)

    def inner_gtol(mu):
        return torch.clamp(0.1 * mu, min=opt.gtol)

    def row(st, data, mu):
        return torch.stack([problem.cost(st.z, data).to(dtype), st.gnorm, mu,
                            st.it.to(dtype)])

    def next_mu(mu):
        return torch.clamp(mu * opt.mu_factor, min=opt.mu_min)

    def prelude(z0, data):
        return BarrierCarry(z=z0, mu=mu0, lam=lam0, history=hist0, o=o0)

    def begin(carry, z0, data):
        st = lm_init(carry.z, (), merit(carry.z, data, carry.mu),
                     consts._replace(lam=torch.clamp(carry.lam, min=eps)))
        return st, inner_gtol(carry.mu)

    def step(inner, carry, z0, data):
        st, gtol = inner
        return lm_step(st, trial(data, carry.mu), gtol=gtol, **lm_args), gtol

    def end(inner, carry, z0, data):
        # A lam-railed inner exit leaves lam at lam_max; the next barrier
        # subproblem is a new landscape, so the warm start is clamped.
        st = inner[0]
        return BarrierCarry(
            z=st.z, mu=next_mu(carry.mu), lam=torch.clamp(st.lam, max=1e3),
            history=carry.history.index_copy(
                0, carry.o.reshape(1), row(st, data, carry.mu)[None]),
            o=carry.o + 1)

    def finish_carry(carry, z0, data):
        return finish(carry.z, data, carry.mu, carry.history)

    def eager(z0, data):
        """The same outer functions around the eager inner loop."""
        carry = prelude(z0, data)
        for _ in range(opt.n_outer):
            st = lm_loop(carry.z, (), merit(carry.z, data, carry.mu),
                         trial(data, carry.mu), maxiter=opt.inner_maxiter,
                         lam0=carry.lam, gtol=inner_gtol(carry.mu),
                         dtype=dtype, **lm_args)
            carry = end((st, None), carry, z0, data)
        return finish_carry(carry, z0, data)

    return CapturedOuterLoop(prelude, begin, step, end, finish_carry, eager,
                             n_outer=opt.n_outer, maxiter=opt.inner_maxiter)


def make_bounded_solver(problem, b: Bounds,
                        options: BoundedOptions = BoundedOptions()):
    """Build ``solve(z0, data) -> (z, BoundedStats)``.

    ``z0`` must be strictly inside the bounds (use :func:`project_interior`).
    The solution approaches active bounds to within O(mu_min / multiplier);
    inactive-bound problems reproduce the unconstrained GN solution.  On a
    CUDA device a call replays the whole homotopy from CUDA graphs
    (:func:`barrier_homotopy`, captured at the first call of each input
    shape); on the CPU it runs the eager loop, which ``solve.eager(z0,
    data)`` runs on any device with the same result bit for bit.
    """
    opt = options
    method = resolve_method(problem, opt.method)
    dtype, device = problem.dtype, problem.device
    nx, nq, nv = problem.model.nx, problem.model.nq, problem.nv
    d = problem.mesh.degree
    num_nodes = problem.num_nodes

    # Masks and safe bound values (inf -> 0 so masked lanes stay finite).
    as_t = lambda a: torch.as_tensor(a, device=device)
    masks = [as_t(np.isfinite(v)) for v in b]
    mp_lo, mp_hi, mx_lo, mx_hi = masks
    p_lo, p_hi, x_lo, x_hi = (
        torch.as_tensor(np.where(np.isfinite(v), v, 0.0), dtype=dtype,
                        device=device) for v in b)
    has_x = bool(np.isfinite(b.x_lo).any() or np.isfinite(b.x_hi).any())
    has_p = bool(nq and (np.isfinite(b.p_lo).any()
                         or np.isfinite(b.p_hi).any()))
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)

    def slacks(z):
        """Masked slacks; masked-out components read as 1."""
        x = z.V[:, :nx]
        return (torch.where(mp_lo, z.p - p_lo, one),
                torch.where(mp_hi, p_hi - z.p, one),
                torch.where(mx_lo, x - x_lo, one),
                torch.where(mx_hi, x_hi - x, one))

    def barrier64(z, mu):
        sl = [s.double() for s in slacks(z)]
        total = sum(torch.sum(torch.log(torch.where(s > 0, s, 1.0)))
                    for s in sl)
        feasible = torch.stack([torch.all(s > 0) for s in sl]).all()
        return torch.where(feasible, -mu.double() * total,
                           torch.full_like(total, math.inf))

    def merit(z, data, mu):
        return problem.cost(z, data) + barrier64(z, mu)

    def add_barrier_terms(sys, z, mu):
        sp_lo, sp_hi, sx_lo, sx_hi = slacks(z)
        if has_p:
            gp_b = (torch.where(mp_lo, -mu / sp_lo, zero)
                    + torch.where(mp_hi, mu / sp_hi, zero))
            hp_b = (torch.where(mp_lo, mu / sp_lo**2, zero)
                    + torch.where(mp_hi, mu / sp_hi**2, zero))
            sys = sys._replace(C=sys.C + torch.diag(hp_b), gp=sys.gp + gp_b)
        if has_x:
            gn_x = (torch.where(mx_lo, -mu / sx_lo, zero)
                    + torch.where(mx_hi, mu / sx_hi, zero))      # (M, nx)
            hn_x = (torch.where(mx_lo, mu / sx_lo**2, zero)
                    + torch.where(mx_hi, mu / sx_hi**2, zero))
            Hn = torch.diag_embed(hn_x).permute(1, 2, 0)         # (nx, nx, M)
            sys = node_block_scatter_soa(
                sys, Hn, Hn.new_zeros((nv, nq, num_nodes)), gn_x.T, d)
        return sys

    def ftb_alpha(z, dV, dp):
        """The exact largest feasible step fraction for box bounds."""
        sp_lo, sp_hi, sx_lo, sx_hi = slacks(z)
        dx = dV[:, :nx]

        def limit(slack, step, mask):
            # A step toward the bound shrinks the slack.
            r = torch.where(mask & (step > 0),
                            opt.ftb * slack / torch.clamp(step, min=1e-300),
                            torch.full_like(slack, math.inf))
            return r.min() if r.numel() else one * math.inf

        a = torch.minimum(limit(sp_lo, -dp, mp_lo), limit(sp_hi, dp, mp_hi))
        a = torch.minimum(a, limit(sx_lo, -dx, mx_lo))
        a = torch.minimum(a, limit(sx_hi, dx, mx_hi))
        return torch.clamp(a, max=1.0)

    def trial(data, mu):
        """The inner LM's trial function on the barrier subproblem at mu
        (gain mode): the step is fraction-to-boundary clipped and alpha
        enters the predicted decrease."""

        def trial_fn(z, carry, lam):
            sys_est = assemble_gn_soa(problem, z, data)
            dmax = pre_barrier_dmax(sys_est)
            sys = add_barrier_terms(sys_est, z, mu)
            gnorm = grad_inf_norm(sys.gx, sys.gp)
            dx, dp = solve_kkt_soa(sys, lam, spike=method == "spike",
                                   damp_scale=dmax)
            dV = blocks_to_nodes_soa(dx, num_nodes, nv)
            alpha = ftb_alpha(z, dV, dp)
            z_try = Decision(V=z.V + alpha * dV, p=z.p + alpha * dp)
            gdot, snorm2 = fused_quadforms(sys.gx.reshape(-1), sys.gp,
                                           dx.reshape(-1), dp)
            aux = LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                        step_norm=alpha * torch.sqrt(snorm2), alpha=alpha)
            return z_try, carry, merit(z_try, data, mu), aux

        return trial_fn

    def finish(z, data, mu, hist):
        return z, BoundedStats(cost=problem.cost(z, data),
                               grad_norm=hist[-1, 1], mu=mu, history=hist)

    return barrier_homotopy(problem, opt, merit, trial, finish)


def bounded_gauss_newton(problem, z0, data, b: Bounds,
                         options: BoundedOptions = BoundedOptions()):
    """One-shot convenience wrapper: projects ``z0`` inside and solves."""
    z0 = project_interior(z0, b)
    return make_bounded_solver(problem, b, options)(z0, data)
