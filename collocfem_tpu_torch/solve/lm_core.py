"""Levenberg-Marquardt outer loop (gain ratio + Nielsen damping, or plain
decrease with a fixed ladder).

Counterpart of ``collocfem_tpu/solve/lm_core.py``.  The step s solves
(H + lam*dmax*I) s = -g and is applied as alpha*s (alpha in (0, 1], a
fraction-to-boundary clip of the interior-point solvers; 1 elsewhere); the
quadratic model predicts the decrease

    pred = -alpha (1 - alpha/2) (g.s) + (alpha^2 / 2) lam (dmax s.s),

which is 0.5 * (lam * dmax * s.s - g.s) at alpha = 1.  ``accept_mode="gain"``
accepts iff the actual decrease is positive and the gain ratio actual/pred
exceeds 1e-4, with Nielsen's damping schedule; ``"decrease"`` accepts any
decrease, with the fixed x0.2 / x5 ladder (the AL/barrier OCP subproblems,
whose nonconvex merit the quadratic model fits poorly).  The cost words are
float64 scalars: the GPU has native float64, so it replaces the JAX
package's double-word cost.

One iteration is :func:`lm_step`: the accept decision, the damping update
and the done flag stay on the device (``torch.where`` on every leaf of the
carry), and it makes no copy from the host and no read to it, so a CUDA graph
can capture it (``solve.graph``).  Once ``done`` is set every later iteration
leaves the state as it is, which reproduces the JAX ``while_loop`` exit
exactly.  :func:`lm_init` makes the initial state from constants that
:func:`lm_constants` builds once (an outer loop's inner solve replaces their
lam with its warm start, on the device).  :func:`lm_loop` runs them
eagerly, a Python loop over device tensors; the solvers of
``solve.newton`` and ``parallel.batch``, the interior-point drivers of
``solve.bounds`` and ``solve.constrained`` and the OCP solver of
``solve.auglag`` replay them from CUDA graphs on a CUDA device.  The eager
loop reads ``done`` on the host only when a tolerance is non-zero
(:func:`stops_early`), to stop early; the fixed-work path never
synchronises.  The captured loops read nothing: with a tolerance the device
tests ``~done & (it < maxiter)`` before each step (a WHILE conditional node,
``solve.graph``), ``lax.while_loop``'s condition.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_map

from collocfem_tpu_torch.utils.profiling import device_span

HISTORY_COLS = ("cost", "grad_norm", "lam", "step_norm", "accepted")


class LMAux(NamedTuple):
    """Reduced scalars the accept test needs."""

    gnorm: torch.Tensor      # inf-norm of the gradient at the CURRENT iterate
    gdot: torch.Tensor       # g . s for the unclipped step s
    sds: torch.Tensor        # s^T (dmax I) s, the damping quadratic form
    step_norm: torch.Tensor  # ||alpha s|| (xtol test + history)
    alpha: Any = 1.0         # applied step fraction (1 unless FTB-clipped)


class LMState(NamedTuple):
    z: Any                 # current iterate (a tuple of tensors)
    carry: Any             # caller state threaded through accepts
    cost: torch.Tensor     # float64 cost at z
    lam: torch.Tensor      # dimensionless damping
    nu: torch.Tensor       # Nielsen reject-escalation factor
    it: torch.Tensor
    done: torch.Tensor
    gnorm: torch.Tensor
    history: torch.Tensor  # (maxiter, 5) per-iteration table


def _select(accept, new, old):
    return tree_map(lambda a, b: torch.where(accept, a, b), new, old)


def stops_early(gtol, ftol: float, xtol: float) -> bool:
    """Whether a loop with these tolerances stops early at ``done``: the
    eager loop reads it on the host before each iteration, a captured one
    on the device (a tensor gtol counts as set)."""
    return torch.is_tensor(gtol) or gtol > 0 or ftol > 0 or xtol > 0


def lm_constants(lam0, *, maxiter: int, dtype, device) -> LMState:
    """The constant part of the initial state (all but z, carry and cost):
    lam = max(lam0, eps), nu = 2, it = 0, done = False, gnorm = inf and a
    zero history.  Building it copies from the host, so a solver builds it
    once, outside any CUDA graph."""
    scalar = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt, device=device)
    return LMState(
        z=None, carry=None, cost=None,
        lam=torch.maximum(scalar(lam0), scalar(torch.finfo(dtype).eps)),
        nu=scalar(2.0), it=scalar(0, torch.int64),
        done=scalar(False, torch.bool), gnorm=scalar(float("inf")),
        history=torch.zeros((maxiter, len(HISTORY_COLS)), dtype=dtype,
                            device=device),
    )


def lm_init(z0, carry0, cost0, consts: LMState) -> LMState:
    """The initial :class:`LMState`: z0, carry0, cost0 and device-to-device
    copies of ``consts`` (:func:`lm_constants`)."""
    return consts._replace(
        z=z0, carry=carry0, cost=cost0,
        **{f: getattr(consts, f).clone()
           for f in ("lam", "nu", "it", "done", "gnorm", "history")})


def lm_step(st: LMState, trial_fn, *, gtol=0.0, ftol: float = 0.0,
            xtol: float = 0.0, lam_min: float = 1e-14, lam_max: float = 1e12,
            accept_mode: str = "gain") -> LMState:
    """One LM iteration from ``st``; returns the new :class:`LMState` (new
    tensors: ``st`` is not written).  No copy from the host, no read to it.
    ``trial_fn`` and the options are :func:`lm_loop`'s."""
    if accept_mode not in ("gain", "decrease"):
        raise ValueError(
            f"accept_mode must be 'gain' or 'decrease', got {accept_mode!r}")
    dtype = st.lam.dtype
    tiny = torch.finfo(dtype).tiny
    z_try, carry_try, ct, aux = trial_fn(st.z, st.carry, st.lam)
    actual64 = st.cost - ct
    actual = actual64.to(dtype)
    a = aux.alpha
    pred = -a * (1.0 - 0.5 * a) * aux.gdot + 0.5 * a * a * st.lam * aux.sds
    rho = actual / torch.clamp(pred, min=tiny)
    decrease = torch.isfinite(ct) & (ct < st.cost)
    if accept_mode == "decrease":
        # Any decrease, and the fixed ladder: the Nielsen factor is a
        # function of the gain ratio, meaningless for a nonconvex merit.
        accept = decrease
        lam_new = torch.where(accept,
                              torch.clamp(st.lam * 0.2, min=lam_min),
                              torch.clamp(st.lam * 5.0, max=lam_max))
        nu_new = st.nu
    else:
        accept = decrease & (pred > 0.0) & (rho > 1e-4)
        # Nielsen's adaptive schedule (Madsen-Nielsen-Tingleff).
        two_rho = 2.0 * rho - 1.0
        down = torch.clamp(1.0 - two_rho * two_rho * two_rho, min=1.0 / 3.0)
        lam_new = torch.where(accept,
                              torch.clamp(st.lam * down, min=lam_min),
                              torch.clamp(st.lam * st.nu, max=lam_max))
        # The reset value is a Python scalar: a kernel argument, not a copy
        # from the host.
        nu_new = torch.where(accept, 2.0, torch.clamp(st.nu * 2.0, max=64.0))
    rel_drop = actual64 / torch.clamp(st.cost, min=1e-300)
    done = (
        (aux.gnorm < gtol)
        | (accept & (ftol > 0.0) & (rel_drop < ftol))
        | (accept & (xtol > 0.0) & (aux.step_norm < xtol))
        # lam railed at lam_max: every damping level was rejected.
        | (~accept & (lam_new >= lam_max))
    )
    row = torch.stack([st.cost.to(dtype), aux.gnorm, st.lam,
                       aux.step_norm, accept.to(dtype)])
    # A finished loop keeps its state, as the JAX while_loop exit does.
    keep = st.done
    take = accept & ~keep
    small_old = (st.lam, st.nu, st.it, st.done, st.gnorm, st.history)
    small_new = (lam_new, nu_new, st.it + 1, done, aux.gnorm,
                 st.history.index_copy(0, st.it.reshape(1), row[None]))
    lam_s, nu_s, it_s, done_s, gnorm_s, hist_s = _select(
        keep, small_old, small_new)
    return LMState(
        z=_select(take, z_try, st.z),
        carry=_select(take, carry_try, st.carry),
        cost=torch.where(take, ct, st.cost),
        lam=lam_s, nu=nu_s, it=it_s, done=done_s, gnorm=gnorm_s,
        history=hist_s,
    )


def lm_loop(z0, carry0, cost0, trial_fn, *, maxiter: int, lam0, gtol=0.0,
            ftol: float = 0.0, xtol: float = 0.0, lam_min: float = 1e-14,
            lam_max: float = 1e12, dtype, accept_mode: str = "gain"
            ) -> LMState:
    """Run the LM loop eagerly; returns the final :class:`LMState`.  Each
    iteration is the device span ``lm.step``.

    Args:
      z0: initial iterate (tuple of tensors).
      carry0: caller state at z0; ``trial_fn`` receives the carry of the
        current iterate and returns that of the trial iterate, and a
        rejected step keeps the old one.
      cost0: float64 cost at z0.
      trial_fn: ``(z, carry, lam) -> (z_try, carry_try, ct, aux: LMAux)``
        with ``ct`` the float64 trial cost.
      lam0, gtol: numbers or scalar tensors (the interior-point inner loops
        warm-start lam and loosen gtol with the barrier parameter).
    """
    st = lm_init(z0, carry0, cost0, lm_constants(
        lam0, maxiter=maxiter, dtype=dtype, device=cost0.device))
    early_exit = stops_early(gtol, ftol, xtol)
    for _ in range(maxiter):
        if early_exit and bool(st.done):
            break
        with device_span("lm.step", cost0.device):
            st = lm_step(st, trial_fn, gtol=gtol, ftol=ftol, xtol=xtol,
                         lam_min=lam_min, lam_max=lam_max,
                         accept_mode=accept_mode)
    return st


def grad_inf_norm(gx, gp):
    """max(max|gx|, max|gp|) with gp possibly empty (nq = 0).  The branch is
    on the shape, so it costs no device synchronisation."""
    gnorm = gx.abs().max()
    return torch.maximum(gnorm, gp.abs().max()) if gp.numel() else gnorm


def fused_quadforms(gx_flat, gp, dx_flat, dp):
    """(g.s, s.s) as one matrix-vector product (these feed only the
    predicted decrease, so working-precision dots are ample)."""
    s_cat = torch.cat([dx_flat, dp])
    sums = torch.stack([torch.cat([gx_flat, gp]), s_cat]) @ s_cat
    return sums[0], sums[1]
