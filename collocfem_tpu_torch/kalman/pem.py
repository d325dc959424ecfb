"""Prediction-error-method (ML) parameter estimation from filter innovations.

Counterpart of ``collocfem_tpu/kalman/pem.py``.  The exact (Gaussian)
likelihood of the data is the product of innovation densities, which every
filter of this subpackage accumulates (``loglik``); the filters are tensor
code, so the NLL is differentiable by autograd and minimized by L-BFGS
(``torch.optim.LBFGS`` with a strong-Wolfe line search, in place of the JAX
package's optax L-BFGS).
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.kalman.disc import discretize_lti
from collocfem_tpu_torch.kalman.filtering import (
    _on,
    _placed,
    ekf_filter,
    kalman_filter,
    ukf_filter,
)


def make_lti_nll(build, ts, ys, mask=None, *, device):
    """NLL for a parameterized linear-Gaussian model.

    ``build(p) -> (A, Qc, H, R, m0, P0)`` defines the model (tensors on
    p's device); sampling times ``ts`` may be irregular (exact Van Loan
    discretization per interval).  Returns ``nll(p)`` (a scalar tensor,
    differentiable), computed on ``device`` in p's dtype; a ``p`` that
    lies elsewhere raises.
    """
    ys = _placed(ys, device)

    def nll(p):
        y = ys.to(p.dtype)
        p, t = _on(p, y), _on(ts, y)
        A, Qc, H, R, m0, P0 = build(p)
        Ad, Qd = discretize_lti(A, Qc, torch.diff(t, prepend=t[:1]))
        return -kalman_filter(Ad, Qd, H, R, y, m0, P0, mask=mask,
                              device=device).loglik

    return nll


def make_ekf_nll(model, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
                 mask=None, *, device):
    """NLL(p) for a nonlinear Model via the continuous-discrete EKF, on
    ``device`` in the dtype of ``ys`` (float64 for an array)."""

    def nll(p):
        return -ekf_filter(model, p, ts, ys, R, Qc, m0, P0, u=u,
                           substeps=substeps, mask=mask,
                           device=device).loglik

    return nll


def make_ukf_nll(model, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
                 mask=None, alpha: float = 1.0, beta: float = 2.0,
                 kappa: float = 0.0, *, device):
    """NLL(p) via the continuous-discrete UKF (derivative-free moments).

    Same contract as :func:`make_ekf_nll`; prefer it when the dynamics are
    strongly nonlinear over a sampling interval.  Differentiable:
    sigma-point propagation is smooth in ``p``.
    """

    def nll(p):
        return -ukf_filter(model, p, ts, ys, R, Qc, m0, P0, u=u,
                           substeps=substeps, mask=mask, alpha=alpha,
                           beta=beta, kappa=kappa, device=device).loglik

    return nll


def run_lbfgs(fun, x0, maxiter: int = 100, gtol: float = 1e-8, *, device):
    """Minimize a scalar ``fun`` with L-BFGS (strong-Wolfe line search).

    ``x0`` is placed on ``device`` (float64 for an array; a tensor that
    lies elsewhere raises).  Stops when the gradient's 2-norm is at most
    ``gtol`` or after ``maxiter`` iterations.  Returns (x, stats) with
    stats = (value, grad_norm, iterations) at the returned x.  ``fun`` is
    evaluated once per point: the optimiser's own re-evaluation at the
    accepted point, and the stop test there, read the point's stored value
    and gradient.  One iteration reads the gradient norm back to the host.
    """
    x = _placed(x0, device).detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1, tolerance_grad=0.0,
                            tolerance_change=0.0,
                            line_search_fn="strong_wolfe")
    evals = []      # (point, value, gradient) since the last accepted point

    def closure():
        for point, value, grad in evals:
            if torch.equal(point, x):
                x.grad = grad.clone()
                return value
        opt.zero_grad()
        value = fun(x)
        value.backward()
        evals.append((x.detach().clone(), value.detach(), x.grad.clone()))
        return value

    def accept():
        value = closure().detach()
        evals[:] = [e for e in evals if torch.equal(e[0], x)]
        return value, torch.linalg.vector_norm(x.grad)

    value, gnorm = accept()
    it = 0
    while it < maxiter and float(gnorm) > gtol:
        opt.step(closure)
        it += 1
        value, gnorm = accept()
    return x.detach(), (value, gnorm.detach(), it)
