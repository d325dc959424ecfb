"""Prediction-error-method (ML) parameter estimation from filter innovations.

Counterpart of ``collocfem_tpu/kalman/pem.py``.  The exact (Gaussian)
likelihood of the data is the product of innovation densities, which every
filter of this subpackage accumulates (``loglik``).  Each ``make_*_nll``
keeps one :class:`collocfem_tpu_torch.kalman.scan.Scan` of its filter's
step: on a CUDA device the first evaluation captures the step and its VJP,
and every evaluation after replays them (T forward and T backward replays a
value and gradient, as reverse-mode AD through the JAX package's
``lax.scan``).  The NLL is minimized by L-BFGS (``torch.optim.LBFGS`` with
a strong-Wolfe line search on the host, in place of the JAX package's optax
L-BFGS in a ``while_loop``).
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.kalman.disc import discretize_lti
from collocfem_tpu_torch.kalman.filtering import (
    _ekf_inputs,
    _ekf_step,
    _filter_result,
    _kf_inputs,
    _kf_step,
    _on,
    _placed,
    _ukf_inputs,
    _ukf_step,
    _ut_lambda,
)
from collocfem_tpu_torch.kalman.scan import Scan


class ScanNLL:
    """``nll(p)``: the negative log-likelihood of a filter's scan, a scalar
    tensor differentiable by autograd.

    ``inputs(p)`` gives the filter's (carry0, xs, consts); ``scan`` is the
    :class:`Scan` of its step, kept across evaluations so that a CUDA
    device captures it once per input key.  ``nll.eager(p)`` runs the same
    scan uncaptured (the captured value and gradient equal it bit for bit)
    and ``nll.plain(p)`` the tape-recording loop over the samples (the
    reference).
    """

    def __init__(self, scan: Scan, inputs):
        self.scan, self._inputs = scan, inputs

    def _value(self, run, p):
        return -_filter_result(*run(*self._inputs(p))).loglik

    def __call__(self, p):
        return self._value(self.scan, p)

    def eager(self, p):
        return self._value(self.scan.eager, p)

    def plain(self, p):
        return self._value(self.scan.plain, p)


def make_lti_nll(build, ts, ys, mask=None, *, device) -> ScanNLL:
    """NLL for a parameterized linear-Gaussian model.

    ``build(p) -> (A, Qc, H, R, m0, P0)`` defines the model (tensors on
    p's device); sampling times ``ts`` may be irregular (exact Van Loan
    discretization per interval, outside the scan).  Returns ``nll(p)`` (a
    :class:`ScanNLL`), computed on ``device`` in p's dtype; a ``p`` that
    lies elsewhere raises.
    """
    ys = _placed(ys, device)

    def inputs(p):
        y = ys.to(p.dtype)
        p, t = _on(p, y), _on(ts, y)
        A, Qc, H, R, m0, P0 = build(p)
        Ad, Qd = discretize_lti(A, Qc, torch.diff(t, prepend=t[:1]))
        return _kf_inputs(Ad, Qd, H, R, y, m0, P0, mask, device)

    return ScanNLL(Scan(_kf_step), inputs)


def make_ekf_nll(model, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
                 mask=None, *, device) -> ScanNLL:
    """NLL(p) for a nonlinear Model via the continuous-discrete EKF, on
    ``device`` in the dtype of ``ys`` (float64 for an array)."""
    return ScanNLL(Scan(_ekf_step(model, substeps)),
                   lambda p: _ekf_inputs(model, p, ts, ys, R, Qc, m0, P0, u,
                                         mask, device))


def make_ukf_nll(model, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
                 mask=None, alpha: float = 1.0, beta: float = 2.0,
                 kappa: float = 0.0, *, device) -> ScanNLL:
    """NLL(p) via the continuous-discrete UKF (derivative-free moments).

    Same contract as :func:`make_ekf_nll`; prefer it when the dynamics are
    strongly nonlinear over a sampling interval.  Differentiable:
    sigma-point propagation is smooth in ``p``.
    """
    step = _ukf_step(model, substeps, _ut_lambda(model.nx, alpha, kappa))
    return ScanNLL(Scan(step), lambda p: _ukf_inputs(
        model, p, ts, ys, R, Qc, m0, P0, u, mask, alpha, beta, kappa,
        device))


def run_lbfgs(fun, x0, maxiter: int = 100, gtol: float = 1e-8, *, device):
    """Minimize a scalar ``fun`` with L-BFGS (strong-Wolfe line search).

    ``x0`` is placed on ``device`` (float64 for an array; a tensor that
    lies elsewhere raises).  Stops when the gradient's 2-norm is at most
    ``gtol``, after ``maxiter`` iterations, or after an iteration that left
    x where it was: its line search found no step (near the optimum, where
    the value's rounding hides any decrease), and every later iteration
    would repeat it.  L-BFGS keeps 10 curvature pairs, optax.lbfgs's
    default memory.  Returns (x, stats) with
    stats = (value, grad_norm, iterations) at the returned x.  ``fun`` is
    evaluated once per point: the optimiser's own re-evaluation at the
    accepted point, and the stop test there, read the point's stored value
    and gradient.  One iteration reads the gradient norm, and whether x
    moved, back to the host.
    With a :class:`ScanNLL` on a CUDA device, an evaluation is the replays
    of its captured forward and backward steps.
    """
    x = _placed(x0, device).detach().clone().requires_grad_(True)
    # One iteration a step; LBFGS's max_eval bounds the evaluations of that
    # step, the first included, so 1 + 25 leaves the strong-Wolfe search
    # its own default of 25 (max_eval's default, 5 max_iter // 4 = 1, left
    # it none: a first trial step that raised the NLL was never shortened).
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1, max_eval=1 + 25,
                            tolerance_grad=0.0, tolerance_change=0.0,
                            history_size=10, line_search_fn="strong_wolfe")
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
        before = x.detach().clone()
        opt.step(closure)
        it += 1
        value, gnorm = accept()
        if torch.equal(x, before):
            break
    return x.detach(), (value, gnorm.detach(), it)
