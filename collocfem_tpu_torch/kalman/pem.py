"""Prediction-error-method (ML) parameter estimation from filter innovations.

Counterpart of ``collocfem_tpu/kalman/pem.py``.  The exact (Gaussian)
likelihood of the data is the product of innovation densities, which every
filter of this subpackage accumulates (``loglik``).  Each ``make_*_nll``
keeps one :class:`collocfem_tpu_torch.kalman.scan.Scan` of its filter's
step: on a CUDA device the first evaluation captures the step and its VJP,
and every evaluation after replays them (T forward and T backward replays a
value and gradient, as reverse-mode AD through the JAX package's
``lax.scan``).  The NLL is minimized by L-BFGS: optax's direction, its
zoom line search and the JAX package's stop rule, with the line search's
scalar logic on the host in place of optax's ``while_loop``.
"""

from __future__ import annotations

import math

import numpy as np
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


def _lbfgs_direction(g, pairs, first: bool):
    """optax.scale_by_lbfgs's preconditioned gradient P g: the two-loop
    recursion over the curvature ``pairs`` (s, y), newest last, from the
    scaled identity gamma I, gamma = s.y / y.y of the newest pair (1 when
    y.y = 0); a pair with s.y = 0 weighs 0.  The first iteration has no
    pair and scales by min(1, 1 / ||g||_2)."""
    if first:
        norm = float(torch.linalg.vector_norm(g))
        return g * (min(1.0, 1.0 / norm) if norm > 0 else 1.0)
    rhos = [torch.where(y.dot(s) == 0, 0.0, 1.0 / y.dot(s)) for s, y in pairs]
    q, alphas = g, []
    for (s, y), rho in zip(reversed(pairs), reversed(rhos)):
        alphas.append(rho * s.dot(q))
        q = q - alphas[-1] * y
    s, y = pairs[-1]
    yy = y.dot(y)
    r = q * torch.where(yy > 0, y.dot(s) / yy, 1.0)
    for (s, y), rho, alpha in zip(pairs, rhos, reversed(alphas)):
        r = r + (alpha - rho * y.dot(r)) * s
    return r


# The constants of optax.lbfgs's line search (scale_by_zoom_linesearch with
# max_linesearch_steps=20 and its defaults).
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
_INTERVAL_THRESHOLD, _INCREASE_FACTOR, _MAX_LINESEARCH_STEPS = 1e-5, 2.0, 20


def _max(a, b):
    """max that propagates NaN, as jnp.maximum."""
    return a if a >= b or a != a else b


def _min(a, b):
    """min that propagates NaN, as jnp.minimum."""
    return a if a <= b or a != a else b


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where there is none), as optax's."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * rb - db ** 2 * rc) / denom
    B = (-(dc ** 3) * rb + db ** 3 * rc) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a, as optax's."""
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / db ** 2))


def _zoom_linesearch(line, value0, slope0):
    """optax.zoom_linesearch on the host: the step size along a descent
    direction, from trial 1, that meets the strong-Wolfe conditions, whose
    sufficient decrease may be Hager and Zhang's approximate one near a
    minimum (the value within 1e-6 of the start's, the slope at most
    (1 - 2e-4) times the start's magnitude).  An interval search doubles
    the step until it brackets one, and a zoom by cubic, quadratic or
    bisection steps narrows it, in at most 20 trials.  ``line(t)`` gives
    the value and slope at step t as float64 scalars.  Where no trial meets
    both conditions it returns the best one that gave sufficient decrease;
    failing that, 0 where the last trial left the function's domain (an
    infinite or NaN value), else the last trial."""
    f64 = np.float64
    inf = f64(math.inf)
    t, value, slope = f64(0.0), value0, slope0
    low = high = cref = f64(0.0)
    vlow = vhigh = vcref = value0
    slow = shigh = slope0
    safe_t, safe_value = f64(0.0), value0
    found = False
    for count in range(_MAX_LINESEARCH_STEPS):
        if found:
            delta = abs(high - low)
            left, right = _min(high, low), _max(high, low)
            cubic = _cubicmin(low, vlow, slow, high, vhigh, cref, vcref)
            quad = _quadmin(low, vlow, slow, high, vhigh)
            if left + 0.2 * delta < cubic < right - 0.2 * delta:
                new_t = cubic
            elif left + 0.1 * delta < quad < right - 0.1 * delta:
                new_t = quad
            else:
                new_t = (low + high) / 2.0
        else:
            new_t = f64(1.0) if count == 0 else _INCREASE_FACTOR * t
        new_value, new_slope = line(new_t)
        decrease = _min(
            _max(new_slope - (2 * _SLOPE_RTOL - 1.0) * slope0,
                 new_value - value0 - _APPROX_DEC_RTOL * abs(value0)),
            new_value - value0 - _SLOPE_RTOL * new_t * slope0)
        decrease = _max(decrease, f64(0.0))
        decrease = inf if decrease != decrease else decrease
        curvature = _max(abs(new_slope) - _CURV_RTOL * abs(slope0), f64(0.0))
        curvature = inf if curvature != curvature else curvature
        done = _max(decrease, curvature) <= 0.0
        if found:
            if decrease <= 0.0 and new_value < safe_value:
                safe_t, safe_value = new_t, new_value
            to_high = decrease > 0.0 or new_value >= vlow
            high_to_low = new_slope * (high - low) >= 0.0 and not to_high
            cref, vcref = ((high, vhigh) if to_high or high_to_low
                           else (low, vlow))
            if to_high:
                high, vhigh, shigh = new_t, new_value, new_slope
            elif high_to_low:
                high, vhigh, shigh = low, vlow, slow
            if not to_high:
                low, vlow, slow = new_t, new_value, new_slope
            failed = (count + 1 >= _MAX_LINESEARCH_STEPS or (
                delta <= _INTERVAL_THRESHOLD and safe_t > 0.0)) and not done
        else:
            if decrease <= 0.0:
                safe_t, safe_value = new_t, new_value
            to_high = decrease > 0.0 or (new_value >= value and count > 0)
            to_low = new_slope >= 0.0 and not to_high
            if to_low:
                low, vlow, slow = new_t, new_value, new_slope
                high, vhigh, shigh = t, value, slope
            else:
                low, vlow, slow = t, value, slope
                high, vhigh, shigh = new_t, new_value, new_slope
            cref, vcref = low, vlow
            found = to_high or to_low or done
            failed = count + 1 >= _MAX_LINESEARCH_STEPS and not done
        t, value, slope = new_t, new_value, new_slope
        if done:
            return t
        if failed:
            return safe_t if safe_t > 0.0 or decrease == inf else t
    return t


def run_lbfgs(fun, x0, maxiter: int = 100, gtol: float = 1e-8, *, device):
    """Minimize a scalar ``fun`` with L-BFGS: optax.lbfgs's, as the JAX
    package runs it, with its line search on the host.

    ``x0`` is placed on ``device`` (float64 for an array; a tensor that
    lies elsewhere raises).  The direction is optax.scale_by_lbfgs's (10
    curvature pairs, every pair kept, the first step the gradient capped
    to unit 2-norm) and the step size optax's zoom line search's
    (:func:`_zoom_linesearch`).  The stop rule is the JAX package's: an
    iteration takes its step from x and carries the 2-norm of the gradient
    at x, and the loop ends after the first iteration whose norm is at most
    ``gtol`` (one step after a test at the new point would stop), or after
    ``maxiter`` iterations.  It also ends after an iteration that left x
    where it was (its line search found no step inside the function's
    domain, or a step too small to change x): every later iteration would
    repeat it.  Returns (x, stats) with stats = (value at the returned x,
    the last iteration's gradient norm (inf when none ran), iterations).
    ``fun`` is evaluated once per point; an iteration reads the gradient
    norm, and each trial of its line search the value and slope, back to
    the host.  With a :class:`ScanNLL` on a CUDA device, an evaluation is
    the replays of its captured forward and backward steps.
    """
    def evaluate(point):
        point = point.detach().requires_grad_(True)
        value = fun(point)
        (grad,) = torch.autograd.grad(value, point)
        return value.detach(), grad

    def on_host(value, grad, d):
        pair = torch.stack((value, grad.dot(d))).tolist()
        return [np.float64(a) for a in pair]

    x = _placed(x0, device).detach().clone()
    value, grad = evaluate(x)
    pairs = []
    # The norm the loop tests: the gradient at the point the last iteration
    # started from (inf before the first, as the JAX package's carry).
    start_norm = torch.full_like(value, math.inf)
    it = 0
    while it < maxiter and float(start_norm) > gtol:
        start_norm = torch.linalg.vector_norm(grad)
        d = -_lbfgs_direction(grad, pairs, first=not it)
        trials = {}     # step size -> (point, value, gradient)

        def line(t):
            if t not in trials:
                point = x + t * d
                trials[t] = (point, *evaluate(point))
            return on_host(*trials[t][1:], d)

        with np.errstate(all="ignore"):
            t = _zoom_linesearch(line, *on_host(value, grad, d))
        it += 1
        if t == 0.0 or torch.equal(trials[t][0], x):
            break
        x_new, value_new, grad_new = trials[t]
        pairs = (pairs + [(x_new - x, grad_new - grad)])[-10:]
        x, value, grad = x_new, value_new, grad_new
    return x, (value, start_norm, it)
