"""Kalman filters and fixed-interval smoothers as scans over time.

Counterpart of ``collocfem_tpu/kalman/filtering.py``, whose recursions are
``lax.scan``s: here each is a step function run by
:class:`collocfem_tpu_torch.kalman.scan.Scan`, which on a CUDA device
replays the step as a CUDA graph once per sample (and its VJP once per
sample backwards) and on the CPU runs it in a loop.  The measurement mask
is applied by ``torch.where``, so nothing reads a value back to the host.  Linear KF (exact, for LTI + Van Loan discretization) and
continuous-discrete EKF/UKF for nonlinear
:class:`collocfem_tpu_torch.model.Model` dynamics (mean/covariance
integrated by fixed-substep RK4 between irregular sample times).

All filters return a :class:`FilterResult` whose ``crosscov[k]`` is the
cross-covariance Cov(x_{k-1}^f, x_k^p); the single backward pass
:func:`cd_smoother` turns any of them into a fixed-interval (RTS /
unscented RTS) smoother via the gain G_k = crosscov[k+1] @ cov_p[k+1]^{-1}.

Conventions: ``y`` is (T, ny) at strictly increasing times ``ts``; the
prior (m0, P0) is the *predicted* state at ts[0] (updated by y[0]).
Inputs ``u`` (T, nu) are zero-order-hold: u[k-1] acts on (ts[k-1], ts[k]].
Every filter computes on its required ``device=`` and in the dtype of its
measurements ``y`` (float64 when ``y`` is not a tensor).  Arrays and numbers
are placed there; a tensor that lies on another device raises, so no
argument is copied between the host and the card behind the caller's back.
All of it is differentiable by autograd.  A filter or smoother call makes a
new :class:`Scan`, so on a CUDA device it captures its step at that call;
the likelihoods of :mod:`collocfem_tpu_torch.kalman.pem` keep theirs and
replay it at every evaluation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from collocfem_tpu_torch.kalman.scan import Scan


class FilterResult(NamedTuple):
    """Forward-pass moments. Shapes: means (T, nx), covs (T, nx, nx)."""

    mean_f: torch.Tensor   # posterior (filtered) means
    cov_f: torch.Tensor
    mean_p: torch.Tensor   # one-step predicted means
    cov_p: torch.Tensor
    crosscov: torch.Tensor  # Cov(x_{k-1}^f, x_k^p); [0] is zeros
    loglik: torch.Tensor   # scalar: sum of innovation log densities


def _on(x, like):
    """``x`` as a tensor on ``like``'s device in its dtype; a tensor that
    lies on another device raises instead of being copied."""
    if not torch.is_tensor(x):
        x = np.array(x, dtype=np.float64)
    elif x.device != like.device:
        raise ValueError(f"a tensor on {x.device} was given to a filter "
                         f"that runs on {like.device}")
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _placed(y, device):
    """``y`` on ``device``: an array in float64, a tensor in its own dtype;
    a tensor that lies elsewhere raises."""
    dev = torch.empty(0, device=device).device
    if torch.is_tensor(y):
        return _on(y, torch.empty(0, dtype=y.dtype, device=dev))
    return torch.as_tensor(np.array(y, dtype=np.float64), device=dev)


def _chol(S):
    """Lower Cholesky factor; ``cholesky_ex`` reads no error flag back to
    the host (a matrix that is not positive definite gives a factor with
    non-finite or meaningless entries, which the likelihood carries)."""
    return torch.linalg.cholesky_ex(S).L


def _sym(P):
    return 0.5 * (P + P.mT)




def _cho_solve(L, b):
    """S^-1 b for S = L L^T, b (n,) or (n, k), as two triangular solves:
    the form the captured MHE step already runs on the card, where
    ``torch.cholesky_solve`` has not been shown to capture."""
    col = b.ndim == 1
    b = b[:, None] if col else b
    x = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, b, upper=False), upper=True)
    return x[:, 0] if col else x


def _innovation(e, S, L, K, m_p, P_p, mask):
    """Masked update with gain K and innovation e (covariance S = L L^T):
    (m_f, P_f, log density)."""
    on = mask != 0
    m_f = torch.where(on, m_p + K @ e, m_p)
    P_f = torch.where(on, _sym(P_p - K @ S @ K.T), _sym(P_p))
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    ll = -0.5 * (e @ _cho_solve(L, e) + logdet
                 + e.shape[0] * math.log(2.0 * math.pi))
    return m_f, P_f, torch.where(on, ll, torch.zeros_like(ll))


def _update(m_p, P_p, H, R, y, mask):
    """Measurement update + innovation log density (masked)."""
    e = y - H @ m_p
    S = H @ P_p @ H.T + R
    L = _chol(S)
    K = _cho_solve(L, H @ P_p).T            # P_p H^T S^-1
    return _innovation(e, S, L, K, m_p, P_p, mask)


def _bcast_time(M, T, like):
    M = _on(M, like)
    return M.expand(T, *M.shape[-2:]) if M.ndim == 2 else M


def _mask(mask, T, like):
    return torch.ones(T, dtype=like.dtype, device=like.device) \
        if mask is None else _on(mask, like)


def _filter_result(carry, ys) -> FilterResult:
    """A filter scan's outputs: its per-step (m_f, P_f, m_p, P_p, C, ll)."""
    del carry
    m_f, P_f, m_p, P_p, C, ll = ys
    return FilterResult(m_f, P_f, m_p, P_p, C, torch.sum(ll))


def _kf_step(carry, x, consts):
    del consts
    m, P = carry
    A_k, Q_k, H_k, R_k, y_k, mk = x
    m_p = A_k @ m
    P_p = _sym(A_k @ P @ A_k.T + Q_k)
    C_k = P @ A_k.T
    m_f, P_f, ll = _update(m_p, P_p, H_k, R_k, y_k, mk)
    return (m_f, P_f), (m_f, P_f, m_p, P_p, C_k, ll)


def _kf_inputs(Ad, Qd, H, R, y, m0, P0, mask, device):
    """The linear filter's (carry0, xs, consts) on ``device``."""
    y = _placed(y, device)
    T = y.shape[0]
    xs = (_on(Ad, y), _on(Qd, y), _bcast_time(H, T, y), _bcast_time(R, T, y),
          y, _mask(mask, T, y))
    return (_on(m0, y), _on(P0, y)), xs, ()


def kalman_filter(Ad, Qd, H, R, y, m0, P0, mask=None, *,
                  device) -> FilterResult:
    """Linear (discrete) Kalman filter.

    Ad, Qd: (T, nx, nx) transitions INTO step k (use Ad[0]=I, Qd[0]=0, e.g.
    from :func:`collocfem_tpu_torch.kalman.disc.discretize_lti` with
    dts[0]=0).  H, R may be (ny, nx)/(ny, ny) or time-varying with a
    leading T axis.  ``mask`` (T,) in {0,1} skips the update (and its
    loglik term) where 0.  Runs on ``device``.
    """
    # Step 0 consumes (Ad[0], Qd[0]) = (I, 0): m_p[0] = m0, P_p[0] = P0.
    return _filter_result(*Scan(_kf_step)(
        *_kf_inputs(Ad, Qd, H, R, y, m0, P0, mask, device)))


def rts_smoother(res: FilterResult):
    """Fixed-interval smoother for any FilterResult. Alias of cd_smoother."""
    return cd_smoother(res)


def _smoother_step(carry, x, consts):
    del consts
    ms_next, Ps_next = carry
    m_f, P_f, m_p1, P_p1, C1 = x
    G = _cho_solve(_chol(P_p1), C1.T).T     # C1 @ P_p1^-1
    ms = m_f + G @ (ms_next - m_p1)
    Ps = _sym(P_f + G @ (Ps_next - P_p1) @ G.T)
    return (ms, Ps), (ms, Ps)


def _smoother_inputs(res: FilterResult):
    """(carry0, xs, consts) of the backward pass: x[k] pairs step k's
    posterior with step k+1's prediction and cross-covariance."""
    xs = (res.mean_f[:-1], res.cov_f[:-1], res.mean_p[1:], res.cov_p[1:],
          res.crosscov[1:])
    return (res.mean_f[-1], res.cov_f[-1]), xs, ()


def cd_smoother(res: FilterResult):
    """Backward (RTS-form) pass: returns smoothed (means (T,nx), covs).

    Works for the linear KF, the CD-EKF and the CD-UKF alike because the
    forward pass records the filter's own cross-covariance: the smoother
    gain is G_k = crosscov[k+1] @ cov_p[k+1]^{-1} in every case (for the
    linear/EKF filters crosscov = P_f Phi^T, recovering classic RTS; for
    the UKF it is the sigma-point cross-covariance, giving the unscented
    RTS smoother).  A reverse scan over the T - 1 earlier steps.
    """
    if res.mean_f.shape[0] == 1:
        return res.mean_f.clone(), res.cov_f.clone()
    _, (ms, Ps) = Scan(_smoother_step)(*_smoother_inputs(res), reverse=True)
    return (torch.cat([ms, res.mean_f[-1:]]),
            torch.cat([Ps, res.cov_f[-1:]]))


# ---------------------------------------------------------------------------
# Continuous-discrete EKF
# ---------------------------------------------------------------------------


def _prep_nonlinear(model, p, ts, ys, u, R, mask, device):
    """The per-sample inputs xs = (ys, u, u_prev, t_left, ts, dts, R,
    mask) of a continuous-discrete filter, and p, on ``device``."""
    ys = _placed(ys, device)
    T = ys.shape[0]
    ts = _on(ts, ys)
    u = ys.new_zeros((T, model.nu)) if u is None else _on(u, ys)
    dts = torch.diff(ts, prepend=ts[:1])      # dts[0] = 0
    # Zero-order hold: the input acting on (ts[k-1], ts[k]] is u[k-1].
    u_prev = torch.roll(u, 1, dims=0)
    xs = (ys, u, u_prev, ts - dts, ts, dts, _bcast_time(R, T, ys),
          _mask(mask, T, ys))
    return xs, _on(p, ys)


def _rk4(ode, state, uu, t0, h):
    """One RK4 step of ``ode(state, u, t)`` over a tuple state."""
    add = lambda s, k, c: tuple(si + c * ki for si, ki in zip(s, k))
    k1 = ode(state, uu, t0)
    k2 = ode(add(state, k1, h / 2), uu, t0 + h / 2)
    k3 = ode(add(state, k2, h / 2), uu, t0 + h / 2)
    k4 = ode(add(state, k3, h), uu, t0 + h)
    return tuple(s + (h / 6) * (a + 2 * b + 2 * c + d)
                 for s, a, b, c, d in zip(state, k1, k2, k3, k4))


def _ekf_step(model, substeps: int):
    """The EKF's step; ``substeps`` RK4 steps an interval (a static)."""
    fjac = jacfwd(model.f, argnums=0)

    def step(carry, x, consts):
        m, P = carry
        y_k, u_k, uprev_k, tl_k, t_k, dt_k, R_k, mk = x
        p, Qc = consts
        hfun = lambda xx, uu, tt: model.h(xx, uu, p, tt)

        def moment_ode(state, uu, tt):
            m_, P_, Phi = state
            A = fjac(m_, uu, p, tt)
            return model.f(m_, uu, p, tt), A @ P_ + P_ @ A.T + Qc, A @ Phi

        h = dt_k / substeps
        st = (m, P, torch.eye(model.nx, dtype=m.dtype, device=m.device))
        for i in range(substeps):
            st = _rk4(moment_ode, st, uprev_k, tl_k + i * h, h)
        m_p, P_p, Phi = st
        P_p = _sym(P_p)
        C_k = P @ Phi.T
        H_k = jacfwd(hfun, argnums=0)(m_p, u_k, t_k)
        e_bias = hfun(m_p, u_k, t_k) - H_k @ m_p
        m_f, P_f, ll = _update(m_p, P_p, H_k, R_k, y_k - e_bias, mk)
        return (m_f, P_f), (m_f, P_f, m_p, P_p, C_k, ll)

    return step


def _ekf_inputs(model, p, ts, ys, R, Qc, m0, P0, u, mask, device):
    """The EKF's (carry0, xs, consts) on ``device``."""
    xs, p = _prep_nonlinear(model, p, ts, ys, u, R, mask, device)
    y = xs[0]
    return (_on(m0, y), _on(P0, y)), xs, (p, _on(Qc, y))


def ekf_filter(model, p, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
               mask=None, *, device) -> FilterResult:
    """Continuous-discrete extended Kalman filter for a Model.

    Between samples, (m, P, Phi) follow the moment ODEs
    m' = f(m), P' = A P + P A^T + Qc, Phi' = A Phi with A = df/dx along
    the mean (``torch.func.jacfwd``), integrated with ``substeps`` fixed
    RK4 steps.  Update linearizes h at the predicted mean.  Qc is the
    continuous process-noise density (nx, nx).  Runs on ``device``.
    """
    return _filter_result(*Scan(_ekf_step(model, substeps))(
        *_ekf_inputs(model, p, ts, ys, R, Qc, m0, P0, u, mask, device)))


# ---------------------------------------------------------------------------
# Continuous-discrete UKF
# ---------------------------------------------------------------------------


def _sigma_points(m, P, lam):
    """(2nx+1, nx) symmetric sigma set; scaled Cholesky of (nx+lam) P."""
    nx = m.shape[0]
    eye = torch.eye(nx, dtype=P.dtype, device=P.device)
    L = _chol(_sym(P) + 1e-300 * eye)
    S = math.sqrt(nx + lam) * L.T            # rows: scaled sqrt directions
    return torch.cat([m[None, :], m + S, m - S], dim=0)


def _ut_lambda(nx, alpha, kappa) -> float:
    return alpha * alpha * (nx + kappa) - nx


def _ut_weights(nx, alpha, beta, kappa, like):
    lam = _ut_lambda(nx, alpha, kappa)
    wm = torch.full((2 * nx + 1,), 1.0 / (2 * (nx + lam)), dtype=like.dtype,
                    device=like.device)
    wm[0] = lam / (nx + lam)
    wc = wm.clone()
    wc[0] += 1.0 - alpha * alpha + beta
    return lam, wm, wc


def _wcov(wc, dX, dY):
    return torch.einsum("i,ij,ik->jk", wc, dX, dY)


def _ukf_step(model, substeps: int, lam: float):
    """The UKF's step; ``substeps`` and the UT's ``lam`` are statics."""
    fjac = jacfwd(model.f, argnums=0)
    fv = vmap(model.f, in_dims=(0, None, None, None))

    def step(carry, x, consts):
        m, P = carry
        y_k, u_k, uprev_k, tl_k, t_k, dt_k, R_k, mk = x
        p, Qc, wm, wc = consts
        hv = vmap(lambda xx, uu, tt: model.h(xx, uu, p, tt),
                  in_dims=(0, None, None))

        def ode(state, uu, tt):
            X, Qd = state
            A = fjac(wm @ X, uu, p, tt)
            return fv(X, uu, p, tt), A @ Qd + Qd @ A.T + Qc

        h = dt_k / substeps
        X0 = _sigma_points(m, P, lam)
        st = (X0, torch.zeros_like(P))
        for i in range(substeps):
            st = _rk4(ode, st, uprev_k, tl_k + i * h, h)
        X1, Qd = st
        m_p = wm @ X1
        dX1 = X1 - m_p
        P_p = _sym(_wcov(wc, dX1, dX1) + Qd)
        C_k = _wcov(wc, X0 - m, dX1)

        # Measurement UT on a fresh sigma set at the prediction.
        Xm = _sigma_points(m_p, P_p, lam)
        Y = hv(Xm, u_k, t_k)
        yhat = wm @ Y
        dY = Y - yhat
        S = _wcov(wc, dY, dY) + R_k
        Pxy = _wcov(wc, Xm - m_p, dY)
        L = _chol(S)
        K = _cho_solve(L, Pxy.T).T
        m_f, P_f, ll = _innovation(y_k - yhat, S, L, K, m_p, P_p, mk)
        return (m_f, P_f), (m_f, P_f, m_p, P_p, C_k, ll)

    return step


def _ukf_inputs(model, p, ts, ys, R, Qc, m0, P0, u, mask, alpha, beta,
                kappa, device):
    """The UKF's (carry0, xs, consts) on ``device``."""
    xs, p = _prep_nonlinear(model, p, ts, ys, u, R, mask, device)
    y = xs[0]
    _, wm, wc = _ut_weights(model.nx, alpha, beta, kappa, y)
    return (_on(m0, y), _on(P0, y)), xs, (p, _on(Qc, y), wm, wc)


def ukf_filter(model, p, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
               mask=None, alpha: float = 1.0, beta: float = 2.0,
               kappa: float = 0.0, *, device) -> FilterResult:
    """Continuous-discrete unscented Kalman filter.

    One sigma set per interval is drawn at the posterior and RK4-integrated
    through the dynamics (``torch.func.vmap`` over the points); the
    additive process noise is integrated alongside via dQd/dt = A Qd + Qd
    A^T + Qc linearized at the sigma mean.  The recorded sigma
    cross-covariance makes :func:`cd_smoother` the unscented RTS smoother.
    Runs on ``device``.
    """
    step = _ukf_step(model, substeps, _ut_lambda(model.nx, alpha, kappa))
    return _filter_result(*Scan(step)(*_ukf_inputs(
        model, p, ts, ys, R, Qc, m0, P0, u, mask, alpha, beta, kappa,
        device)))
