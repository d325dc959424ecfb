"""Kalman filters and fixed-interval smoothers as loops over time.

Counterpart of ``collocfem_tpu/kalman/filtering.py``, whose recursions are
``lax.scan``s: here each is a Python loop over the samples on tensors, with
the measurement mask applied by ``torch.where``, so nothing reads a value
back to the host.  Linear KF (exact, for LTI + Van Loan discretization) and
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
All of it is differentiable by autograd.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap


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
    """S^-1 b for S = L L^T, b (n,) or (n, k)."""
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


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


def _stack(steps):
    """Per-step tuples -> a tuple of stacked tensors."""
    return tuple(torch.stack(col) for col in zip(*steps))


def kalman_filter(Ad, Qd, H, R, y, m0, P0, mask=None, *,
                  device) -> FilterResult:
    """Linear (discrete) Kalman filter.

    Ad, Qd: (T, nx, nx) transitions INTO step k (use Ad[0]=I, Qd[0]=0, e.g.
    from :func:`collocfem_tpu_torch.kalman.disc.discretize_lti` with
    dts[0]=0).  H, R may be (ny, nx)/(ny, ny) or time-varying with a
    leading T axis.  ``mask`` (T,) in {0,1} skips the update (and its
    loglik term) where 0.  Runs on ``device``.
    """
    y = _placed(y, device)
    T = y.shape[0]
    Ad, Qd = _on(Ad, y), _on(Qd, y)
    H, R = _bcast_time(H, T, y), _bcast_time(R, T, y)
    mask = _mask(mask, T, y)
    m, P = _on(m0, y), _on(P0, y)
    steps = []
    # Step 0 consumes (Ad[0], Qd[0]) = (I, 0): m_p[0] = m0, P_p[0] = P0.
    for k in range(T):
        A_k = Ad[k]
        m_p = A_k @ m
        P_p = _sym(A_k @ P @ A_k.T + Qd[k])
        C_k = P @ A_k.T
        m, P, ll = _update(m_p, P_p, H[k], R[k], y[k], mask[k])
        steps.append((m, P, m_p, P_p, C_k, ll))
    m_f, P_f, m_p, P_p, C, ll = _stack(steps)
    return FilterResult(m_f, P_f, m_p, P_p, C, torch.sum(ll))


def rts_smoother(res: FilterResult):
    """Fixed-interval smoother for any FilterResult. Alias of cd_smoother."""
    return cd_smoother(res)


def cd_smoother(res: FilterResult):
    """Backward (RTS-form) pass: returns smoothed (means (T,nx), covs).

    Works for the linear KF, the CD-EKF and the CD-UKF alike because the
    forward pass records the filter's own cross-covariance: the smoother
    gain is G_k = crosscov[k+1] @ cov_p[k+1]^{-1} in every case (for the
    linear/EKF filters crosscov = P_f Phi^T, recovering classic RTS; for
    the UKF it is the sigma-point cross-covariance, giving the unscented
    RTS smoother).
    """
    T = res.mean_f.shape[0]
    ms, Ps = res.mean_f[-1], res.cov_f[-1]
    out = [(ms, Ps)]
    # Step k pairs step k's posterior with step k+1's prediction/crosscov.
    for k in range(T - 2, -1, -1):
        m_p1, P_p1 = res.mean_p[k + 1], res.cov_p[k + 1]
        G = _cho_solve(_chol(P_p1), res.crosscov[k + 1].T).T
        ms = res.mean_f[k] + G @ (ms - m_p1)
        Ps = _sym(res.cov_f[k] + G @ (Ps - P_p1) @ G.T)
        out.append((ms, Ps))
    ms, Ps = _stack(out[::-1])
    return ms, Ps


# ---------------------------------------------------------------------------
# Continuous-discrete EKF
# ---------------------------------------------------------------------------


def _prep_nonlinear(model, p, ts, ys, u, R, mask, device):
    ys = _placed(ys, device)
    T = ys.shape[0]
    ts = _on(ts, ys)
    u = ys.new_zeros((T, model.nu)) if u is None else _on(u, ys)
    R = _bcast_time(R, T, ys)
    mask = _mask(mask, T, ys)
    p = _on(p, ys)
    dts = torch.diff(ts, prepend=ts[:1])      # dts[0] = 0
    # Zero-order hold: the input acting on (ts[k-1], ts[k]] is u[k-1].
    u_prev = torch.roll(u, 1, dims=0)
    t_left = ts - dts
    return ys, T, ts, u, u_prev, t_left, dts, R, mask, p


def _rk4(ode, state, uu, t0, h):
    """One RK4 step of ``ode(state, u, t)`` over a tuple state."""
    add = lambda s, k, c: tuple(si + c * ki for si, ki in zip(s, k))
    k1 = ode(state, uu, t0)
    k2 = ode(add(state, k1, h / 2), uu, t0 + h / 2)
    k3 = ode(add(state, k2, h / 2), uu, t0 + h / 2)
    k4 = ode(add(state, k3, h), uu, t0 + h)
    return tuple(s + (h / 6) * (a + 2 * b + 2 * c + d)
                 for s, a, b, c, d in zip(state, k1, k2, k3, k4))


def ekf_filter(model, p, ts, ys, R, Qc, m0, P0, u=None, substeps: int = 4,
               mask=None, *, device) -> FilterResult:
    """Continuous-discrete extended Kalman filter for a Model.

    Between samples, (m, P, Phi) follow the moment ODEs
    m' = f(m), P' = A P + P A^T + Qc, Phi' = A Phi with A = df/dx along
    the mean (``torch.func.jacfwd``), integrated with ``substeps`` fixed
    RK4 steps.  Update linearizes h at the predicted mean.  Qc is the
    continuous process-noise density (nx, nx).  Runs on ``device``.
    """
    ys, T, ts, u, u_prev, t_left, dts, R, mask, p = _prep_nonlinear(
        model, p, ts, ys, u, R, mask, device)
    Qc = _on(Qc, ys)
    eye = torch.eye(model.nx, dtype=ys.dtype, device=ys.device)
    fjac = jacfwd(model.f, argnums=0)
    hfun = lambda x, uu, tt: model.h(x, uu, p, tt)
    hjac = jacfwd(hfun, argnums=0)

    def moment_ode(state, uu, tt):
        m, P, Phi = state
        A = fjac(m, uu, p, tt)
        return model.f(m, uu, p, tt), A @ P + P @ A.T + Qc, A @ Phi

    m, P = _on(m0, ys), _on(P0, ys)
    steps = []
    for k in range(T):
        h = dts[k] / substeps
        st = (m, P, eye)
        for i in range(substeps):
            st = _rk4(moment_ode, st, u_prev[k], t_left[k] + i * h, h)
        m_p, P_p, Phi = st
        P_p = _sym(P_p)
        C_k = P @ Phi.T
        H_k = hjac(m_p, u[k], ts[k])
        e_bias = hfun(m_p, u[k], ts[k]) - H_k @ m_p
        m, P, ll = _update(m_p, P_p, H_k, R[k], ys[k] - e_bias, mask[k])
        steps.append((m, P, m_p, P_p, C_k, ll))
    m_f, P_f, m_p, P_p, C, ll = _stack(steps)
    return FilterResult(m_f, P_f, m_p, P_p, C, torch.sum(ll))


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


def _ut_weights(nx, alpha, beta, kappa, like):
    lam = alpha * alpha * (nx + kappa) - nx
    wm = torch.full((2 * nx + 1,), 1.0 / (2 * (nx + lam)), dtype=like.dtype,
                    device=like.device)
    wm[0] = lam / (nx + lam)
    wc = wm.clone()
    wc[0] += 1.0 - alpha * alpha + beta
    return lam, wm, wc


def _wcov(wc, dX, dY):
    return torch.einsum("i,ij,ik->jk", wc, dX, dY)


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
    ys, T, ts, u, u_prev, t_left, dts, R, mask, p = _prep_nonlinear(
        model, p, ts, ys, u, R, mask, device)
    Qc = _on(Qc, ys)
    nx = model.nx
    lam, wm, wc = _ut_weights(nx, alpha, beta, kappa, ys)
    fjac = jacfwd(model.f, argnums=0)
    fv = vmap(model.f, in_dims=(0, None, None, None))
    hv = vmap(lambda x, uu, tt: model.h(x, uu, p, tt), in_dims=(0, None, None))

    def ode(state, uu, tt):
        X, Qd = state
        A = fjac(wm @ X, uu, p, tt)
        return fv(X, uu, p, tt), A @ Qd + Qd @ A.T + Qc

    m, P = _on(m0, ys), _on(P0, ys)
    steps = []
    for k in range(T):
        h = dts[k] / substeps
        X0 = _sigma_points(m, P, lam)
        st = (X0, torch.zeros_like(P))
        for i in range(substeps):
            st = _rk4(ode, st, u_prev[k], t_left[k] + i * h, h)
        X1, Qd = st
        m_p = wm @ X1
        dX1 = X1 - m_p
        P_p = _sym(_wcov(wc, dX1, dX1) + Qd)
        C_k = _wcov(wc, X0 - m, dX1)

        # Measurement UT on a fresh sigma set at the prediction.
        Xm = _sigma_points(m_p, P_p, lam)
        Y = hv(Xm, u[k], ts[k])
        yhat = wm @ Y
        dY = Y - yhat
        S = _wcov(wc, dY, dY) + R[k]
        Pxy = _wcov(wc, Xm - m_p, dY)
        L = _chol(S)
        K = _cho_solve(L, Pxy.T).T
        m, P, ll = _innovation(ys[k] - yhat, S, L, K, m_p, P_p, mask[k])
        steps.append((m, P, m_p, P_p, C_k, ll))
    m_f, P_f, m_p, P_p, C, ll = _stack(steps)
    return FilterResult(m_f, P_f, m_p, P_p, C, torch.sum(ll))
