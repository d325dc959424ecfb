"""Square-root Kalman filtering/smoothing (QR array algorithms).

Counterpart of ``collocfem_tpu/kalman/sqrt.py``.  Covariances are carried
as lower-triangular square roots and every propagation/update is one QR
triangularization of a stacked pre-array (Kailath array algorithm), so
covariances stay PSD by construction: the float32-safe path.  The smoother
uses the all-PSD Joseph form

    P_s = G P_s' G^T + (I - G A) P_f (I - G A)^T + G Q G^T

so the smoothed square root is again a single stacked QR.  Loops over time
on tensors, on the filter's ``device=`` and in the dtype of ``y`` (see
:mod:`collocfem_tpu_torch.kalman.filtering`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from collocfem_tpu_torch.kalman.filtering import (
    _bcast_time,
    _chol,
    _mask,
    _placed,
    _on,
    _stack,
)


class SqrtFilterResult(NamedTuple):
    """Means (T, nx); S_* are lower-triangular with P = S S^T."""

    mean_f: torch.Tensor
    S_f: torch.Tensor
    mean_p: torch.Tensor
    S_p: torch.Tensor
    loglik: torch.Tensor


def psd_sqrt(M):
    """Symmetric PSD square root via eigh, eigenvalues clamped at 0.

    Used for process-noise inputs that may be exactly singular (e.g.
    Qd[0] = 0, Van Loan Qd of rank-deficient Qc) where Cholesky would fail.
    """
    w, V = torch.linalg.eigh(0.5 * (M + M.mT))
    return (V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]) @ V.mT


def _tri_pos(Rm):
    """Flip row signs so the triangular factor has nonnegative diagonal."""
    d = torch.sign(torch.diagonal(Rm, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return d[..., :, None] * Rm


def _qr_r(pre):
    """Upper factor of a tall pre-array, diagonal made nonnegative."""
    return _tri_pos(torch.linalg.qr(pre, mode="r").R)


def _lower_solve(S, b):
    """S^-1 b for lower-triangular S, b (n,)."""
    return torch.linalg.solve_triangular(S, b[:, None], upper=False)[:, 0]


def sqrt_kalman_filter(Ad, Qd, H, R, y, m0, P0, mask=None, *,
                       device) -> SqrtFilterResult:
    """Linear square-root KF. Same conventions as ``kalman_filter``.

    Qd may be singular (a PSD sqrt is taken via eigh); R must be PD.
    """
    y = _placed(y, device)
    T, ny = y.shape
    Hb = _bcast_time(H, T, y)
    R_sq = _chol(_bcast_time(R, T, y))
    mask = _mask(mask, T, y)
    Ad = _on(Ad, y)
    Q_sq = psd_sqrt(_on(Qd, y))
    m = _on(m0, y)
    S = _chol(_on(P0, y))
    nx = m.shape[0]
    steps = []
    for k in range(T):
        A_k, H_k = Ad[k], Hb[k]
        # Predict: S_p from QR of [[(A S)^T], [Qs^T]].
        S_p = _qr_r(torch.cat([(A_k @ S).T, Q_sq[k].T], dim=0)).T
        m_p = A_k @ m
        # Update: one triangularization of the (ny+nx) pre-array.
        pre = y.new_zeros((ny + nx, ny + nx))
        pre[:ny, :ny] = R_sq[k].T
        pre[ny:, :ny] = S_p.T @ H_k.T
        pre[ny:, ny:] = S_p.T
        post = _qr_r(pre)
        S_y = post[:ny, :ny].T              # innovation sqrt (lower)
        Kbar = post[:ny, ny:].T             # K @ S_y
        ew = _lower_solve(S_y, y[k] - H_k @ m_p)
        on = mask[k] != 0
        m = torch.where(on, m_p + Kbar @ ew, m_p)
        S = torch.where(on, post[ny:, ny:].T, S_p)
        ll = -0.5 * (ew @ ew + 2.0 * torch.sum(torch.log(torch.diagonal(S_y)))
                     + ny * math.log(2.0 * math.pi))
        steps.append((m, S, m_p, S_p, torch.where(on, ll,
                                                  torch.zeros_like(ll))))
    m_f, S_f, m_p, S_p, ll = _stack(steps)
    return SqrtFilterResult(m_f, S_f, m_p, S_p, torch.sum(ll))


def sqrt_rts_smoother(res: SqrtFilterResult, Ad, Qd):
    """Square-root RTS pass. Returns smoothed (means (T,nx), S (T,nx,nx)).

    Needs the same per-step (Ad, Qd) passed to the forward filter, and runs
    where ``res`` lies; the smoother gain is built from triangular solves against S_p (no inverse,
    no covariance differencing).
    """
    like = res.mean_f
    Ad = _on(Ad, like)
    Q_sq = psd_sqrt(_on(Qd, like))
    T, nx = like.shape
    eye = torch.eye(nx, dtype=like.dtype, device=like.device)
    ms, Ss = res.mean_f[-1], res.S_f[-1]
    out = [(ms, Ss)]
    for k in range(T - 2, -1, -1):
        S_f, A1, S_p1 = res.S_f[k], Ad[k + 1], res.S_p[k + 1]
        P_f = S_f @ S_f.T
        # G^T = P_p^{-1} A P_f via two triangular solves on S_p.
        t1 = torch.linalg.solve_triangular(S_p1, A1 @ P_f, upper=False)
        G = torch.linalg.solve_triangular(S_p1.T, t1, upper=True).T
        ms = res.mean_f[k] + G @ (ms - res.mean_p[k + 1])
        pre = torch.cat([(G @ Ss).T, ((eye - G @ A1) @ S_f).T,
                         (G @ Q_sq[k + 1]).T], dim=0)
        Ss = _qr_r(pre).T
        out.append((ms, Ss))
    ms, Ss = _stack(out[::-1])
    return ms, Ss
