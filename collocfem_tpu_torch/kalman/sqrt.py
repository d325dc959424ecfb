"""Square-root Kalman filtering/smoothing (QR array algorithms).

Counterpart of ``collocfem_tpu/kalman/sqrt.py``.  Covariances are carried
as lower-triangular square roots and every propagation/update is one QR
triangularization of a stacked pre-array (Kailath array algorithm), so
covariances stay PSD by construction: the float32-safe path.  The smoother
uses the all-PSD Joseph form

    P_s = G P_s' G^T + (I - G A) P_f (I - G A)^T + G Q G^T

so the smoothed square root is again a single stacked QR.  Both are scans
over time (:class:`collocfem_tpu_torch.kalman.scan.Scan`: captured on a
CUDA device), on the filter's ``device=`` and in the dtype of ``y`` (see
:mod:`collocfem_tpu_torch.kalman.filtering`).  The QR is a Householder
triangularization in tensor operations (:func:`_qr_r`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from collocfem_tpu_torch.kalman.filtering import (
    _bcast_time,
    _chol,
    _mask,
    _on,
    _placed,
)
from collocfem_tpu_torch.kalman.scan import Scan


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
    """Upper factor R (n, n) of a tall pre-array (m, n), diagonal made
    nonnegative, by n Householder reflections in tensor operations.

    In place of ``torch.linalg.qr(pre, mode="r")``, which has no derivative
    (it drops Q) and whose cuSOLVER call has not been shown to capture in a
    CUDA graph.  R is unique for a pre-array of full column rank, so this is
    the same factor; a zero column reflects nothing.
    """
    rows, B = [], pre
    for j in range(pre.shape[-1]):
        x = B[:, 0]
        one = torch.ones_like(x[0])
        s = torch.where(x[0] < 0, -one, one)
        v = torch.cat([x[:1] + s * torch.linalg.vector_norm(x), x[1:]])
        vv = v @ v
        beta = torch.where(vv > 0, 2.0 / torch.where(vv > 0, vv, one),
                           0.0 * one)
        B = B - beta * torch.outer(v, v @ B)     # (I - beta v v^T) B
        rows.append(torch.cat([B.new_zeros(j), B[0]]))
        B = B[1:, 1:]
    return _tri_pos(torch.stack(rows))


def _lower_solve(S, b):
    """S^-1 b for lower-triangular S, b (n,)."""
    return torch.linalg.solve_triangular(S, b[:, None], upper=False)[:, 0]


def _sqrt_kf_step(carry, x, consts):
    del consts
    m, S = carry
    A_k, Qs_k, H_k, Rs_k, y_k, mk = x
    ny, nx = H_k.shape
    # Predict: S_p from QR of [[(A S)^T], [Qs^T]].
    S_p = _qr_r(torch.cat([(A_k @ S).T, Qs_k.T], dim=0)).T
    m_p = A_k @ m
    # Update: one triangularization of the (ny+nx) pre-array
    # [[Rs^T, 0], [S_p^T H^T, S_p^T]].
    pre = torch.cat([torch.cat([Rs_k.T, S_p.new_zeros((ny, nx))], dim=1),
                     torch.cat([S_p.T @ H_k.T, S_p.T], dim=1)], dim=0)
    post = _qr_r(pre)
    S_y = post[:ny, :ny].T                  # innovation sqrt (lower)
    Kbar = post[:ny, ny:].T                 # K @ S_y
    ew = _lower_solve(S_y, y_k - H_k @ m_p)
    on = mk != 0
    m_f = torch.where(on, m_p + Kbar @ ew, m_p)
    S_f = torch.where(on, post[ny:, ny:].T, S_p)
    ll = -0.5 * (ew @ ew + 2.0 * torch.sum(torch.log(torch.diagonal(S_y)))
                 + ny * math.log(2.0 * math.pi))
    return (m_f, S_f), (m_f, S_f, m_p, S_p,
                        torch.where(on, ll, torch.zeros_like(ll)))


def _sqrt_kf_inputs(Ad, Qd, H, R, y, m0, P0, mask, device):
    """The square-root filter's (carry0, xs, consts) on ``device``; the
    square roots of Qd (eigh) and R are taken outside the scan."""
    y = _placed(y, device)
    T = y.shape[0]
    xs = (_on(Ad, y), psd_sqrt(_on(Qd, y)), _bcast_time(H, T, y),
          _chol(_bcast_time(R, T, y)), y, _mask(mask, T, y))
    return (_on(m0, y), _chol(_on(P0, y))), xs, ()


def sqrt_kalman_filter(Ad, Qd, H, R, y, m0, P0, mask=None, *,
                       device) -> SqrtFilterResult:
    """Linear square-root KF. Same conventions as ``kalman_filter``.

    Qd may be singular (a PSD sqrt is taken via eigh); R must be PD.
    """
    _, (m_f, S_f, m_p, S_p, ll) = Scan(_sqrt_kf_step)(
        *_sqrt_kf_inputs(Ad, Qd, H, R, y, m0, P0, mask, device))
    return SqrtFilterResult(m_f, S_f, m_p, S_p, torch.sum(ll))


def _sqrt_smoother_step(carry, x, consts):
    del consts
    ms_next, Ss_next = carry
    m_f, S_f, A1, Qs1, m_p1, S_p1 = x
    P_f = S_f @ S_f.T
    # G^T = P_p^{-1} A P_f via two triangular solves on S_p.
    t1 = torch.linalg.solve_triangular(S_p1, A1 @ P_f, upper=False)
    G = torch.linalg.solve_triangular(S_p1.T, t1, upper=True).T
    ms = m_f + G @ (ms_next - m_p1)
    eye = torch.eye(m_f.shape[0], dtype=m_f.dtype, device=m_f.device)
    pre = torch.cat([(G @ Ss_next).T, ((eye - G @ A1) @ S_f).T,
                     (G @ Qs1).T], dim=0)
    Ss = _qr_r(pre).T
    return (ms, Ss), (ms, Ss)


def _sqrt_smoother_inputs(res: SqrtFilterResult, Ad, Qd):
    """(carry0, xs, consts) of the square-root backward pass, where ``res``
    lies."""
    like = res.mean_f
    Ad, Q_sq = _on(Ad, like), psd_sqrt(_on(Qd, like))
    xs = (res.mean_f[:-1], res.S_f[:-1], Ad[1:], Q_sq[1:], res.mean_p[1:],
          res.S_p[1:])
    return (res.mean_f[-1], res.S_f[-1]), xs, ()


def sqrt_rts_smoother(res: SqrtFilterResult, Ad, Qd):
    """Square-root RTS pass. Returns smoothed (means (T,nx), S (T,nx,nx)).

    Needs the same per-step (Ad, Qd) passed to the forward filter, and runs
    where ``res`` lies; the smoother gain is built from triangular solves
    against S_p (no inverse, no covariance differencing).  A reverse scan.
    """
    if res.mean_f.shape[0] == 1:
        return res.mean_f.clone(), res.S_f.clone()
    _, (ms, Ss) = Scan(_sqrt_smoother_step)(
        *_sqrt_smoother_inputs(res, Ad, Qd), reverse=True)
    return (torch.cat([ms, res.mean_f[-1:]]),
            torch.cat([Ss, res.S_f[-1:]]))
