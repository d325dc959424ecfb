"""Exact discretization of LTI stochastic dynamics (Van Loan's method).

Counterpart of ``collocfem_tpu/kalman/disc.py``.  Given x' = A x + w with
continuous process-noise density Qc, the sampled process x_{k+1} = Ad x_k +
w_k, Cov(w_k) = Qd comes from one matrix exponential of the 2nx x 2nx block
matrix

    M = [[A, Qc], [0, -A^T]] * dt,   expm(M) = [[Ad, X], [0, Ad^{-T}]],

whence Qd = X @ Ad^T (Van Loan 1978).  ``torch.linalg.matrix_exp`` is
differentiable and batched, so :func:`discretize_lti` is one call for all
intervals.
"""

from __future__ import annotations

import torch


def van_loan(A, Qc, dt):
    """Exact (Ad, Qd) for interval(s) ``dt``.  A, Qc: (nx, nx) tensors;
    ``dt`` a number or a tensor of shape (T,) (then Ad, Qd are (T, nx,
    nx))."""
    nx = A.shape[0]
    dt = torch.as_tensor(dt, dtype=A.dtype, device=A.device)[..., None, None]
    top = torch.cat([A * dt, Qc * dt], dim=-1)
    bottom = torch.cat([torch.zeros_like(top[..., :nx]), -A.T * dt], dim=-1)
    EM = torch.linalg.matrix_exp(torch.cat([top, bottom], dim=-2))
    Ad = EM[..., :nx, :nx]
    Qd = EM[..., :nx, nx:] @ Ad.mT
    return Ad, 0.5 * (Qd + Qd.mT)


def discretize_lti(A, Qc, dts):
    """Batched exact discretization: dts (T,) -> Ad (T, nx, nx), Qd (T, nx, nx).

    For the filtering convention (transition INTO step k), pass
    ``dts[0] = 0`` to get Ad[0] = I, Qd[0] = 0.
    """
    return van_loan(A, Qc, torch.as_tensor(dts, dtype=A.dtype,
                                           device=A.device))
