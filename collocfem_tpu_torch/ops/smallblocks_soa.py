"""Structure-of-arrays tiny-block algebra: block indices leading, batch last.

Counterpart of ``collocfem_tpu/ops/smallblocks_soa.py``.  Block matrices are
(b, b, K): the small dimension is unrolled in Python and every arithmetic op
is an elementwise op over the batch axis K.  The Cholesky clamps each pivot
at ``finfo.tiny`` instead of raising on a noise-indefinite block (as
``torch.linalg.cholesky`` would): the factor is then finite junk and the
Levenberg-Marquardt loop rejects the step.
"""

from __future__ import annotations

import torch


def chol(A):
    """Lower Cholesky of SPD blocks in SoA layout: A (b, b, K) -> L."""
    b = A.shape[0]
    tiny = torch.finfo(A.dtype).tiny
    L = [[None] * b for _ in range(b)]
    for j in range(b):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=tiny))
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, b):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(A[0, 0])
    return torch.stack([
        torch.stack([L[i][j] if j <= i else zero for j in range(b)])
        for i in range(b)
    ])


def solve_lower(L, B):
    """X with L X = B; L (b, b, K) lower, B (b, r, K)."""
    b = B.shape[0]
    X = [None] * b
    for i in range(b):
        s = B[i]
        for k in range(i):
            s = s - L[i, k] * X[k]
        X[i] = s * (1.0 / L[i, i])
    return torch.stack(X)


def solve_lower_t(L, B):
    """X with L^T X = B."""
    b = B.shape[0]
    X = [None] * b
    for i in range(b - 1, -1, -1):
        s = B[i]
        for k in range(i + 1, b):
            s = s - L[k, i] * X[k]
        X[i] = s * (1.0 / L[i, i])
    return torch.stack(X)


def chol_solve(L, B):
    """X with (L L^T) X = B."""
    return solve_lower_t(L, solve_lower(L, B))


def mm(A, B):
    """(b, m, K) @ (m, c, K) -> (b, c, K)."""
    return torch.einsum("imk,mck->ick", A, B)


def mtm(A, B):
    """A^T @ B in SoA: (m, b, K)^T @ (m, c, K) -> (b, c, K)."""
    return torch.einsum("mik,mck->ick", A, B)


def transpose(A):
    """(b, c, K) -> (c, b, K)."""
    return A.transpose(0, 1)
