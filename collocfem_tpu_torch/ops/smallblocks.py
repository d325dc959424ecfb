"""Block-major tiny-block algebra: leading batch axes, block indices last.

Counterpart of ``collocfem_tpu/ops/smallblocks.py``.  Blocks are (..., b, b)
and right-hand sides (..., b, r); the small dimension is unrolled in Python,
so every arithmetic op is an elementwise op over the leading batch axes.  The
Cholesky clamps each pivot at ``finfo.tiny``, as
:mod:`collocfem_tpu_torch.ops.smallblocks_soa` does, so a noise-indefinite
block gives a finite junk factor that the Levenberg-Marquardt loop rejects.
Unlike the JAX module there is no fallback to library factorisations for
b > 16: the unrolled form is used at every size.
"""

from __future__ import annotations

import torch


def chol(A):
    """Lower Cholesky factor of SPD blocks (..., b, b)."""
    b = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    L = [[None] * b for _ in range(b)]
    for j in range(b):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=tiny))
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, b):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([
        torch.stack([L[i][j] if j <= i else zero for j in range(b)], dim=-1)
        for i in range(b)
    ], dim=-2)


def solve_lower(L, B):
    """X with L X = B; L (..., b, b) lower triangular, B (..., b, r)."""
    b = L.shape[-1]
    X = [None] * b
    for i in range(b):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * X[k]
        X[i] = s / L[..., i, i, None]
    return torch.stack(X, dim=-2)


def solve_lower_t(L, B):
    """X with L^T X = B (back substitution on the transposed factor)."""
    b = L.shape[-1]
    X = [None] * b
    for i in range(b - 1, -1, -1):
        s = B[..., i, :]
        for k in range(i + 1, b):
            s = s - L[..., k, i, None] * X[k]
        X[i] = s / L[..., i, i, None]
    return torch.stack(X, dim=-2)


def chol_solve(L, B):
    """SPD solve from a precomputed lower Cholesky factor."""
    return solve_lower_t(L, solve_lower(L, B))


def spd_solve(A, B):
    """One-shot SPD solve of tiny blocks: Cholesky and two triangular sweeps."""
    return chol_solve(chol(A), B)
