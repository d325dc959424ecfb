"""Chain solves of an SPD block-tridiagonal system.

Counterpart of ``collocfem_tpu/solve/blocktri.py``.  All are pivot-free:
the damped Gauss-Newton system keeps every Schur complement SPD.

  * :func:`blocktri_cr_factor_soa`: cyclic reduction in SoA layout, factor
    once and apply to any number of right-hand sides.  The chain is padded to
    a power of two with identity blocks; levels run while the chain has more
    than ``TAIL`` = 8 blocks, through the per-level CR kernels of
    :mod:`collocfem_tpu_torch.ops.cr` on a CUDA device (#4 factor, #5
    apply and #6 back-substitution, each a whole sweep in one call of the
    library) and their plain versions on the CPU, and the last 8 blocks
    finish with a block Cholesky (Thomas) tail, factored densely.  This is
    the TPU's level schedule: Pallas levels while the chain has >= 16 and >
    8 blocks.
    :func:`blocktri_cr_factor` is its block-major wrapper.
  * :func:`blocktri_cr_factor_plain`: the same schedule on the plain level
    math alone, on any device.  The plain versions of kernels #1 and #2 run
    it, so that they never launch a kernel.
  * :func:`blocktri_solve_cr`: one block-major solve, kernel #3 per level
    and #6's sweep on the way back (the covariance path's ``SOLVERS["cr"]``), and
    :func:`blocktri_solve_cr_plain`, the same on the plain level math.
  * :func:`blocktri_solve_cr_unrolled`, :func:`blocktri_solve_scan`,
    :func:`blocktri_solve_dense`: the plain references (CR down to one
    block, the sequential block Thomas solve, a dense solve).
  * :func:`blocktri_inverse_blocks`: the block-tridiagonal part of A^-1.

Convention: A[k,k] = D[k] (SPD), A[k,k+1] = E[k], A[k+1,k] = E[k]^T, with
E[K-1] ignored.  Block-major arrays are (K, b, ·), SoA arrays (b, ·, K).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from collocfem_tpu_torch.ops import cr
from collocfem_tpu_torch.ops import smallblocks as sb
from collocfem_tpu_torch.ops import smallblocks_soa as soa

# Chains of at most this many blocks are solved by the tail.  The chain is a
# power of two, so "more than 8 blocks" is the TPU's condition for a Pallas
# level, ">= pallas_min (16) and > tail (8)" (solve/blocktri.py:364, 493).
TAIL = 8
# The kernels' tail factors its dense matrix in panels of this many columns.
TAIL_PANEL = 32


class _Levels(NamedTuple):
    factor_sweep: object
    apply_sweep: object
    level: object
    backsub_sweep: object
    tail_factor: object
    tail_solve: object


def _pad_pow2_soa(Ds, Es):
    """Pad SoA (b, b, K) to a power-of-two chain with identity/zero blocks;
    the results are contiguous."""
    b, _, k0 = Ds.shape
    kp = 1 << max(0, (k0 - 1).bit_length())
    if kp == k0:
        return Ds.contiguous(), Es.contiguous()
    eye = torch.eye(b, dtype=Ds.dtype, device=Ds.device)[:, :, None]
    Ds = torch.cat([Ds, eye.expand(b, b, kp - k0)], dim=-1)
    # E[k0-1] is ignored by convention but becomes an interior coupling
    # after padding: zero it so the pad blocks stay decoupled.
    Es = torch.cat([Es[..., :k0 - 1], Es.new_zeros(b, b, kp - k0 + 1)],
                   dim=-1)
    return Ds, Es


def _pad_rhs(Gs, kp):
    b, r, k0 = Gs.shape
    return torch.cat([Gs, Gs.new_zeros(b, r, kp - k0)], dim=-1)


def _dense_tail_factor(Ds, Es):
    """Cholesky factor of the dense (m b, m b) matrix of an m-block chain,
    m <= TAIL.  A banded Cholesky has no fill outside the band, so this is
    the block Cholesky (Thomas) factorisation of the tail, in a few large
    ops instead of 2m sequential block steps.  The plain versions' tail."""
    b, _, m = Ds.shape
    A = Ds.new_zeros(m * b, m * b)
    for i in range(m):
        s = slice(i * b, (i + 1) * b)
        A[s, s] = Ds[..., i]
        if i + 1 < m:
            s1 = slice((i + 1) * b, (i + 2) * b)
            A[s, s1] = Es[..., i]
            A[s1, s] = Es[..., i].T
    return torch.linalg.cholesky_ex(A).L


def _dense_tail_solve(L, Gs):
    """X (b, r, m) with A X = G for the tail factored by
    _dense_tail_factor."""
    b, r, m = Gs.shape
    g = Gs.permute(2, 0, 1).reshape(m * b, r)
    return torch.cholesky_solve(g, L).reshape(m, b, r).permute(1, 2, 0)


def _tail_factor(Ds, Es):
    """The kernels' tail: the Cholesky factor of the dense (m b, m b)
    matrix of an m-block chain, m <= TAIL, right-looking in panels of
    TAIL_PANEL columns (one panel at m b <= 32, then the same factor as
    :func:`_dense_tail_factor`'s).  cuSOLVER factors a wider matrix on its
    blocked path, whose inner cuBLAS, inside a CUDA-graph capture, made
    memory-allocation nodes (config 3 on 'cr', m b = 96), which the body of
    a conditional node (``solve.graph``'s loops) refuses."""
    b, _, m = Ds.shape
    n = m * b
    A = Ds.new_zeros(m, b, m, b)
    i = torch.arange(m, device=Ds.device)
    A[i, :, i, :] = Ds.permute(2, 0, 1)
    A[i[:-1], :, i[1:], :] = Es[..., :m - 1].permute(2, 0, 1)
    A[i[1:], :, i[:-1], :] = Es[..., :m - 1].permute(2, 1, 0)
    A = A.reshape(n, n)
    for j in range(0, n, TAIL_PANEL):
        e = min(j + TAIL_PANEL, n)
        ljj = torch.linalg.cholesky_ex(A[j:e, j:e]).L
        A[j:e, j:e] = ljj
        if e < n:
            lrj = torch.linalg.solve_triangular(ljj, A[e:, j:e].T,
                                                upper=False).T
            A[e:, j:e] = lrj
            A[e:, e:] -= lrj @ lrj.T
    return torch.tril(A)


def _tail_solve(L, Gs):
    """X (b, r, m) with A X = G for the tail factored by _tail_factor: the
    two triangular solves."""
    b, r, m = Gs.shape
    g = Gs.permute(2, 0, 1).reshape(m * b, r)
    y = torch.linalg.solve_triangular(L, g, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x.reshape(m, b, r).permute(1, 2, 0)


# On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
# its plain version.
_KERNELS = _Levels(cr.cr_factor_sweep, cr.cr_apply_sweep, cr.cr_level,
                   cr.cr_backsub_sweep, _tail_factor, _tail_solve)
_PLAIN = _Levels(cr.factor_sweep_plain, cr.apply_sweep_plain, cr.level_plain,
                 cr.backsub_sweep_plain, _dense_tail_factor,
                 _dense_tail_solve)


def _cr_factor(Ds, Es, levels: _Levels):
    k0 = Ds.shape[-1]
    Ds, Es = _pad_pow2_soa(Ds, Es)
    kp = Ds.shape[-1]
    (Ds, Es), facs = levels.factor_sweep(Ds, Es, TAIL)
    tail = levels.tail_factor(Ds, Es)
    s_up, s_lo = cr.factor_columns(facs)

    def apply(Gs):
        Gs, s_gs = levels.apply_sweep(facs, _pad_rhs(Gs, kp))
        X = levels.tail_solve(tail, Gs).contiguous()
        return levels.backsub_sweep(X, s_up, s_lo, s_gs)[..., :k0]

    return apply


def blocktri_cr_factor_soa(Ds, Es):
    """Factor the SoA chain by cyclic reduction; returns ``apply(Gs)``.

    Ds, Es (b, b, K); ``apply`` maps Gs (b, r, K) to X (b, r, K) with
    A X = G.  On a CUDA device every level above the tail is kernel #4
    (factor), #5 (apply) and #6 (back-substitution), each one sweep; on the
    CPU their plain versions.
    """
    return _cr_factor(Ds, Es, _KERNELS)


def blocktri_cr_factor_plain(Ds, Es):
    """:func:`blocktri_cr_factor_soa` on the plain level math alone, on any
    device: the chain solve inside the plain versions of kernels #1 and #2,
    which must never launch a kernel."""
    return _cr_factor(Ds, Es, _PLAIN)


def _squeezed(G):
    return (G[..., None], True) if G.ndim == 2 else (G, False)


def blocktri_cr_factor(D, E):
    """Block-major wrapper around :func:`blocktri_cr_factor_soa`: returns
    ``apply(G)`` on (K, b, r) or (K, b) arrays."""
    apply_soa = blocktri_cr_factor_soa(D.permute(1, 2, 0), E.permute(1, 2, 0))

    def apply(G):
        G, squeeze = _squeezed(G)
        X = apply_soa(G.permute(1, 2, 0)).permute(2, 0, 1)
        return X[..., 0] if squeeze else X

    return apply


def _solve_cr(D, E, G, levels: _Levels):
    G, squeeze = _squeezed(G)
    k0 = D.shape[0]
    Ds, Es = _pad_pow2_soa(D.permute(1, 2, 0), E.permute(1, 2, 0))
    Gs = _pad_rhs(G.permute(1, 2, 0), Ds.shape[-1])
    s_up, s_lo, s_g = [], [], []
    while Ds.shape[-1] > TAIL:
        (Ds, Es, Gs), sol = levels.level(Ds, Es, Gs)
        for arrays, a in zip((s_up, s_lo, s_g), sol):
            arrays.append(a)
    X = levels.tail_solve(levels.tail_factor(Ds, Es), Gs).contiguous()
    X = levels.backsub_sweep(X, s_up, s_lo, s_g)[..., :k0].permute(2, 0, 1)
    return X[..., 0] if squeeze else X


def blocktri_solve_cr(D, E, G):
    """Cyclic-reduction solve of A X = G, block-major: D, E (K, b, b), G
    (K, b, r) or (K, b).  On a CUDA device each level above the tail is one
    kernel #3 call on the way down, and the way back is one kernel #6
    sweep; on the CPU their plain versions."""
    return _solve_cr(D, E, G, _KERNELS)


def blocktri_solve_cr_plain(D, E, G):
    """:func:`blocktri_solve_cr` on the plain level math alone, on any
    device: what the kernel path is held against."""
    return _solve_cr(D, E, G, _PLAIN)


def blocktri_solve_cr_unrolled(D, E, G):
    """Plain cyclic reduction down to a single block, block-major (the
    reference of :func:`blocktri_solve_cr`, as in the JAX package)."""
    G, squeeze = _squeezed(G)
    k0 = D.shape[0]
    Ds, Es = _pad_pow2_soa(D.permute(1, 2, 0), E.permute(1, 2, 0))
    Gs = _pad_rhs(G.permute(1, 2, 0), Ds.shape[-1])
    stack = []
    while Ds.shape[-1] > 1:
        (Ds, Es, Gs), sol = cr.level_plain(Ds, Es, Gs)
        stack.append(sol)
    X = soa.chol_solve(soa.chol(Ds), Gs)
    for s_up, s_lo, s_g in reversed(stack):
        X = cr.backsub_plain(X, s_up, s_lo, s_g)
    X = X[..., :k0].permute(2, 0, 1)
    return X[..., 0] if squeeze else X


def blocktri_solve_scan(D, E, G):
    """Block-Cholesky Thomas solve in block-major layout (the test oracle).

    D, E (K, b, b); G (K, b, r) -> X (K, b, r).
    """
    G, squeeze = _squeezed(G)
    k = D.shape[0]
    ls, ys = [sb.chol(D[0])], [G[0]]
    for i in range(1, k):
        w = sb.chol_solve(ls[-1], E[i - 1])              # U^-1 E
        ls.append(sb.chol(D[i] - E[i - 1].T @ w))        # D - E^T U^-1 E
        ys.append(G[i] - w.T @ ys[-1])
    xs = [sb.chol_solve(ls[-1], ys[-1])]
    for i in range(k - 2, -1, -1):
        xs.append(sb.chol_solve(ls[i], ys[i] - E[i] @ xs[-1]))
    X = torch.stack(xs[::-1])
    return X[..., 0] if squeeze else X


def blocktri_solve_dense(D, E, G):
    """Materialise the block-tridiagonal matrix and solve densely (tests)."""
    k, b, _ = D.shape
    A = D.new_zeros(k * b, k * b)
    for i in range(k):
        s = slice(i * b, (i + 1) * b)
        A[s, s] = D[i]
        if i + 1 < k:
            s1 = slice((i + 1) * b, (i + 2) * b)
            A[s, s1] = E[i]
            A[s1, s] = E[i].T
    return torch.linalg.solve(A, G.reshape(k * b, -1)).reshape(G.shape)


def blocktri_inverse_blocks(D, E):
    """Selected inverse of the SPD block-tridiagonal A (Takahashi recursion).

    Only the block-tridiagonal part of A^-1 is formed, from the block
    Cholesky (Thomas) factorisation:

      forward:   S_0 = D_0;   W_k = S_k^-1 E_k;  S_{k+1} = D_{k+1} - E_k^T W_k
      backward:  Sigma_{K-1} = S_{K-1}^-1
                 Sigma_{k,k+1} = -W_k Sigma_{k+1}
                 Sigma_k = S_k^-1 + W_k Sigma_{k+1} W_k^T

    A sequential recursion over K of a few library calls per block (a
    reporting path, not the LM loop, and no TPU kernel).  Returns (diag
    (K, b, b) = inv(A)[k, k], off (K-1, b, b) = inv(A)[k, k+1]).
    """
    k, b, _ = D.shape
    sinvs, ws = [], []
    s = D[0]
    for i in range(k - 1):
        lf = torch.linalg.cholesky_ex(s).L
        ws.append(torch.cholesky_solve(E[i], lf))
        sinvs.append(torch.cholesky_inverse(lf))
        s = D[i + 1] - E[i].T @ ws[-1]
    sigma = torch.cholesky_inverse(torch.linalg.cholesky_ex(s).L)
    diag, off = [sigma], []
    for i in range(k - 2, -1, -1):
        off.append(-ws[i] @ sigma)
        sigma = sinvs[i] - ws[i] @ off[-1].T
        diag.append(sigma)
    off = torch.stack(off[::-1]) if off else D.new_zeros((0, b, b))
    return torch.stack(diag[::-1]), off


# The double-word CR (``cr_dw``) is not ported: float64 takes its place.
SOLVERS = {
    "cr": blocktri_solve_cr,
    "cr_unrolled": blocktri_solve_cr_unrolled,
    "scan": blocktri_solve_scan,
    "dense": blocktri_solve_dense,
}
