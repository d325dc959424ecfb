"""Plain chain solves of an SPD block-tridiagonal system (no kernels).

Counterpart of ``collocfem_tpu/solve/blocktri.py``: the CPU path of the KKT
solve, the plain version the CUDA kernel is held against, and the test
oracle.  Both are pivot-free: the damped Gauss-Newton system keeps every
Schur complement SPD.

  * :func:`blocktri_cr_factor_soa`: vectorised cyclic reduction in SoA
    layout; the chain is padded to a power of two with identity blocks,
    factored once, and the returned ``apply`` reduces any number of
    right-hand sides through the stored factors.
  * :func:`blocktri_solve_scan`: the sequential block-Cholesky Thomas solve
    in block-major layout, used as the test oracle.

Convention: A[k,k] = D[k] (SPD), A[k,k+1] = E[k], A[k+1,k] = E[k]^T, with
E[K-1] ignored.
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.ops import smallblocks_soa as soa


def _pad_pow2_soa(Ds, Es):
    """Pad SoA (b, b, K) to a power-of-two chain with identity/zero blocks."""
    b, _, k0 = Ds.shape
    kp = 1 << max(0, (k0 - 1).bit_length())
    if kp == k0:
        return Ds, Es
    eye = torch.eye(b, dtype=Ds.dtype, device=Ds.device)[:, :, None]
    Ds = torch.cat([Ds, eye.expand(b, b, kp - k0)], dim=-1)
    # E[k0-1] is ignored by convention but becomes an interior coupling
    # after padding: zero it so the pad blocks stay decoupled.
    Es = torch.cat([Es[..., :k0 - 1], Es.new_zeros(b, b, kp - k0 + 1)],
                   dim=-1)
    return Ds, Es


def blocktri_cr_factor_soa(Ds, Es):
    """Factor the SoA chain by cyclic reduction; returns ``apply(Gs)``.

    Ds, Es (b, b, K); ``apply`` maps Gs (b, r, K) to X (b, r, K) with
    A X = G.  Each level eliminates the odd blocks with one batched
    Cholesky and halves the chain; back-substitution uses the stored
    Schur factors x_odd = s_g - s_up x_even - s_lo x_right.
    """
    k0 = Ds.shape[-1]
    Ds, Es = _pad_pow2_soa(Ds, Es)
    kp = Ds.shape[-1]
    levels = []
    while Ds.shape[-1] > 1:
        d_even, d_odd = Ds[..., 0::2], Ds[..., 1::2]
        e_up, e_lo = Es[..., 0::2], Es[..., 1::2]
        l_odd = soa.chol(d_odd)
        s_up = soa.chol_solve(l_odd, soa.transpose(e_up))
        s_lo = soa.chol_solve(l_odd, e_lo)
        d_new = d_even - soa.mm(e_up, s_up)
        d_new[..., 1:] -= soa.mtm(e_lo, s_lo)[..., :-1]
        levels.append((l_odd, e_up, e_lo, s_up, s_lo))
        Ds, Es = d_new, -soa.mm(e_up, s_lo)
    l_root = soa.chol(Ds)

    def apply(Gs):
        b, r, _ = Gs.shape
        Gs = torch.cat([Gs, Gs.new_zeros(b, r, kp - k0)], dim=-1)
        s_gs = []
        for l_odd, e_up, e_lo, _, _ in levels:
            g_even, g_odd = Gs[..., 0::2], Gs[..., 1::2]
            s_g = soa.chol_solve(l_odd, g_odd)
            Gs = g_even - soa.mm(e_up, s_g)
            Gs[..., 1:] -= soa.mtm(e_lo, s_g)[..., :-1]
            s_gs.append(s_g)
        X = soa.chol_solve(l_root, Gs)
        for (_, _, _, s_up, s_lo), s_g in zip(reversed(levels),
                                              reversed(s_gs)):
            x_right = torch.cat([X[..., 1:], torch.zeros_like(X[..., :1])],
                                dim=-1)
            x_odd = s_g - soa.mm(s_up, X) - soa.mm(s_lo, x_right)
            X = torch.stack([X, x_odd], dim=-1).reshape(b, r, 2 * X.shape[-1])
        return X[..., :k0]

    return apply


def blocktri_solve_scan(D, E, G):
    """Block-Cholesky Thomas solve in block-major layout (the test oracle).

    D, E (K, b, b); G (K, b, r) -> X (K, b, r).
    """
    def chol1(A):
        return soa.chol(A[..., None])

    def solve1(L, B):
        return soa.chol_solve(L, B[..., None])[..., 0]

    k = D.shape[0]
    ls, ys = [chol1(D[0])], [G[0]]
    for i in range(1, k):
        w = solve1(ls[-1], E[i - 1])                     # U^-1 E
        ls.append(chol1(D[i] - E[i - 1].T @ w))          # D - E^T U^-1 E
        ys.append(G[i] - w.T @ ys[-1])
    xs = [solve1(ls[-1], ys[-1])]
    for i in range(k - 2, -1, -1):
        xs.append(solve1(ls[i], ys[i] - E[i] @ xs[-1]))
    return torch.stack(xs[::-1])
