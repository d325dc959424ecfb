"""Seeded inputs and residual checks shared by the port's tests and
``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA


def random_kkt_system(k: int, b: int, nq: int, seed: int, *,
                      dtype=torch.float64, device="cpu") -> BlockTriSystemSoA:
    """A seeded SPD bordered system in SoA layout.

    The chain blocks are diagonally dominant and the parameter corner
    dominates the Schur term B^T A^-1 B, so every damped system is positive
    definite.  Drawn in float64 with numpy, then cast.
    """
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, b, b))
    D = np.moveaxis(m @ m.transpose(0, 2, 1) + 2 * b * np.eye(b), 0, -1)
    m2 = rng.standard_normal((nq, nq))
    arrays = dict(D=D, E=0.3 * rng.standard_normal((b, b, k)),
                  B=rng.standard_normal((b, nq, k)),
                  C=m2 @ m2.T + 2 * b * k * np.eye(nq),
                  gx=rng.standard_normal((b, k)),
                  gp=rng.standard_normal(nq))
    return BlockTriSystemSoA(**{
        name: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                              device=device)
        for name, a in arrays.items()})


def random_chain(k: int, b: int, r: int, seed: int, *, boundary=None,
                 dtype=torch.float64, device="cpu"):
    """A seeded SPD block-tridiagonal chain in SoA layout: (D, E (b, b, K),
    G (b, r, K)).  With ``boundary`` every boundary-th coupling is exactly
    zero, as at the experiment boundaries of a concatenated chain."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, b, b))
    D = m @ m.transpose(0, 2, 1) + 2 * b * np.eye(b)
    E = 0.3 * rng.standard_normal((k, b, b))
    if boundary:
        E[boundary - 1::boundary] = 0.0
    G = rng.standard_normal((k, b, r))
    return tuple(torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)),
                                 dtype=dtype, device=device) for a in (D, E, G))


def random_chain_batch(n_exp: int, k: int, b: int, r: int, seed: int, *,
                       dtype=torch.float64, device="cpu"):
    """A seeded batch of SPD chains in block-major layout: (D, E
    (n_exp, K, b, b), G (n_exp, K, b, r))."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n_exp, k, b, b))
    D = m @ m.transpose(0, 1, 3, 2) + 4 * b * np.eye(b)
    E = 0.3 * rng.standard_normal((n_exp, k, b, b))
    G = rng.standard_normal((n_exp, k, b, r))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (D, E, G))


def chain_residual(D, E, G, X) -> float:
    """||A X - G||_inf / ||G||_inf in float64 for an SoA chain (E[..., K-1]
    ignored)."""
    D, E, G, X = (a.double() for a in (D, E, G, X))
    e = E[..., :-1]
    AX = torch.einsum("ijk,jrk->irk", D, X)
    AX[..., :-1] += torch.einsum("ijk,jrk->irk", e, X[..., 1:])
    AX[..., 1:] += torch.einsum("jik,jrk->irk", e, X[..., :-1])
    return float((AX - G).abs().max() / G.abs().max())


def batch_residual(D, E, G, X) -> float:
    """||A X - G||_inf / ||G||_inf in float64 over a block-major batch of
    chains (E[:, K-1] ignored)."""
    D, E, G, X = (a.double() for a in (D, E, G, X))
    AX = D @ X
    AX[:, :-1] += E[:, :-1] @ X[:, 1:]
    AX[:, 1:] += E[:, :-1].mT @ X[:, :-1]
    return float((AX - G).abs().max() / G.abs().max())
