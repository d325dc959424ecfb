"""Seeded inputs shared by the port's tests and ``chip_smoke.py``."""

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
