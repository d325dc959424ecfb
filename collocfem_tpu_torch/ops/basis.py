"""Legendre–Gauss–Lobatto basis, quadrature, and differentiation tables.

Counterpart of ``collocfem_tpu/ops/basis.py``.  All tables are computed once,
on the host, in numpy float64 (root finding and barycentric weights want full
precision and run at problem-build time, never in the hot loop); the problem
layer turns them into tensors of the working dtype on the chosen device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class LGLBasis:
    """Degree-``d`` Legendre–Gauss–Lobatto basis on the reference element [-1, 1].

    Attributes:
      degree:  polynomial degree d (d+1 nodes).
      nodes:   (d+1,) LGL nodes, ascending, nodes[0] = -1, nodes[-1] = +1.
      weights: (d+1,) LGL quadrature weights; exact for polynomials of degree
               <= 2d - 1.
      diff:    (d+1, d+1) differentiation matrix D:  (dq/dtau)(nodes[k]) =
               sum_j D[k, j] q(nodes[j]) for any polynomial q of degree <= d.
      bary:    (d+1,) barycentric interpolation weights for the node set.
    """

    degree: int
    nodes: np.ndarray
    weights: np.ndarray
    diff: np.ndarray
    bary: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.degree + 1

    def interp_rows(self, s: np.ndarray) -> np.ndarray:
        """Lagrange interpolation rows L with L @ q(nodes) = q(s).

        Args:
          s: (T,) evaluation points in [-1, 1].
        Returns:
          (T, d+1) float64 array of Lagrange cardinal values l_j(s_t).
        """
        s = np.atleast_1d(np.asarray(s, dtype=np.float64))
        diffs = s[:, None] - self.nodes[None, :]  # (T, d+1)
        # Exact-node hits -> one-hot rows (avoid division by zero).
        hit = np.isclose(diffs, 0.0, rtol=0.0, atol=1e-14)
        safe = np.where(hit, 1.0, diffs)
        terms = self.bary[None, :] / safe
        rows = terms / np.sum(terms, axis=1, keepdims=True)
        any_hit = hit.any(axis=1)
        rows[any_hit] = hit[any_hit].astype(np.float64)
        return rows


def lgl_nodes(degree: int) -> np.ndarray:
    """LGL nodes: {-1, +1} plus the roots of P'_d (derivative of Legendre)."""
    if degree < 1:
        raise ValueError("LGL basis needs degree >= 1")
    if degree == 1:
        return np.array([-1.0, 1.0])
    cd = np.zeros(degree + 1)
    cd[degree] = 1.0
    dcoef = np.polynomial.legendre.legder(cd)
    interior = np.polynomial.legendre.legroots(dcoef)
    # Two Newton polish steps on P'_d for tight accuracy.
    for _ in range(2):
        val = np.polynomial.legendre.legval(interior, dcoef)
        dval = np.polynomial.legendre.legval(
            interior, np.polynomial.legendre.legder(dcoef)
        )
        interior = interior - val / dval
    return np.concatenate([[-1.0], np.sort(interior), [1.0]])


def lgl_weights(degree: int, nodes: np.ndarray) -> np.ndarray:
    """LGL quadrature weights w_j = 2 / (d (d+1) P_d(x_j)^2)."""
    cd = np.zeros(degree + 1)
    cd[degree] = 1.0
    pd = np.polynomial.legendre.legval(nodes, cd)
    return 2.0 / (degree * (degree + 1) * pd**2)


def barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    """Barycentric weights b_j = 1 / prod_{k != j} (x_j - x_k), normalized."""
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    b = 1.0 / np.prod(diff, axis=1)
    return b / np.max(np.abs(b))


def diff_matrix(nodes: np.ndarray, bary: np.ndarray) -> np.ndarray:
    """Spectral differentiation matrix from barycentric weights.

    D[k, j] = (b_j / b_k) / (x_k - x_j) for k != j;  D[k, k] = -sum_{j!=k} D[k, j].
    """
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    d = (bary[None, :] / bary[:, None]) / diff
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(d, -np.sum(d, axis=1))
    return d


@functools.lru_cache(maxsize=None)
def make_basis(degree: int) -> LGLBasis:
    """Build (and cache) the degree-``degree`` LGL basis tables in float64."""
    nodes = lgl_nodes(degree)
    weights = lgl_weights(degree, nodes)
    bary = barycentric_weights(nodes)
    diff = diff_matrix(nodes, bary)
    for arr in (nodes, weights, bary, diff):
        arr.setflags(write=False)
    return LGLBasis(degree=degree, nodes=nodes, weights=weights, diff=diff,
                    bary=bary)
