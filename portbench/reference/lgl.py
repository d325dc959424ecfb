"""Legendre-Gauss-Lobatto tables on [-1, 1], in float64 numpy.

Written for the benchmark's plain reference, apart from the port: the nodes
are -1, 1 and the roots of P'_d; the weights 2 / (d (d+1) P_d(x)^2); the
differentiation matrix is the derivative of the Lagrange basis, taken from
the monomial coefficients of each cardinal polynomial (a Vandermonde
inverse, exact enough at the low degrees the configurations use); the
interpolation rows are the Lagrange product formula.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre, polynomial


def nodes(degree: int) -> np.ndarray:
    """(d+1,) ascending LGL nodes."""
    c = np.zeros(degree + 1)
    c[-1] = 1.0
    inner = np.sort(np.real(legendre.legroots(legendre.legder(c))))
    return np.concatenate([[-1.0], inner, [1.0]])


def weights(x: np.ndarray) -> np.ndarray:
    """(d+1,) LGL quadrature weights at the nodes ``x``."""
    d = x.size - 1
    c = np.zeros(d + 1)
    c[-1] = 1.0
    return 2.0 / (d * (d + 1) * legendre.legval(x, c) ** 2)


def diff_matrix(x: np.ndarray) -> np.ndarray:
    """D[k, j] = l_j'(x_k) for the Lagrange cardinal polynomials l_j."""
    vander = np.vander(x, increasing=True)           # row k: x_k^0 .. x_k^d
    coef = np.linalg.inv(vander)                     # column j: l_j's coefs
    return np.stack([polynomial.polyval(x, polynomial.polyder(coef[:, j]))
                     for j in range(x.size)], axis=1)


def interp_rows(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(T, d+1) values l_j(s_t) of the cardinal polynomials at points s."""
    s = np.asarray(s, dtype=np.float64)[:, None]
    rows = np.ones((s.shape[0], x.size))
    for j in range(x.size):
        for m in range(x.size):
            if m != j:
                rows[:, j] *= (s[:, 0] - x[m]) / (x[j] - x[m])
    return rows
