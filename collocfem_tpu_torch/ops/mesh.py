"""Mesh / discretization layer: elements, global node indexing, time scaling.

Counterpart of ``collocfem_tpu/ops/mesh.py``.  The mesh and its tables are
host numpy; :func:`interpolate_trajectory` and :func:`make_prolongation`
evaluate the collocation polynomial on tensors.

The horizon [t0, tf] is split into N elements; element e carries a degree-d
LGL node set and adjacent elements share their boundary node, so there are
M = N*d + 1 global nodes.  For the block-tridiagonal KKT structure the node
vector is padded to K = N+1 groups of d nodes: element e touches group e and
the first node of group e+1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from collocfem_tpu_torch.ops.basis import LGLBasis, make_basis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Static collocation mesh: breakpoints + degree-d LGL layout per element."""

    basis: LGLBasis
    breakpoints: np.ndarray  # (N+1,) float64, strictly increasing

    def __post_init__(self):
        bp = np.asarray(self.breakpoints, dtype=np.float64)
        if bp.ndim != 1 or bp.size < 2:
            raise ValueError("breakpoints must be 1-D with at least 2 entries")
        if not np.all(np.diff(bp) > 0):
            raise ValueError("breakpoints must be strictly increasing")
        bp = bp.copy()
        bp.setflags(write=False)
        object.__setattr__(self, "breakpoints", bp)

    @property
    def degree(self) -> int:
        return self.basis.degree

    @property
    def num_elements(self) -> int:
        return self.breakpoints.size - 1

    @property
    def num_nodes(self) -> int:
        """Global node count M = N*d + 1 (boundary nodes shared)."""
        return self.num_elements * self.degree + 1

    @property
    def num_blocks(self) -> int:
        """K = N+1 groups of d nodes each (last group padded)."""
        return self.num_elements + 1

    @property
    def t0(self) -> float:
        return float(self.breakpoints[0])

    @property
    def tf(self) -> float:
        return float(self.breakpoints[-1])

    @property
    def widths(self) -> np.ndarray:
        """(N,) element widths h_e."""
        return np.diff(self.breakpoints)

    @property
    def elem_node_idx(self) -> np.ndarray:
        """(N, d+1) int32: global node index of (element, local node)."""
        d = self.degree
        e = np.arange(self.num_elements)[:, None]
        j = np.arange(d + 1)[None, :]
        return (e * d + j).astype(np.int32)

    @property
    def node_times(self) -> np.ndarray:
        """(M,) physical time of every global node."""
        tau = self.basis.nodes
        left = self.breakpoints[:-1][:, None]
        h = self.widths[:, None]
        per_elem = left + 0.5 * h * (tau[None, :] + 1.0)  # (N, d+1)
        out = np.empty(self.num_nodes)
        out[self.elem_node_idx] = per_elem  # shared nodes written twice, equal
        return out

    @property
    def elem_times(self) -> np.ndarray:
        """(N, d+1) physical time of every (element, local node)."""
        return self.node_times[self.elem_node_idx]

    def locate(self, times: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Map physical times to (element index, local coordinate tau in [-1,1]).

        Times outside [t0, tf] are clamped to the boundary elements.
        """
        t = np.asarray(times, dtype=np.float64)
        e = np.searchsorted(self.breakpoints, t, side="right") - 1
        e = np.clip(e, 0, self.num_elements - 1)
        left = self.breakpoints[e]
        h = self.widths[e]
        tau = 2.0 * (t - left) / h - 1.0
        return e.astype(np.int32), np.clip(tau, -1.0, 1.0)

    def interp_rows(self, times: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-time element index + Lagrange row over that element's nodes.

        Returns (elem (T,) int32, rows (T, d+1) float64) such that
        ``rows[t] @ x[elem_node_idx[elem[t]]]`` evaluates the collocation
        polynomial at ``times[t]``.
        """
        e, tau = self.locate(times)
        return e, self.basis.interp_rows(tau)


def uniform_mesh(t0: float, tf: float, num_elements: int, degree: int) -> Mesh:
    """Uniform mesh over [t0, tf] with ``num_elements`` degree-``degree`` elements."""
    return Mesh(
        basis=make_basis(degree),
        breakpoints=np.linspace(float(t0), float(tf), num_elements + 1),
    )


def interpolate_trajectory(mesh: Mesh, V, times, derivative: bool = False):
    """Evaluate the piecewise collocation polynomial (and optionally d/dt).

    ``V`` (M, n) global node values (a tensor), ``times`` (T,) physical
    times.  The element location and Lagrange rows are computed on the host
    per call.  Returns (T, n) values, or (values, derivatives).
    """
    e, rows = mesh.interp_rows(times)
    Ve = V[torch.as_tensor(mesh.elem_node_idx[e], device=V.device,
                           dtype=torch.long)]                   # (T, d+1, n)
    as_t = lambda a: torch.as_tensor(np.array(a), dtype=V.dtype,
                                     device=V.device)
    vals = torch.einsum("tj,tjn->tn", as_t(rows), Ve)
    if not derivative:
        return vals
    # p' at the nodes is D @ p (exact for degree <= d); interpolate those.
    dVe = torch.einsum("kj,tjn->tkn", as_t(mesh.basis.diff), Ve)
    scale = as_t(2.0 / mesh.widths[e])[:, None]
    return vals, torch.einsum("tj,tjn->tn", as_t(rows), dVe) * scale


def make_prolongation(mesh: Mesh, times, *, device, dtype):
    """A device-side evaluator of the collocation polynomial at fixed
    ``times`` (the multilevel ladder's warm start between levels).

    The element and Lagrange-row tables are built on the host once and
    placed on ``device``; the returned ``prolong(V) -> (T, n)`` is a gather
    and an einsum, with no host work or transfer per call.
    """
    e, rows = mesh.interp_rows(np.asarray(times, dtype=np.float64))
    idx = torch.as_tensor(mesh.elem_node_idx[e], dtype=torch.long,
                          device=device)                        # (T, d+1)
    rows_t = torch.as_tensor(rows, dtype=dtype, device=device)

    def prolong(V):
        return torch.einsum("tj,tjn->tn", rows_t, V[idx])

    return prolong


def refined_mesh(t0: float, tf: float, num_elements: int, degree: int,
                 density: np.ndarray) -> Mesh:
    """Graded mesh whose breakpoint density follows ``density`` (> 0,
    (num_elements_old,)): each new element receives equal integrated
    density."""
    w = np.asarray(density, dtype=np.float64)
    if w.ndim != 1 or np.any(w <= 0):
        raise ValueError("density must be 1-D and strictly positive")
    cdf = np.concatenate([[0.0], np.cumsum(w)])
    cdf /= cdf[-1]
    grid = np.linspace(0.0, 1.0, w.size + 1)
    targets = np.linspace(0.0, 1.0, num_elements + 1)
    bp = t0 + (tf - t0) * np.interp(targets, cdf, grid)
    bp[0], bp[-1] = t0, tf
    return Mesh(basis=make_basis(degree), breakpoints=bp)
