"""Mesh / discretization layer: elements, global node indexing, time scaling.

Counterpart of ``collocfem_tpu/ops/mesh.py`` (host numpy, no tensors).

The horizon [t0, tf] is split into N elements; element e carries a degree-d
LGL node set and adjacent elements share their boundary node, so there are
M = N*d + 1 global nodes.  For the block-tridiagonal KKT structure the node
vector is padded to K = N+1 groups of d nodes: element e touches group e and
the first node of group e+1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
