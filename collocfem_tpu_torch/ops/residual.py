"""Per-element collocation residual primitives.

Counterpart of ``collocfem_tpu/ops/residual.py``.  Every function works on a
single element; the problem layer maps them over all elements with
``torch.func.vmap`` and the assembly differentiates them with ``jacfwd``.
"""

from __future__ import annotations

import torch
from torch.func import vmap


def element_derivative(diff, width, Xe):
    """Collocation-polynomial time derivative at all element nodes.

    Args:
      diff:  (d+1, d+1) reference-element differentiation matrix.
      width: scalar element width h_e.
      Xe:    (d+1, n) node values.
    Returns:
      (d+1, n) dX/dt at the nodes (chain rule: dtau/dt = 2/h).

    D annihilates constants (its rows sum to zero), so the element-left value
    is subtracted first: mathematically identical, but it removes the O(|X|)
    cancellation in D @ X that leaves float32 derivatives with ~3 significant
    digits on fine meshes (h ~ 1e-3).
    """
    return (2.0 / width) * (diff @ (Xe - Xe[:1]))


def defect_residual(model, diff, width, times, Xe, Ue, p, scale):
    """Weighted collocation defects at local nodes 1..d of one element.

    The defect at node k is dx/dt(t_k) - f(x_k, u_k, p, t_k); local node 0 is
    skipped (it is node d of the previous element, or the initial state).

    Args:
      model: Model instance.
      diff:  (d+1, d+1) differentiation matrix.
      width: scalar h_e.
      times: (d+1,) node times.
      Xe:    (d+1, nx) node states.
      Ue:    (d+1, nu) node inputs.
      p:     (nq,) parameters.
      scale: (d, nx) multiplicative sqrt-weights (quadrature x process noise).
    Returns:
      (d, nx) scaled defect residuals.
    """
    xdot = element_derivative(diff, width, Xe)
    fvals = vmap(model.f, in_dims=(0, 0, None, 0))(Xe, Ue, p, times)
    return (xdot - fvals)[1:, :] * scale


def defect_residual_all(model, diff, width, times, Xe, Ue, p, scale):
    """Weighted defects at ALL d+1 nodes of one element.

    The trajectory-optimization layer enforces the defect at every LGL node:
    that pins the degree-d defect polynomial at d+1 points, so it vanishes
    identically (collocating only at d nodes leaves one dynamics-violating
    control mode per element that an optimizer exploits).  The constraint
    set is mildly over-determined across shared nodes, which the
    augmented-Lagrangian least-squares form absorbs.

    Returns (d+1, nx) scaled defect residuals (``scale`` is (d+1, nx)).
    """
    xdot = element_derivative(diff, width, Xe)
    fvals = vmap(model.f, in_dims=(0, 0, None, 0))(Xe, Ue, p, times)
    return (xdot - fvals) * scale


def measurement_residual(model, rows, Xe, Ue_meas, p, times, y, w, mask):
    """Weighted output residuals for the measurements landing in one element.

    Args:
      model:   Model instance.
      rows:    (S, d+1) Lagrange interpolation rows at the sample times.
      Xe:      (d+1, nx) node states.
      Ue_meas: (S, nu) input at the sample times.
      p:       (nq,) parameters.
      times:   (S,) sample times.
      y:       (S, ny) measured values (padded entries arbitrary).
      w:       (ny,) or (S, ny) sqrt measurement weights.
      mask:    (S,) 1.0 for real samples, 0.0 for padding.
    Returns:
      (S, ny) scaled residuals (zero on padding).
    """
    x_s = rows @ Xe
    h_s = vmap(model.h, in_dims=(0, 0, None, 0))(x_s, Ue_meas, p, times)
    return (h_s - y) * w * mask[:, None]


def interpolate_states(rows, Xe):
    """(S, d+1) rows x (d+1, n) node values -> (S, n) interpolated values."""
    return rows @ Xe
