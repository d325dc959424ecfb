"""Smoother-based warm starts for collocation estimation.

Counterpart of ``collocfem_tpu/kalman/initialize.py``: run an (unscented)
Kalman smoother at a nominal parameter value, then hand the smoothed state
path to the joint MAP collocation problem as its initial guess.
"""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.kalman.filtering import (
    cd_smoother,
    ekf_filter,
    ukf_filter,
)
from collocfem_tpu_torch.problem import Decision


def smoother_initial_guess(problem, t_meas, y, p0, R, Qc, m0=None, P0=None,
                           u_nodes=None, substeps: int = 4,
                           kind: str = "ekf") -> Decision:
    """Decision warm start from a CD-EKF/UKF fixed-interval smoother.

    The filter runs at ``p0`` over the measurement grid (inputs, if any,
    interpolated from the mesh nodes) on the problem's device and in its
    dtype (the filter and smoother scans captured on a CUDA device); the
    smoothed means come to the host once and are interpolated there
    (``np.interp``) to the collocation node times.  ``R`` (ny, ny) and
    ``Qc`` (nx, nx) set measurement/process noise; defaults for the prior
    are m0 = measured channels at the first sample (zeros elsewhere) and
    P0 = 4 max(1, max |y|)^2 I.
    """
    model = problem.model
    t_meas = np.asarray(t_meas, dtype=np.float64)
    y = np.atleast_2d(np.asarray(y, dtype=np.float64))
    nx = model.nx

    u_meas = None
    if model.nu > 0:
        # u_nodes follows pack_data's convention: (num_elements, degree+1,
        # nu) sampled at mesh.elem_times.  Element-boundary nodes appear
        # twice in the flattened grid; np.interp handles the duplicates.
        tt = np.asarray(problem.mesh.elem_times).ravel()
        un = (np.zeros((tt.size, model.nu)) if u_nodes is None
              else np.asarray(u_nodes).reshape(-1, model.nu))
        u_meas = np.stack(
            [np.interp(t_meas, tt, un[:, j]) for j in range(model.nu)],
            axis=1)

    if m0 is None:
        m0 = np.zeros(nx)
        m0[: min(nx, y.shape[1])] = y[0, : min(nx, y.shape[1])]
    if P0 is None:
        # Moderate, data-scaled prior, deliberately NOT diffuse: UKF sigma
        # points at +-sqrt((nx+lam) P0) must stay where fixed-substep RK4
        # of the dynamics is stable.  The first update (dt0 = 0) anchors
        # the measured channels before any propagation happens.
        P0 = 4.0 * max(1.0, float(np.max(np.abs(y)))) ** 2 * np.eye(nx)

    filt = {"ekf": ekf_filter, "ukf": ukf_filter}[kind]
    ys = problem._tensor(y)
    res = filt(model, problem._tensor(p0), t_meas, ys, R, Qc, m0, P0,
               u=u_meas, substeps=substeps, device=problem.device)
    ms = cd_smoother(res)[0].detach().cpu().double().numpy()

    node_t = np.asarray(problem.mesh.node_times)
    V0 = np.stack(
        [np.interp(node_t, t_meas, ms[:, j]) for j in range(nx)], axis=1)
    return Decision(V=problem._tensor(V0), p=problem._tensor(p0))
