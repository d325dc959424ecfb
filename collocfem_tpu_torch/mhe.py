"""Moving-horizon estimation: online sliding-window MAP state estimation.

Counterpart of ``collocfem_tpu/mhe.py``: the serving path of the system, one
:meth:`MovingHorizonEstimator.step` per incoming sample.

Design
------
* The window holds the most recent ``horizon`` samples at fixed spacing
  ``dt``.  The mesh (one degree-``degree`` element per sample interval) is
  built ONCE over the window's **local time** [0, (horizon-1) dt]; sliding
  the window changes only the data tensors (models must be time-invariant:
  ``f``/``h`` receive local window time).
* Discarded information enters through a **filtering arrival cost**
  (Rao-Rawlings-Mayne): when the oldest sample y_0 leaves the window, the
  running prior (m, P) is EKF-updated with y_0 (Joseph form) and propagated
  one sample interval by RK4 integration of the moment ODE (m' = f,
  P' = A P + P A^T + Q_c).  The prior lands in the window problem as a
  full-matrix sqrt-information x0 prior (``ProblemData.x0_w`` with L =
  chol(P)^-1), so correlated arrival uncertainty is carried exactly.
* Each ``step`` warm-starts from the previous window solution shifted by
  one element and solves the window MAP problem with the damped
  Gauss-Newton driver (block-tridiagonal KKT, no arrowhead: parameters are
  fixed online).  On a CUDA device 'auto' runs the SPIKE chain kernel
  (kernel #2) once per LM iteration.

The JAX package compiles ``step`` with ``jax.jit``.  On a CUDA device the
port replays it from CUDA graphs (:mod:`solve.graph`): one graph of the work
before the window solve (the EKF update, the RK4 moment propagation, the
window slide, the warm start and the window's data), then the captured
window solve, whose early exit reads ``done`` once per LM iteration.
:meth:`MovingHorizonEstimator.step_eager` is the same step run eagerly, bit
for bit; on the CPU ``step`` runs eagerly too.  For linear-Gaussian models
the scheme reproduces the Kalman filter at the newest sample (up to
collocation/RK4 discretization error).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import (
    Decision,
    EstimationProblem,
    ProblemData,
    group_measurements,
)
from collocfem_tpu_torch.solve.covariance import state_covariance_nodes
from collocfem_tpu_torch.solve.graph import CapturedFunction
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver


class _FixedParamModel(Model):
    """Wrap a model with nq > 0, pinning its parameters to known values
    (a tensor on the estimator's device, in its dtype)."""

    def __init__(self, base: Model, p_fixed, device, dtype):
        self.base = base
        p_fixed = np.asarray(p_fixed, dtype=np.float64)
        if p_fixed.shape != (base.nq,):
            raise ValueError(
                f"p_fixed must have shape ({base.nq},), got {p_fixed.shape}"
            )
        self.p_fixed = torch.as_tensor(p_fixed, dtype=dtype, device=device)
        self.nx, self.nu, self.nq = base.nx, base.nu, 0

    def f(self, x, u, p, t):
        del p
        return self.base.f(x, u, self.p_fixed, t)

    def h(self, x, u, p, t):
        del p
        return self.base.h(x, u, self.p_fixed, t)


class MHEState(NamedTuple):
    """State of the moving-horizon estimator (one per stream).

    Attributes:
      z: current window MAP solution (warm start for the next step).
      m: (nx,) arrival-prior mean at the window start: the filtered mean
         given every sample that has LEFT the window.
      P: (nx, nx) arrival-prior covariance at the window start.
      y: (H, ny) window measurements, oldest first.
      u: (H-1, nu) zero-order-hold inputs per sample interval.
      k: samples consumed so far (the initial window counts as H).
    """

    z: Decision
    m: torch.Tensor
    P: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    k: int


class MovingHorizonEstimator:
    """Sliding-window MAP estimator over the last ``horizon`` samples.

    Args:
      model: time-invariant :class:`Model` (local window time is passed to
        ``f``/``h``).  Models with unknown parameters require ``p_fixed``.
      horizon: number of samples in the window (>= 2).
      dt: sample spacing.
      sig_w: process-noise spectral density (scalar or (nx,): sqrt Q_c diag).
      sig_v: measurement noise std (scalar or (ny,)).
      degree: LGL element degree per sample interval.
      p_fixed: known parameter values when ``model.nq > 0``.
      substeps: RK4 substeps for the arrival-cost moment propagation.
      options: Gauss-Newton solver options for the window solve.
      device, dtype: where the window problem lives and is solved.

    Usage::

        mhe = MovingHorizonEstimator(model, horizon=10, dt=0.1, sig_w=0.3,
                                     sig_v=0.05, device="cuda")
        state = mhe.init(y_first_window, m0=m0, P0=P0)
        state, est = mhe.step(state, y_new, u_new)
    """

    def __init__(self, model: Model, horizon: int, dt: float, sig_w, sig_v,
                 degree: int = 4, p_fixed=None, substeps: int = 4,
                 options: SolverOptions | None = None, *, device,
                 dtype=torch.float64):
        if horizon < 2:
            raise ValueError("horizon must be >= 2 samples")
        if model.nq > 0:
            if p_fixed is None:
                raise ValueError(
                    "model has unknown parameters; MHE estimates states only "
                    "- pass p_fixed with their known values"
                )
            model = _FixedParamModel(model, p_fixed, device, dtype)
        self.model = model
        self.horizon = int(horizon)
        self.dt = float(dt)
        self.degree = int(degree)
        self.substeps = int(substeps)
        nx, ny = model.nx, model.ny

        mesh = uniform_mesh(0.0, (horizon - 1) * dt, horizon - 1, degree)
        t_samples = np.arange(horizon, dtype=np.float64) * dt
        sw = np.broadcast_to(np.asarray(sig_w, np.float64), (nx,))
        sv = np.broadcast_to(np.asarray(sig_v, np.float64), (ny,))
        # Full-rule defect quadrature: the interior rule's dropped
        # left-endpoint weight biases the process-noise integral by
        # O(1/(d(d+1))), visible against the Kalman-filter oracle.
        self.problem = EstimationProblem.build(
            model, mesh, t_samples, defect_weight=1.0 / sw, device=device,
            dtype=dtype, defect_rule="full",
        )
        self.dtype, self.device = self.problem.dtype, self.problem.device
        self._t_samples = t_samples
        self._meas_w = self.problem._tensor(1.0 / sv)
        self._Qc = self.problem._tensor(np.diag(sw**2))
        self._R = self.problem._tensor(np.diag(sv**2))
        self._empty = self.problem._tensor(np.zeros(0))

        # Static (element, slot) -> sample-index table: the window's grouped
        # measurement values are a gather of the (H, ny) ring buffer.
        idx = np.arange(horizon, dtype=np.float64)[:, None]
        ig, _, _, _ = group_measurements(
            mesh, t_samples, idx, pad_to=self.problem.mrows.shape[1]
        )
        self._slot_sample = torch.as_tensor(ig[..., 0].astype(np.int64),
                                            device=self.device)  # (N, S)

        self.options = options or SolverOptions(maxiter=25)
        self._solver = make_gn_solver(self.problem, self.options)
        self._advance_graph = CapturedFunction(self._advance)

    # -- data plumbing ---------------------------------------------------------
    def _sqrt_info(self, P):
        """P = S S^T (chol)  ->  L = S^-1 with ||L(x-m)||^2 = (x-m)^T P^-1
        (x-m).  The ``_ex`` factorisations here and in ``_ekf_update`` read
        no error flag back to the host."""
        S = torch.linalg.cholesky_ex(P).L
        eye = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
        return torch.linalg.solve_triangular(S, eye, upper=False)

    def _data(self, y_win, u_win, m, P) -> ProblemData:
        n, d = self.problem.mesh.num_elements, self.degree
        nu = self.model.nu
        yg = y_win[self._slot_sample]  # (N, S, ny); padded slots masked out
        return ProblemData(
            y=yg,
            u=u_win[:, None, :].expand(n, d + 1, nu),
            meas_w=self._meas_w,
            p_prior=self._empty,
            p_w=self._empty,
            x0_prior=m,
            x0_w=self._sqrt_info(P),
        )

    # -- arrival-cost EKF pieces -------------------------------------------------
    def _ekf_update(self, m, P, y, u, t):
        hfun = lambda x: self.model.h(x, u, self._empty, t)
        H = jacfwd(hfun)(m)
        S = H @ P @ H.T + self._R
        K = torch.linalg.solve_ex(S, H @ P).result.T
        m2 = m + K @ (y - hfun(m))
        ikh = torch.eye(m.shape[0], dtype=m.dtype, device=m.device) - K @ H
        P2 = ikh @ P @ ikh.T + K @ self._R @ K.T  # Joseph form
        return m2, 0.5 * (P2 + P2.T)

    def _propagate(self, m, P, u, t0):
        """RK4 moment propagation over one sample interval under ZOH input."""
        ffun = lambda x, t: self.model.f(x, u, self._empty, t)

        def ode(m_, P_, t):
            A = jacfwd(lambda xx: ffun(xx, t))(m_)
            return ffun(m_, t), A @ P_ + P_ @ A.T + self._Qc

        h = self.dt / self.substeps
        for i in range(self.substeps):
            t = t0 + float(i) * h
            k1 = ode(m, P, t)
            k2 = ode(m + 0.5 * h * k1[0], P + 0.5 * h * k1[1], t + 0.5 * h)
            k3 = ode(m + 0.5 * h * k2[0], P + 0.5 * h * k2[1], t + 0.5 * h)
            k4 = ode(m + h * k3[0], P + h * k3[1], t + h)
            m = m + (h / 6) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            P = P + (h / 6) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        return m, 0.5 * (P + P.T)

    # -- public API --------------------------------------------------------------
    def init(self, y_window, m0, P0, u_window=None) -> MHEState:
        """Solve the first full window.  ``y_window``: (horizon, ny)."""
        h, nu = self.horizon, self.model.nu
        y = np.atleast_2d(np.asarray(y_window, np.float64))
        if y.shape != (h, self.model.ny):
            raise ValueError(
                f"y_window must be ({h}, {self.model.ny}), got {y.shape}"
            )
        u = (np.zeros((h - 1, nu)) if u_window is None
             else np.asarray(u_window, np.float64).reshape(h - 1, nu))
        nx, tensor = self.model.nx, self.problem._tensor
        m0, P0 = tensor(np.reshape(m0, nx)), tensor(np.reshape(P0, (nx, nx)))
        y_t, u_t = tensor(y), tensor(u)
        z0 = self.problem.initial_guess_from_data(self._t_samples, y,
                                                  np.zeros((0,)))
        z, _ = self._solver(z0, self._data(y_t, u_t, m0, P0))
        return MHEState(z=z, m=m0, P=P0, y=y_t, u=u_t, k=self.horizon)

    def _advance(self, m, P, y, u, V, y_new, u_new):
        """The step's work before its window solve: (m, P, y_win, u_win, z0,
        data)."""
        d, nx = self.degree, self.model.nx
        # 1. Fold the departing oldest sample into the arrival prior.
        m, P = self._ekf_update(m, P, y[0], u[0], 0.0)
        m, P = self._propagate(m, P, u[0], 0.0)
        # 2. Slide the window.
        y_win = torch.cat([y[1:], y_new[None, :]])
        u_win = torch.cat([u[1:], u_new[None, :]])
        # 3. Warm start: shift the previous solution one element left and
        #    hold the newest state over the fresh interval.
        z0 = Decision(V=torch.cat([V[d:], V[-1].expand(d, nx)]),
                      p=self._empty)
        return m, P, y_win, u_win, z0, self._data(y_win, u_win, m, P)

    def step(self, state: MHEState, y_new, u_new=None):
        """Consume one sample; returns (new_state, (nx,) newest-state MAP).
        On a CUDA device it replays the step's CUDA graphs."""
        return self._step(state, y_new, u_new, self._advance_graph,
                          self._solver)

    def step_eager(self, state: MHEState, y_new, u_new=None):
        """:meth:`step` run eagerly on any device, with the same result."""
        return self._step(state, y_new, u_new, self._advance_graph.eager,
                          self._solver.eager)

    def _step(self, state, y_new, u_new, advance, solve):
        ny, nu = self.model.ny, self.model.nu
        y_new = torch.as_tensor(y_new, dtype=self.dtype,
                                device=self.device).reshape(ny)
        u_new = (torch.zeros((nu,), dtype=self.dtype, device=self.device)
                 if u_new is None else
                 torch.as_tensor(u_new, dtype=self.dtype,
                                 device=self.device).reshape(nu))
        m, P, y_win, u_win, z0, data = advance(
            state.m, state.P, state.y, state.u, state.z.V, y_new, u_new)
        # 4. Window MAP solve with the full-matrix arrival prior.
        z, _ = solve(z0, data)
        # The captured step's outputs are overwritten by the next step: the
        # state keeps copies.
        new_state = MHEState(z=z, m=m.clone(), P=P.clone(), y=y_win.clone(),
                             u=u_win.clone(), k=state.k + 1)
        return new_state, z.V[-1]

    def estimate(self, state: MHEState) -> torch.Tensor:
        """(nx,) MAP state at the newest sample of the window."""
        return state.z.V[-1]

    def current_covariance(self, state: MHEState) -> torch.Tensor:
        """(nx, nx) posterior covariance at the newest sample.

        The last node's marginal from the Takahashi selected inverse of the
        window KKT (``solve.covariance``): for linear-Gaussian models this
        is the Kalman filtered covariance.
        """
        data = self._data(state.y, state.u, state.m, state.P)
        return state_covariance_nodes(self.problem, state.z, data)[-1]
