"""Problem assembly layer: estimation problems on a collocation mesh.

Counterpart of ``collocfem_tpu/problem.py``.  A problem is split into

  * a static :class:`EstimationProblem` (an ``nn.Module``): the model, the
    mesh, and host-built tables (differentiation matrix, widths,
    interpolation rows, masks) registered as buffers, so ``.to(device)``
    moves them; and
  * a :class:`ProblemData` tuple of tensors: measurements, inputs, priors
    and weights, passed at call time.

Residuals are evaluated per element (``torch.func.vmap``) and turned into
the block-tridiagonal + arrowhead Gauss-Newton system by
:mod:`collocfem_tpu_torch.ops.assemble`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import vmap

from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.ops.assemble import x0_prior_residual
from collocfem_tpu_torch.ops import residual as res_ops
from collocfem_tpu_torch.ops.mesh import Mesh
from collocfem_tpu_torch.utils.profiling import spanned


class Decision(NamedTuple):
    """Decision variables: node values V (M, nv) and parameters p (nq,)."""

    V: torch.Tensor
    p: torch.Tensor


class ProblemData(NamedTuple):
    """Per-experiment data.

    Attributes:
      y:        (N, S, ny) measurement values grouped by element (padded).
      u:        (N, d+1, nu) exogenous input at the collocation nodes.
      meas_w:   (ny,) sqrt measurement weights (1/sigma), or (N, S, ny)
                per sample (the IRLS solver's reweighted data).
      p_prior:  (nq,) parameter prior mean.
      p_w:      (nq,) sqrt prior weights (0 = no prior on that parameter).
      x0_prior: (nx,) initial-state prior mean.
      x0_w:     (nx,) sqrt prior weights (0 = free initial state), or a
                full (nx, nx) sqrt-information matrix L (residual
                L (x(t0) - x0_prior), normal-equation term L^T L): the
                moving-horizon estimator's arrival prior (``mhe.py``).
    """

    y: torch.Tensor
    u: torch.Tensor
    meas_w: torch.Tensor
    p_prior: torch.Tensor
    p_w: torch.Tensor
    x0_prior: torch.Tensor
    x0_w: torch.Tensor


class ElemData(NamedTuple):
    """Per-element slice of problem tables + data (vmapped over elements)."""

    width: torch.Tensor   # ()
    times: torch.Tensor   # (d+1,)
    u: torch.Tensor       # (d+1, nu)
    dscale: torch.Tensor  # (d, nx), or (d+1, nx) for the 'full' rule
    rows: torch.Tensor    # (S, d+1)
    mask: torch.Tensor    # (S,)
    mtimes: torch.Tensor  # (S,)
    y: torch.Tensor       # (S, ny)
    meas_w: torch.Tensor  # (S, ny) per-sample sqrt weights


def group_measurements(mesh: Mesh, times, values, pad_to: int | None = None):
    """Group samples by containing element with static-shape padding.

    Returns host arrays (y (N,S,ny), rows (N,S,d+1), mask (N,S),
    mtimes (N,S)).
    """
    times = np.asarray(times, dtype=np.float64)
    values = np.atleast_2d(np.asarray(values, dtype=np.float64))
    if values.shape[0] != times.shape[0]:
        raise ValueError("values must have one row per sample time")
    n, d = mesh.num_elements, mesh.degree
    e, rows = mesh.interp_rows(times)
    counts = np.bincount(e, minlength=n)
    s = int(counts.max()) if pad_to is None else int(pad_to)
    if s < counts.max():
        raise ValueError(f"pad_to={s} < max samples per element {counts.max()}")
    s = max(s, 1)
    ny = values.shape[1]
    yg = np.zeros((n, s, ny))
    rg = np.zeros((n, s, d + 1))
    mg = np.zeros((n, s))
    tg = np.zeros((n, s))
    # Stable-sort samples by element; the slot of a sample is its rank
    # within its element.
    order = np.argsort(e, kind="stable")
    es = e[order]
    starts = np.searchsorted(es, np.arange(n), side="left")
    slot = np.arange(es.size) - starts[es]
    yg[es, slot] = values[order]
    rg[es, slot] = rows[order]
    mg[es, slot] = 1.0
    tg[es, slot] = times[order]
    return yg, rg, mg, tg


class EstimationProblem(nn.Module):
    """Weighted nonlinear least-squares collocation problem.

    Residual groups:
      * defects at local nodes 1..d of every element (all d+1 nodes for
        ``defect_rule='full'``), scaled by
        sqrt(quadrature weight * h/2) * defect_weight;
      * measurement residuals h(x(t_i)) - y_i scaled by meas_w;
      * optional Gaussian priors on p and on x(t0).

    Buffers (moved by ``.to(device)``): ``diff`` (d+1, d+1), ``widths``
    (N,), ``elem_times`` (N, d+1), ``dscale`` (N, d, nx) or (N, d+1, nx),
    ``mrows``
    (N, S, d+1), ``mmask`` (N, S), ``mtimes`` (N, S).
    """

    diff: torch.Tensor
    widths: torch.Tensor
    elem_times: torch.Tensor
    dscale: torch.Tensor
    mrows: torch.Tensor
    mmask: torch.Tensor
    mtimes: torch.Tensor

    def __init__(self, model: Model, mesh: Mesh, tables: dict,
                 defect_rule: str = "interior"):
        super().__init__()
        self.model = model
        self.mesh = mesh
        self.defect_rule = defect_rule
        for name, value in tables.items():
            self.register_buffer(name, value)

    @staticmethod
    @spanned("problem.build")
    def build(model: Model, mesh: Mesh, meas_times, defect_weight=1.0,
              pad_to: int | None = None, *, device, dtype,
              defect_rule: str = "interior") -> "EstimationProblem":
        """Precompute the static tables on the host and place them on
        ``device`` in ``dtype``.

        ``defect_rule``: ``"interior"`` collocates the defects at local
        nodes 1..d; ``"full"`` at all d+1 LGL nodes, each with its own
        quadrature weight, so the MAP objective integrates the process
        noise with the complete LGL rule (filtering-grade estimation: the
        moving-horizon estimator and the Kalman-smoother parity).
        """
        if defect_rule not in ("interior", "full"):
            raise ValueError(f"unknown defect_rule {defect_rule!r}")
        nx = model.nx
        dummy_vals = np.zeros((np.asarray(meas_times).size, model.ny))
        _, rg, mg, tg = group_measurements(mesh, meas_times, dummy_vals,
                                           pad_to)
        # Defect scale sqrt(w_k * h_e / 2) * defect_weight at the collocated
        # nodes (1..d, or 0..d for the 'full' rule).
        w = mesh.basis.weights if defect_rule == "full" else \
            mesh.basis.weights[1:]
        h = mesh.widths
        dw = np.broadcast_to(np.asarray(defect_weight, dtype=np.float64),
                             (nx,))
        scale = np.sqrt(w[None, :, None] * h[:, None, None] * 0.5) * dw
        tables = dict(diff=mesh.basis.diff, widths=h,
                      elem_times=mesh.elem_times, dscale=scale, mrows=rg,
                      mmask=mg, mtimes=tg)
        return EstimationProblem(model, mesh, {
            k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in tables.items()
        }, defect_rule)

    @property
    def dtype(self) -> torch.dtype:
        return self.diff.dtype

    @property
    def device(self) -> torch.device:
        return self.diff.device

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float64),
                               dtype=self.dtype, device=self.device)

    @spanned("problem.pack_data")
    def pack_data(self, y_values, meas_times, u_nodes=None, meas_weight=1.0,
                  p_prior=None, p_weight=0.0, x0_prior=None,
                  x0_weight=0.0) -> ProblemData:
        """Build the ProblemData tensors from raw sample arrays."""
        m = self.model
        y_arr = np.atleast_2d(np.asarray(y_values, dtype=np.float64))
        if y_arr.shape[-1] != m.ny:
            raise ValueError(
                f"y_values has {y_arr.shape[-1]} channel(s) but the model's "
                f"output map h produces ny={m.ny}"
            )
        yg, _, _, _ = group_measurements(
            self.mesh, meas_times, y_values, pad_to=self.mrows.shape[1]
        )
        n, d = self.mesh.num_elements, self.mesh.degree
        if u_nodes is None:
            u_nodes = np.zeros((n, d + 1, m.nu))
        bc = lambda v, k: np.broadcast_to(np.asarray(v, dtype=np.float64), (k,))
        x0w = x0_weight if np.ndim(x0_weight) == 2 else bc(x0_weight, m.nx)
        return ProblemData(
            y=self._tensor(yg),
            u=self._tensor(u_nodes),
            meas_w=self._tensor(bc(meas_weight, m.ny)),
            p_prior=self._tensor(np.zeros(m.nq) if p_prior is None
                                 else p_prior),
            p_w=self._tensor(bc(p_weight, m.nq)),
            x0_prior=self._tensor(np.zeros(m.nx) if x0_prior is None
                                  else x0_prior),
            x0_w=self._tensor(x0w),
        )

    @property
    def nv(self) -> int:
        """Decision variables per node (estimation: just the state)."""
        return self.model.nx

    @property
    def num_nodes(self) -> int:
        return self.mesh.num_nodes

    def _elem_data(self, data: ProblemData) -> ElemData:
        # meas_w may be (ny,) shared or (N, S, ny) per sample (IRLS).
        n, s = self.mmask.shape
        return ElemData(
            width=self.widths,
            times=self.elem_times,
            u=data.u,
            dscale=self.dscale,
            rows=self.mrows,
            mask=self.mmask,
            mtimes=self.mtimes,
            y=data.y,
            meas_w=data.meas_w.expand(n, s, self.model.ny),
        )

    def elem_residual(self, xe_flat, p, ed: ElemData):
        """Residual vector of ONE element: (d*nx + S*ny,), or ((d+1)*nx +
        S*ny,) for the 'full' rule. jacfwd target."""
        d, nx = self.mesh.degree, self.model.nx
        xe = xe_flat.reshape(d + 1, self.nv)
        x_nodes, u_nodes = xe[:, :nx], ed.u
        defect_fn = (res_ops.defect_residual_all
                     if self.defect_rule == "full"
                     else res_ops.defect_residual)
        defect = defect_fn(
            self.model, self.diff, ed.width, ed.times, x_nodes, u_nodes, p,
            ed.dscale,
        )
        u_meas = res_ops.interpolate_states(ed.rows, u_nodes)
        meas = res_ops.measurement_residual(
            self.model, ed.rows, x_nodes, u_meas, p, ed.mtimes, ed.y,
            ed.meas_w, ed.mask,
        )
        return torch.cat([defect.reshape(-1), meas.reshape(-1)])

    def gather_elements(self, V):
        """(..., M, nv) node values -> (..., N, (d+1)*nv) per-element flats.

        Element e spans global nodes e*d + j (j = 0..d, endpoints shared),
        so the overlapping windows are d+1 static strided slices.
        """
        n, d = self.mesh.num_elements, self.mesh.degree
        cols = [V[..., j:j + (n - 1) * d + 1:d, :] for j in range(d + 1)]
        return torch.stack(cols, dim=-2).reshape(*V.shape[:-2], n, -1)

    def elem_data_batched(self, data_batch: ProblemData):
        """Element data of a batch of experiments (a leading experiment axis
        on every ``data_batch`` leaf), with the ``vmap`` in_dims that map
        the experiment axis: the shared tables are not batched (None)."""
        n, s = self.mmask.shape
        e = data_batch.y.shape[0]
        ed = ElemData(
            width=self.widths, times=self.elem_times, u=data_batch.u,
            dscale=self.dscale, rows=self.mrows, mask=self.mmask,
            mtimes=self.mtimes, y=data_batch.y,
            meas_w=data_batch.meas_w[:, None, None, :].expand(
                e, n, s, self.model.ny),
        )
        dims = ElemData(width=None, times=None, u=0, dscale=None, rows=None,
                        mask=None, mtimes=None, y=0, meas_w=0)
        return ed, dims

    def residuals_batched(self, Vb, p, data_batch: ProblemData):
        """Element residuals of every experiment: (E, N, m), shared p."""
        ed, dims = self.elem_data_batched(data_batch)
        per_exp = vmap(self.elem_residual, in_dims=(0, None, 0))
        return vmap(per_exp, in_dims=(0, None, dims))(
            self.gather_elements(Vb), p, ed)

    def prior_residuals_batched(self, Vb, p, data_batch: ProblemData):
        """(E, nq + nx) per-experiment prior residuals (p and x(t0))."""
        r_p = data_batch.p_w * (p - data_batch.p_prior)
        r_x0 = x0_prior_residual(
            data_batch.x0_w, Vb[:, 0, :self.model.nx] - data_batch.x0_prior)
        return torch.cat([r_p, r_x0], dim=-1)

    def prior_residuals(self, z: Decision, data: ProblemData):
        """(nq + nx,) residuals of the parameter and initial-state priors."""
        r_p = data.p_w * (z.p - data.p_prior)
        r_x0 = x0_prior_residual(data.x0_w,
                                 z.V[0, :self.model.nx] - data.x0_prior)
        return torch.cat([r_p, r_x0])

    def residual_vector(self, z: Decision, data: ProblemData):
        """Full stacked residual vector (defects, measurements, priors)."""
        xe = self.gather_elements(z.V)
        ed = self._elem_data(data)
        r_elems = vmap(self.elem_residual, in_dims=(0, None, 0))(xe, z.p, ed)
        return torch.cat([r_elems.reshape(-1), self.prior_residuals(z, data)])

    def cost(self, z: Decision, data: ProblemData):
        """0.5 * ||r||^2, accumulated in float64 (a float64 scalar)."""
        r = self.residual_vector(z, data).double()
        return 0.5 * torch.sum(r * r)

    def measurement_residuals(self, z: Decision, data: ProblemData):
        """Weighted per-sample measurement residuals (N, S, ny), zero on
        padding: what the IRLS solver reweights."""
        d, nx = self.mesh.degree, self.model.nx

        def per_elem(xe_flat, e):
            x_nodes = xe_flat.reshape(d + 1, self.nv)[:, :nx]
            u_meas = res_ops.interpolate_states(e.rows, e.u)
            return res_ops.measurement_residual(
                self.model, e.rows, x_nodes, u_meas, z.p, e.mtimes, e.y,
                e.meas_w, e.mask,
            )

        return vmap(per_elem)(self.gather_elements(z.V), self._elem_data(data))

    def initial_guess_from_data(self, meas_times, y_values, p0,
                                state_guess=None) -> Decision:
        """Crude V0: interpolate measured channels over time, zeros elsewhere."""
        m = self.mesh
        nx = self.model.nx
        V0 = np.zeros((m.num_nodes, self.nv))
        y = np.atleast_2d(np.asarray(y_values, dtype=np.float64))
        for j in range(min(nx, y.shape[1])):
            V0[:, j] = np.interp(m.node_times, np.asarray(meas_times), y[:, j])
        if state_guess is not None:
            V0[:] = state_guess
        return Decision(V=self._tensor(V0), p=self._tensor(p0))
