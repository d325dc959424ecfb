"""Trajectory-optimization problem assembly (config 3).

Counterpart of ``collocfem_tpu/ocp.py``.  Controls are node decision
variables beside the states: each global node carries v = [x (nx); u (nu)],
so the Gauss-Newton KKT matrix keeps the uniform block-tridiagonal structure
of estimation (blocks of d nodes, b = d (nx + nu)), and the constrained solve
(:mod:`collocfem_tpu_torch.solve.auglag`) runs the same damped chain solve.

Residual and constraint groups:
  * collocation defects at every node of every element (equalities, handled
    by the augmented Lagrangian), scaled by sqrt(w_k h_e / 2);
  * boundary conditions x(t0), x(tf) (equalities, masked per component);
  * running and terminal cost in least-squares form
    (``Model.running_cost_residual``, ``Model.terminal_cost_residual``);
  * path constraints g(x, u, p, t) <= 0 at every global node (log barrier);
  * equality path constraints g_eq(x, u, p, t) = 0 at every global node
    (augmented Lagrangian).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import vmap

from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.ops import residual as res_ops
from collocfem_tpu_torch.ops.mesh import Mesh
from collocfem_tpu_torch.problem import Decision


class Multipliers(NamedTuple):
    """Augmented-Lagrangian multipliers of the equality constraint groups."""

    defect: torch.Tensor   # (N, d+1, nx) defects at ALL nodes
    b0: torch.Tensor       # (nx,)
    bf: torch.Tensor       # (nx,)
    path_eq: torch.Tensor  # (M, ne) equality path constraints per node


def _mask_from_value(val, nx):
    """NaN entries mean 'free'; finite entries are fixed boundary values."""
    if val is None:
        return np.zeros(nx), np.zeros(nx)
    v = np.broadcast_to(np.asarray(val, dtype=np.float64), (nx,))
    fixed = np.isfinite(v)
    return np.where(fixed, v, 0.0), fixed.astype(np.float64)


class OptimalControlProblem(nn.Module):
    """Direct LGL collocation OCP with node variables v = [x; u].

    Buffers (moved by ``.to(device)``): ``diff`` (d+1, d+1), ``widths``
    (N,), ``elem_times`` (N, d+1), ``cscale`` (N, d+1, nx) defect scale,
    ``qscale`` (N, d+1) cost-quadrature scale, ``node_times`` (M,),
    ``x0_val``, ``x0_mask``, ``xf_val``, ``xf_mask`` (nx,) (mask 1 = fixed
    component).
    """

    diff: torch.Tensor
    widths: torch.Tensor
    elem_times: torch.Tensor
    cscale: torch.Tensor
    qscale: torch.Tensor
    node_times: torch.Tensor
    x0_val: torch.Tensor
    x0_mask: torch.Tensor
    xf_val: torch.Tensor
    xf_mask: torch.Tensor

    def __init__(self, model: Model, mesh: Mesh, tables: dict):
        super().__init__()
        self.model = model
        self.mesh = mesh
        for name, value in tables.items():
            self.register_buffer(name, value)

    @staticmethod
    def build(model: Model, mesh: Mesh, x0=None, xf=None, *, dtype,
              device) -> "OptimalControlProblem":
        """Precompute the static tables on the host and place them on
        ``device`` in ``dtype``.  NaN entries of ``x0`` / ``xf`` are free."""
        nx = model.nx
        w = mesh.basis.weights
        h = mesh.widths
        cscale = np.broadcast_to(
            np.sqrt(w[None, :, None] * h[:, None, None] * 0.5),
            (mesh.num_elements, mesh.degree + 1, nx))
        qscale = np.sqrt(w[None, :] * h[:, None] * 0.5)
        x0v, x0m = _mask_from_value(x0, nx)
        xfv, xfm = _mask_from_value(xf, nx)
        tables = dict(diff=mesh.basis.diff, widths=h,
                      elem_times=mesh.elem_times, cscale=cscale,
                      qscale=qscale, node_times=mesh.node_times, x0_val=x0v,
                      x0_mask=x0m, xf_val=xfv, xf_mask=xfm)
        return OptimalControlProblem(model, mesh, {
            k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in tables.items()
        })

    # -- sizes ----------------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.diff.dtype

    @property
    def device(self) -> torch.device:
        return self.diff.device

    @property
    def nv(self) -> int:
        return self.model.nx + self.model.nu

    @property
    def num_nodes(self) -> int:
        return self.mesh.num_nodes

    def split(self, V):
        """(..., nv) node variables -> states (..., nx), controls (..., nu)."""
        nx = self.model.nx
        return V[..., :nx], V[..., nx:]

    # -- per-element pieces (mapped over the elements by the solver) ----------
    def gather_elements(self, V):
        """(M, nv) node values -> (N, (d+1) nv) per-element flats (d+1
        static strided slices: element e spans nodes e d .. e d + d)."""
        n, d = self.mesh.num_elements, self.mesh.degree
        cols = [V[..., j:j + (n - 1) * d + 1:d, :] for j in range(d + 1)]
        return torch.stack(cols, dim=-2).reshape(*V.shape[:-2], n, -1)

    def elem_constraints(self, ve_flat, p, width, times, cscale):
        """Scaled defect constraints of one element: (d+1, nx)."""
        ve = ve_flat.reshape(self.mesh.degree + 1, self.nv)
        x_nodes, u_nodes = self.split(ve)
        return res_ops.defect_residual_all(self.model, self.diff, width,
                                           times, x_nodes, u_nodes, p, cscale)

    def elem_cost_residual(self, ve_flat, p, times, qscale):
        """Scaled running-cost residuals of one element: (d+1, nl)."""
        ve = ve_flat.reshape(self.mesh.degree + 1, self.nv)
        x_nodes, u_nodes = self.split(ve)
        lr = vmap(self.model.running_cost_residual, in_dims=(0, 0, None, 0))(
            x_nodes, u_nodes, p, times)
        return lr * qscale[:, None]

    # -- whole-trajectory quantities ------------------------------------------
    def _node_map(self, fn, z: Decision):
        x, u = self.split(z.V)
        return vmap(fn, in_dims=(0, 0, None, 0))(x, u, z.p, self.node_times)

    def constraints(self, z: Decision) -> Multipliers:
        """Every equality constraint value (the shape of the multipliers)."""
        c_def = vmap(self.elem_constraints, in_dims=(0, None, 0, 0, 0))(
            self.gather_elements(z.V), z.p, self.widths, self.elem_times,
            self.cscale)
        x, _ = self.split(z.V)
        return Multipliers(
            defect=c_def, b0=self.x0_mask * (x[0] - self.x0_val),
            bf=self.xf_mask * (x[-1] - self.xf_val),
            path_eq=self.eq_path_constraints(z))

    def path_constraints(self, z: Decision):
        """g(x, u, p, t) at every global node: (M, ng)."""
        return self._node_map(self.model.g, z)

    def eq_path_constraints(self, z: Decision):
        """g_eq(x, u, p, t) at every global node: (M, ne)."""
        return self._node_map(self.model.g_eq, z)

    def objective(self, z: Decision):
        """Quadrature running cost + terminal cost (no constraint terms)."""
        lr = vmap(self.elem_cost_residual, in_dims=(0, None, 0, 0))(
            self.gather_elements(z.V), z.p, self.elem_times, self.qscale)
        x, _ = self.split(z.V)
        tr = self.model.terminal_cost_residual(x[-1], z.p)
        return 0.5 * (torch.sum(lr * lr) + torch.sum(tr * tr))

    def zero_multipliers(self) -> Multipliers:
        n, d, nx = self.mesh.num_elements, self.mesh.degree, self.model.nx
        zeros = lambda *shape: torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
        return Multipliers(defect=zeros(n, d + 1, nx), b0=zeros(nx),
                           bf=zeros(nx),
                           path_eq=zeros(self.num_nodes, self.model.ne))

    def initial_guess(self, u0=0.0, p0=None) -> Decision:
        """Linear state interpolation between the (masked) boundary values,
        constant controls u0, parameters p0 (default zeros)."""
        m = self.mesh
        nu = self.model.nu
        s = (np.asarray(m.node_times) - m.t0) / (m.tf - m.t0)
        host = lambda t: t.cpu().double().numpy()
        xa = host(self.x0_val) * host(self.x0_mask)
        xb = host(self.xf_val) * host(self.xf_mask)
        X = xa[None, :] + s[:, None] * (xb - xa)[None, :]
        U = np.broadcast_to(np.asarray(u0, dtype=np.float64),
                            (m.num_nodes, nu))
        V = np.concatenate([X, U], axis=1)
        p = np.zeros(self.model.nq) if p0 is None else np.asarray(p0)
        as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64),
                                         dtype=self.dtype, device=self.device)
        return Decision(V=as_t(V), p=as_t(p))
