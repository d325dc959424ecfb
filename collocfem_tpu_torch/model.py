"""Model layer: ODE dynamics, output maps, costs and constraints.

Counterpart of ``collocfem_tpu/model.py``.  A model is a set of pure torch
functions; every derivative comes from ``torch.func.jacfwd`` per element, so
``f`` and ``h`` must work under ``torch.func.vmap`` and ``jacfwd``: no
in-place writes, no ``.item()``, no Python branching on tensor values.

Conventions:
  x: (nx,) state          u: (nu,) input (may be empty)
  p: (nq,) parameters     t: scalar time
"""

from __future__ import annotations

import functools

import torch


class Model:
    """Base class for collocation models.

    Subclasses set ``nx``, ``nu``, ``nq`` and implement ``f``.  The output
    map ``h`` defaults to full state observation.  ``g`` (inequality path
    constraints, g <= 0), ``g_eq`` (equality path constraints) and the cost
    residuals are optional; the trajectory-optimization and constrained
    solvers use them.
    """

    nx: int = 0  # number of states
    nu: int = 0  # number of exogenous/decision inputs
    nq: int = 0  # number of unknown parameters
    ng: int = 0  # number of inequality path constraints
    ne: int = 0  # number of equality path constraints

    def f(self, x, u, p, t):
        """State derivative dx/dt. Returns (nx,)."""
        raise NotImplementedError

    def h(self, x, u, p, t):
        """Measured output. Returns (ny,). Defaults to full state."""
        del u, p, t
        return x

    @functools.cached_property
    def ny(self) -> int:
        """Output dimension, read off one evaluation of ``h`` at zeros."""
        z = torch.zeros
        return int(self.h(z(self.nx), z(self.nu), z(self.nq), 0.0).shape[0])

    def g(self, x, u, p, t):
        """Inequality path constraints, enforced as g(...) <= 0. Returns (ng,)."""
        del u, p, t
        return x.new_zeros((0,))

    def g_eq(self, x, u, p, t):
        """Equality path constraints, enforced as g_eq(...) = 0 at every
        global collocation node by the augmented-Lagrangian OCP solver.
        Returns (ne,)."""
        del u, p, t
        return x.new_zeros((0,))

    def running_cost(self, x, u, p, t):
        """Integrand of the running cost: 0.5 * ||running_cost_residual||^2."""
        r = self.running_cost_residual(x, u, p, t)
        return 0.5 * torch.sum(r * r)

    def running_cost_residual(self, x, u, p, t):
        """Running cost in least-squares form (cost = 0.5 ||r||^2), (nl,)."""
        del u, p, t
        return x.new_zeros((0,))

    def terminal_cost_residual(self, x, p):
        """Terminal (Mayer) cost in least-squares form at t_f, (nt,)."""
        del p
        return x.new_zeros((0,))
