"""Pendulum swing-up (counterpart of ``collocfem_tpu/models/pendulum.py``),
the model of config 3: trajectory optimization with torque path
constraints, solved by the augmented-Lagrangian / log-barrier solver
(:mod:`collocfem_tpu_torch.solve.auglag`)."""

from __future__ import annotations

import math

import torch

from collocfem_tpu_torch.model import Model


class Pendulum(Model):
    """theta' = w;  w' = -(g/l) sin(theta) + u / (m l^2), torque-limited.

    State x = [theta, w]; control u (a decision variable); no unknown
    parameters.  Path constraint |u| <= u_max, as g = [u - u_max,
    -u - u_max].  Swing-up: theta 0 -> pi with terminal boundary conditions,
    minimum integrated torque^2.
    """

    nx = 2
    nu = 1
    nq = 0
    ng = 2

    def __init__(self, m=1.0, l=0.5, grav=9.81, u_max=2.0, effort_weight=1.0):
        self.m, self.l, self.grav = float(m), float(l), float(grav)
        self.u_max = float(u_max)
        self.effort_weight = float(effort_weight)

    def f(self, x, u, p, t):
        del p, t
        theta, w = x[0], x[1]
        acc = (-(self.grav / self.l) * torch.sin(theta)
               + u[0] / (self.m * self.l**2))
        return torch.stack([w, acc])

    def g(self, x, u, p, t):
        del x, p, t
        return torch.stack([u[0] - self.u_max, -u[0] - self.u_max])

    def running_cost_residual(self, x, u, p, t):
        del x, p, t
        return math.sqrt(self.effort_weight) * u
