"""Duffing oscillator (counterpart of ``collocfem_tpu/models/duffing.py``),
the model of config 2: joint state-path and parameter estimation, where the
defects carry a process-noise weight so the state path is itself a MAP
decision variable."""

from __future__ import annotations

import torch

from collocfem_tpu_torch.model import Model


class Duffing(Model):
    """x1' = x2;  x2' = -delta x2 - alpha x1 - beta x1^3 + gamma cos(omega t).

    Parameters p = [alpha, beta, delta]; the forcing amplitude gamma and
    frequency omega are known constants.  No input (nu = 0).  Measured
    output: x1.
    """

    nx = 2
    nu = 0
    nq = 3

    def __init__(self, gamma: float = 0.3, omega: float = 1.2):
        self.gamma = float(gamma)
        self.omega = float(omega)

    def f(self, x, u, p, t):
        del u
        x1, x2 = x[0], x[1]
        alpha, beta, delta = p[0], p[1], p[2]
        force = self.gamma * torch.cos(self.omega * t)
        return torch.stack([x2, -delta * x2 - alpha * x1 - beta * x1**3
                            + force])

    def h(self, x, u, p, t):
        del u, p, t
        return x[:1]
