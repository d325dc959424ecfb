"""Van der Pol oscillator (counterpart of ``collocfem_tpu/models/vdp.py``)."""

from __future__ import annotations

import torch

from collocfem_tpu_torch.model import Model


class VanDerPol(Model):
    """x1' = x2;  x2' = mu (1 - x1^2) x2 - x1 + b u.

    Parameters p = [mu, b].  Measured output: x1 (position) by default.
    """

    nx = 2
    nu = 1
    nq = 2

    def __init__(self, measure_full_state: bool = False):
        self.measure_full_state = measure_full_state

    def f(self, x, u, p, t):
        del t
        x1, x2 = x[0], x[1]
        mu, b = p[0], p[1]
        return torch.stack([x2, mu * (1.0 - x1**2) * x2 - x1 + b * u[0]])

    def h(self, x, u, p, t):
        del u, p, t
        return x if self.measure_full_state else x[:1]
