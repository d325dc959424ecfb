"""Aircraft longitudinal short-period model (counterpart of
``collocfem_tpu/models/aircraft.py``), the model of config 4: output-error
estimation of the dimensional stability and control derivatives from a
flight record."""

from __future__ import annotations

import torch

from collocfem_tpu_torch.model import Model


class AircraftLongitudinal(Model):
    """Short-period approximation with unknown dimensional derivatives.

    alpha' = Z_a * alpha + q + Z_d * de
    q'     = M_a * alpha + M_q * q + M_d * de

    p = [Z_a, M_a, M_q, Z_d, M_d]; the input is the elevator de.  Measured
    outputs: alpha, q, and the normal-acceleration proxy
    az = V/g0 * (alpha' - q).
    """

    nx = 2
    nu = 1
    nq = 5

    def __init__(self, V: float = 60.0, g0: float = 9.81):
        self.V = float(V)
        self.g0 = float(g0)

    def f(self, x, u, p, t):
        del t
        alpha, q = x[0], x[1]
        Za, Ma, Mq, Zd, Md = p[0], p[1], p[2], p[3], p[4]
        de = u[0]
        return torch.stack([Za * alpha + q + Zd * de,
                            Ma * alpha + Mq * q + Md * de])

    def h(self, x, u, p, t):
        del t
        alpha, q = x[0], x[1]
        Za, Zd = p[0], p[3]
        adot_minus_q = Za * alpha + Zd * u[0]   # alpha' - q
        return torch.stack([alpha, q, self.V / self.g0 * adot_minus_q])
