"""Linear time-invariant system model (counterpart of
``collocfem_tpu/models/lti.py``): the oracle model of the Kalman tier and
the moving-horizon estimator's linear-Gaussian parity."""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.model import Model


class LinearSystem(Model):
    """x' = A x + B u,  y = C x, with fixed (known) matrices.

    Set ``estimate_params=True`` to expose the entries of A as unknown
    parameters p (row-major), turning this into a linear system
    identification model.  The matrices are kept on the host and placed on
    the device and dtype of the state at first use there.
    """

    def __init__(self, A, B=None, C=None, estimate_params: bool = False):
        A = np.asarray(A, dtype=np.float64)
        nx = A.shape[0]
        B = np.zeros((nx, 0)) if B is None else np.asarray(B, np.float64)
        C = np.eye(nx) if C is None else np.asarray(C, np.float64)
        self.A0, self.B0, self.C0 = A, B, C
        self.estimate_params = bool(estimate_params)
        self.nx = nx
        self.nu = B.shape[1]
        self.nq = nx * nx if estimate_params else 0
        self._placed = {}

    def _mats(self, x):
        """(A0, B0, C0) as tensors on x's device in x's dtype."""
        key = (x.dtype, x.device)
        if key not in self._placed:
            self._placed[key] = tuple(
                torch.as_tensor(m, dtype=x.dtype, device=x.device)
                for m in (self.A0, self.B0, self.C0))
        return self._placed[key]

    def _A(self, p, x):
        if self.estimate_params:
            return p.reshape(self.nx, self.nx)
        return self._mats(x)[0]

    def f(self, x, u, p, t):
        del t
        dx = self._A(p, x) @ x
        if self.nu:
            dx = dx + self._mats(x)[1] @ u
        return dx

    def h(self, x, u, p, t):
        del u, p, t
        return self._mats(x)[2] @ x
