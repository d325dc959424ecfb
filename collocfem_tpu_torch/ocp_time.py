"""Free-final-time trajectory optimization (minimum-time problems).

Counterpart of ``collocfem_tpu/ocp_time.py``.  The problem is transcribed in
normalized time s in [0, 1] on a static mesh, and the horizon is one extra
entry of the parameter arrowhead of the KKT system:

  * the dynamics are time-dilated: dx/ds = tf f(x, u, p, s tf);
  * tf = tf_ref exp(theta) with theta the appended parameter (positive by
    construction, and well scaled across decades of tf);
  * a bracket tf in [tf_min, tf_max] enters as two extra rows of ``g`` (the
    log barrier keeps the iterates off the degenerate basin tf -> 0);
  * the running cost picks up the dilation: its residuals are scaled by
    sqrt(tf), and a time cost time_weight T is the constant residual
    sqrt(2 time_weight tf) under the same quadrature.

Everything downstream (the AL/barrier solve, the block-tridiagonal KKT with
its arrowhead Schur complement, the chain kernels) is unchanged; the
pendulum-sized free-time problem runs kernel #1 at nq = 1.
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.ocp import OptimalControlProblem
from collocfem_tpu_torch.ops.mesh import uniform_mesh


class FreeTimeModel(Model):
    """Time-dilated wrapper: normalized time s in [0, 1], horizon in p[-1].

    The wrapped model's parameters stay at p[:-1]; the appended theta =
    p[-1] encodes the horizon as tf = tf_ref exp(theta).  Built through
    :func:`free_time_ocp`.
    """

    def __init__(self, base: Model, tf_ref: float, time_weight: float,
                 tf_min: float, tf_max: float):
        if tf_ref <= 0 or tf_min <= 0 or tf_max <= tf_min:
            raise ValueError("need 0 < tf_min < tf_max and tf_ref > 0")
        if not (tf_min < tf_ref < tf_max):
            raise ValueError(
                f"tf_ref={tf_ref} must lie strictly inside the bracket "
                f"({tf_min}, {tf_max}) so the initial guess is "
                "barrier-feasible")
        self.base = base
        self.tf_ref = float(tf_ref)
        self.time_weight = float(time_weight)
        self.tf_min = float(tf_min)
        self.tf_max = float(tf_max)
        self.nx = base.nx
        self.nu = base.nu
        self.nq = base.nq + 1
        self.ng = base.ng + 2
        self.ne = base.ne

    def final_time(self, p):
        """The horizon tf = tf_ref exp(theta) of a parameter vector."""
        return self.tf_ref * torch.exp(p[-1])

    def _split(self, p):
        return p[:-1], self.final_time(p)

    def f(self, x, u, p, s):
        pb, tf = self._split(p)
        return tf * self.base.f(x, u, pb, s * tf)

    def h(self, x, u, p, s):
        pb, tf = self._split(p)
        return self.base.h(x, u, pb, s * tf)

    def g(self, x, u, p, s):
        pb, tf = self._split(p)
        gb = self.base.g(x, u, pb, s * tf)
        bracket = torch.stack([self.tf_min - tf, tf - self.tf_max])
        return torch.cat([gb, bracket])

    def g_eq(self, x, u, p, s):
        pb, tf = self._split(p)
        return self.base.g_eq(x, u, pb, s * tf)

    def running_cost_residual(self, x, u, p, s):
        pb, tf = self._split(p)
        rb = torch.sqrt(tf) * self.base.running_cost_residual(x, u, pb, s * tf)
        if self.time_weight == 0.0:
            return rb
        # 0.5 sum w_k (h/2) (sqrt(2 w_t tf))^2 = w_t tf int_0^1 ds = w_t T.
        rt = torch.sqrt(2.0 * self.time_weight * tf)
        return torch.cat([rb, rt[None]])

    def terminal_cost_residual(self, x, p):
        return self.base.terminal_cost_residual(x, p[:-1])


def free_time_ocp(model: Model, num_elements: int = 16, degree: int = 4,
                  x0=None, xf=None, tf_ref: float = 1.0,
                  time_weight: float = 1.0, tf_min: float | None = None,
                  tf_max: float | None = None, *, dtype, device):
    """Build a free-final-time OCP on a static normalized-time mesh.

    Returns ``(prob, ftmodel)``: an :class:`OptimalControlProblem` over s in
    [0, 1] whose parameters end with the horizon coordinate theta, and the
    :class:`FreeTimeModel` (``ftmodel.final_time(z.p)`` reads the horizon).
    ``prob.initial_guess()`` starts at theta = 0, tf = tf_ref, strictly
    inside the bracket (default tf_ref / 10 .. 10 tf_ref).
    """
    tf_min = tf_ref / 10.0 if tf_min is None else float(tf_min)
    tf_max = tf_ref * 10.0 if tf_max is None else float(tf_max)
    ftmodel = FreeTimeModel(model, tf_ref, time_weight, tf_min, tf_max)
    mesh = uniform_mesh(0.0, 1.0, num_elements, degree)
    prob = OptimalControlProblem.build(ftmodel, mesh, x0=x0, xf=xf,
                                       dtype=dtype, device=device)
    return prob, ftmodel
