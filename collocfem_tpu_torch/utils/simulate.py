"""Fixed-step trajectory simulation for data synthesis and validation
(counterpart of ``collocfem_tpu/utils/simulate.py``): RK4 over the sample
grid, a loop over the intervals on tensors, differentiable by autograd."""

from __future__ import annotations

import numpy as np
import torch


def rk4_trajectory(f, x0, ts, u_fn=None, p=None, *, device):
    """Integrate dx/dt = f(x, u, p, t) over sample times ``ts`` with RK4.

    Args:
      f: dynamics ``f(x, u, p, t) -> (nx,)`` (a Model.f works directly).
      x0: (nx,) initial state; its dtype is used (float64 for an array).
      ts: (T,) strictly increasing sample times (possibly nonuniform; one
          RK4 step per interval; refine ``ts`` for accuracy).
      u_fn: optional ``u_fn(t) -> (nu,)``; defaults to zero input.
      p: (nq,) parameters (defaults to empty).
      device: where the simulation runs; a tensor argument that lies
          elsewhere raises.
    Returns:
      (T, nx) states at ``ts`` (first row = x0).
    """
    dev = torch.empty(0, device=device).device
    for name, v in (("x0", x0), ("ts", ts), ("p", p)):
        if torch.is_tensor(v) and v.device != dev:
            raise ValueError(f"{name} lies on {v.device}; the simulation "
                             f"runs on {dev}")
    if not torch.is_tensor(x0):
        x0 = np.array(x0, dtype=np.float64)
    x0 = torch.as_tensor(x0, device=dev)
    ts = torch.as_tensor(ts, dtype=x0.dtype, device=x0.device)
    p = x0.new_zeros((0,)) if p is None else torch.as_tensor(
        p, dtype=x0.dtype, device=x0.device)
    if u_fn is None:
        u_fn = lambda t: x0.new_zeros((0,))
    xs = [x0]
    x = x0
    for t0, t1 in zip(ts[:-1], ts[1:]):
        h = t1 - t0
        k1 = f(x, u_fn(t0), p, t0)
        k2 = f(x + 0.5 * h * k1, u_fn(t0 + 0.5 * h), p, t0 + 0.5 * h)
        k3 = f(x + 0.5 * h * k2, u_fn(t0 + 0.5 * h), p, t0 + 0.5 * h)
        k4 = f(x + h * k3, u_fn(t1), p, t1)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        xs.append(x)
    return torch.stack(xs)
