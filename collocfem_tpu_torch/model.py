"""Model layer: ODE dynamics and output maps.

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
    map ``h`` defaults to full state observation.
    """

    nx: int = 0  # number of states
    nu: int = 0  # number of exogenous inputs
    nq: int = 0  # number of unknown parameters

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
