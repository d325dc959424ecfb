"""Carry an iterate and a data set from the JAX package into the port.

The estimation problem has no learned weights: what crosses between the two
packages is the decision vector, the data and the mesh.  Each function takes
the JAX package's fields as numpy arrays (``np.asarray`` of each
``Decision``, ``BatchDecision`` or ``ProblemData`` field, or a ``Mesh``'s
breakpoints) and returns the port's tensors (or ``Mesh``).
"""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.ops.basis import make_basis
from collocfem_tpu_torch.ops.mesh import Mesh
from collocfem_tpu_torch.parallel.batch import BatchDecision
from collocfem_tpu_torch.problem import Decision, ProblemData


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def decision_from_numpy(V, p, device, dtype) -> Decision:
    """Decision(V (M, nv), p (nq,)) on ``device`` in ``dtype``."""
    return Decision(V=_tensor(V, device, dtype), p=_tensor(p, device, dtype))


def data_from_numpy(y, u, meas_w, p_prior, p_w, x0_prior, x0_w, device,
                    dtype) -> ProblemData:
    """ProblemData from the JAX package's fields, in field order, for one
    experiment or stacked over a leading experiment axis; ``x0_w`` may be
    per-state weights or a full sqrt-information matrix."""
    return ProblemData(*(_tensor(x, device, dtype) for x in
                         (y, u, meas_w, p_prior, p_w, x0_prior, x0_w)))


def batch_decision_from_numpy(V, p, device, dtype) -> BatchDecision:
    """BatchDecision(V (E, M, nv), p (nq,)) on ``device`` in ``dtype``."""
    return BatchDecision(V=_tensor(V, device, dtype), p=_tensor(p, device, dtype))


def mesh_from_numpy(breakpoints, degree: int) -> Mesh:
    """The port's Mesh of a JAX ``Mesh`` (its breakpoints and degree)."""
    return Mesh(basis=make_basis(int(degree)),
                breakpoints=np.asarray(breakpoints, dtype=np.float64))
