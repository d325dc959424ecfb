"""Parameter and state-path uncertainty from the Gauss-Newton Fisher matrix.

Counterpart of ``collocfem_tpu/solve/covariance.py``.  With every residual
pre-multiplied by its sqrt information (1/sigma), the GN normal matrix is the
Fisher information of (V, p), so

    Cov(p) = (C - B^T A^-1 B)^-1,
    Cov(x) = A^-1 + (A^-1 B) Cov(p) (A^-1 B)^T,

from one multi-RHS chain solve (``SOLVERS[method]``; 'cr' runs kernels #3
and #6 on a CUDA device) and, for the state path, the block-tridiagonal part
of A^-1 (:func:`blocktri_inverse_blocks`).  The system is the block-major
:func:`ops.assemble.assemble_gn` at the solution.
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.ops.assemble import assemble_gn
from collocfem_tpu_torch.ops.smallblocks import spd_solve
from collocfem_tpu_torch.solve.blocktri import SOLVERS, blocktri_inverse_blocks


def _param_cov(sys, a_b):
    """Cov(p) = (C - B^T A^-1 B)^-1 from a_b = A^-1 B (K, bd, nq)."""
    schur = sys.C - torch.einsum("kbq,kbr->qr", sys.B, a_b)
    eye = torch.eye(schur.shape[0], dtype=schur.dtype, device=schur.device)
    return spd_solve(schur, eye)


def parameter_covariance(problem, z, data, method: str = "cr"):
    """(nq, nq) covariance of the parameter estimate at solution ``z``.

    Assumes measurement weights 1/sigma and a (local) optimum; with joint
    MAP estimation the defect weights act as the process-noise prior.
    """
    sys = assemble_gn(problem, z, data)
    nq = sys.C.shape[0]
    if nq == 0:
        return sys.D.new_zeros((0, 0))
    return _param_cov(sys, SOLVERS[method](sys.D, sys.E, sys.B))


def parameter_std(problem, z, data, method: str = "cr"):
    """(nq,) standard errors sqrt(diag(Cov(p)))."""
    return torch.sqrt(torch.diagonal(
        parameter_covariance(problem, z, data, method)))


def state_covariance_blocks(problem, z, data, method: str = "cr"):
    """Block-tridiagonal part of the state-path covariance at ``z``,
    marginalised over the parameters.

    Returns (diag (K, bd, bd), off (K-1, bd, bd), cov_p (nq, nq)) with
    ``off[k] = Cov(block k, block k+1)``.
    """
    sys = assemble_gn(problem, z, data)
    diag, off = blocktri_inverse_blocks(sys.D, sys.E)
    nq = sys.C.shape[0]
    if nq == 0:
        return diag, off, sys.D.new_zeros((0, 0))
    a_b = SOLVERS[method](sys.D, sys.E, sys.B)       # W = A^-1 B (K, bd, nq)
    cov_p = _param_cov(sys, a_b)
    wc = torch.einsum("kbq,qr->kbr", a_b, cov_p)     # W Cov(p)
    diag = diag + torch.einsum("kbq,kcq->kbc", wc, a_b)
    off = off + torch.einsum("kbq,kcq->kbc", wc[:-1], a_b[1:])
    return diag, off, cov_p


def state_covariance_nodes(problem, z, data, method: str = "cr"):
    """(num_nodes, nv, nv) marginal covariance of each node's variables."""
    diag, _, _ = state_covariance_blocks(problem, z, data, method)
    k, bd, _ = diag.shape
    nv = problem.nv
    d = bd // nv
    j = torch.arange(d, device=diag.device)
    per_node = diag.reshape(k, d, nv, d, nv)[:, j, :, j, :]  # (d, k, nv, nv)
    return per_node.transpose(0, 1).reshape(k * d, nv, nv)[:problem.num_nodes]


def state_std(problem, z, data, method: str = "cr"):
    """(num_nodes, nv) standard deviation of every node variable."""
    cov = state_covariance_nodes(problem, z, data, method)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    return torch.sqrt(torch.clamp(var, min=0.0))


def element_covariance(problem, z, data, method: str = "cr"):
    """(N, s, s) joint covariance of each element's stacked variables.

    Element e owns block e plus the leading nv variables of block e+1 (the
    shared boundary node): s = (d+1) nv locals, laid out as
    ``problem.gather_elements``.
    """
    diag, off, _ = state_covariance_blocks(problem, z, data, method)
    nv = problem.nv
    n = problem.mesh.num_elements
    bd = diag.shape[1]
    top_right = off[:n, :, :nv]                            # (N, bd, nv)
    top = torch.cat([diag[:n], top_right], dim=2)
    bottom = torch.cat([top_right.transpose(1, 2),
                        diag[1:n + 1, :nv, :nv]], dim=2)
    return torch.cat([top, bottom], dim=1)


def trajectory_std(problem, z, data, times, method: str = "cr"):
    """(T, nv) standard deviation of the interpolated trajectory at
    ``times``: Var[x(t)] = r(t)^T Cov_elem r(t) per variable, with r(t) the
    Lagrange row of the element holding t."""
    mesh = problem.mesh
    nv, d = problem.nv, mesh.degree
    ecov = element_covariance(problem, z, data, method)     # (N, s, s)
    e, rows = mesh.interp_rows(times)
    rows = torch.as_tensor(rows, dtype=ecov.dtype, device=ecov.device)
    C = ecov[torch.as_tensor(e, dtype=torch.long, device=ecov.device)]
    C = C.reshape(rows.shape[0], d + 1, nv, d + 1, nv)
    var = torch.einsum("tj,tl,tjala->ta", rows, rows, C)
    return torch.sqrt(torch.clamp(var, min=0.0))
