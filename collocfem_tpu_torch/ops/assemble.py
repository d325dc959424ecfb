"""Gauss-Newton assembly: per-element jacfwd -> block-tridiagonal + arrowhead.

Counterpart of the structure-of-arrays path of ``collocfem_tpu/ops/assemble.py``.
Nodes are padded to K*d (K = N+1 blocks of d nodes); element e touches block e
plus the first node of block e+1, so the state Hessian is block tridiagonal
with uniform (d*nv, d*nv) blocks.  The parameter "arrowhead" is a separate
(bd, nq, K) strip + (nq, nq) corner, eliminated by a Schur complement in the
solver.  Every chain array keeps the chain index K on its LAST axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap


class BlockTriSystemSoA(NamedTuple):
    """Damped-GN normal equations [[A, B], [B^T, C]] [dx, dp] = -[gx, gp].

    A is block tridiagonal: diagonal blocks ``D`` (bd, bd, K) and coupling
    ``E`` (bd, bd, K) with A[k, k+1] = E[..., k] (E[..., K-1] unused).
    ``B`` (bd, nq, K) is the parameter strip, ``C`` (nq, nq) the corner;
    ``gx`` (bd, K) and ``gp`` (nq,) the gradient.
    """

    D: torch.Tensor
    E: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    gx: torch.Tensor
    gp: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.D.shape[-1]

    @property
    def block_size(self) -> int:
        return self.D.shape[0]


def assemble_gn_soa(problem, z, data, with_cost: bool = False):
    """Assemble the Gauss-Newton system at iterate ``z``.

    Residuals and Jacobians come from ``vmap(jacfwd(elem_residual))`` over
    the elements; the normal-equation contractions emit the element axis
    last, and the chain scatter is two static lane slices (element e ->
    chain slots e and e+1).  With ``with_cost`` it also returns the float64
    cost 0.5 * ||r||^2 at ``z``, read off the same residuals (this replaces
    the double-word cost of the JAX package: the GPU has native float64).
    """
    mesh, model = problem.mesh, problem.model
    n, d, nv, nq = mesh.num_elements, mesh.degree, problem.nv, model.nq
    k, bd = n + 1, d * nv
    nx = model.nx

    xe = problem.gather_elements(z.V)
    ed = problem._elem_data(data)

    def res_aux(xe_flat, p, edata):
        r = problem.elem_residual(xe_flat, p, edata)
        return r, r

    def per_elem(xe_flat, edata):
        (jx, jp), r = jacfwd(res_aux, argnums=(0, 1), has_aux=True)(
            xe_flat, z.p, edata)
        return r, jx, jp

    r, jx, jp = vmap(per_elem)(xe, ed)          # (N, m), (N, m, s), (N, m, nq)

    jx1, jx2 = jx[:, :, :bd], jx[:, :, bd:]
    h11 = torch.einsum("emi,emj->ije", jx1, jx1).reshape(bd * bd, n)
    h22 = torch.einsum("emi,emj->ije", jx2, jx2)       # (nv, nv, N)
    h12 = torch.einsum("emi,emj->ije", jx1, jx2)       # (bd, nv, N)
    b1 = torch.einsum("emi,emq->iqe", jx1, jp).reshape(bd * nq, n)
    b2 = torch.einsum("emi,emq->iqe", jx2, jp).reshape(nv * nq, n)
    g1 = torch.einsum("emi,em->ie", jx1, r)            # (bd, N)
    g2 = torch.einsum("emi,em->ie", jx2, r)            # (nv, N)
    hpp = torch.einsum("emq,emr->qr", jp, jp)
    gpe = torch.einsum("emq,em->q", jp, r)

    dtype, device = z.V.dtype, z.V.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    # Block e+1's top-left (nv, nv) overlap: rows i*bd + j for i, j < nv are
    # the leading nv*bd rows once the column space is padded nv -> bd.
    pad_cols = (0, 0, 0, bd - nv)
    D2 = zeros(bd * bd, k)
    D2[:, :n] += h11
    D2[:nv * bd, 1:] += torch.nn.functional.pad(h22, pad_cols).reshape(nv * bd, n)
    E2 = zeros(bd * bd, k)
    E2[:, :n] = torch.nn.functional.pad(h12, pad_cols).reshape(bd * bd, n)
    B2 = zeros(bd * nq, k)
    B2[:, :n] += b1
    B2[:nv * nq, 1:] += b2
    gx = zeros(bd, k)
    gx[:, :n] += g1
    gx[:nv, 1:] += g2

    pw2 = data.p_w**2
    C = hpp + torch.diag(pw2)
    gp = gpe + pw2 * (z.p - data.p_prior)
    dx0 = z.V[0, :nx] - data.x0_prior
    x0w2 = data.x0_w**2
    # Diagonal additions: SPD identity on the trailing pad entries of the
    # last block, and the x0-prior weights on block 0.
    diag_add = zeros(bd, k)
    diag_add[nv:, k - 1] = 1.0
    diag_add[:nx, 0] += x0w2
    gx[:nx, 0] += x0w2 * dx0
    D2[::bd + 1] += diag_add

    out = BlockTriSystemSoA(
        D=D2.reshape(bd, bd, k), E=E2.reshape(bd, bd, k),
        B=B2.reshape(bd, nq, k), C=C, gx=gx, gp=gp,
    )
    if with_cost:
        r64 = torch.cat([r.reshape(-1), problem.prior_residuals(z, data)])
        r64 = r64.double()
        return out, 0.5 * torch.sum(r64 * r64)
    return out


def blocks_to_nodes_soa(dx, num_nodes: int, nv: int):
    """(bd, K) SoA solution -> (M, nv) node values."""
    bd, k = dx.shape
    return dx.T.reshape(k * (bd // nv), nv)[:num_nodes]
