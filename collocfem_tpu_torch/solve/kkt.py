"""Damped KKT solve: block-tridiagonal core + arrowhead Schur complement.

Counterpart of the SoA path of ``collocfem_tpu/solve/kkt.py``.  The
parameters touch every block (arrowhead columns); they are eliminated by a
Schur complement: solve the chain against [gx | B] in one multi-RHS pass,
then a tiny dense (nq, nq) solve, then compose.

Ported: ``refine == 0``, ``nq > 0``, no double-word tier.  On a CUDA device
the solve runs the fused CUDA kernel (:mod:`collocfem_tpu_torch.ops.spike`);
the plain cyclic-reduction path below is the CPU path and that kernel's
reference.
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.ops import smallblocks_soa as soa
from collocfem_tpu_torch.solve.blocktri import blocktri_cr_factor_soa


def resolve_auto_method(block_size: int, nq: int, device) -> str:
    """'auto' method policy: the fused CUDA kernel on a CUDA device, the
    plain cyclic reduction on the CPU.

    The gate is the kernel's own limit: it is compiled for a fixed set of
    (block size, nq) shapes.  A shape outside that set raises on the card
    rather than quietly running the plain solve there.
    """
    if torch.device(device).type != "cuda":
        return "cr"
    from collocfem_tpu_torch.ops.spike import kernel_supports

    if not kernel_supports(block_size, nq):
        raise ValueError(
            f"the fused KKT kernel is not built for block size {block_size} "
            f"with nq={nq}; add the shape to csrc/kkt_spike.cu")
    return "spike"


def _schur_solve(schur, rhs):
    """Tiny dense SPD solve of the (nq, nq) parameter Schur system."""
    L = soa.chol(schur[..., None])
    return soa.chol_solve(L, rhs[:, None, None])[:, 0, 0]


def damping_scales(D, C, lam, damp_scale=None):
    """Dimensionless isotropic damping and the Jacobi scales it implies.

    ``lam`` multiplies the global max diagonal dmax = max(diag(A) ∪
    diag(C)) (or ``damp_scale``), i.e. A + lam*dmax*I in the original
    coordinates: an absolute lam*I is meaningless once the diagonal spans
    1..1e8.  Returns (lam_abs, dmax, inv = diag(A + lam_abs)^-1/2 (bd, K),
    C + lam_abs*I, inv_sp = diag(C + lam_abs)^-1/2 (nq,)).
    """
    dtype, device = D.dtype, D.device
    diag = torch.diagonal(D, dim1=0, dim2=1).T                   # (bd, K)
    if damp_scale is None:
        dmax = torch.maximum(diag.max(), torch.diagonal(C).max())
    else:
        dmax = torch.as_tensor(damp_scale, dtype=dtype, device=device)
    lam_abs = lam * torch.clamp(dmax, min=torch.finfo(dtype).tiny)
    inv = 1.0 / torch.sqrt(diag + lam_abs)
    c_damped = C + lam_abs * torch.eye(C.shape[0], dtype=dtype, device=device)
    inv_sp = 1.0 / torch.sqrt(torch.diagonal(c_damped))
    return lam_abs, dmax, inv, c_damped, inv_sp


def _equilibrate_soa(sys, lam, damp_scale=None):
    """Symmetric Jacobi scaling of the damped SoA system (unit diagonal).

    Returns (scaled system, inv (bd, K), inv_sp (nq,), dmax).
    """
    lam_abs, dmax, inv, c_damped, inv_sp = damping_scales(
        sys.D, sys.C, lam, damp_scale)
    eye = torch.eye(sys.block_size, dtype=sys.D.dtype, device=sys.D.device)
    D = (sys.D + lam_abs * eye[:, :, None]) * inv[:, None, :] * inv[None, :, :]
    inv_next = torch.cat([inv[:, 1:], torch.ones_like(inv[:, :1])], dim=-1)
    scaled = type(sys)(
        D=D,
        E=sys.E * inv[:, None, :] * inv_next[None, :, :],
        B=sys.B * inv[:, None, :] * inv_sp[None, :, None],
        C=c_damped * inv_sp[:, None] * inv_sp[None, :],
        gx=sys.gx * inv, gp=sys.gp * inv_sp,
    )
    return scaled, inv, inv_sp, dmax


def solve_kkt_plain(sys, lam, damp_scale=None):
    """The plain damped KKT solve: equilibrate, cyclic reduction on
    [gx | B], Schur solve, compose and unscale.  Returns (dx, dp, dmax).

    This is the reference of the fused kernel
    (``ops.spike.kkt_solve_spike_fused_ref`` calls it); the solver runs it
    only on the CPU.
    """
    s, inv, inv_sp, dmax = _equilibrate_soa(sys, lam, damp_scale)
    apply = blocktri_cr_factor_soa(s.D, s.E)
    x = apply(torch.cat([s.gx[:, None, :], s.B], dim=1))
    a_g, a_b = x[:, 0, :], x[:, 1:, :]
    schur = s.C - torch.einsum("bqk,brk->qr", s.B, a_b)
    rp = s.gp - torch.einsum("bqk,bk->q", s.B, a_g)
    dp = -_schur_solve(schur, rp)
    dx = -(a_g + torch.einsum("bqk,q->bk", a_b, dp))
    return dx * inv, dp * inv_sp, dmax


def solve_kkt_soa(sys, lam, refine: int = 0, dw: bool = False,
                  spike: bool = False, damp_scale=None,
                  with_dmax: bool = False):
    """Solve the damped KKT system [[A, B], [B^T, C]] [dx, dp] = -[gx, gp].

    ``sys`` is an ``ops.assemble.BlockTriSystemSoA``.  ``spike=True`` runs
    the fused kernel wrapper (:func:`ops.spike.kkt_solve_spike_fused`);
    otherwise :func:`solve_kkt_plain`, which is refused on a CUDA device.
    Returns (dx (bd, K), dp (nq,)) and, with ``with_dmax``, the damping
    scale.
    """
    nq = sys.C.shape[0]
    if refine or dw or nq == 0:
        raise NotImplementedError(
            "only refine=0, dw=False, nq>0 is ported (ROADMAP queue B: "
            "kernel #2 serves nq=0 and refinement)")
    if spike:
        from collocfem_tpu_torch.ops.spike import kkt_solve_spike_fused

        out = kkt_solve_spike_fused(
            sys.D, sys.E, sys.B, sys.gx, sys.C, sys.gp, lam, damp_scale)
    elif sys.D.is_cuda:
        raise ValueError("the plain KKT solve runs on the CPU only; on a "
                         "CUDA device use spike=True (the fused kernel)")
    else:
        out = solve_kkt_plain(sys, lam, damp_scale)
    return out if with_dmax else out[:2]
