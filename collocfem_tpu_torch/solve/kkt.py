"""Damped KKT solve: block-tridiagonal core + arrowhead Schur complement.

Counterpart of the SoA path of ``collocfem_tpu/solve/kkt.py``.  The
parameters touch every block (arrowhead columns); they are eliminated by a
Schur complement: solve the chain against [gx | B] in one multi-RHS pass,
then a tiny dense (nq, nq) solve, then compose.

Ported: every case but the double-word tier (``dw=True`` raises; float64
takes its place on the card).  On a CUDA device the solve runs CUDA kernels:
with ``spike=True`` those of :mod:`collocfem_tpu_torch.ops.spike` (the fused
KKT kernel for ``refine == 0`` with ``nq > 0``, the SPIKE chain kernel as the
chain solve of the refinement passes and of ``nq == 0``), otherwise the
per-level cyclic-reduction kernels of :mod:`collocfem_tpu_torch.ops.cr`.  On
the CPU the same cyclic reduction runs its plain versions.
:func:`solve_kkt_plain`, the fused kernel's reference, runs the plain chain
solve on any device.
"""

from __future__ import annotations

import torch

from collocfem_tpu_torch.ops import smallblocks_soa as soa
from collocfem_tpu_torch.solve.blocktri import (
    blocktri_cr_factor_plain,
    blocktri_cr_factor_soa,
)


def resolve_auto_method(block_size: int, nq: int, device,
                        refine: int = 0) -> str:
    """'auto' method policy: the SPIKE CUDA kernels on a CUDA device, the
    plain cyclic reduction on the CPU.

    On the card the gate is the kernels' range: ``refine == 0`` with
    ``nq > 0`` needs the fused KKT kernel at (block size, nq) (1 <= b <= 16,
    1 <= nq <= 16); refinement and ``nq == 0`` need the chain kernel at
    (block size, 1 + nq) and (block size, 1).  A shape outside the range
    raises ValueError, naming it, rather than quietly running the plain
    solve there.  Nothing is built here (:func:`resolve_method` builds).
    """
    if torch.device(device).type != "cuda":
        return "cr"
    _spike_instances(block_size, nq, refine)
    return "spike"


def require_cr_shapes(block_size: int, nq: int, device, refine: int = 0):
    """On a CUDA device, raise ValueError, naming the range, unless the CR
    kernels take every right-hand-side count the KKT solve gives them: r =
    1 + nq for [gx | B] and r = 1 for refinement passes or nq = 0 (1 <= b
    <= 16, 1 <= r <= 17).  Nothing is built here."""
    if torch.device(device).type != "cuda":
        return
    _cr_instances(block_size, nq, refine)


def _spike_instances(block_size, nq, refine):
    """The SPIKE library instances a KKT solve at (block size, nq) runs:
    kernel #1 at nq for ``refine == 0`` with ``nq > 0``, else kernel #2 at
    r = 1 + nq and r = 1.  Raises ValueError outside the kernels' range."""
    from collocfem_tpu_torch.ops import spike

    if nq > 0 and refine == 0:
        return [spike.kkt_instance(block_size, nq)]
    return [spike.chain_instance(block_size, r) for r in sorted({1, 1 + nq})]


def _cr_instances(block_size, nq, refine):
    """The CR library instances a KKT solve at (block size, nq) runs: the
    factor kernel (r = 0) and the right-hand-side kernels at r = 1 + nq
    (and r = 1 for refinement passes or nq = 0).  Raises ValueError outside
    the kernels' range."""
    from collocfem_tpu_torch.ops import cr

    counts = {0, 1 + nq} | ({1} if refine or nq == 0 else set())
    return [cr.instance(block_size, r) for r in sorted(counts)]


def resolve_method(problem, method: str, refine: int = 0) -> str:
    """The solvers' method policy for ``problem``: 'auto' through
    :func:`resolve_auto_method`; 'cr' checks the CR kernels' range on the
    card (:func:`require_cr_shapes`); 'cr_dw' is not ported.  On a CUDA
    device it also builds and loads every kernel instance the solve will
    run (``ops._build``), at the solver's construction, so that no nvcc run
    and no library load happens inside a CUDA-graph capture."""
    if method == "cr_dw":
        raise NotImplementedError(
            "method='cr_dw' is not ported: a float64 level on method='cr' "
            "takes its place, as headline.ConvergedLadder runs its fine level "
            "past refine.CR_DW_CHAIN")
    block_size = problem.mesh.degree * problem.nv
    nq = problem.model.nq
    if method == "auto":
        method = resolve_auto_method(block_size, nq, problem.device, refine)
    elif method not in ("spike", "cr"):
        raise ValueError(f"unknown method {method!r}")
    if torch.device(problem.device).type == "cuda":
        from collocfem_tpu_torch.ops import _build

        instances = (_spike_instances if method == "spike" else
                     _cr_instances)(block_size, nq, refine)
        _build.load_all(instances)
    return method


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
        dmax = diag.max()
        if C.shape[0]:
            dmax = torch.maximum(dmax, torch.diagonal(C).max())
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


def _matvec_soa(D, E, X):
    """y = A X in SoA: D, E (bd, bd, K), X (bd, K); E[..., K-1] ignored."""
    e = E[..., :-1]
    y = torch.einsum("ijk,jk->ik", D, X)
    up = torch.einsum("ijk,jk->ik", e, X[:, 1:])
    lo = torch.einsum("jik,jk->ik", e, X[:, :-1])
    zero = torch.zeros_like(X[:, :1])
    return y + torch.cat([up, zero], dim=1) + torch.cat([zero, lo], dim=1)


def _solve_equilibrated(sys, lam, refine, damp_scale, chain):
    """Equilibrate, solve the chain against [gx | B], Schur solve, compose,
    ``refine`` refinement passes, unscale.  ``chain`` names the chain solve:
    'spike' (kernel #2), 'cr' (the CR kernels, or their plain versions on
    the CPU) or 'plain' (the plain CR on any device).  Returns (dx, dp,
    dmax)."""
    nq = sys.C.shape[0]
    s, inv, inv_sp, dmax = _equilibrate_soa(sys, lam, damp_scale)
    if chain == "spike":
        from collocfem_tpu_torch.ops.spike import blocktri_solve_spike_fused

        apply_fn = lambda G: blocktri_solve_spike_fused(s.D, s.E,
                                                        G.contiguous())
    elif chain == "cr":
        apply_fn = blocktri_cr_factor_soa(s.D, s.E)
    else:
        apply_fn = blocktri_cr_factor_plain(s.D, s.E)

    if nq == 0:
        dx = -apply_fn(s.gx[:, None, :])[:, 0, :]
        for _ in range(refine):
            res = s.gx + _matvec_soa(s.D, s.E, dx)
            dx = dx - apply_fn(res[:, None, :])[:, 0, :]
        return dx * inv, sys.D.new_zeros((0,)), dmax

    x = apply_fn(torch.cat([s.gx[:, None, :], s.B], dim=1))
    a_g, a_b = x[:, 0, :], x[:, 1:, :]
    schur = s.C - torch.einsum("bqk,brk->qr", s.B, a_b)
    rp = s.gp - torch.einsum("bqk,bk->q", s.B, a_g)
    dp = -_schur_solve(schur, rp)
    dx = -(a_g + torch.einsum("bqk,q->bk", a_b, dp))
    for _ in range(refine):
        res_x = (s.gx + _matvec_soa(s.D, s.E, dx)
                 + torch.einsum("bqk,q->bk", s.B, dp))
        res_p = s.gp + torch.einsum("bqk,bk->q", s.B, dx) + s.C @ dp
        ax = apply_fn(res_x[:, None, :])[:, 0, :]
        cp = _schur_solve(schur, res_p - torch.einsum("bqk,bk->q", s.B, ax))
        dx = dx - (ax - torch.einsum("bqk,q->bk", a_b, cp))
        dp = dp - cp
    return dx * inv, dp * inv_sp, dmax


def solve_kkt_plain(sys, lam, damp_scale=None):
    """The plain damped KKT solve: equilibrate, cyclic reduction on
    [gx | B], Schur solve, compose and unscale.  Returns (dx, dp, dmax).

    This is the reference of the fused kernel
    (``ops.spike.kkt_solve_spike_fused_ref`` calls it): it launches no
    kernel on any device.
    """
    return _solve_equilibrated(sys, lam, 0, damp_scale, "plain")


def solve_kkt_soa(sys, lam, refine: int = 0, dw: bool = False,
                  spike: bool = False, damp_scale=None,
                  with_dmax: bool = False):
    """Solve the damped KKT system [[A, B], [B^T, C]] [dx, dp] = -[gx, gp].

    ``sys`` is an ``ops.assemble.BlockTriSystemSoA``.  With ``spike=True``
    the chain runs on the CUDA kernels: for ``refine == 0`` and ``nq > 0``
    the fused KKT kernel (:func:`ops.spike.kkt_solve_spike_fused`), else the
    plain SPIKE chain kernel (:func:`ops.spike.blocktri_solve_spike_fused`)
    for every chain solve, each call refactoring.  Otherwise cyclic
    reduction factors once and is reused (on a CUDA device the CR kernels
    #4-#6, on the CPU their plain versions).  ``refine``
    iterative-refinement passes re-solve the scaled KKT residual.  Returns
    (dx (bd, K), dp (nq,)) and, with ``with_dmax``, the damping scale.
    """
    if dw:
        raise NotImplementedError(
            "the double-word factorisation (dw=True) is not ported: a float64 "
            "solve takes its place, as headline.ConvergedLadder runs its fine "
            "level past refine.CR_DW_CHAIN")
    if spike and sys.C.shape[0] > 0 and refine == 0:
        from collocfem_tpu_torch.ops.spike import kkt_solve_spike_fused

        out = kkt_solve_spike_fused(
            sys.D, sys.E, sys.B, sys.gx, sys.C, sys.gp, lam, damp_scale)
    else:
        out = _solve_equilibrated(sys, lam, refine, damp_scale,
                                  "spike" if spike else "cr")
    return out if with_dmax else out[:2]
