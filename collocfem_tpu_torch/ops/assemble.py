"""Gauss-Newton assembly: per-element jacfwd -> block-tridiagonal + arrowhead.

Counterpart of ``collocfem_tpu/ops/assemble.py``.  Nodes are padded to K*d
(K = N+1 blocks of d nodes); element e touches block e plus the first node of
block e+1, so the state Hessian is block tridiagonal with uniform
(d*nv, d*nv) blocks.  The parameter "arrowhead" is a separate strip + (nq, nq)
corner, eliminated by a Schur complement in the solver.

Two layouts:
  * structure of arrays (:class:`BlockTriSystemSoA`, the hot path): the
    chain index K on the LAST axis; :func:`assemble_gn_soa` for one
    experiment (on the card through the kernel of :mod:`ops.gn_elements`
    where it engages), :func:`assemble_gn_soa_batched` for a batch laid
    side by side as one concatenated chain;
  * block-major (:class:`BlockTriSystem`): (..., K, b, b) with optional
    leading experiment axes; :func:`assemble_gn` and
    :func:`assemble_gn_batched` (config 5's ``layout="blocks"``).

The initial-state prior enters every assembly through two helpers,
:func:`x0_prior_residual` and :func:`add_x0_prior`: per-state weights (nx,)
or a full (nx, nx) sqrt-information matrix.

The batched assemblies carry an explicit experiment axis: ``torch.func.vmap``
maps only the per-element ``jacfwd`` (the scatters below write in place into
fresh tensors, which ``vmap`` cannot run).  Every cost is float64, read off
the assembly's own residuals, in place of the JAX package's double-word cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, jacfwd, vmap

from collocfem_tpu_torch.utils import profiling


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


def x0_prior_residual(x0_w, dx0):
    """Residual of the initial-state prior at dx0 = x(t0) - x0_prior (...,
    nx): L dx0 for a full sqrt-information matrix x0_w (..., nx, nx), x0_w *
    dx0 for per-state weights (..., nx)."""
    if x0_w.ndim > dx0.ndim:
        return torch.einsum("...ij,...j->...i", x0_w, dx0)
    return x0_w * dx0


def add_x0_prior(D0, g0, x0_w, dx0):
    """Add the initial-state prior's normal equations in place: D0 (...,
    nx, nx) is a view of block 0's leading states, g0 (..., nx) of their
    gradient.  A full sqrt-information matrix L adds L^T L and L^T L dx0;
    per-state weights w add w^2 on the diagonal and w^2 dx0."""
    if x0_w.ndim > dx0.ndim:
        lam_x0 = x0_w.mT @ x0_w
        D0 += lam_x0
        g0 += torch.einsum("...ij,...j->...i", lam_x0, dx0)
    else:
        w2 = x0_w**2
        torch.diagonal(D0, dim1=-2, dim2=-1).add_(w2)
        g0 += w2 * dx0


def _chain_scatter_soa(h11, h22, h12, b1, b2, g1, g2):
    """Scatter per-element blocks, element axis LAST, into the 2-D SoA
    chain (D2, E2 (bd*bd, K), B2 (bd*nq, K), gx (bd, K)), K = N + 1.
    Element e's local variables are block e (``bd``) then the leading
    ``nv`` of block e+1: h11 (bd, bd, N), h22 (nv, nv, N), h12 (bd, nv, N),
    b1 (bd, nq, N), b2 (nv, nq, N), g1 (bd, N), g2 (nv, N).  The scatter is
    two static lane slices (element e -> chain slots e and e+1)."""
    bd, nv, n = h11.shape[0], h22.shape[0], h11.shape[-1]
    k, nq = n + 1, b1.shape[1]
    zeros = lambda *shape: h11.new_zeros(shape)
    # Block e+1's top-left (nv, nv) overlap: rows i*bd + j for i, j < nv are
    # the leading nv*bd rows once the column space is padded nv -> bd.
    pad_cols = (0, 0, 0, bd - nv)
    D2 = zeros(bd * bd, k)
    D2[:, :n] += h11.reshape(bd * bd, n)
    D2[:nv * bd, 1:] += torch.nn.functional.pad(h22, pad_cols).reshape(nv * bd, n)
    E2 = zeros(bd * bd, k)
    E2[:, :n] = torch.nn.functional.pad(h12, pad_cols).reshape(bd * bd, n)
    B2 = zeros(bd * nq, k)
    B2[:, :n] += b1.reshape(bd * nq, n)
    B2[:nv * nq, 1:] += b2.reshape(nv * nq, n)
    gx = zeros(bd, k)
    gx[:, :n] += g1
    gx[:nv, 1:] += g2
    return D2, E2, B2, gx


def _scatter_soa(problem, z, data, *, h11, h22, h12, b1, b2, g1, g2, hpp,
                 gpe):
    """:func:`_chain_scatter_soa` of the per-element blocks, then the
    priors; hpp (nq, nq) and gpe (nq,) are summed over the elements."""
    n, nv, nx = problem.mesh.num_elements, problem.nv, problem.model.nx
    k, bd, nq = n + 1, h11.shape[0], hpp.shape[0]
    dtype, device = z.V.dtype, z.V.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    D2, E2, B2, gx = _chain_scatter_soa(h11, h22, h12, b1, b2, g1, g2)

    pw2 = data.p_w**2
    C = hpp + torch.diag(pw2)
    gp = gpe + pw2 * (z.p - data.p_prior)
    # SPD identity on the trailing pad entries of the last block, and the
    # x0 prior on block 0.
    diag_add = zeros(bd, k)
    diag_add[nv:, k - 1] = 1.0
    D2[::bd + 1] += diag_add
    add_x0_prior(D2.view(bd, bd, k)[:nx, :nx, 0], gx[:nx, 0], data.x0_w,
                 z.V[0, :nx] - data.x0_prior)
    return BlockTriSystemSoA(
        D=D2.reshape(bd, bd, k), E=E2.reshape(bd, bd, k),
        B=B2.reshape(bd, nq, k), C=C, gx=gx, gp=gp,
    )


def normal_equations_soa(problem, z, data, r, jx, jp,
                         with_cost: bool = False):
    """The SoA system from every element's residual r (N, m) and Jacobians
    jx (N, m, (d + 1) nv), jp (N, m, nq): the normal-equation contractions
    emit the element axis last, and the chain scatter is two static lane
    slices (element e -> chain slots e and e+1).  With ``with_cost`` also
    the float64 cost 0.5 ||r||^2 with the priors' residuals."""
    bd = problem.mesh.degree * problem.nv
    jx1, jx2 = jx[:, :, :bd], jx[:, :, bd:]
    out = _scatter_soa(
        problem, z, data,
        h11=torch.einsum("emi,emj->ije", jx1, jx1),
        h22=torch.einsum("emi,emj->ije", jx2, jx2),
        h12=torch.einsum("emi,emj->ije", jx1, jx2),
        b1=torch.einsum("emi,emq->iqe", jx1, jp),
        b2=torch.einsum("emi,emq->iqe", jx2, jp),
        g1=torch.einsum("emi,em->ie", jx1, r),
        g2=torch.einsum("emi,em->ie", jx2, r),
        hpp=torch.einsum("emq,emr->qr", jp, jp),
        gpe=torch.einsum("emq,em->q", jp, r))
    if not with_cost:
        return out
    r64 = torch.cat([r.reshape(-1), problem.prior_residuals(z, data)])
    r64 = r64.double()
    return out, 0.5 * torch.sum(r64 * r64)


def assemble_gn_soa(problem, z, data, with_cost: bool = False):
    """Assemble the Gauss-Newton system at iterate ``z``.

    On the card, for an :class:`EstimationProblem` in the kernel's range
    (:func:`ops.gn_elements.engages`), the model's values at the nodes and
    the hand-written kernel ``csrc/gn_elements.cu`` build it
    (:mod:`ops.gn_elements`; counted in ``profiling.COUNTERS
    ["assembly_fused"]``).  Otherwise (``["assembly_generic"]``) residuals
    and Jacobians come from ``vmap(jacfwd(elem_residual))`` over the
    elements, then :func:`normal_equations_soa`.  With ``with_cost`` it
    also returns the float64 cost 0.5 * ||r||^2 at ``z``, read off the same
    residuals (this replaces the double-word cost of the JAX package: the
    GPU has native float64).
    """
    from collocfem_tpu_torch.ops import gn_elements

    if gn_elements.engages(problem, z, data):
        profiling.count("assembly_fused")
        out = gn_elements.gn_system(
            problem, z, data, gn_elements.node_values(problem, z, data))
        return out if with_cost else out[0]
    profiling.count("assembly_generic")
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
    return normal_equations_soa(problem, z, data, r, jx, jp, with_cost)


def scatter_gn_blocks_soa(hxx, hxp, hpp, gxe, gpe, *, num_blocks, nv,
                          overlap, dtype):
    """Per-element dense Gauss-Newton blocks, element axis LAST, into the
    SoA block-tridiagonal + arrowhead system (no priors).

    Counterpart of the JAX package's ``scatter_gn_blocks_soa``.  hxx (s, s,
    N), hxp (s, nq, N), gxe (s, N) with s = bd + overlap: element e owns
    block e (its first bd local variables) and the leading ``overlap`` (=
    ``nv``) variables of block e+1; hpp (nq, nq) and gpe (nq,) are summed
    over the elements (K = ``num_blocks`` = N + 1; ``nv`` and ``dtype``
    are the JAX signature's, read off the inputs here).  The trailing pad
    entries of the last block get an identity, which keeps the padded
    system SPD.
    """
    bd, nq = hxx.shape[0] - overlap, hxp.shape[1]
    D2, E2, B2, gx = _chain_scatter_soa(
        hxx[:bd, :bd], hxx[bd:, bd:], hxx[:bd, bd:], hxp[:bd], hxp[bd:],
        gxe[:bd], gxe[bd:])
    D2[overlap * (bd + 1)::bd + 1, num_blocks - 1] += 1.0
    return BlockTriSystemSoA(
        D=D2.reshape(bd, bd, num_blocks), E=E2.reshape(bd, bd, num_blocks),
        B=B2.reshape(bd, nq, num_blocks), C=hpp, gx=gx, gp=gpe)


def node_block_scatter_soa(sys, Hn, Bn, gn, degree: int):
    """Add per-node terms to the SoA block structure, node axis LAST.

    Counterpart of the JAX package's ``node_block_scatter_soa``.  Hn (nv,
    nv, M), Bn (nv, nq, M), gn (nv, M); node m lives in block m // d at
    node offset m % d, so the nodes of one offset are a strided lane slice
    [off::d]: d static slices, no dynamic scatter.  Returns a new system
    (``sys`` is left as it was).
    """
    bd, _, k = sys.D.shape
    nq = sys.C.shape[0]
    nv, m = gn.shape
    d = degree
    D = sys.D.clone()
    B = sys.B.clone()
    gx = sys.gx.clone()
    D5 = D.view(d, nv, d, nv, k)
    B4 = B.view(d, nv, nq, k)
    g3 = gx.view(d, nv, k)
    for off in range(d):
        w = len(range(off, m, d))
        D5[off, :, off, :, :w] += Hn[:, :, off::d]
        if nq:
            B4[off, :, :, :w] += Bn[:, :, off::d]
        g3[off, :, :w] += gn[:, off::d]
    return sys._replace(D=D, B=B, gx=gx)


def blocks_to_nodes_soa(dx, num_nodes: int, nv: int):
    """(bd, K) SoA solution -> (M, nv) node values."""
    bd, k = dx.shape
    return dx.T.reshape(k * (bd // nv), nv)[:num_nodes]


# ---- batched experiments and the block-major layout --------------------------


class BlockTriSystem(NamedTuple):
    """Damped-GN normal equations [[A, B], [B^T, C]] [dx, dp] = -[gx, gp] in
    block-major layout, with optional leading experiment axes (...).

    ``D`` (..., K, bd, bd) diagonal blocks, ``E`` (..., K, bd, bd) coupling
    with A[k, k+1] = E[k] (E[K-1] = 0), ``B`` (..., K, bd, nq) parameter
    strip, ``C`` (..., nq, nq) corner, ``gx`` (..., K, bd), ``gp`` (..., nq).
    """

    D: torch.Tensor
    E: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    gx: torch.Tensor
    gp: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.D.shape[-3]

    @property
    def block_size(self) -> int:
        return self.D.shape[-1]


def scatter_gn_blocks(hxx, hxp, hpp, gxe, gpe, *, num_blocks, overlap, dtype):
    """Scatter per-element dense GN blocks into the block-tri + arrowhead form.

    Element ``e`` owns block ``e`` (its first ``bd = s - overlap`` local
    variables) and the leading ``overlap`` variables of block ``e+1``.

    Args (optional leading experiment axes ``...`` on every argument):
      hxx (..., N, s, s) per-element J^T J; hxp (..., N, s, nq);
      hpp (..., nq, nq) summed parameter block; gxe (..., N, s);
      gpe (..., nq) summed parameter gradient.
    Returns a :class:`BlockTriSystem` with no priors (the caller adds them).
    """
    *lead, n, s, _ = hxx.shape
    k, bd, nq = num_blocks, s - overlap, hxp.shape[-1]
    zeros = lambda *shape: torch.zeros((*lead, *shape), dtype=dtype,
                                       device=hxx.device)
    D = zeros(k, bd, bd)
    D[..., :n, :, :] += hxx[..., :bd, :bd]
    D[..., 1:n + 1, :overlap, :overlap] += hxx[..., bd:, bd:]
    E = zeros(k, bd, bd)
    E[..., :n, :, :overlap] += hxx[..., :bd, bd:]
    B = zeros(k, bd, nq)
    B[..., :n, :, :] += hxp[..., :bd, :]
    B[..., 1:n + 1, :overlap, :] += hxp[..., bd:, :]
    gx = zeros(k, bd)
    gx[..., :n, :] += gxe[..., :bd]
    gx[..., 1:n + 1, :overlap] += gxe[..., bd:]
    # Identity on the trailing pad entries of the last block keeps the
    # padded system SPD; their solution and gradient are exactly 0.
    last = torch.diagonal(D[..., k - 1, :, :], dim1=-2, dim2=-1)
    last[..., overlap:] += 1.0
    return BlockTriSystem(D=D, E=E, B=B, C=hpp, gx=gx, gp=gpe)


def _batched_jacobians(problem, Vb, p, data_batch):
    """Residuals and Jacobians of every element of every experiment:
    r (E, N, m), jx (E, N, m, s), jp (E, N, m, nq).  ``vmap`` over the
    elements of ``jacfwd``, then over experiments with the shared tables
    unbatched."""
    ed, dims = problem.elem_data_batched(data_batch)

    def res_aux(xe_flat, p_, edata):
        r = problem.elem_residual(xe_flat, p_, edata)
        return r, r

    def per_elem(xe_flat, edata):
        (jx, jp), r = jacfwd(res_aux, argnums=(0, 1), has_aux=True)(
            xe_flat, p, edata)
        return r, jx, jp

    return vmap(vmap(per_elem), in_dims=(0, dims))(
        problem.gather_elements(Vb), ed)


def cost64_from_residuals(problem, r, Vb, p, data_batch):
    """float64 0.5 * ||r||^2 over the element residuals ``r`` (E, N, m) and
    every experiment's own priors (a shared prior is the caller's)."""
    r64 = torch.cat([
        r.reshape(-1),
        problem.prior_residuals_batched(Vb, p, data_batch).reshape(-1),
    ]).double()
    return 0.5 * torch.sum(r64 * r64)


def assemble_gn_batched(problem, Vb, p, data_batch, with_cost: bool = False):
    """Block-major Gauss-Newton systems of a batch of experiments sharing p.

    Counterpart of ``vmap(assemble_gn)`` over experiments in the JAX
    package's ``parallel.batch.shared_gn_step``.  ``Vb`` (E, M, nv),
    ``data_batch`` a :class:`ProblemData` with a leading experiment axis.
    Returns a :class:`BlockTriSystem` with a leading experiment axis on every
    field (C (E, nq, nq) and gp (E, nq) per experiment, each with its own
    p prior) and, with ``with_cost``, the float64 cost summed over the
    batch.
    """
    mesh, model = problem.mesh, problem.model
    nv, nx = problem.nv, model.nx
    r, jx, jp = _batched_jacobians(problem, Vb, p, data_batch)
    sys = scatter_gn_blocks(
        torch.einsum("xemi,xemj->xeij", jx, jx),
        torch.einsum("xemi,xemq->xeiq", jx, jp),
        torch.einsum("xemq,xemr->xqr", jp, jp),
        torch.einsum("xemi,xem->xei", jx, r),
        torch.einsum("xemq,xem->xq", jp, r),
        num_blocks=mesh.num_blocks, overlap=nv, dtype=Vb.dtype)
    pw2 = data_batch.p_w**2                                   # (E, nq)
    D, gx = sys.D, sys.gx
    add_x0_prior(D[:, 0, :nx, :nx], gx[:, 0, :nx], data_batch.x0_w,
                 Vb[:, 0, :nx] - data_batch.x0_prior)
    out = BlockTriSystem(
        D=D, E=sys.E, B=sys.B, C=sys.C + torch.diag_embed(pw2), gx=gx,
        gp=sys.gp + pw2 * (p - data_batch.p_prior))
    if with_cost:
        return out, cost64_from_residuals(problem, r, Vb, p, data_batch)
    return out


def _stack_one(data):
    return type(data)(*(x[None] for x in data))


def assemble_gn(problem, z, data, with_cost: bool = False):
    """Block-major Gauss-Newton system of one experiment at iterate ``z``:
    :func:`assemble_gn_batched` over a batch of one.  With ``with_cost``
    also the float64 cost at ``z``."""
    out = assemble_gn_batched(problem, z.V[None], z.p, _stack_one(data),
                              with_cost)
    if with_cost:
        sys, cost = out
        return type(sys)(*(x[0] for x in sys)), cost
    return type(out)(*(x[0] for x in out))


def assemble_gn_soa_batched(problem, Vb, p, data_batch,
                            with_cost: bool = False):
    """Batched-experiment SoA assembly: ONE concatenated chain for the whole
    batch (config 5's hot path).

    Chain slot ``x*K + k`` holds experiment x's block k; the coupling slot
    at each experiment's last block stays exactly zero, so the concatenated
    matrix is block diagonal over experiments, a valid chain for the SPIKE
    solve.  B and C accumulate over all experiments, so the arrowhead Schur
    complement of the concatenated system is the shared-parameter Schur sum.
    Per-experiment p priors (``data_batch.p_w``) enter C and gp; the batch
    solvers pass them as zero and add the shared prior once.  Every scatter
    is a static slice of (bd, bd, E, K) intermediates.

    Returns a :class:`BlockTriSystemSoA` with chain length E*K and, with
    ``with_cost``, the float64 cost of the batch (without a shared prior).
    """
    mesh, model = problem.mesh, problem.model
    n, d, nv, nq = mesh.num_elements, mesh.degree, problem.nv, model.nq
    k, bd, nx = n + 1, d * nv, model.nx
    n_exp = Vb.shape[0]
    r, jx, jp = _batched_jacobians(problem, Vb, p, data_batch)
    hxx = torch.einsum("xemi,xemj->ijxe", jx, jx)           # (s, s, E, N)
    hxp = torch.einsum("xemi,xemq->iqxe", jx, jp)           # (s, nq, E, N)
    gxe = torch.einsum("xemi,xem->ixe", jx, r)              # (s, E, N)

    zeros = lambda *shape: torch.zeros(shape, dtype=Vb.dtype, device=Vb.device)
    D = zeros(bd, bd, n_exp, k)
    D[:, :, :, :n] += hxx[:bd, :bd]
    D[:nv, :nv, :, 1:] += hxx[bd:, bd:]
    E = zeros(bd, bd, n_exp, k)
    E[:, :nv, :, :n] = hxx[:bd, bd:]      # slot K-1 stays 0: experiments
    B = zeros(bd, nq, n_exp, k)           # decouple at the boundary
    B[:, :, :, :n] += hxp[:bd]
    B[:nv, :, :, 1:] += hxp[bd:]
    gx = zeros(bd, n_exp, k)
    gx[:, :, :n] += gxe[:bd]
    gx[:nv, :, 1:] += gxe[bd:]

    pw2 = data_batch.p_w**2                                 # (E, nq)
    C = torch.einsum("xemq,xemr->qr", jp, jp) + torch.diag(pw2.sum(0))
    gp = (torch.einsum("xemq,xem->q", jp, r)
          + torch.sum(pw2 * (p - data_batch.p_prior), dim=0))
    diag_add = zeros(bd, n_exp, k)
    diag_add[nv:, :, k - 1] = 1.0
    torch.diagonal(D, dim1=0, dim2=1)[...] += diag_add.permute(1, 2, 0)
    add_x0_prior(D[:nx, :nx, :, 0].permute(2, 0, 1), gx[:nx, :, 0].T,
                 data_batch.x0_w, Vb[:, 0, :nx] - data_batch.x0_prior)

    out = BlockTriSystemSoA(
        D=D.reshape(bd, bd, n_exp * k), E=E.reshape(bd, bd, n_exp * k),
        B=B.reshape(bd, nq, n_exp * k), C=C, gx=gx.reshape(bd, n_exp * k),
        gp=gp)
    if with_cost:
        return out, cost64_from_residuals(problem, r, Vb, p, data_batch)
    return out


def assemble_newton(problem, z, data):
    """Assemble the EXACT Newton system at iterate ``z`` (SoA layout).

    Counterpart of the JAX package's ``ops.assemble.assemble_newton`` (which
    builds the block-major system; its ``soa_from_blocks`` of that is this
    function's result): the Gauss-Newton system drops the curvature term
    sum_i r_i hess(r_i); this keeps it.  Per element, the gradient and the
    full Hessian of 0.5 ||r_e||^2 over (local nodes, parameters) come from
    forward-over-reverse AD (``jacfwd`` of ``grad``) under ``vmap``, and
    scatter into the same block-tridiagonal + arrowhead structure: an
    element's residuals touch only its own variables, so second derivatives
    add no new sparsity.  The priors are exactly quadratic, so their
    Gauss-Newton and exact-Newton contributions coincide.

    The exact Hessian can be indefinite far from a minimum.  The KKT solve
    factors without pivoting, so such a step gives a non-finite trial cost;
    the LM loop rejects it and raises lam until H + lam dmax I is positive
    definite.
    """
    bd = problem.mesh.degree * problem.nv

    def cost_e(xe_flat, p, edata):
        r = problem.elem_residual(xe_flat, p, edata)
        return 0.5 * torch.sum(r * r)

    grad_e = grad(cost_e, argnums=(0, 1))

    def per_elem(xe_flat, edata):
        gx_e, gp_e = grad_e(xe_flat, z.p, edata)
        (hxx, hxp), (_, hpp) = jacfwd(grad_e, argnums=(0, 1))(
            xe_flat, z.p, edata)
        return gx_e, gp_e, hxx, hxp, hpp

    gxe, gpe, hxx, hxp, hpp = vmap(per_elem)(
        problem.gather_elements(z.V), problem._elem_data(data))
    last = lambda a: a.movedim(0, -1)             # element axis last
    return _scatter_soa(
        problem, z, data,
        h11=last(hxx[:, :bd, :bd]), h22=last(hxx[:, bd:, bd:]),
        h12=last(hxx[:, :bd, bd:]), b1=last(hxp[:, :bd]),
        b2=last(hxp[:, bd:]), g1=last(gxe[:, :bd]), g2=last(gxe[:, bd:]),
        hpp=hpp.sum(0), gpe=gpe.sum(0))


def blocks_to_nodes(dx_blocks, num_nodes: int, nv: int):
    """(..., K, bd) block-stacked solution -> (..., M, nv) node values."""
    *lead, k, bd = dx_blocks.shape
    return dx_blocks.reshape(*lead, k * (bd // nv), nv)[..., :num_nodes, :]
