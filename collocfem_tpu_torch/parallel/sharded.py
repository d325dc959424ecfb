"""Element-chain (time-mesh) sharded Gauss-Newton over the "sp" ranks.

Counterpart of ``collocfem_tpu/parallel/sharded.py``.  The collocation
elements are split into contiguous slices, one per rank of the sp group.
Each rank

  1. evaluates residuals and ``jacfwd`` blocks of its own elements only;
  2. scatters them into its slice of the block chain: an element at the
     right edge of a shard touches the first block of the next shard, so
     one boundary block of (D, B, gx) goes to the right neighbour, and the
     first node of the right neighbour comes back (halo exchanges);
  3. solves the damped, Jacobi-equilibrated system with SPIKE
     (:func:`parallel.spike.blocktri_solve_spike`), one interface exchange
     a solve;
  4. sums the (nq, nq) parameter Schur pieces and the scalars that drive
     the LM loop (cost, gradient norm, the accept quantities) over the
     ranks.

The LM loop is the single-rank solvers' (:func:`solve.newton.
captured_lm_solve` over :func:`solve.lm_core.lm_step`).  Every input of an
accept decision is all-reduced (the float64 cost and g.s, s.s partials in
one sum, where the JAX package sums double words with ``psum_dw``), so every
rank takes the same branch, holds the same ``done`` bit for bit and ends
with the same bits.

As the JAX package jits a ``shard_map`` over its ``lax.while_loop`` and
slices and pads outside it, a call runs in three parts: this rank's node
rows and element data, eagerly; the LM solve on them, which on a CUDA
device replays CUDA graphs (:mod:`solve.graph`) with every all-reduce, halo
exchange and kernel #2 launch inside them; and the gather of V over the
ranks, eagerly.  The collectives are the peer all-reduce's kernel
(:mod:`parallel.peer`), so with a tolerance set the LM steps run under the
loop graph's WHILE node, as a single-rank solve's do: the device decides
the exit and the host reads nothing during the solve, on ranks sharing one
card as on one rank a card.  Every rank captures the same graphs in the
same order, and the ranks' ``done`` is the same bit for bit, so they run
the same steps.  A call ends with :func:`parallel.peer.check` (one
synchronisation, then a read of the sp group's error word).  On the CPU the
solve runs eagerly; a group whose ranks cannot map each other's memory is
refused when the solver is made (``parallel.meshes.capture_refusal``).

Sizing: K = N + 1 blocks must divide by sp with >= 2 blocks a shard.  The
one dummy element that squares the element count with K sits in the last
slot of the last shard and is masked out.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from collocfem_tpu_torch.ops.assemble import (add_x0_prior,
                                              scatter_gn_blocks,
                                              x0_prior_residual)
from collocfem_tpu_torch.ops.smallblocks import spd_solve
from collocfem_tpu_torch.parallel import peer
from collocfem_tpu_torch.parallel.meshes import (all_max, all_sum,
                                                  capture_refusal, from_left,
                                                  from_right, gather)
from collocfem_tpu_torch.parallel.spike import blocktri_solve_spike
from collocfem_tpu_torch.problem import Decision, ElemData
from collocfem_tpu_torch.solve.lm_core import LMAux
from collocfem_tpu_torch.solve.newton import SolverOptions, captured_lm_solve


def make_sp_gn_solver(problem, dev_mesh, options: SolverOptions =
                      SolverOptions()):
    """Single-experiment GN solver with the elements sharded over
    ``dev_mesh``'s sp ranks.

    Returns ``solve(z0, data) -> (z, SolveStats)`` on GLOBAL tensors, which
    every rank of the sp group passes alike; every rank returns the global
    ``Decision`` and stats, bit for bit the same.  Counterpart of the JAX
    package's ``jax.jit(shard_map(...))``: with ``dev_mesh`` on a CUDA
    device, the LM solve replays CUDA graphs captured at the first call of
    each input shape (with a tolerance, one loop graph that reads nothing
    to the host); on the CPU it runs eagerly.  ``solve.eager(z0, data)``
    runs the eager loop on any device and ``solve.stepwise(z0, data)``
    (CPU) the captured functions in replay order, each with the same result
    bit for bit.  If the sp group's ranks cannot map each other's memory a
    call raises ValueError with the reason.
    """
    opt = options
    group, sp, sidx = dev_mesh.sp_group, dev_mesh.sp, dev_mesh.sp_rank
    n, d = problem.mesh.num_elements, problem.mesh.degree
    nv, nq, nx = problem.nv, problem.model.nq, problem.model.nx
    k, bd = n + 1, d * nv
    if k % sp:
        raise ValueError(f"K={k} blocks not divisible by sp={sp}")
    mb = k // sp  # blocks (= element slots) a shard
    if mb < 2:
        raise ValueError("need >= 2 blocks per sp shard")
    is_first, is_last = sidx == 0, sidx == sp - 1
    dtype, device = problem.dtype, problem.device
    # The dummy element (the last slot of the last shard) contributes
    # nothing.
    emask = torch.ones(mb, dtype=dtype, device=device)
    if is_last:
        emask[-1] = 0.0

    def gather_local(V):
        """(mb, (d+1) nv) element flats of the local node rows, the right
        neighbour's first node closing the last element."""
        v_ext = torch.cat([V, from_right(V[0], group)[None]])
        cols = [v_ext[j:j + (mb - 1) * d + 1:d] for j in range(d + 1)]
        return v_ext, torch.stack(cols, dim=-2).reshape(mb, -1)

    def total_cost(V, p, ed, data, *partials):
        """The global float64 cost at (V, p), and the global sums of the
        float64 ``partials``, in one all-reduce.  x(t0) lives on shard 0 and
        joins the sum; the priors are added once, on every rank alike."""
        _, xe = gather_local(V)
        r = vmap(problem.elem_residual, in_dims=(0, None, 0))(xe, p, ed)
        r64 = (r * emask[:, None]).double()
        x0 = V[0, :nx] if is_first else V.new_zeros(nx)
        s, x0, *sums = all_sum(group, torch.sum(r64 * r64), x0, *partials)
        extra = torch.cat([data.p_w * (p - data.p_prior),
                           x0_prior_residual(data.x0_w,
                                             x0 - data.x0_prior)]).double()
        return 0.5 * (s + torch.sum(extra * extra)), sums

    def assemble(V, p, ed, data):
        v_ext, xe = gather_local(V)

        def res_aux(xe_flat, p_, edata):
            r = problem.elem_residual(xe_flat, p_, edata)
            return r, r

        def per_elem(xe_flat, edata):
            (jx, jp), r = jacfwd(res_aux, argnums=(0, 1), has_aux=True)(
                xe_flat, p, edata)
            return r, jx, jp

        r, jx, jp = vmap(per_elem)(xe, ed)
        r = r * emask[:, None]
        jx = jx * emask[:, None, None]
        jp = jp * emask[:, None, None]
        sys_loc = scatter_gn_blocks(
            torch.einsum("emi,emj->eij", jx, jx),
            torch.einsum("emi,emq->eiq", jx, jp),
            torch.einsum("emq,emr->qr", jp, jp),          # local partial
            torch.einsum("emi,em->ei", jx, r),
            torch.einsum("emq,em->q", jp, r),             # local partial
            num_blocks=mb + 1, overlap=nv, dtype=dtype)
        # Block mb spills into the right neighbour's block 0, less the pad
        # identity scatter_gn_blocks put on it (those entries are the
        # neighbour's real nodes).
        spill_D = sys_loc.D[-1].clone()
        torch.diagonal(spill_D)[nv:] -= 1.0
        spill = from_left(torch.cat([spill_D.reshape(-1),
                                     sys_loc.B[-1].reshape(-1),
                                     sys_loc.gx[-1]]), group)
        D, B, gx = sys_loc.D[:-1].clone(), sys_loc.B[:-1].clone(), \
            sys_loc.gx[:-1].clone()
        D[0] += spill[:bd * bd].reshape(bd, bd)
        B[0] += spill[bd * bd:bd * (bd + nq)].reshape(bd, nq)
        gx[0] += spill[bd * (bd + nq):]
        E = sys_loc.E[:-1]  # E[mb-1] couples to the next shard
        if is_last:  # the pad identity of the true last block
            torch.diagonal(D[mb - 1])[nv:] += 1.0
        if is_first:
            add_x0_prior(D[0, :nx, :nx], gx[0, :nx], data.x0_w,
                         v_ext[0, :nx] - data.x0_prior)
        return D, E, B, sys_loc.C, gx, sys_loc.gp

    def initial(z0, ed, data):
        return (), total_cost(z0.V, z0.p, ed, data)[0]

    def trial(z0, ed, data):
        pw2 = data.p_w**2
        eye_b = torch.eye(bd, dtype=dtype, device=device)
        tiny = torch.finfo(dtype).tiny

        def trial_fn(z, carry, lam):
            V, p = z
            D, E, B, hpp_loc, gx, gpe_loc = assemble(V, p, ed, data)
            hpp, gpe = all_sum(group, hpp_loc, gpe_loc)
            C = hpp + torch.diag(pw2)
            gp = gpe + pw2 * (p - data.p_prior)
            dgd = torch.diagonal(D, dim1=-2, dim2=-1)
            gx_max, dmax = all_max(group, gx.abs().max(), dgd.max())
            gnorm = torch.maximum(gx_max, gp.abs().max()) if nq else gx_max
            if nq:
                dmax = torch.maximum(dmax, torch.diagonal(C).max())
            # Damped, Jacobi-equilibrated system (solve.kkt's scaling,
            # distributed): lam times the global max diagonal, then unit
            # diagonal.
            lam_abs = lam * torch.clamp(dmax, min=tiny)
            dd = D + lam_abs * eye_b
            inv = 1.0 / torch.sqrt(torch.diagonal(dd, dim1=-2, dim2=-1))
            inv_shift = torch.cat([inv[1:], from_right(inv[0], group)[None]])
            Ds = dd * inv[:, :, None] * inv[:, None, :]
            Es = E * inv[:, :, None] * inv_shift[:, None, :]
            rhs = (gx * inv)[..., None]
            if nq:
                invp = 1.0 / torch.sqrt(torch.diagonal(C) + lam_abs)
                Bs = B * inv[:, :, None] * invp[None, None, :]
                rhs = torch.cat([rhs, Bs], dim=-1)
            x = blocktri_solve_spike(Ds, Es, rhs, group=group)
            a_g, a_b = x[..., 0], x[..., 1:]
            if nq:
                Cs = (C + lam_abs * torch.eye(nq, dtype=dtype, device=device)
                      ) * (invp[:, None] * invp[None, :])
                s_b, s_g = all_sum(group,
                                   torch.einsum("kbq,kbr->qr", Bs, a_b),
                                   torch.einsum("kbq,kb->q", Bs, a_g))
                dps = -spd_solve(Cs - s_b, (gp * invp - s_g)[:, None])[:, 0]
                dx = -(a_g + torch.einsum("kbq,q->kb", a_b, dps)) * inv
                dp = dps * invp
            else:
                dp = p.new_zeros((0,))
                dx = -a_g * inv
            z_try = Decision(V=V + dx.reshape(mb * d, nv), p=p + dp)
            dx64 = dx.reshape(-1).double()
            ct, (gdot, snorm2) = total_cost(
                *z_try, ed, data, torch.dot(gx.reshape(-1).double(), dx64),
                torch.dot(dx64, dx64))
            gdot = (gdot + torch.dot(gp, dp)).to(dtype)
            snorm2 = (snorm2 + torch.dot(dp, dp)).to(dtype)
            aux = LMAux(gnorm=gnorm, gdot=gdot, sds=dmax * snorm2,
                        step_norm=torch.sqrt(snorm2))
            return z_try, carry, ct, aux

        return trial_fn

    def local_inputs(z0, data):
        """This rank's node rows and element data: the nodes padded to K d
        rows, the elements to K with the dummy (width 1, zeros)."""
        lo, hi = sidx * mb, (sidx + 1) * mb
        V_pad = z0.V.new_zeros((k * d, nv))
        V_pad[:problem.num_nodes] = z0.V
        ed = problem._elem_data(data)
        pad = lambda leaf: torch.cat([leaf, leaf.new_zeros((1,) +
                                                           leaf.shape[1:])])
        ed = ElemData(*(pad(leaf)[lo:hi] for leaf in ed))
        if is_last:
            ed.width[-1] = 1.0
        return V_pad[lo * d:hi * d], ed

    captured = captured_lm_solve(
        initial, trial, opt, refused=capture_refusal(group, dev_mesh.device))

    def around(run):
        """The solve with ``run`` (the captured solve or one of its forms)
        as its middle part."""
        def solve(z0: Decision, data):
            V_loc, ed = local_inputs(z0, data)
            z, stats = run(Decision(V=V_loc, p=z0.p), ed, data)
            V = gather(z.V, group).reshape(k * d, nv)[:problem.num_nodes]
            peer.check(group)
            return Decision(V=V, p=z.p), stats
        return solve

    solve = around(captured)
    solve.eager = around(captured.eager)
    solve.stepwise = around(captured.stepwise)
    return solve
