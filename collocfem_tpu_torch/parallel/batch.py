"""Multi-experiment estimation: a batch of experiments sharing parameters.

Counterpart of ``collocfem_tpu/parallel/batch.py`` on one device (config 5:
1024 Van der Pol experiments of 10 elements).  The experiments share the
parameter vector p, which couples them only through the tiny (nq, nq)
parameter Schur complement:

  per experiment e:  A_e dx_e + B_e dp = -gx_e   (block-tridiagonal A_e)
  shared:            S = sum_e (C_e - B_e^T A_e^-1 B_e) + prior,
                     r = sum_e (gp_e - B_e^T A_e^-1 gx_e) + prior,
                     dp = -S^-1 r;   dx_e = -A_e^-1 (gx_e + B_e dp).

Two layouts, chosen by ``make_multi_experiment_solver(layout=...)``:

  * ``"soa"`` (the default): one concatenated SoA chain of E*K blocks
    (:func:`ops.assemble.assemble_gn_soa_batched`) solved by the SPIKE chain
    kernel, the trial cost read off the trial assembly's residuals;
  * ``"blocks"``: block-major per-experiment systems
    (:func:`ops.assemble.assemble_gn_batched`) solved by the batched Thomas
    kernel, the trial cost a separate residual pass.

The accept/damping logic is the shared :func:`solve.lm_core.lm_step`; the
JAX package's double-word cost sums and dot products are float64 sums here.
Where the JAX package jits the solve, the port replays it from CUDA graphs
on a CUDA device (``solve.newton.captured_lm_solve``).  With ``dp_axis`` (a
process group, :mod:`parallel.meshes`) each rank passes its own experiments
and the Schur pieces and the LM loop's scalars are all-reduced over the
group, as the JAX package's ``psum`` / ``pmax`` do inside ``shard_map``; on
a CUDA device those all-reduces (and, for dp x sp, the SPIKE exchanges of
``parallel.spike.spike_chain_solver``) are the peer all-reduce's kernel
(``parallel.peer``), captured in the graphs with the rest of the step, and
with a tolerance the steps run under the loop graph's WHILE node.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from collocfem_tpu_torch.ops.assemble import (
    assemble_gn_batched,
    assemble_gn_soa_batched,
    blocks_to_nodes,
    cost64_from_residuals,
)
from collocfem_tpu_torch.ops.smallblocks import spd_solve
from collocfem_tpu_torch.parallel import peer
from collocfem_tpu_torch.parallel.meshes import (all_max, all_sum,
                                                  capture_refusal)
from collocfem_tpu_torch.solve.lm_core import LMAux, grad_inf_norm
from collocfem_tpu_torch.solve.newton import SolverOptions, captured_lm_solve
from collocfem_tpu_torch.utils.profiling import device_span


class BatchDecision(NamedTuple):
    """V: (n_exp, M, nv) per-experiment state paths; p: (nq,) shared."""

    V: torch.Tensor
    p: torch.Tensor


def batched_chain_solver():
    """Chain solve of the block-major layout: every experiment's chain in
    one call of the batched Thomas kernel (:mod:`ops.thomas`) on a CUDA
    tensor, its plain version on the CPU.  Signature ``solve(D, E, G) -> X``
    with a leading experiment axis: (E, K, b, b), (E, K, b, r)."""
    from collocfem_tpu_torch.ops.thomas import batched_thomas_solve

    return batched_thomas_solve


def concat_chain_solver():
    """Chain solve of the concatenated SoA chain: the SPIKE chain kernel
    (:func:`ops.spike.blocktri_solve_spike_fused`) on a CUDA tensor, its
    plain version (cyclic reduction) on the CPU.  Signature
    ``solve(D, E, G) -> X`` in the SoA (b, b, K) / (b, r, K) convention."""
    from collocfem_tpu_torch.ops.spike import blocktri_solve_spike_fused

    return blocktri_solve_spike_fused


def _load_chain_kernel(problem, layout):
    """Build and load the layout's chain kernel at the problem's shape (b,
    r = 1 + nq) when the solver is made, not inside a CUDA-graph capture;
    raises ValueError for a shape outside the kernel's range."""
    from collocfem_tpu_torch.ops import _build, spike, thomas

    b, r = problem.mesh.degree * problem.nv, 1 + problem.model.nq
    _build.load(spike.chain_instance(b, r) if layout == "soa"
                else thomas.instance(b, r))


def batch_cost(problem, z: BatchDecision, data_batch, p_prior, p_w,
               dp_axis=None):
    """float64 total cost over the batch plus the shared parameter prior;
    with ``dp_axis``, over every rank's experiments.

    Per-experiment ``data_batch.p_w`` must be zero: the shared prior enters
    exactly once, here.  The device span ``assemble``.
    """
    with device_span("assemble", z.p.device):
        r = problem.residuals_batched(z.V, z.p, data_batch)
        return _finish_cost(cost64_from_residuals(problem, r, z.V, z.p,
                                                  data_batch),
                            z.p, p_prior, p_w, dp_axis)


def _finish_cost(local, p, p_prior, p_w, dp_axis):
    """The local batch's float64 cost -> the global cost plus the shared
    prior (added once, on every rank alike)."""
    local, = all_sum(dp_axis, local)
    return local + _prior_cost(p, p_prior, p_w)


def _prior_cost(p, p_prior, p_w):
    rp = (p_w * (p - p_prior)).double()
    return 0.5 * torch.sum(rp * rp)


def _dot64(a, b):
    return torch.dot(a.reshape(-1).double(), b.reshape(-1).double())


def _shared_schur_step(s_loc, r_loc, gp_sum, lam, p, p_prior, p_w):
    """Add the shared prior and the damping lam * smax to the summed Schur
    system and solve it.  Returns (dp, gp_tot, smax)."""
    nq = s_loc.shape[0]
    pw2 = p_w**2
    prior_g = pw2 * (p - p_prior)
    s_tot = s_loc + torch.diag(pw2)
    smax = torch.clamp(torch.diagonal(s_tot).max(),
                       min=torch.finfo(s_tot.dtype).tiny)
    s_tot = s_tot + (lam * smax) * torch.eye(nq, dtype=s_tot.dtype,
                                             device=s_tot.device)
    dp = -spd_solve(s_tot, (r_loc + prior_g)[:, None])[:, 0]
    return dp, gp_sum + prior_g, smax


def scale_concat_chain(sys, lam, n_exp: int):
    """Per-experiment damping and Jacobi scaling of the concatenated chain.

    Damping is dimensionless per EXPERIMENT: lam times the max diagonal of
    experiment e's blocks.  Returns the scaled chain and right-hand sides
    (Dsc, Esc (bd, bd, Kt), rhs = [gx | B] scaled (bd, 1 + nq, Kt)), the
    scales inv (bd, Kt) and dmax_e (n_exp,).
    """
    bd, _, kt = sys.D.shape
    k = kt // n_exp
    dtype = sys.D.dtype
    diag = torch.diagonal(sys.D, dim1=0, dim2=1).T               # (bd, Kt)
    dmax_e = torch.clamp(diag.reshape(bd, n_exp, k).amax(dim=(0, 2)),
                         min=torch.finfo(dtype).tiny)            # (n_exp,)
    lam_lane = (lam * dmax_e)[:, None].expand(n_exp, k).reshape(kt)
    eye = torch.eye(bd, dtype=dtype, device=sys.D.device)[:, :, None]
    inv = 1.0 / torch.sqrt(diag + lam_lane)
    Dsc = (sys.D + lam_lane * eye) * inv[:, None, :] * inv[None, :, :]
    inv_next = torch.cat([inv[:, 1:], torch.ones_like(inv[:, :1])], dim=-1)
    Esc = sys.E * inv[:, None, :] * inv_next[None, :, :]
    rhs = torch.cat([(sys.gx * inv)[:, None, :], sys.B * inv[:, None, :]],
                    dim=1)
    return Dsc, Esc, rhs, inv, dmax_e


def _reduced_aux(gnorm, gx, dx, dmax_e, dx2_e, dp, gp_tot, smax, dp_axis):
    """The LM accept quantities of a shared-parameter step from this rank's
    gradient norm and state step, maxed and summed over ``dp_axis``: the
    norm, g.s in float64, the damping quadratic form sum_e dmax_e
    ||dx_e||^2 + smax ||dp||^2 and ||s||."""
    gnorm, = all_max(dp_axis, gnorm)
    gdot, sds, sn2 = all_sum(dp_axis, _dot64(gx, dx), torch.dot(dmax_e, dx2_e),
                             dx2_e.sum())
    dp2 = torch.dot(dp, dp)
    return LMAux(gnorm=gnorm, gdot=(gdot + _dot64(gp_tot, dp)).to(dx.dtype),
                 sds=sds + smax * dp2, step_norm=torch.sqrt(sn2 + dp2))


def shared_gn_step_soa(problem, sys, lam, p, p_prior, p_w, *, n_exp: int,
                       chain_solve, dp_axis=None):
    """One damped shared-parameter GN step from the concatenated-chain SoA
    system (:func:`ops.assemble.assemble_gn_soa_batched`), config 5's hot
    path.  The chain solve (:func:`concat_chain_solver`) runs on the
    Jacobi-scaled chain; the damping quadratic form in ``aux.sds`` is that
    of the block-diagonal damping matrix, sum_e dmax_e ||dx_e||^2 +
    smax ||dp||^2.  ``dp_axis``: the process group the experiments are
    sharded over (None: one rank).  The damped chain solve is the device
    span ``kkt``, the shared-parameter Schur step ``shared``.

    Returns (dV (n_exp, M, nv), dp (nq,), aux: LMAux).
    """
    bd, _, kt = sys.D.shape
    k = kt // n_exp
    nv = problem.nv
    with device_span("kkt", p.device):
        Dsc, Esc, rhs, inv, dmax_e = scale_concat_chain(sys, lam, n_exp)
        x = chain_solve(Dsc, Esc, rhs)                       # (bd, 1+nq, Kt)
        # Unscale: A_d^-1 = S X~ S for the state-side Jacobi scaling S.
        a_g = x[:, 0, :] * inv
        a_b = x[:, 1:, :] * inv[:, None, :]
    with device_span("shared", p.device):
        s_loc, r_loc, gp_sum = all_sum(
            dp_axis, sys.C - torch.einsum("bqk,brk->qr", sys.B, a_b),
            sys.gp - torch.einsum("bqk,bk->q", sys.B, a_g), sys.gp)
        dp, gp_tot, smax = _shared_schur_step(s_loc, r_loc, gp_sum, lam, p,
                                              p_prior, p_w)
    dx = -(a_g + torch.einsum("bqk,q->bk", a_b, dp))        # (bd, Kt)
    dV = (dx.reshape(bd, n_exp, k).permute(1, 2, 0)
          .reshape(n_exp, k * (bd // nv), nv)[:, :problem.num_nodes])
    dx2_e = torch.sum(dx.reshape(bd, n_exp, k) ** 2, dim=(0, 2))
    return dV, dp, _reduced_aux(grad_inf_norm(sys.gx, gp_tot), sys.gx, dx,
                                dmax_e, dx2_e, dp, gp_tot, smax, dp_axis)


def damp_blocks(D, lam):
    """Per-experiment dimensionless damping of block-major chains
    D (E, K, b, b): D + lam * dmax_e * I.  Returns (D_damped, dmax_e)."""
    dmax = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1).amax(dim=(1, 2)),
                       min=torch.finfo(D.dtype).tiny)        # (n_exp,)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return D + (lam * dmax)[:, None, None, None] * eye, dmax


def shared_gn_step(problem, z: BatchDecision, data_batch, lam, p_prior,
                   p_w, *, chain_solver=None, dp_axis=None):
    """One damped shared-parameter GN step in the block-major layout.

    Assembles every experiment at ``z`` (:func:`ops.assemble.
    assemble_gn_batched`), damps each by lam * its own max diagonal (no
    Jacobi scaling), and solves every chain with ``chain_solver``:
    ``solve(D, E, G) -> X`` on the whole (E, K, b, ·) batch (default
    :func:`batched_chain_solver`; ``parallel.spike.spike_chain_solver``
    shards every chain over "sp").
    ``dp_axis``: the process group the experiments are sharded over.  The
    device spans ``assemble``, ``kkt`` (the damped chain solves) and
    ``shared`` (the shared-parameter Schur step).

    Returns (dV (n_exp, M, nv), dp (nq,), gnorm, aux: LMAux).
    """
    chain_solver = chain_solver or batched_chain_solver()
    device = z.p.device
    with device_span("assemble", device):
        sys_b = assemble_gn_batched(problem, z.V, z.p, data_batch)
    with device_span("kkt", device):
        d_damped, dmax = damp_blocks(sys_b.D, lam)
        rhs = torch.cat([sys_b.gx[..., None], sys_b.B], dim=-1)
        x = chain_solver(d_damped, sys_b.E, rhs)            # (E, K, bd, 1+nq)
        a_g, a_b = x[..., 0], x[..., 1:]
    with device_span("shared", device):
        s_loc, r_loc, gp_sum = all_sum(
            dp_axis,
            sys_b.C.sum(0) - torch.einsum("ekbq,ekbr->qr", sys_b.B, a_b),
            sys_b.gp.sum(0) - torch.einsum("ekbq,ekb->q", sys_b.B, a_g),
            sys_b.gp.sum(0))
        dp, gp_tot, smax = _shared_schur_step(s_loc, r_loc, gp_sum, lam,
                                              z.p, p_prior, p_w)
    dx = -(a_g + torch.einsum("ekbq,q->ekb", a_b, dp))
    dV = blocks_to_nodes(dx, problem.num_nodes, problem.nv)
    aux = _reduced_aux(grad_inf_norm(sys_b.gx, sys_b.gp), sys_b.gx, dx, dmax,
                       torch.sum(dx * dx, dim=(1, 2)), dp, gp_tot, smax,
                       dp_axis)
    return dV, dp, aux.gnorm, aux


def make_multi_experiment_solver(problem, options: SolverOptions =
                                 SolverOptions(), *, dp_axis=None,
                                 chain_solver=None, layout: str = "auto"):
    """Shared-parameter LM solver over a batch of experiments.

    Returns ``solve(z0: BatchDecision, data_batch, p_prior, p_w) ->
    (BatchDecision, SolveStats)``.  ``data_batch`` is a ProblemData with a
    leading experiment axis on every leaf and ``p_w == 0`` (the shared
    prior is passed explicitly).  Counterpart of the JAX package's
    ``jax.jit(solve)``: on a CUDA device a call replays CUDA graphs of the
    assembly at z0 and of one LM iteration (:mod:`solve.graph`); on the CPU
    it runs the eager loop, which ``solve.eager`` runs on any device with
    the same result bit for bit.

    ``dp_axis``: a process group (``parallel.meshes.DeviceMesh.dp_group``)
    the experiments are sharded over, the counterpart of the JAX package's
    call inside ``shard_map``: each rank passes its own experiments (z0.V
    and data_batch) and the shared p, prior and options alike, and gets its
    experiments' V and the shared p.  On a CUDA device the graphs hold the
    group's all-reduces, and with a tolerance the loop graph reads nothing
    to the host, as in ``parallel.sharded``; a call, ``solve.eager`` and
    ``solve.stepwise`` end with ``parallel.peer.check`` of ``dp_axis`` and
    of ``chain_solver.groups`` where it has them.  If the group's
    ranks cannot map each other's memory a call raises ValueError
    (``parallel.meshes.capture_refusal``).

    ``layout``: ``"soa"`` (concatenated chain, SPIKE chain kernel) or
    ``"blocks"`` (block-major, batched Thomas kernel, or ``chain_solver``:
    see :func:`shared_gn_step`); ``"auto"`` is ``"blocks"`` when a
    ``chain_solver`` is given, ``"soa"`` otherwise.  On the CPU each
    kernel's wrapper runs its plain version.  ``options.method`` and
    ``options.kkt_refine`` do not apply.
    """
    if dp_axis is not None and not isinstance(dp_axis, dist.ProcessGroup):
        raise TypeError(f"dp_axis must be a torch.distributed process group "
                        f"(parallel.meshes.DeviceMesh.dp_group), not "
                        f"{dp_axis!r}")
    if layout == "auto":
        layout = "blocks" if chain_solver is not None else "soa"
    if layout not in ("soa", "blocks"):
        raise ValueError(f"unknown layout {layout!r}")
    if torch.device(problem.device).type == "cuda" and (
            layout == "soa" or chain_solver is None):
        _load_chain_kernel(problem, layout)

    if layout == "soa":
        chain_solve = concat_chain_solver()

        def initial(z, data_batch, p_prior, p_w):
            with device_span("assemble", z.p.device):
                sys, ct = assemble_gn_soa_batched(problem, z.V, z.p,
                                                  data_batch, with_cost=True)
                return sys, _finish_cost(ct, z.p, p_prior, p_w, dp_axis)

        def trial(z0, data_batch, p_prior, p_w):
            n_exp = z0.V.shape[0]

            def trial_fn(z, sys, lam):
                dV, dp, aux = shared_gn_step_soa(
                    problem, sys, lam, z.p, p_prior, p_w, n_exp=n_exp,
                    chain_solve=chain_solve, dp_axis=dp_axis)
                z_try = BatchDecision(V=z.V + dV, p=z.p + dp)
                sys_try, ct = initial(z_try, data_batch, p_prior, p_w)
                return z_try, sys_try, ct, aux
            return trial_fn
    else:
        def initial(z, data_batch, p_prior, p_w):
            return (), batch_cost(problem, z, data_batch, p_prior, p_w,
                                  dp_axis)

        def trial(z0, data_batch, p_prior, p_w):
            def trial_fn(z, carry, lam):
                dV, dp, _, aux = shared_gn_step(
                    problem, z, data_batch, lam, p_prior, p_w,
                    chain_solver=chain_solver, dp_axis=dp_axis)
                z_try = BatchDecision(V=z.V + dV, p=z.p + dp)
                ct = batch_cost(problem, z_try, data_batch, p_prior, p_w,
                                dp_axis)
                return z_try, carry, ct, aux
            return trial_fn

    captured = captured_lm_solve(
        initial, trial, options,
        refused=capture_refusal(dp_axis, problem.device))
    if dp_axis is None:
        return captured
    groups = (dp_axis, *getattr(chain_solver, "groups", ()))

    def checked(run):
        """``run`` (the captured solve or one of its forms), then
        ``parallel.peer.check`` of the solver's groups."""
        def solve(*args):
            out = run(*args)
            peer.check(*groups)
            return out
        return solve

    solve = checked(captured)
    solve.eager = checked(captured.eager)
    solve.stepwise = checked(captured.stepwise)
    solve.refused = captured.refused
    return solve
