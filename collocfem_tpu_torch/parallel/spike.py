"""Element-chain sharded block-tridiagonal solve: SPIKE over the "sp" ranks.

Counterpart of ``collocfem_tpu/parallel/spike.py``.  The chain is cut into
contiguous shards, one per rank of the sp group.  Each rank eliminates its
interior blocks with a local chain solve, the shards' boundary blocks form
a small SPD block-tridiagonal interface system (two blocks per shard) that
every rank gathers and solves redundantly, and the interiors come back by
local back-substitution.  Communication per solve: one all-reduce of the
(P, 2, b, 2b + r) interface blocks.  Every Schur complement of an SPD
matrix is SPD, so nothing pivots.

Block-major layout, optional leading batch axes (...): D, E (..., m, b, b),
G (..., m, b, r), with A[k, k+1] = E[k].  The chain solves run on
:func:`chain_solve_blocks`: kernel #2 (``ops.spike.blocktri_solve_spike_fused``)
on a CUDA tensor, every chain of the batch concatenated into one call;
``solve.blocktri.blocktri_solve_scan`` on a CPU tensor, what the JAX
package's default computes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from collocfem_tpu_torch.parallel.meshes import gather
from collocfem_tpu_torch.solve.blocktri import blocktri_solve_scan


def chain_solve_blocks(D, E, G):
    """Solve every SPD chain of a block-major batch: D, E (..., K, b, b)
    with E[..., K-1, :, :] ignored, G (..., K, b, r) -> X (..., K, b, r).

    On a CUDA tensor the chains are laid end to end in SoA layout, coupled
    by zero blocks, and solved by one call of kernel #2; on a CPU tensor
    each chain goes through ``blocktri_solve_scan``.
    """
    if D.device.type == "cpu":
        flat = lambda a: a.reshape(-1, *a.shape[-3:])
        return torch.stack([blocktri_solve_scan(d, e, g) for d, e, g in
                            zip(flat(D), flat(E), flat(G))]).reshape(G.shape)
    from collocfem_tpu_torch.ops.spike import blocktri_solve_spike_fused

    b, r = D.shape[-1], G.shape[-1]
    E = torch.cat([E[..., :-1, :, :], torch.zeros_like(E[..., -1:, :, :])],
                  dim=-3)
    soa = lambda a: a.reshape(-1, b, a.shape[-1]).permute(1, 2, 0).contiguous()
    X = blocktri_solve_spike_fused(soa(D), soa(E), soa(G))
    return X.permute(2, 0, 1).reshape(G.shape)


def blocktri_solve_spike(D, E, G, *, group, local_solver=None):
    """Distributed SPD block-tridiagonal solve over the ranks of ``group``.

    Args:
      D: (..., m, b, b) this rank's diagonal blocks (its contiguous slice of
         the global K-block chain; m = K / P >= 2).
      E: (..., m, b, b) superdiagonal; E[m-1] couples this shard's last
         block to the NEXT shard's first block (zero on the last shard).
      G: (..., m, b, r) right-hand sides.
      group: the sp process group the chain is sharded over.
      local_solver: ``solve(D, E, G)`` for the interior chains (default
         :func:`chain_solve_blocks`); the interface system always runs on
         :func:`chain_solve_blocks`.
    Returns:
      (..., m, b, r): this rank's slice of the global solution.
    """
    local_solver = local_solver or chain_solve_blocks
    m, b, r = D.shape[-3], D.shape[-1], G.shape[-1]
    if m < 2:
        raise ValueError("SPIKE needs >= 2 blocks per shard")
    at = lambda a, k: a[..., k, :, :]
    if m == 2:
        s_ll, s_rr, s_lr = at(D, 0), at(D, 1), at(E, 0)
        gh_l, gh_r = at(G, 0), at(G, 1)
    else:
        # The interior (local blocks 1..m-2) against [G | U | V]: its part
        # of g and its couplings to the two boundary blocks.
        u_cols = torch.zeros_like(D[..., 1:-1, :, :])
        v_cols = torch.zeros_like(u_cols)
        u_cols[..., 0, :, :] = at(E, 0).mT
        v_cols[..., -1, :, :] = at(E, m - 2)
        w = local_solver(D[..., 1:-1, :, :], E[..., 1:-1, :, :],
                         torch.cat([G[..., 1:-1, :, :], u_cols, v_cols], -1))
        w_g, w_u, w_v = w[..., :r], w[..., r:r + b], w[..., r + b:]
        # Boundary Schur blocks: S = A_bb - A_bI A_II^-1 A_Ib.
        e0, e_last = at(E, 0), at(E, m - 2).mT
        s_ll = at(D, 0) - e0 @ at(w_u, 0)
        s_lr = -(e0 @ at(w_v, 0))
        s_rr = at(D, m - 1) - e_last @ at(w_v, -1)
        gh_l = at(G, 0) - e0 @ at(w_g, 0)
        gh_r = at(G, m - 1) - e_last @ at(w_g, -1)

    # The interface system: two blocks a shard, chained across shards by
    # E[m-1], gathered in rank order and solved on every rank.
    red = torch.stack([torch.cat([s_ll, s_lr, gh_l], -1),
                       torch.cat([s_rr, at(E, m - 1), gh_r], -1)], dim=-3)
    every = gather(red, group).movedim(0, -4)          # (..., P, 2, b, .)
    every = every.reshape(*every.shape[:-4], -1, b, every.shape[-1])
    x_all = chain_solve_blocks(every[..., :b], every[..., b:2 * b],
                               every[..., 2 * b:])
    s = dist.get_rank(group)
    x_l, x_r = at(x_all, 2 * s), at(x_all, 2 * s + 1)
    if m == 2:
        return torch.stack([x_l, x_r], dim=-3)
    # Local back-substitution: x_I = W_g - W_U x_l - W_V x_r.
    x_int = w_g - w_u @ x_l[..., None, :, :] - w_v @ x_r[..., None, :, :]
    return torch.cat([x_l[..., None, :, :], x_int, x_r[..., None, :, :]],
                     dim=-3)


def spike_chain_solver(num_blocks: int, sp_size: int, *, group):
    """Chain solver over the sp ranks of ``group`` for global chains that
    every rank holds: ``solve(D, E, G)`` on (..., K, b, b) / (..., K, b, r);
    each rank eliminates its contiguous m = K / sp blocks by SPIKE and the
    result is gathered, so every rank returns the full (..., K, b, r).

    It takes the leading experiment axis of ``parallel.batch.
    make_multi_experiment_solver``'s block layout at once (one kernel #2
    call for the experiments' interiors, one for their interface systems),
    which composes dp x sp.  K must be divisible by ``sp_size`` with >= 2
    blocks a shard.  ``solve.groups``: ``(group,)``, the groups whose
    collectives a solver using it checks after a solve
    (``parallel.peer.check``).
    """
    if dist.get_world_size(group) != sp_size:
        raise ValueError(f"the group has {dist.get_world_size(group)} ranks, "
                         f"not sp={sp_size}")
    if num_blocks % sp_size:
        raise ValueError(f"K={num_blocks} not divisible by sp={sp_size}")
    m = num_blocks // sp_size
    if m < 2:
        raise ValueError("need >= 2 blocks per sp shard")

    def solve(D, E, G):
        j = dist.get_rank(group)
        part = lambda a: a[..., j * m:(j + 1) * m, :, :]
        X = blocktri_solve_spike(part(D), part(E), part(G), group=group)
        # (P, ..., m, b, r) -> (..., K, b, r)
        return gather(X, group).movedim(0, -4).reshape(G.shape)

    solve.groups = (group,)
    return solve


def spike_sharded_solver(dev_mesh):
    """``solve(D, E, G) -> X`` on global (K, b, b) / (K, b, r) chains, the
    chain sharded over ``dev_mesh``'s sp ranks (K divisible by sp)."""

    def solve(D, E, G):
        return spike_chain_solver(D.shape[-3], dev_mesh.sp,
                                  group=dev_mesh.sp_group)(D, E, G)

    return solve
