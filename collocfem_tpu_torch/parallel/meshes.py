"""The (dp, sp) rank grid and the collectives every sharded solve uses.

Counterpart of ``collocfem_tpu/parallel/meshes.py``.  Two axes:

  * "dp": data parallel over independent experiments (config 5).  The only
    traffic is the tiny shared-parameter Schur complement and the LM
    loop's scalars.
  * "sp": the collocation element chain, cut into contiguous shards
    (``parallel.sharded``, ``parallel.spike``): halo blocks and the SPIKE
    interface system every solve.

The grid lives on an initialised ``torch.distributed`` world: rank =
dp_index * sp + sp_index, so consecutive ranks hold consecutive chain
shards.  Every cross-rank operation is an ``all_reduce`` (a sum, or a max
for the JAX package's ``pmax``): a halo ``ppermute`` or an ``all_gather`` is
an ``all_reduce`` of a buffer each rank fills in its own slot, which adds
only zeros, so every rank gets the same bits.  One code path then serves
gloo on CPU tensors, gloo on CUDA tensors (several ranks sharing one card,
which NCCL refuses) and NCCL with one rank per card.  Every sum runs in
float64, which takes the place of the JAX package's double-word
``psum_dw``.

Every collective here can be captured in a CUDA graph on an NCCL group: it
allocates its buffers on the current stream (inside a capture, from the
graph's pool), reads nothing to the host and takes its ranks and sizes from
the group on the host.  The sharded solvers capture them where the JAX
package jits ``shard_map``; when the solver is made, :func:`capture_refusal`
decides by the group's backend whether it can.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DP_AXIS = "dp"
SP_AXIS = "sp"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """This rank's place in the (dp, sp) grid: the sizes, its coordinates,
    the process groups of its dp column and sp row, and its device."""

    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    dp_group: object
    sp_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, SP_AXIS: self.sp}


def make_device_mesh(dp: int = 1, sp: int = 1, device=None) -> DeviceMesh:
    """Build the (dp, sp) grid over the initialised world of dp * sp ranks.

    ``sp`` is the minor axis: rank r sits at (r // sp, r % sp).  Every rank
    must call this with the same sizes (``dist.new_group`` is collective).
    ``device`` is where this rank computes: by default the current CUDA
    device; pass ``"cpu"`` for CPU tensors (gloo).
    """
    world = dist.get_world_size()
    if dp * sp != world:
        raise ValueError(f"mesh dp={dp} x sp={sp} needs {dp * sp} ranks, the "
                         f"world has {world}")
    rank = dist.get_rank()
    rows = [dist.new_group([i * sp + j for j in range(sp)]) for i in range(dp)]
    cols = [dist.new_group([i * sp + j for i in range(dp)]) for j in range(sp)]
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return DeviceMesh(dp=dp, sp=sp, dp_rank=rank // sp, sp_rank=rank % sp,
                      dp_group=cols[rank % sp], sp_group=rows[rank // sp],
                      device=torch.device(device))


def capture_refusal(group, device):
    """Why a solve whose collectives run over ``group`` cannot replay CUDA
    graphs on ``device``, or None where nothing stands in the way: no group,
    a device that is not CUDA (the solve runs eagerly there), or an NCCL
    group, whose collectives a graph captures.  A gloo group on a CUDA
    device (ranks sharing one card) reduces through the host, which no
    graph can hold; such a solver runs only its ``.eager``."""
    if group is None or torch.device(device).type != "cuda":
        return None
    backend = str(dist.get_backend(group))
    if backend == "nccl" or "cuda:nccl" in backend:
        return None
    return (f"the collectives of a {backend!r} group cannot be captured in a "
            "CUDA graph: call the solver's .eager on a CUDA device, or run "
            "one NCCL rank per card")


def _reduce(op, group, xs):
    """All-reduce the tensors ``xs`` over ``group`` in one float64 buffer;
    each comes back in its own dtype and shape."""
    if group is None:
        return xs
    buf = torch.cat([x.reshape(-1).double() for x in xs])
    dist.all_reduce(buf, op=op, group=group)
    out, at = [], 0
    for x in xs:
        out.append(buf[at:at + x.numel()].reshape(x.shape).to(x.dtype))
        at += x.numel()
    return out


def all_sum(group, *xs):
    """The sums of ``xs`` over ``group`` (a list, one per input; the inputs
    themselves when ``group`` is None), accumulated in float64."""
    return _reduce(dist.ReduceOp.SUM, group, xs)


def all_max(group, *xs):
    """The elementwise maxima of ``xs`` over ``group``, as :func:`all_sum`."""
    return _reduce(dist.ReduceOp.MAX, group, xs)


def gather(x, group):
    """(P, *x.shape): every rank's ``x`` in rank order, on every rank."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = x.new_zeros((size, *x.shape))
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    return buf


def from_right(x, group):
    """The right neighbour's ``x`` (zeros on the last rank of ``group``)."""
    buf, rank = gather(x, group), dist.get_rank(group)
    return buf[rank + 1] if rank + 1 < buf.shape[0] else torch.zeros_like(x)


def from_left(x, group):
    """The left neighbour's ``x`` (zeros on the first rank of ``group``)."""
    buf, rank = gather(x, group), dist.get_rank(group)
    return buf[rank - 1] if rank > 0 else torch.zeros_like(x)
