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
shards.  Every cross-rank operation is one call of the peer all-reduce
(:mod:`parallel.peer`) on one float64 vector: a sum, a max (the JAX
package's ``pmax``) or a gather in rank order, whose rows a halo
``ppermute`` or an ``all_gather`` reads; every rank gets the same bits.
On a CUDA tensor that is a hand-written kernel over the ranks' peer-mapped
buffers, which serves ranks sharing one card and one rank a card alike; on
a CPU tensor its plain version over ``torch.distributed`` (gloo).  Every
sum runs in float64 in rank order, which takes the place of the JAX
package's double-word ``psum_dw``.

Every collective here can be captured in a CUDA graph, under a WHILE
conditional node too: it allocates its buffers on the current stream
(inside a capture, from the graph's pool), reads nothing to the host and
takes its ranks and sizes from the group on the host.  The sharded solvers
capture them where the JAX package jits ``shard_map``.  A group's peer
buffers are set up when a CUDA mesh or a sharded solver is made;
:func:`capture_refusal` says whether they could be.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from collocfem_tpu_torch.parallel import peer

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
    device; pass ``"cpu"`` for CPU tensors (gloo).  On a CUDA device the
    peer buffers of this rank's sp row and dp column are set up here
    (:func:`parallel.peer.setup`; a group that cannot be is refused by the
    solvers made on it).
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
    mesh = DeviceMesh(dp=dp, sp=sp, dp_rank=rank // sp, sp_rank=rank % sp,
                      dp_group=cols[rank % sp], sp_group=rows[rank // sp],
                      device=torch.device(device))
    if mesh.device.type == "cuda":
        for group in (mesh.sp_group, mesh.dp_group):   # rows, then columns
            peer.setup(group, mesh.device)
    return mesh


def capture_refusal(group, device):
    """Why a solve whose collectives run over ``group`` cannot replay CUDA
    graphs on ``device``, or None where nothing stands in the way: no group,
    a device that is not CUDA (the solve runs eagerly there), or a group
    whose ranks map each other's memory, whatever its backend: ranks
    sharing one card, or one rank a card of one host.  Sets the group up
    (:func:`parallel.peer.setup`, collective over the group).  A group
    that cannot be mapped (ranks of several hosts, a process without a
    card) is refused with the reason; its collectives cannot run on a card
    at all, eagerly or captured."""
    if group is None or torch.device(device).type != "cuda":
        return None
    return peer.setup(group, device)


def _reduce(op, group, xs):
    """All-reduce the tensors ``xs`` over ``group`` in one float64 vector;
    each comes back in its own dtype and shape."""
    if group is None:
        return xs
    buf = peer.peer_reduce(torch.cat([x.reshape(-1).double() for x in xs]),
                           group, op)
    out, at = [], 0
    for x in xs:
        out.append(buf[at:at + x.numel()].reshape(x.shape).to(x.dtype))
        at += x.numel()
    return out


def all_sum(group, *xs):
    """The sums of ``xs`` over ``group`` (a list, one per input; the inputs
    themselves when ``group`` is None), accumulated in float64 in rank
    order."""
    return _reduce(peer.SUM, group, xs)


def all_max(group, *xs):
    """The elementwise maxima of ``xs`` over ``group``, as :func:`all_sum`."""
    return _reduce(peer.MAX, group, xs)


def gather(x, group):
    """(P, *x.shape): every rank's ``x`` in rank order, on every rank."""
    buf = peer.peer_reduce(x.reshape(-1).double(), group, peer.GATHER)
    return buf.reshape(-1, *x.shape).to(x.dtype)


def from_right(x, group):
    """The right neighbour's ``x`` (zeros on the last rank of ``group``)."""
    buf, rank = gather(x, group), dist.get_rank(group)
    return buf[rank + 1] if rank + 1 < buf.shape[0] else torch.zeros_like(x)


def from_left(x, group):
    """The left neighbour's ``x`` (zeros on the first rank of ``group``)."""
    buf, rank = gather(x, group), dist.get_rank(group)
    return buf[rank - 1] if rank > 0 else torch.zeros_like(x)
