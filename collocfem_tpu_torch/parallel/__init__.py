"""Parallelism layer: the counterparts of ``collocfem_tpu.parallel``.

  * :mod:`parallel.meshes`: the (dp, sp) rank grid over ``torch.distributed``
    and its all-reduce collectives;
  * :mod:`parallel.spike`: element-chain sharding of the block-tridiagonal
    solve (SPIKE, interface system exchanged between the sp ranks);
  * :mod:`parallel.sharded`: the sp-sharded Gauss-Newton solver;
  * :mod:`parallel.batch`: multi-experiment estimation with shared
    parameters, on one rank or sharded over "dp".
"""

from collocfem_tpu_torch.parallel.meshes import make_device_mesh
from collocfem_tpu_torch.parallel.sharded import make_sp_gn_solver
from collocfem_tpu_torch.parallel.spike import (
    blocktri_solve_spike,
    spike_chain_solver,
    spike_sharded_solver,
)

__all__ = [
    "make_device_mesh",
    "blocktri_solve_spike",
    "spike_chain_solver",
    "spike_sharded_solver",
    "make_sp_gn_solver",
]
