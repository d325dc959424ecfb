"""Port parity, problem and assembly: the residual vector, the cost and every
leaf of ``assemble_gn_soa`` of ``collocfem_tpu_torch`` against
``collocfem_tpu`` on the same seeded Van der Pol problem and iterate, in
float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.assemble import assemble_gn_soa as jax_assemble
from collocfem_tpu.ops.assemble import blocks_to_nodes_soa as jax_to_nodes
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import Decision as JaxDecision
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu_torch.convert import data_from_numpy, decision_from_numpy
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.assemble import assemble_gn_soa, blocks_to_nodes_soa
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem

F64 = torch.float64
RTOL = 1e-12  # float64; the two packages order their sums differently


def _close(got, want):
    """rtol 1e-12, with an absolute floor of 1e-12 x the leaf's magnitude
    for entries that cancel to (nearly) zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _problem_pair(n):
    """The same VdP estimation problem, data and a seeded iterate, built by
    both packages (priors on p and x0 switched on to cover their paths)."""
    rng = np.random.default_rng(n)
    tf, d = 6.0, 4
    t_meas = np.sort(rng.uniform(0.0, tf, 3 * n))
    y = np.sin(t_meas)[:, None] + 0.01 * rng.standard_normal((3 * n, 1))
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, n, d),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, n, d),
                                    t_meas, defect_weight=30.0, device="cpu",
                                    dtype=F64)
    u_nodes = np.cos(0.7 * jprob.mesh.elem_times)[..., None]
    kw = dict(u_nodes=u_nodes, meas_weight=2.0, p_prior=[1.0, 0.8],
              p_weight=0.1, x0_prior=[0.1, 0.9], x0_weight=[0.5, 0.25])
    jdata = jprob.pack_data(y, t_meas, **kw)
    tdata = tprob.pack_data(y, t_meas, **kw)
    V = rng.standard_normal((jprob.num_nodes, 2))
    p = rng.uniform(0.5, 1.5, 2)
    jz = JaxDecision(V=jnp.asarray(V), p=jnp.asarray(p))
    tz = decision_from_numpy(V, p, "cpu", F64)
    return jprob, jz, jdata, tprob, tz, tdata


@pytest.mark.parametrize("n", [40, 101])
def test_residual_vector_and_cost_match(n):
    jprob, jz, jdata, tprob, tz, tdata = _problem_pair(n)
    _close(tprob.residual_vector(tz, tdata),
           jprob.residual_vector(jz, jdata))
    cost = tprob.cost(tz, tdata)
    assert cost.dtype == F64
    _close(cost, jprob.cost(jz, jdata))
    # data_from_numpy carries the JAX package's data over unchanged.
    carried = data_from_numpy(*map(np.asarray, jdata), device="cpu",
                              dtype=F64)
    for a, b in zip(carried, tdata):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n", [40, 101])
def test_assemble_gn_soa_leaves_match(n):
    jprob, jz, jdata, tprob, tz, tdata = _problem_pair(n)
    jsys, jcost = jax_assemble(jprob, jz, jdata, with_cost=True)
    tsys, tcost = assemble_gn_soa(tprob, tz, tdata, with_cost=True)
    for name in ("D", "E", "B", "C", "gx", "gp"):
        got, want = getattr(tsys, name), getattr(jsys, name)
        assert tuple(got.shape) == want.shape, name
        _close(got, want)
    _close(tcost, float(jcost.hi) + float(jcost.lo))
    np.testing.assert_array_equal(
        blocks_to_nodes_soa(tsys.gx, tprob.num_nodes, tprob.nv).numpy(),
        np.asarray(jax_to_nodes(jnp.asarray(tsys.gx.numpy()),
                                jprob.num_nodes, jprob.nv)))


def test_problem_tables_are_buffers():
    """EstimationProblem is an nn.Module: .to() moves and casts its tables."""
    tprob = _problem_pair(40)[3]
    names = {n for n, _ in tprob.named_buffers()}
    assert names == {"diff", "widths", "elem_times", "dscale", "mrows",
                     "mmask", "mtimes"}
    tprob.to(torch.float32)
    assert tprob.dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in tprob.buffers())
