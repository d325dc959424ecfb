"""Port parity, problem and assembly: the residual vector, the cost and every
leaf of ``assemble_gn_soa`` of ``collocfem_tpu_torch`` against
``collocfem_tpu`` on the same seeded Van der Pol problem and iterate, in
float64.  Also the JAX package's assembly stored for the card
(``tests/data/gn_assembly_jax.npz``, which ``tests/test_torch_cuda.py``
holds the GN element kernel against, with no JAX on the card): the file
against the JAX package now, and the kernel's plain version against the
file.  Rewrite the file from the root of the repo with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_assemble.py``."""

import sys
from pathlib import Path

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
from collocfem_tpu_torch.headline import TF, build_headline_problem
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops import gn_elements
from collocfem_tpu_torch.ops.assemble import assemble_gn_soa, blocks_to_nodes_soa
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.testing import (GN_REFERENCE_LEAVES,
                                         stored_assembly_case)

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


# ---- the JAX package's assembly, stored for the card ------------------------

GN_REFERENCE = Path(__file__).parent / "data" / "gn_assembly_jax.npz"
GN_CASES = ("headline", "full_per_sample")


def _gn_reference_inputs(case):
    """The inputs of a stored case: 'headline' is bench.py's headline at N =
    40 (defect weight 100, a shared meas_w) with priors on p and per-state
    ones on x(t0), at a seeded iterate; 'full_per_sample' the 'full' defect
    rule on 120 random samples, a per-sample meas_w (IRLS's form) and a full
    x(t0) sqrt-information matrix."""
    rng = np.random.default_rng(25 + len(case))
    n, d = 40, 4
    priors = dict(p_prior=np.array([1.0, 0.8]), p_w=np.array([0.1, 0.2]),
                  x0_prior=np.array([0.1, 0.9]))
    if case == "headline":
        _, t_meas, y, u_nodes = build_headline_problem(n, d)
        a = dict(tf=TF, defect_weight=100.0, full=0, t_meas=t_meas, y=y,
                 u_nodes=u_nodes, meas_w=np.ones(1),
                 x0_w=np.array([0.5, 0.25]), **priors)
    else:
        tf = 6.0
        t_meas = np.sort(rng.uniform(0.0, tf, 3 * n))
        y = np.sin(t_meas)[:, None] + 0.01 * rng.standard_normal((3 * n, 1))
        mesh = jax_uniform_mesh(0.0, tf, n, d)
        a = dict(tf=tf, defect_weight=30.0, full=1, t_meas=t_meas, y=y,
                 u_nodes=np.cos(0.7 * mesh.elem_times)[..., None],
                 x0_w=np.array([[0.5, 0.0], [0.2, 0.3]]), **priors)
    a.update(elements=n, degree=d)
    jprob = _jax_problem(a)
    if case != "headline":
        a["meas_w"] = rng.uniform(0.5, 2.0, tuple(jprob.mmask.shape) + (1,))
    a["V"] = 1.0 + rng.standard_normal((jprob.num_nodes, 2))
    a["p"] = rng.uniform(0.5, 1.5, 2)
    return a


def _jax_problem(a):
    return JaxProblem.build(
        JaxVanDerPol(), jax_uniform_mesh(0.0, float(a["tf"]),
                                         int(a["elements"]),
                                         int(a["degree"])),
        np.asarray(a["t_meas"]), defect_weight=float(a["defect_weight"]),
        defect_rule="full" if int(a["full"]) else "interior")


def _jax_assembly(a):
    """The JAX package's float64 assembly of a case's inputs: {leaf:
    array}."""
    jprob = _jax_problem(a)
    jdata = jprob.pack_data(
        np.asarray(a["y"]), np.asarray(a["t_meas"]),
        u_nodes=np.asarray(a["u_nodes"]), p_prior=np.asarray(a["p_prior"]),
        p_weight=np.asarray(a["p_w"]), x0_prior=np.asarray(a["x0_prior"]),
        x0_weight=np.asarray(a["x0_w"]))
    jdata = jdata._replace(meas_w=jnp.asarray(a["meas_w"]))
    jz = JaxDecision(V=jnp.asarray(a["V"]), p=jnp.asarray(a["p"]))
    jsys, jcost = jax_assemble(jprob, jz, jdata, with_cost=True)
    out = {name: np.asarray(getattr(jsys, name))
           for name in GN_REFERENCE_LEAVES if name != "cost"}
    out["cost"] = np.asarray(float(jcost.hi) + float(jcost.lo))
    return out


def write_gn_reference(path=GN_REFERENCE):
    """Write every case's inputs and the JAX package's assembly of them."""
    arrays = {}
    for case in GN_CASES:
        a = _gn_reference_inputs(case)
        a.update(_jax_assembly(a))
        arrays.update({f"{case}.{k}": np.asarray(v) for k, v in a.items()})
    path.parent.mkdir(exist_ok=True)
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("case", GN_CASES)
def test_stored_jax_assembly_is_the_jax_packages(case):
    """The stored inputs are the case's, and the stored assembly is what the
    JAX package gives on them now (rtol 1e-12)."""
    with np.load(GN_REFERENCE) as ref:
        stored = {k.split(".", 1)[1]: ref[k] for k in ref.files
                  if k.startswith(case + ".")}
    a = _gn_reference_inputs(case)
    for k, v in a.items():
        np.testing.assert_array_equal(stored[k], np.asarray(v), err_msg=k)
    for name, want in _jax_assembly(a).items():
        _close(torch.as_tensor(stored[name]), want)


@pytest.mark.parametrize("case", GN_CASES)
def test_kernel_plain_version_matches_stored_jax_assembly(case):
    """The GN element kernel's plain version (node values, then each
    element's Jacobian from the structure of elem_residual) on the CPU
    against the JAX package's stored assembly: every leaf and the cost
    within rtol 1e-12; the card holds the kernel to the same file."""
    with np.load(GN_REFERENCE) as ref:
        (prob, z, data), want = stored_assembly_case(ref, case, dtype=F64,
                                                     device="cpu")
    assert gn_elements.in_range(prob, data)
    sys_, cost = gn_elements.gn_system_ref(
        prob, z, data, gn_elements.node_values(prob, z, data))
    for name in GN_REFERENCE_LEAVES[:-1]:
        _close(getattr(sys_, name), want[name])
    _close(cost, want["cost"])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    sys.exit(write_gn_reference())
