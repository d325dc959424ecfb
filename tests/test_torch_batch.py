"""Port parity, config 5: the batched assemblies, the shared-parameter steps,
the kernel #2 wrapper's plain path and ``make_multi_experiment_solver`` of
``collocfem_tpu_torch`` against ``collocfem_tpu`` on the same seeded batch,
in float64.  Degree 2 and a few experiments keep the JAX compiles short; the
CUDA kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from baseline_cpu.configs_baseline import make_config5_data as jax_config5_data
from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops import smallblocks as jax_sb
from collocfem_tpu.ops.assemble import assemble_gn as jax_assemble_gn
from collocfem_tpu.ops.assemble import blocks_to_nodes as jax_blocks_to_nodes
from collocfem_tpu.ops.assemble import (
    assemble_gn_soa_batched as jax_assemble_soa_batched,
)
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.ops.spike_pallas import (
    blocktri_solve_spike_fused as jax_spike_chain,
)
from collocfem_tpu.parallel import batch as jax_batch
from collocfem_tpu.problem import Decision as JaxDecision
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve.blocktri import blocktri_solve_scan as jax_scan
from collocfem_tpu_torch.batched import build_config5_problem, stack_data
from collocfem_tpu_torch.convert import (
    batch_decision_from_numpy,
    data_from_numpy,
    decision_from_numpy,
)
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops import smallblocks as sb
from collocfem_tpu_torch.ops import spike
from collocfem_tpu_torch.ops.assemble import (
    assemble_gn,
    assemble_gn_soa_batched,
    blocks_to_nodes,
)
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.parallel import batch
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve.newton import SolverOptions
from collocfem_tpu_torch.testing import random_chain

F64 = torch.float64
MU_TRUE, B_TRUE = 1.3, 0.5
N_EXP, ELEMENTS, DEGREE, TF = 4, 24, 2, 8.0


def _close(got, want, rtol):
    """rtol, with an absolute floor of rtol x the leaf's magnitude for
    entries that cancel to (nearly) zero."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def pair():
    """The same seeded degree-2 batch (the shape of
    tests/test_multi_experiment.py, fewer experiments) in both packages."""
    mesh_j = jax_uniform_mesh(0.0, TF, ELEMENTS, DEGREE)
    t_meas = np.linspace(0.05, TF - 0.05, 40)
    jprob = JaxProblem.build(JaxVanDerPol(), mesh_j, t_meas,
                             defect_weight=300.0)
    tprob = EstimationProblem.build(
        VanDerPol(), uniform_mesh(0.0, TF, ELEMENTS, DEGREE), t_meas,
        defect_weight=300.0, device="cpu", dtype=F64)
    rng = np.random.default_rng(42)
    datas, v0s = [], []
    for i in range(N_EXP):
        x0 = rng.uniform(-2, 2, size=2)
        freq = 0.7 + 0.15 * i
        sol = solve_ivp(
            lambda t, x: [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0]
                          + B_TRUE * np.sin(freq * t)],
            (0.0, TF), x0, rtol=1e-10, atol=1e-11, dense_output=True)
        y = sol.sol(t_meas)[0][:, None]
        u_nodes = np.sin(freq * mesh_j.elem_times)[..., None]
        # x0 priors switched on to cover their scatter.
        datas.append(jprob.pack_data(y, t_meas, u_nodes=u_nodes,
                                     meas_weight=3.0, x0_prior=x0 + 0.1,
                                     x0_weight=[0.5, 0.2]))
        v0s.append(jprob.initial_guess_from_data(t_meas, y, p0=[0, 0]).V)
    jdata = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    jz0 = jax_batch.BatchDecision(V=jnp.stack(v0s),
                                  p=jnp.asarray([2.0, 0.2]))
    tdata = data_from_numpy(*map(np.asarray, jdata), device="cpu", dtype=F64)
    tz0 = batch_decision_from_numpy(jz0.V, jz0.p, "cpu", F64)
    prior = (jnp.asarray([1.0, 1.0]), jnp.asarray([1e-3, 1e-3]))
    tprior = tuple(torch.tensor(np.asarray(x)) for x in prior)
    return jprob, jz0, jdata, prior, tprob, tz0, tdata, tprior


@pytest.fixture(scope="module")
def jax_soa_solution(pair):
    """ONE JAX reference solve (the default concatenated-chain pipeline)."""
    jprob, jz0, jdata, prior, *_ = pair
    opts = JaxSolverOptions(maxiter=40, gtol=1e-9, xtol=1e-10)
    return jax_batch.make_multi_experiment_solver(jprob, opts)(
        jz0, jdata, *prior)


def test_smallblocks_match_jax():
    """Block-major chol, triangular solves and spd_solve over a batch:
    rtol 1e-12 (float64)."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((5, 4, 8, 8))
    A = m @ m.transpose(0, 1, 3, 2) + 8 * np.eye(8)
    B = rng.standard_normal((5, 4, 8, 3))
    tA, tB = torch.as_tensor(A), torch.as_tensor(B)
    jA, jB = jnp.asarray(A), jnp.asarray(B)
    L = sb.chol(tA)
    _close(L, jax_sb.chol(jA), 1e-12)
    _close(sb.solve_lower(L, tB), jax_sb.solve_lower(jax_sb.chol(jA), jB),
           1e-12)
    _close(sb.solve_lower_t(L, tB),
           jax_sb.solve_lower_t(jax_sb.chol(jA), jB), 1e-12)
    _close(sb.spd_solve(tA, tB), jax_sb.spd_solve(jA, jB), 1e-12)


@pytest.mark.parametrize("k,b,r,tiles", [(3, 2, 1, 128), (7, 3, 2, 4)])
def test_spike_chain_plain_matches_pallas_interpret(k, b, r, tiles):
    """The kernel #2 wrapper on CPU tensors and its plain version against
    the Pallas kernel in interpret mode, at the fast shapes of
    tests/test_spike_pallas.py: rtol 1e-11 (float64)."""
    args = random_chain(k, b, r, seed=k)
    want = jax_spike_chain(*(jnp.asarray(a.numpy()) for a in args),
                           tiles=tiles, interpret=True)
    _close(spike.blocktri_solve_spike_fused(*args), want, 1e-11)
    _close(spike.blocktri_solve_spike_fused_ref(*args), want, 1e-11)


@pytest.mark.parametrize("r", [1, 3])
def test_spike_chain_plain_matches_scan_on_concatenated_chain(r):
    """b = 8 on a chain of 5 experiments of 11 blocks with exactly zero
    couplings at the experiment boundaries, against JAX
    blocktri_solve_scan: rtol 1e-11 (float64)."""
    args = random_chain(55, 8, r, seed=r, boundary=11)
    want = np.asarray(jax_scan(*(jnp.asarray(a.permute(2, 0, 1).numpy())
                                 for a in args)))
    got = spike.blocktri_solve_spike_fused(*args)
    _close(got.permute(2, 0, 1), want, 1e-11)


def test_spike_chain_wrapper_dispatch():
    """A CPU tensor goes to the plain version and moves only its counter; a
    tensor on a device with no kernel raises."""
    D, E, G = random_chain(9, 8, 3, seed=0)
    kernel0 = spike.blocktri_solve_spike_fused.launches
    plain0 = spike.blocktri_solve_spike_fused_ref.launches
    got = spike.blocktri_solve_spike_fused(D, E, G)
    np.testing.assert_array_equal(
        got.numpy(), spike.blocktri_solve_spike_fused_ref(D, E, G).numpy())
    assert spike.blocktri_solve_spike_fused.launches == kernel0
    assert spike.blocktri_solve_spike_fused_ref.launches == plain0 + 2
    with pytest.raises(ValueError, match="no kernel"):
        spike.blocktri_solve_spike_fused(*(a.to("meta") for a in (D, E, G)))


def test_assemble_gn_soa_batched_matches_jax(pair):
    """Every leaf of the concatenated-chain system and the float64 cost:
    rtol 1e-12; boundary couplings exactly zero."""
    jprob, jz0, jdata, _, tprob, tz0, tdata, _ = pair
    jsys, jcost = jax_assemble_soa_batched(jprob, jz0.V, jz0.p, jdata,
                                           with_cost=True)
    tsys, tcost = assemble_gn_soa_batched(tprob, tz0.V, tz0.p, tdata,
                                          with_cost=True)
    for name in tsys._fields:
        _close(getattr(tsys, name), getattr(jsys, name), 1e-12)
    k = ELEMENTS + 1
    assert torch.all(tsys.E[:, :, k - 1::k] == 0.0)
    assert tcost.dtype == F64
    np.testing.assert_allclose(float(tcost), float(jcost.hi) + float(jcost.lo),
                               rtol=1e-12)


def test_assemble_gn_matches_jax(pair):
    """Block-major assemble_gn of one experiment, every leaf and the
    float64 cost: rtol 1e-12."""
    jprob, jz0, jdata, _, tprob, tz0, tdata, _ = pair
    jd = jax.tree_util.tree_map(lambda x: x[1], jdata)
    jsys, jcost = jax_assemble_gn(jprob, JaxDecision(V=jz0.V[1], p=jz0.p), jd,
                                  with_cost=True)
    td = type(tdata)(*(x[1] for x in tdata))
    tsys, tcost = assemble_gn(tprob, decision_from_numpy(
        tz0.V[1].numpy(), tz0.p.numpy(), "cpu", F64), td, with_cost=True)
    for name in tsys._fields:
        _close(getattr(tsys, name), getattr(jsys, name), 1e-12)
    np.testing.assert_allclose(float(tcost), float(jcost.hi) + float(jcost.lo),
                               rtol=1e-12)
    dx = np.random.default_rng(0).standard_normal((ELEMENTS + 1, DEGREE * 2))
    np.testing.assert_array_equal(
        blocks_to_nodes(torch.as_tensor(dx), tprob.num_nodes, 2).numpy(),
        np.asarray(jax_blocks_to_nodes(jnp.asarray(dx), tprob.num_nodes, 2)))


def test_batch_cost_matches_jax(pair):
    """float64 batch cost with the shared prior: rtol 1e-12."""
    jprob, jz0, jdata, prior, tprob, tz0, tdata, tprior = pair
    want = float(jax_batch.batch_cost(jprob, jz0, jdata, *prior))
    got = batch.batch_cost(tprob, tz0, tdata, *tprior)
    assert got.dtype == F64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)


def test_shared_gn_step_soa_matches_jax(pair):
    """shared_gn_step_soa at lam = 1e-3 against JAX's, with the bars of
    tests/test_multi_experiment.py:187-195 (dp rtol 1e-9, dV rtol 1e-7,
    gdot/sds/step_norm rtol 1e-9)."""
    jprob, jz0, jdata, prior, tprob, tz0, tdata, tprior = pair
    jsys = jax_assemble_soa_batched(jprob, jz0.V, jz0.p, jdata)
    jdV, jdp, jaux = jax_batch.shared_gn_step_soa(
        jprob, jsys, jnp.asarray(1e-3), jz0.p, *prior, n_exp=N_EXP,
        chain_solve=jax_batch.concat_chain_solver())
    tsys = assemble_gn_soa_batched(tprob, tz0.V, tz0.p, tdata)
    tdV, tdp, taux = batch.shared_gn_step_soa(
        tprob, tsys, torch.tensor(1e-3, dtype=F64), tz0.p, *tprior,
        n_exp=N_EXP, chain_solve=batch.concat_chain_solver())
    _check_step(tdV, tdp, taux, jdV, jdp, jaux)


def test_shared_gn_step_matches_jax(pair):
    """shared_gn_step (block-major, batched Thomas plain version) at
    lam = 1e-3 against JAX's (per-chain CR), same bars."""
    jprob, jz0, jdata, prior, tprob, tz0, tdata, tprior = pair
    jdV, jdp, jg, jaux = jax_batch.shared_gn_step(
        jprob, jz0, jdata, jnp.asarray(1e-3), *prior)
    tdV, tdp, tg, taux = batch.shared_gn_step(
        tprob, tz0, tdata, torch.tensor(1e-3, dtype=F64), *tprior)
    _check_step(tdV, tdp, taux, jdV, jdp, jaux)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-12)


def _check_step(tdV, tdp, taux, jdV, jdp, jaux):
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tdV.numpy(), np.asarray(jdV), rtol=1e-7,
                               atol=1e-9)
    for name in ("gnorm", "gdot", "sds", "step_norm"):
        np.testing.assert_allclose(float(getattr(taux, name)),
                                   float(getattr(jaux, name)), rtol=1e-9)


@pytest.mark.parametrize("layout", ["soa", "blocks"])
def test_multi_experiment_solver_matches_jax(pair, jax_soa_solution, layout):
    """End to end, both layouts against JAX's soa solve: p to rtol 1e-8 and
    V to rtol 1e-6 (tests/test_multi_experiment.py:121-126)."""
    _, _, _, _, tprob, tz0, tdata, tprior = pair
    jz, jst = jax_soa_solution
    opts = SolverOptions(maxiter=40, gtol=1e-9, xtol=1e-10)
    tz, tst = batch.make_multi_experiment_solver(tprob, opts, layout=layout)(
        tz0, tdata, *tprior)
    assert bool(tst.converged) and bool(jst.converged)
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(tz.V.numpy(), np.asarray(jz.V), rtol=1e-6,
                               atol=1e-8)
    assert tst.cost.dtype == F64


def test_multi_experiment_solver_refuses_what_is_not_ported(pair):
    tprob = pair[4]
    # dp_axis is a torch.distributed process group, not the JAX package's
    # mesh axis name.
    with pytest.raises(TypeError, match="process group"):
        batch.make_multi_experiment_solver(tprob, dp_axis="dp")
    with pytest.raises(ValueError, match="layout"):
        batch.make_multi_experiment_solver(tprob, layout="rows")


def test_build_config5_problem_matches_jax_data():
    """build_config5_problem at n_exp = 3 against the JAX package's
    make_config5_data and configs_bench packing: identical y, u and z0."""
    prob, z0, data, p_prior, p_w = build_config5_problem(
        3, dtype=F64, device="cpu")
    mesh, t_meas, y_all, u_all = jax_config5_data(3, 10)
    jprob = JaxProblem.build(JaxVanDerPol(), mesh, t_meas,
                             defect_weight=300.0)
    for e in range(3):
        jd = jprob.pack_data(y_all[e], t_meas, u_nodes=u_all[e],
                             meas_weight=100.0)
        jv = jprob.initial_guess_from_data(t_meas, y_all[e], p0=[0, 0]).V
        np.testing.assert_array_equal(data.y[e].numpy(), np.asarray(jd.y))
        np.testing.assert_array_equal(data.u[e].numpy(), np.asarray(jd.u))
        np.testing.assert_array_equal(data.meas_w[e].numpy(),
                                      np.asarray(jd.meas_w))
        np.testing.assert_array_equal(z0.V[e].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(z0.p.numpy(), [2.0, 0.2])
    np.testing.assert_array_equal(p_prior.numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(p_w.numpy(), [1e-3, 1e-3])
    _close(prob.dscale, jprob.dscale, 1e-15)


def test_stack_data_adds_experiment_axis():
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, 1.0, 3, 2),
                                    np.linspace(0.1, 0.9, 6), device="cpu",
                                    dtype=F64)
    ds = [tprob.pack_data(np.full((6, 1), float(i)), np.linspace(0.1, 0.9, 6))
          for i in range(3)]
    st = stack_data(ds)
    assert st.y.shape == (3,) + ds[0].y.shape
    for i in range(3):
        for a, b in zip(st, ds[i]):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())


@pytest.mark.parametrize("nq", [0, 2])
def test_gradient_norm_takes_an_empty_parameter_gradient(nq):
    """The gradient inf-norm of both shared-parameter steps
    (``lm_core.grad_inf_norm``) with nq = 0: the maximum over an empty gp is
    taken as 0, as the JAX package's ``jnp.max(..., initial=0.0)`` does.
    The JAX package's multi-experiment step itself cannot run at nq = 0 (its
    Schur step takes ``jnp.max`` of an empty diagonal and raises, checked
    here), so the two lines are held by this test of the helper."""
    from collocfem_tpu_torch.solve.lm_core import grad_inf_norm

    rng = np.random.default_rng(nq)
    gx, gp = rng.standard_normal((8, 13)), 5.0 * rng.standard_normal(nq)
    want = jnp.maximum(jnp.max(jnp.abs(gx)),
                       jnp.max(jnp.abs(jnp.asarray(gp)), initial=0.0))
    got = grad_inf_norm(torch.as_tensor(gx), torch.as_tensor(gp))
    assert got.shape == () and float(got) == float(want)
    if nq == 0:
        with pytest.raises(ValueError, match="zero-size"):
            jnp.max(jnp.diag(jnp.zeros((0, 0))))
