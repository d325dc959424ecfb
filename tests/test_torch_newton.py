"""Port parity, the whole slice: ``make_gn_solver`` (Gauss-Newton and exact
Newton), ``assemble_newton`` and ``make_irls_solver`` of
``collocfem_tpu_torch`` against ``collocfem_tpu``'s on the CPU (where both
resolve 'auto' to the plain cyclic reduction), plus the guard that the port
never imports JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from test_assemble import small_problem

from collocfem_tpu.model import Model as JaxModel
from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.assemble import assemble_newton as jax_assemble_newton
from collocfem_tpu.ops.assemble import soa_from_blocks as jax_soa_from_blocks
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve.newton import make_gn_solver as jax_make_gn_solver
from collocfem_tpu.solve.newton import make_irls_solver as jax_make_irls_solver
from collocfem_tpu.utils import rk4_trajectory
from collocfem_tpu_torch.convert import data_from_numpy, decision_from_numpy
from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.assemble import assemble_newton
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve.lm_core import LMAux, lm_loop
from collocfem_tpu_torch.solve.newton import (SolverOptions, make_gn_solver,
                                              make_irls_solver)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MU_TRUE, B_TRUE = 1.0, 0.7


def _vdp_data(seed=0, sigma=0.01):
    """The N = 40 VdP of tests/test_gauss_newton.py, with seeded noise."""
    tf = 10.0
    u_fn = lambda t: 0.5 * np.sin(1.1 * t)
    sol = solve_ivp(
        lambda t, x: [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0]
                      + B_TRUE * u_fn(t)],
        (0.0, tf), (2.0, 0.0), rtol=1e-11, atol=1e-12, dense_output=True)
    t_meas = np.linspace(0.025, tf - 0.025, 200)
    y = sol.sol(t_meas)[0][:, None]
    y = y + sigma * np.random.default_rng(seed).standard_normal(y.shape)
    return tf, t_meas, y, u_fn


def test_gn_solver_matches_jax():
    """15 fixed-work LM iterations in float64: identical accept column,
    history cost within rtol 1e-8, final V and p within rtol 1e-7."""
    tf, t_meas, y, u_fn = _vdp_data()
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, 40, 4),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, 40, 4),
                                    t_meas, defect_weight=30.0, device="cpu",
                                    dtype=torch.float64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=u_fn(jprob.mesh.elem_times)[..., None],
                            meas_weight=1.0, p_prior=[1.0, 1.0], p_weight=1e-3)
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[2.0, 0.3])
    # Both packages start from the same iterate and data.
    tdata = data_from_numpy(*map(np.asarray, jdata), device="cpu",
                            dtype=torch.float64)
    tz0 = decision_from_numpy(jz0.V, jz0.p, "cpu", torch.float64)

    fixed = dict(maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0)
    jz, jst = jax_make_gn_solver(jprob, JaxSolverOptions(**fixed))(jz0, jdata)
    tz, tst = make_gn_solver(tprob, SolverOptions(**fixed))(tz0, tdata)

    jhist, thist = np.asarray(jst.history), tst.history.numpy()
    np.testing.assert_array_equal(thist[:, 4], jhist[:, 4])
    assert int(tst.iterations) == int(jst.iterations) == 15
    np.testing.assert_allclose(thist[:, 0], jhist[:, 0], rtol=1e-8)
    np.testing.assert_allclose(tz.V.numpy(), np.asarray(jz.V), rtol=1e-7,
                               atol=1e-7 * float(jnp.abs(jz.V).max()))
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-7)
    assert tst.cost.dtype == torch.float64


def test_gn_solver_with_refinement_matches_jax():
    """make_gn_solver(kkt_refine=1) against JAX's at N = 40, float64, 12
    fixed-work iterations: identical accept column, p within rtol 1e-8."""
    tf, t_meas, y, u_fn = _vdp_data(seed=1)
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, 40, 4),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, 40, 4),
                                    t_meas, defect_weight=30.0, device="cpu",
                                    dtype=torch.float64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=u_fn(jprob.mesh.elem_times)[..., None])
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[2.0, 0.3])
    tdata = data_from_numpy(*map(np.asarray, jdata), device="cpu",
                            dtype=torch.float64)
    tz0 = decision_from_numpy(jz0.V, jz0.p, "cpu", torch.float64)
    fixed = dict(maxiter=12, gtol=0.0, ftol=0.0, xtol=0.0, kkt_refine=1)
    jz, jst = jax_make_gn_solver(jprob, JaxSolverOptions(**fixed))(jz0, jdata)
    tz, tst = make_gn_solver(tprob, SolverOptions(**fixed))(tz0, tdata)
    np.testing.assert_array_equal(tst.history.numpy()[:, 4],
                                  np.asarray(jst.history)[:, 4])
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-8)


class _JaxOscillator(JaxModel):
    """x1' = x2, x2' = -x1 - 0.2 x2 + u: two states, one input, no
    parameter."""

    nx, nu, nq = 2, 1, 0

    def f(self, x, u, p, t):
        return jnp.stack([x[1], -x[0] - 0.2 * x[1] + u[0]])


class _Oscillator(Model):
    nx, nu, nq = 2, 1, 0

    def f(self, x, u, p, t):
        return torch.stack([x[1], -x[0] - 0.2 * x[1] + u[0]])


def test_gn_solver_without_parameters_matches_jax():
    """make_gn_solver at nq = 0 (state estimation only; the gradient norm
    must take an empty gp): a damped oscillator, N = 20, degree 4, float64,
    method='cr', maxiter=5.  Both packages stop after the same number of
    iterations; V within 1e-9 of max|V| and the cost within 1e-9
    (relative)."""
    tf = 5.0
    u_fn = lambda t: np.sin(1.3 * t)
    sol = solve_ivp(lambda t, x: [x[1], -x[0] - 0.2 * x[1] + u_fn(t)],
                    (0.0, tf), (1.0, 0.0), rtol=1e-11, atol=1e-12,
                    dense_output=True)
    t_meas = np.linspace(0.05, tf - 0.05, 60)
    y = sol.sol(t_meas).T
    y = y + 1e-3 * np.random.default_rng(0).standard_normal(y.shape)
    jprob = JaxProblem.build(_JaxOscillator(), jax_uniform_mesh(0.0, tf, 20, 4),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(_Oscillator(),
                                    uniform_mesh(0.0, tf, 20, 4), t_meas,
                                    defect_weight=30.0, device="cpu",
                                    dtype=torch.float64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=u_fn(jprob.mesh.elem_times)[..., None])
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=np.zeros(0))
    tdata = data_from_numpy(*map(np.asarray, jdata), device="cpu",
                            dtype=torch.float64)
    tz0 = decision_from_numpy(jz0.V, jz0.p, "cpu", torch.float64)
    opts = dict(maxiter=5, method="cr")
    jz, jst = jax_make_gn_solver(jprob, JaxSolverOptions(**opts))(jz0, jdata)
    tz, tst = make_gn_solver(tprob, SolverOptions(**opts))(tz0, tdata)
    assert tuple(tz.p.shape) == (0,)
    assert int(tst.iterations) == int(jst.iterations) >= 1
    assert float(tst.cost) < 1e-3 * float(tprob.cost(tz0, tdata))
    np.testing.assert_allclose(float(tst.cost), float(jst.cost), rtol=1e-9)
    np.testing.assert_allclose(tz.V.numpy(), np.asarray(jz.V), rtol=0,
                               atol=1e-9 * float(jnp.abs(jz.V).max()))


def test_port_never_imports_jax():
    """A fresh interpreter builds a small headline problem and runs one LM
    iteration of the port, builds configs 2 and 4 (reading the flight
    record) and runs one exact-Newton and one IRLS round on config 4, with
    JAX nowhere in sys.modules."""
    code = (
        "import sys\n"
        "import collocfem_tpu_torch as ct\n"
        "from collocfem_tpu_torch import configs\n"
        "from collocfem_tpu_torch.headline import build_headline_problem\n"
        "from collocfem_tpu_torch.models import VanDerPol\n"
        "from collocfem_tpu_torch.solve.newton import SolverOptions, "
        "make_gn_solver, make_irls_solver\n"
        "import torch\n"
        "mesh, t, y, u = build_headline_problem(100)\n"
        "prob = ct.EstimationProblem.build(VanDerPol(), mesh, t, "
        "defect_weight=100.0, device='cpu', dtype=torch.float32)\n"
        "data = prob.pack_data(y, t, u_nodes=u)\n"
        "z0 = prob.initial_guess_from_data(t, y, p0=[0.5, 0.5])\n"
        "z, st = make_gn_solver(prob, SolverOptions(maxiter=1, gtol=0.0))"
        "(z0, data)\n"
        "assert int(st.iterations) == 1 and bool(torch.isfinite(z.p).all())\n"
        "configs.build_config2_problem(dtype=torch.float64, device='cpu')\n"
        "prob, z0, data = configs.build_config4_problem("
        "dtype=torch.float64, device='cpu')\n"
        "opts = SolverOptions(maxiter=1, gtol=0.0, irls_delta=2.0)\n"
        "make_gn_solver(prob, SolverOptions(maxiter=1, gtol=0.0, "
        "hessian='newton'))(z0, data)\n"
        "make_irls_solver(prob, opts, n_rounds=1)(z0, data)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'collocfem_tpu', 'baseline_cpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("change", [dict(state_dw=True),
                                    dict(method="cr_dw")])
def test_unported_solver_paths_raise(change):
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, 1.0, 4, 4),
                                    np.linspace(0.1, 0.9, 5), device="cpu",
                                    dtype=torch.float64)
    with pytest.raises(NotImplementedError,
                       match="float64 .*ConvergedLadder .*CR_DW_CHAIN"):
        make_gn_solver(tprob, SolverOptions(**change))


def test_decrease_accept_mode_raises():
    """accept_mode='decrease' is ported (tests/test_torch_ocp.py holds it
    against the JAX package's loop) and takes any decrease; a mode the JAX
    package does not know still raises."""
    zero = torch.zeros((), dtype=torch.float64)
    with pytest.raises(ValueError, match="accept_mode"):
        lm_loop((), (), zero, None, maxiter=1, lam0=1.0, dtype=torch.float64,
                accept_mode="armijo")

    def trial(z, carry, lam):   # a decrease whose gain ratio is negative
        return z + 1.0, carry, zero - 1.0, LMAux(
            gnorm=zero + 1.0, gdot=zero + 1.0, sds=zero, step_norm=zero)

    st = lm_loop(zero, (), zero, trial, maxiter=1, lam0=1.0,
                 dtype=torch.float64, accept_mode="decrease")
    assert float(st.z) == 1.0 and float(st.cost) == -1.0


def _carry(jdata, jz):
    """The JAX package's data and iterate as the port's float64 tensors."""
    return (data_from_numpy(*map(np.asarray, jdata), device="cpu",
                            dtype=torch.float64),
            decision_from_numpy(jz.V, jz.p, "cpu", torch.float64))


@pytest.mark.parametrize("seed", [0, 2])
def test_assemble_newton_matches_jax(seed):
    """assemble_newton against the JAX package's soa_from_blocks of its
    assemble_newton on tests/test_assemble.py's small problem (VdP, 4
    elements of degree 3, 17 samples, priors on p and x0) at a seeded
    iterate: every leaf within 1e-10."""
    jprob, jz, jdata = small_problem(seed)
    tprob = EstimationProblem.build(
        VanDerPol(), uniform_mesh(0.0, 3.0, 4, 3), np.linspace(0.05, 2.95, 17),
        defect_weight=2.0, device="cpu", dtype=torch.float64)
    tdata, tz = _carry(jdata, jz)
    want = jax_soa_from_blocks(jax_assemble_newton(jprob, jz, jdata))
    got = assemble_newton(tprob, tz, tdata)
    for name in ("D", "E", "B", "C", "gx", "gp"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(w).max()))


def test_newton_solver_matches_jax():
    """make_gn_solver(hessian='newton') against JAX's on the N = 40 VdP
    problem, float64, 12 fixed-work iterations from the same iterate (the
    first steps are indefinite and rejected until lam grows): identical
    accept column, V and p within 1e-9."""
    tf, t_meas, y, u_fn = _vdp_data(seed=2)
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, 40, 4),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, 40, 4),
                                    t_meas, defect_weight=30.0, device="cpu",
                                    dtype=torch.float64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=u_fn(jprob.mesh.elem_times)[..., None],
                            p_prior=[1.0, 1.0], p_weight=1e-3)
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[2.0, 0.3])
    tdata, tz0 = _carry(jdata, jz0)
    opts = dict(maxiter=12, gtol=0.0, hessian="newton")
    jz, jst = jax_make_gn_solver(jprob, JaxSolverOptions(**opts))(jz0, jdata)
    tz, tst = make_gn_solver(tprob, SolverOptions(**opts))(tz0, tdata)
    np.testing.assert_array_equal(tst.history.numpy()[:, 4],
                                  np.asarray(jst.history)[:, 4])
    assert float(tst.cost) < float(tprob.cost(tz0, tdata))
    np.testing.assert_allclose(tz.V.numpy(), np.asarray(jz.V), rtol=1e-9,
                               atol=1e-9 * float(jnp.abs(jz.V).max()))
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-9)


def _outlier_problem():
    """tests/test_irls_utils.py's outlier fixture: VdP on 48 elements of
    degree 2, 120 samples with noise 0.01 and 8 gross outliers of +-2."""
    tf = 8.0
    mesh = jax_uniform_mesh(0.0, tf, 48, 2)
    t_meas = np.linspace(0.05, tf - 0.05, 120)
    model = JaxVanDerPol()
    ts_fine = np.linspace(0.0, tf, 8001)
    xs = rk4_trajectory(model.f, jnp.asarray([1.0, 0.0]), ts_fine,
                        u_fn=lambda t: jnp.stack([jnp.sin(0.9 * t)]),
                        p=jnp.asarray([1.0, 1.0]))
    y = np.interp(t_meas, ts_fine, np.asarray(xs[:, 0]))[:, None]
    rng = np.random.default_rng(5)
    y += 0.01 * rng.standard_normal(y.shape)
    idx = rng.choice(t_meas.size, 8, replace=False)
    y[idx] += rng.choice([-1, 1], 8)[:, None] * 2.0
    jprob = JaxProblem.build(model, mesh, t_meas, defect_weight=300.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, 48, 2),
                                    t_meas, defect_weight=300.0, device="cpu",
                                    dtype=torch.float64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=np.sin(0.9 * mesh.elem_times)[..., None],
                            meas_weight=100.0)
    return jprob, tprob, jdata, jprob.initial_guess_from_data(
        t_meas, y, p0=[0.5, 0.5])


def test_irls_solver_matches_jax():
    """measurement_residuals at the initial guess (within 1e-12), then
    make_irls_solver (irls_delta 2, 4 rounds, maxiter 40, gtol 1e-8, xtol
    1e-10) on the outlier fixture: p within 1e-9 of the JAX package's, the
    final per-sample weights within 1e-9, outliers down-weighted, a stats
    entry per solve, the last one's cost within 1e-9 of the JAX package's
    (the iteration counts differ: near the optimum a step's decrease falls
    below the float64 cost's resolution, which the JAX package's
    double-word cost still resolves)."""
    jprob, tprob, jdata, jz0 = _outlier_problem()
    tdata, tz0 = _carry(jdata, jz0)
    want = np.asarray(jprob.measurement_residuals(jz0, jdata))
    got = tprob.measurement_residuals(tz0, tdata)
    assert tuple(got.shape) == want.shape == (48, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))
    opts = dict(maxiter=40, gtol=1e-8, xtol=1e-10, irls_delta=2.0)
    jz, jst, jw = jax_make_irls_solver(jprob, JaxSolverOptions(**opts),
                                       n_rounds=4)(jz0, jdata)
    tz, trounds, tw = make_irls_solver(tprob, SolverOptions(**opts),
                                       n_rounds=4)(tz0, tdata)
    assert len(trounds) == 5
    np.testing.assert_allclose(float(trounds[-1].cost), float(jst.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-9)
    np.testing.assert_allclose(tw.meas_w.numpy(), np.asarray(jw.meas_w),
                               rtol=1e-9)
    assert float(tw.meas_w.min()) < 0.1 * float(tw.meas_w.max())


def test_irls_needs_a_threshold():
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, 1.0, 4, 4),
                                    np.linspace(0.1, 0.9, 5), device="cpu",
                                    dtype=torch.float64)
    with pytest.raises(ValueError, match="irls_delta"):
        make_irls_solver(tprob, SolverOptions())


def test_gauss_newton_matches_jax():
    """gauss_newton, the one-shot wrapper over make_gn_solver, against the
    JAX package's on the N = 40 Van der Pol problem, float64, to
    convergence: both converge, V and p within 1e-9 (relative) and the cost
    within 1e-9.  It is exported as solve.gauss_newton, as the JAX package
    exports it."""
    from collocfem_tpu.solve import gauss_newton as jax_gauss_newton
    from collocfem_tpu_torch import solve as tsolve

    tf, t_meas, y, u_fn = _vdp_data()
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, 40, 4),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, 40, 4),
                                    t_meas, defect_weight=30.0, device="cpu",
                                    dtype=torch.float64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=u_fn(jprob.mesh.elem_times)[..., None],
                            meas_weight=1.0, p_prior=[1.0, 1.0], p_weight=1e-3)
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[2.0, 0.3])
    tdata, tz0 = _carry(jdata, jz0)
    opts = dict(maxiter=50, gtol=1e-9, xtol=1e-12)
    jz, jst = jax_gauss_newton(jprob, jz0, jdata, JaxSolverOptions(**opts))
    tz, tst = tsolve.gauss_newton(tprob, tz0, tdata, SolverOptions(**opts))
    assert bool(jst.converged) and bool(tst.converged)
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-9)
    np.testing.assert_allclose(tz.V.numpy(), np.asarray(jz.V), rtol=1e-9,
                               atol=1e-9 * float(jnp.abs(jz.V).max()))
    np.testing.assert_allclose(float(tst.cost), float(jst.cost), rtol=1e-9)
