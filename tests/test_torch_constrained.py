"""Port parity, estimation under constraints: ``solve.bounds`` (box bounds
on parameters and states) and ``solve.constrained`` (nonlinear path
constraints from ``model.g`` and parameter constraints g(p) <= 0) against
``collocfem_tpu`` in float64 on the CPU, on the Van der Pol set-ups of
``tests/test_bounds.py`` and ``tests/test_constrained.py``.

Whole solves: the port on 'cr' and on 'spike' (on the CPU both run the
plain chain solves) against the JAX package's ``method='cr'``; each JAX
solver is compiled once, in a module-scoped fixture.  Tolerances: the
estimation cost of the first three outer rounds within 1e-9 (relative),
the final p within 1e-6 and the final cost within 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import BoundedOptions as JaxBoundedOptions
from collocfem_tpu.solve import ConstrainedOptions as JaxConstrainedOptions
from collocfem_tpu.solve import bounded_gauss_newton as jax_bounded
from collocfem_tpu.solve import constrained_gauss_newton as jax_constrained
from collocfem_tpu.solve import make_bounds as jax_make_bounds
from collocfem_tpu.solve import project_interior as jax_project_interior
from collocfem_tpu_torch import configs
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import Decision, EstimationProblem
from collocfem_tpu_torch.solve import (
    BoundedOptions,
    ConstrainedOptions,
    bounded_gauss_newton,
    constrained_gauss_newton,
    make_bounds,
    make_constrained_solver,
    project_interior,
)

F64 = torch.float64
MU_TRUE, B_TRUE, TF = 1.0, 0.7, 8.0


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _truth():
    def rhs(t, x):
        return [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0]
                + B_TRUE * 0.5 * np.sin(1.1 * t)]

    return solve_ivp(rhs, (0.0, TF), (2.0, 0.0), rtol=1e-11, atol=1e-12,
                     dense_output=True).sol


def _setups(elements, n_meas, jmodel=None, model=None, x_cap=None):
    """Both packages' Van der Pol problems on ``elements`` elements of
    degree 2 with ``n_meas`` noise-free samples of x1 (the set-ups of
    tests/test_bounds.py and tests/test_constrained.py); p0 = (0.6, 0.4).
    With ``x_cap`` the initial states are clipped inside |x1| < 0.98
    x_cap."""
    sol = _truth()
    t_meas = np.linspace(0.025, TF - 0.025, n_meas)
    y = sol(t_meas)[0][:, None]
    jmesh = jax_uniform_mesh(0.0, TF, elements, 2)
    mesh = uniform_mesh(0.0, TF, elements, 2)
    u_nodes = 0.5 * np.sin(1.1 * mesh.elem_times)[..., None]
    jprob = JaxProblem.build(jmodel or JaxVanDerPol(), jmesh, t_meas,
                             defect_weight=30.0)
    prob = EstimationProblem.build(model or VanDerPol(), mesh, t_meas,
                                   defect_weight=30.0, dtype=F64,
                                   device="cpu")
    jdata = jprob.pack_data(y, t_meas, u_nodes=u_nodes)
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes)
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[0.6, 0.4])
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.6, 0.4])
    if x_cap is not None:
        V0 = np.array(jz0.V)
        V0[:, 0] = np.clip(V0[:, 0], -0.98 * x_cap, 0.98 * x_cap)
        jz0 = jz0._replace(V=jnp.asarray(V0))
        z0 = z0._replace(V=torch.as_tensor(V0))
    return (jprob, jdata, jz0), (prob, data, z0), y


def _hold(z, st, jz, jst, hist_col=0):
    _close(st.history[:3, hist_col], np.asarray(jst.history)[:3, hist_col],
           1e-9)
    _close(z.p, jz.p, 1e-6)
    _close(st.cost, jst.cost, 1e-9)


# ---- unit parity ---------------------------------------------------------------


def test_bounds_and_projection_match_jax():
    """make_bounds (None entries, a scalar bound) and project_interior
    (one- and two-sided, states and parameters): identical."""
    (jprob, _, jz0), (prob, _, z0), _ = _setups(10, 20)
    for kw in (dict(p_lo=[0.0, None], p_hi=[0.8, None]),
               dict(x_lo=-1.5, x_hi=[1.5, None]),
               dict(p_lo=[1.5, None])):
        jb, b = jax_make_bounds(jprob, **kw), make_bounds(prob, **kw)
        for g, w in zip(b, jb):
            np.testing.assert_array_equal(g, w)
        jz, z = jax_project_interior(jz0, jb), project_interior(z0, b)
        np.testing.assert_array_equal(z.V.numpy(), np.asarray(jz.V))
        np.testing.assert_array_equal(z.p.numpy(), np.asarray(jz.p))
    with pytest.raises(ValueError):
        make_bounds(prob, p_lo=[1.0, None], p_hi=[0.5, None])


def test_no_constraints_raises():
    _, (prob, _, _), _ = _setups(10, 20)
    with pytest.raises(ValueError):
        make_constrained_solver(prob)


# ---- whole solves ----------------------------------------------------------------

CAP = 0.8
BOUNDED_OPTS = dict(n_outer=12, inner_maxiter=40, mu_min=1e-12)


@pytest.fixture(scope="module")
def bounded_case():
    (jprob, jdata, jz0), port, _ = _setups(60, 160)
    jz, jst = jax_bounded(jprob, jz0, jdata,
                          jax_make_bounds(jprob, p_lo=[0.0, None],
                                          p_hi=[CAP, None]),
                          JaxBoundedOptions(**BOUNDED_OPTS, method="cr"))
    return port, jz, jst


@pytest.mark.parametrize("method", ["cr", "spike"])
def test_active_parameter_bound_matches_jax(bounded_case, method):
    """tests/test_bounds.py's active parameter bound (mu capped at 0.8 below
    its true 1.0; 60 elements of degree 2): the tolerances above; strictly
    interior and within 1e-4 of the cap."""
    (prob, data, z0), jz, jst = bounded_case
    b = make_bounds(prob, p_lo=[0.0, None], p_hi=[CAP, None])
    z, st = bounded_gauss_newton(prob, z0, data, b,
                                 BoundedOptions(**BOUNDED_OPTS, method=method))
    _hold(z, st, jz, jst)
    assert 0.0 < CAP - float(z.p[0]) < 1e-4


R2 = 1.2
CONSTRAINED_OPTS = dict(n_outer=12, inner_maxiter=40, mu_min=1e-12)


@pytest.fixture(scope="module")
def param_constraint_case():
    (jprob, jdata, jz0), port, _ = _setups(48, 120)
    jz, jst = jax_constrained(
        jprob, jz0, jdata, JaxConstrainedOptions(**CONSTRAINED_OPTS,
                                                 method="cr"),
        g_param=lambda p: jnp.atleast_1d(jnp.vdot(p, p) - R2))
    return port, jz, jst


@pytest.mark.parametrize("method", ["cr", "spike"])
def test_active_parameter_constraint_matches_jax(param_constraint_case,
                                                 method):
    """tests/test_constrained.py's nonlinear cap ||p||^2 <= 1.2 (active; 48
    elements of degree 2): the tolerances above; strictly feasible, riding
    the bound, and gviol equal to g(p)."""
    (prob, data, z0), jz, jst = param_constraint_case
    g_param = lambda p: torch.atleast_1d(torch.dot(p, p) - R2)
    z, st = constrained_gauss_newton(
        prob, z0, data, ConstrainedOptions(**CONSTRAINED_OPTS, method=method),
        g_param=g_param)
    _hold(z, st, jz, jst)
    gval = float(g_param(z.p)[0])
    assert -1e-3 * R2 < gval < 0.0
    assert float(st.gviol) == gval
    _close(st.mu, jst.mu, 1e-15)


class JaxVdPEnvelope(JaxVanDerPol):
    ng = 2

    def __init__(self, x_cap):
        super().__init__()
        self.x_cap = float(x_cap)

    def g(self, x, u, p, t):
        return jnp.stack([x[0] - self.x_cap, -self.x_cap - x[0]])


class VdPEnvelope(VanDerPol):
    ng = 2

    def __init__(self, x_cap):
        super().__init__()
        self.x_cap = float(x_cap)

    def g(self, x, u, p, t):
        return torch.stack([x[0] - self.x_cap, -self.x_cap - x[0]])


@pytest.fixture(scope="module")
def envelope_case():
    y = _truth()(np.linspace(0.025, TF - 0.025, 120))[0]
    x_cap = 0.95 * float(np.max(np.abs(y)))
    (jprob, jdata, jz0), port, _ = _setups(
        48, 120, JaxVdPEnvelope(x_cap), VdPEnvelope(x_cap), x_cap)
    jz, jst = jax_constrained(jprob, jz0, jdata, JaxConstrainedOptions(
        n_outer=8, inner_maxiter=30, method="cr"))
    return port, jz, jst, x_cap


@pytest.mark.parametrize("method", ["cr", "spike"])
def test_state_envelope_matches_jax(envelope_case, method):
    """tests/test_constrained.py's path constraint |x1| <= 0.95 max|y|
    from model.g (48 elements of degree 2): the tolerances above, V within
    1e-6, feasible everywhere and the envelope active."""
    (prob, data, z0), jz, jst, x_cap = envelope_case
    z, st = constrained_gauss_newton(
        prob, z0, data, ConstrainedOptions(n_outer=8, inner_maxiter=30,
                                           method=method))
    _hold(z, st, jz, jst)
    _close(z.V, jz.V, 1e-6)
    x1 = z.V[:, 0].numpy()
    assert np.all(np.abs(x1) < x_cap) and np.max(np.abs(x1)) > 0.99 * x_cap
    assert float(st.gviol) < 0.0


def test_bounded_vdp_builder_matches_the_test_setup():
    """configs.build_bounded_vdp_problem at the test's degree 2 builds the
    problem of _setups(60, 160): same data and initial guess."""
    prob, z0, data = configs.build_bounded_vdp_problem(2, dtype=F64,
                                                       device="cpu")
    _, (prob2, data2, z02), _ = _setups(60, 160)
    for a, b in zip((*data, *z0), (*data2, *z02)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert isinstance(z0, Decision)


def test_constrained_stack_never_imports_jax():
    """A fresh interpreter runs one outer round of the OCP solver on config
    3 (N = 4), of the free-time OCP, of the constrained aircraft set-up (one
    inner iteration) and of the bounded Van der Pol set-up, with JAX (and
    the JAX package) nowhere in sys.modules."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "from collocfem_tpu_torch import configs\n"
        "from collocfem_tpu_torch.solve import (ALBarrierOptions, "
        "BoundedOptions, ConstrainedOptions, make_bounded_solver, "
        "make_bounds, make_constrained_solver, make_ocp_solver)\n"
        "f64 = dict(dtype=torch.float64, device='cpu')\n"
        "prob, z0 = configs.build_config3_problem(4, **f64)\n"
        "o = ALBarrierOptions(n_outer=1, inner_maxiter=2)\n"
        "z, st = make_ocp_solver(prob, o)(z0)\n"
        "prob, ftm, z0 = configs.build_min_time_problem(**f64)\n"
        "make_ocp_solver(prob, o)(z0)\n"
        "prob, z0, data = configs.build_constrained_aircraft_problem(**f64)\n"
        "make_constrained_solver(prob, ConstrainedOptions(n_outer=1, "
        "inner_maxiter=1), g_param=configs.zeta_constraint)(z0, data)\n"
        "prob, z0, data = configs.build_bounded_vdp_problem(**f64)\n"
        "b = make_bounds(prob, p_hi=[configs.MU_CAP, None])\n"
        "make_bounded_solver(prob, b, BoundedOptions(n_outer=1, "
        "inner_maxiter=1))(z0, data)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'collocfem_tpu', 'baseline_cpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
