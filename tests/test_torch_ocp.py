"""Port parity, trajectory optimization (config 3): the all-node defect
residual, ``OptimalControlProblem``'s tables and functions, the SoA
scatters of the OCP assembly, the decrease-mode LM loop and alpha in its
predicted decrease, the batched feasibility line search, the SPIKE
semantics at the OCP block size b = 12, and whole AL/barrier solves (the
pendulum swing-up, the split-actuator model with an equality path
constraint, the free-time double integrator) against ``collocfem_tpu`` in
float64 on the CPU.

Whole solves: the port on 'cr' and on 'spike' (on the CPU both run the
plain chain solves) against the JAX package's ``method='cr'``; each JAX
solver is compiled once, in a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.model import Model as JaxModel
from collocfem_tpu.models import Pendulum as JaxPendulum
from collocfem_tpu.ocp import OptimalControlProblem as JaxOCP
from collocfem_tpu.ocp_time import free_time_ocp as jax_free_time_ocp
from collocfem_tpu.ops import doubleword
from collocfem_tpu.ops.assemble import BlockTriSystemSoA as JaxSystem
from collocfem_tpu.ops.assemble import (
    node_block_scatter_soa as jax_node_scatter,
)
from collocfem_tpu.ops.assemble import scatter_gn_blocks_soa as jax_scatter
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.ops.residual import (
    defect_residual_all as jax_defect_residual_all,
)
from collocfem_tpu.problem import Decision as JaxDecision
from collocfem_tpu.solve.auglag import ALBarrierOptions as JaxOptions
from collocfem_tpu.solve.auglag import make_ocp_solver as jax_make_ocp_solver
from collocfem_tpu.solve.blocktri import blocktri_solve_scan as jax_scan
from collocfem_tpu.solve.kkt import solve_kkt_soa as jax_solve_kkt_soa
from collocfem_tpu.solve.lm_core import LMAux as JaxLMAux
from collocfem_tpu.solve.lm_core import lm_loop as jax_lm_loop
from collocfem_tpu_torch import configs
from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.models import Pendulum
from collocfem_tpu_torch.ocp import OptimalControlProblem
from collocfem_tpu_torch.ocp_time import free_time_ocp
from collocfem_tpu_torch.ops import spike
from collocfem_tpu_torch.ops.assemble import (
    BlockTriSystemSoA,
    node_block_scatter_soa,
    scatter_gn_blocks_soa,
)
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.ops.residual import defect_residual_all
from collocfem_tpu_torch.problem import Decision
from collocfem_tpu_torch.solve.auglag import (
    ALBarrierOptions,
    backtrack_halvings,
    first_feasible_alpha,
    make_ocp_solver,
)
from collocfem_tpu_torch.solve.lm_core import LMAux, lm_loop
from collocfem_tpu_torch.testing import random_chain, random_kkt_system

F64 = torch.float64


def _close(got, want, tol):
    """Relative tolerance ``tol`` with an absolute floor of tol x the
    array's magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    if want.size:
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(float(np.abs(want).max()),
                                                  1e-300))


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# ---- models of tests/test_ocp.py, in both packages ----------------------------


class JaxSplitActuator(JaxModel):
    """x1' = x2, x2' = u1 + u2 with u1 = 2 u2; cost 0.5 int |u|^2."""

    nx, nu, nq, ng, ne = 2, 2, 0, 0, 1

    def f(self, x, u, p, t):
        return jnp.stack([x[1], u[0] + u[1]])

    def g_eq(self, x, u, p, t):
        return jnp.stack([u[0] - 2.0 * u[1]])

    def running_cost_residual(self, x, u, p, t):
        return u


class SplitActuator(Model):
    nx, nu, nq, ng, ne = 2, 2, 0, 0, 1

    def f(self, x, u, p, t):
        return torch.stack([x[1], u[0] + u[1]])

    def g_eq(self, x, u, p, t):
        return torch.stack([u[0] - 2.0 * u[1]])

    def running_cost_residual(self, x, u, p, t):
        return u


class JaxDoubleIntegrator(JaxModel):
    """x1' = x2, x2' = u with |u| <= 1 (examples/min_time_ocp.py)."""

    nx, nu, nq, ng = 2, 1, 0, 2

    def f(self, x, u, p, t):
        return jnp.stack([x[1], u[0]])

    def g(self, x, u, p, t):
        return jnp.stack([u[0] - 1.0, -u[0] - 1.0])


# ---- unit parity ---------------------------------------------------------------


def test_defect_residual_all_matches_jax():
    """All-node defects of one pendulum element on seeded (X, U, scale):
    within 1e-13."""
    rng = np.random.default_rng(0)
    mesh = uniform_mesh(0.0, 2.5, 5, 4)
    X, U = rng.standard_normal((5, 2)), rng.standard_normal((5, 1))
    scale, times = rng.random((5, 2)), mesh.elem_times[2]
    want = jax_defect_residual_all(JaxPendulum(), jnp.asarray(mesh.basis.diff),
                                   0.5, jnp.asarray(times), jnp.asarray(X),
                                   jnp.asarray(U), jnp.zeros(0),
                                   jnp.asarray(scale))
    got = defect_residual_all(Pendulum(), _t(mesh.basis.diff), 0.5,
                              _t(times), _t(X), _t(U), torch.zeros(0, dtype=F64),
                              _t(scale))
    _close(got, want, 1e-13)


@pytest.mark.parametrize("which", ["pendulum", "split", "free_time"])
def test_problem_tables_and_functions_match_jax(which):
    """Buffers, initial guess, constraints, path constraints (inequality and
    equality), objective and zero multipliers of both packages' problems at
    a seeded iterate: within 1e-13.  The pendulum leaves x(tf)'s velocity
    free (NaN)."""
    rng = np.random.default_rng(1)
    if which == "free_time":
        jprob, _ = jax_free_time_ocp(JaxDoubleIntegrator(), 5, 4,
                                     x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0)
        prob, _ = free_time_ocp(configs.DoubleIntegrator(), 5, 4,
                                x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
                                dtype=F64, device="cpu")
    else:
        jmodel, model, xf = ((JaxPendulum(), Pendulum(), [np.pi, np.nan])
                             if which == "pendulum" else
                             (JaxSplitActuator(), SplitActuator(), [1.0, 0.0]))
        jprob = JaxOCP.build(jmodel, jax_uniform_mesh(0.0, 2.5, 5, 4),
                             x0=[0.0, 0.0], xf=xf)
        prob = OptimalControlProblem.build(model, uniform_mesh(0.0, 2.5, 5, 4),
                                           x0=[0.0, 0.0], xf=xf, dtype=F64,
                                           device="cpu")
    for name in ("diff", "widths", "elem_times", "cscale", "qscale",
                 "node_times", "x0_val", "x0_mask", "xf_val", "xf_mask"):
        _close(getattr(prob, name), getattr(jprob, name), 1e-15)
    z0, jz0 = prob.initial_guess(u0=0.3), jprob.initial_guess(u0=0.3)
    _close(z0.V, jz0.V, 1e-15)
    V = rng.standard_normal(tuple(z0.V.shape))
    p = 0.1 * rng.standard_normal(tuple(z0.p.shape))
    z, jz = Decision(V=_t(V), p=_t(p)), JaxDecision(V=jnp.asarray(V),
                                                    p=jnp.asarray(p))
    for got, want in zip(prob.constraints(z), jprob.constraints(jz)):
        _close(got, want, 1e-13)
    _close(prob.path_constraints(z), jprob.path_constraints(jz), 1e-13)
    _close(prob.eq_path_constraints(z), jprob.eq_path_constraints(jz), 1e-13)
    _close(prob.objective(z), jprob.objective(jz), 1e-13)
    for got, want in zip(prob.zero_multipliers(), jprob.zero_multipliers()):
        assert tuple(got.shape) == tuple(want.shape)


def test_scatter_gn_blocks_soa_matches_jax():
    """The element-last scatter at the OCP shape b = 12 (d = 4, nv = 3, s =
    15), N = 6, nq = 1: exact."""
    rng = np.random.default_rng(2)
    n, s, nq, nv = 6, 15, 1, 3
    args = [rng.standard_normal(shape) for shape in
            ((s, s, n), (s, nq, n), (nq, nq), (s, n), (nq,))]
    want = jax_scatter(*map(jnp.asarray, args), num_blocks=n + 1, nv=nv,
                       overlap=nv, dtype=jnp.float64)
    got = scatter_gn_blocks_soa(*map(_t, args), num_blocks=n + 1, nv=nv,
                                overlap=nv, dtype=F64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_node_block_scatter_soa_matches_jax():
    """Per-node terms into the b = 12 blocks (d = 4, nv = 3, M = N d + 1 =
    25 nodes, K = 7 blocks, nq = 1): exact, and the input system is left as
    it was."""
    rng = np.random.default_rng(3)
    k, bd, nq, nv, d, m = 7, 12, 1, 3, 4, 25
    sys_np = [rng.standard_normal(shape) for shape in
              ((bd, bd, k), (bd, bd, k), (bd, nq, k), (nq, nq), (bd, k),
               (nq,))]
    node = [rng.standard_normal(shape) for shape in
            ((nv, nv, m), (nv, nq, m), (nv, m))]
    want = jax_node_scatter(JaxSystem(*map(jnp.asarray, sys_np)),
                            *map(jnp.asarray, node), d)
    sys_ = BlockTriSystemSoA(*map(_t, sys_np))
    got = node_block_scatter_soa(sys_, *map(_t, node), d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for before, after in zip(sys_np, sys_):
        np.testing.assert_array_equal(after.numpy(), before)


def _rosenbrock_loops(accept_mode, alpha):
    """The LM loop of both packages on the 2-D Rosenbrock least squares
    r = (10 (y - x^2), 1 - x) with a fixed step fraction ``alpha``: the
    Gauss-Newton step, damping lam (r.r-scaled) and the float64 cost."""

    def parts(xy, lam, np_):
        x, y = xy
        r = np_.stack([10.0 * (y - x * x), 1.0 - x])
        J = np_.stack([np_.stack([-20.0 * x, 10.0 + 0.0 * x]),
                       np_.stack([-1.0 + 0.0 * x, 0.0 * x])])
        H, g = J.T @ J, J.T @ r
        dmax = np_.max(np_.stack([H[0, 0], H[1, 1]]))
        return H, g, dmax

    def port_trial(z, carry, lam):
        H, g, dmax = parts(z, lam, torch)
        s = torch.linalg.solve(H + lam * dmax * torch.eye(2, dtype=F64), -g)
        z_try = z + alpha * s
        x, y = z_try
        ct = 0.5 * ((10.0 * (y - x * x))**2 + (1.0 - x)**2)
        return z_try, carry, ct, LMAux(
            gnorm=g.abs().max(), gdot=g @ s, sds=dmax * (s @ s),
            step_norm=alpha * torch.sqrt(s @ s),
            alpha=torch.as_tensor(alpha, dtype=F64))

    def jax_trial(z, carry, lam):
        H, g, dmax = parts(z, lam, jnp)
        s = jnp.linalg.solve(H + lam * dmax * jnp.eye(2), -g)
        z_try = z + alpha * s
        x, y = z_try
        ct = 0.5 * ((10.0 * (y - x * x))**2 + (1.0 - x)**2)
        return z_try, carry, doubleword.DW(ct, jnp.zeros(())), JaxLMAux(
            gnorm=jnp.max(jnp.abs(g)), gdot=g @ s, sds=dmax * (s @ s),
            step_norm=alpha * jnp.sqrt(s @ s), alpha=jnp.asarray(alpha))

    z0 = np.array([-1.2, 1.0])
    c0 = 0.5 * ((10.0 * (1.0 - 1.44))**2 + 2.2**2)
    kw = dict(maxiter=25, lam0=1e-3, gtol=1e-12, accept_mode=accept_mode)
    st = lm_loop(_t(z0), (), torch.as_tensor(c0, dtype=F64), port_trial,
                 dtype=F64, **kw)
    jst = jax_lm_loop(jnp.asarray(z0), (),
                      doubleword.DW(jnp.asarray(c0), jnp.zeros(())),
                      jax_trial, dtype=jnp.float64, **kw)
    return st, jst


@pytest.mark.parametrize("alpha", [1.0, 0.6])
@pytest.mark.parametrize("accept_mode", ["decrease", "gain"])
def test_lm_loop_modes_and_alpha_match_jax(accept_mode, alpha):
    """The decrease-mode ladder and the gain-ratio schedule, each with alpha
    entering the predicted decrease: the per-iteration history (cost,
    gradient norm, lam, step norm, accepted) and the final iterate within
    1e-9 of the JAX package's loop on Rosenbrock."""
    st, jst = _rosenbrock_loops(accept_mode, alpha)
    assert int(st.it) == int(jst.it)
    _close(st.history, jst.history, 1e-9)
    _close(st.z, jst.z, 1e-9)
    assert float(st.history[:, 4].sum()) > 0          # it moved


@pytest.mark.parametrize("first_feasible", [0, 3, 29, 30, None])
def test_batched_line_search_matches_while_loop(first_feasible):
    """first_feasible_alpha against the JAX package's while_loop (the
    halving loop of solve.auglag.line_search_alpha, with the same
    feasibility test): candidate j = alpha0 2^-j is feasible from
    ``first_feasible`` on (None: none is, and the loop stops after 30
    halvings on an infeasible alpha).  Exact."""
    alpha0 = 0.8123456789
    thresh = -np.inf if first_feasible is None else \
        alpha0 * 0.5**first_feasible * (1 + 1e-9)
    max_backtrack = 30

    def cond(carry):
        alpha, it = carry
        g_try = jnp.stack([alpha - thresh, -alpha])
        return jnp.any(g_try >= 0) & (it < max_backtrack)

    want, _ = jax.lax.while_loop(
        cond, lambda c: (c[0] * 0.5, c[1] + 1),
        (jnp.asarray(alpha0), jnp.asarray(0, jnp.int32)))
    got = first_feasible_alpha(
        torch.as_tensor(alpha0, dtype=F64),
        backtrack_halvings(max_backtrack, F64, "cpu"),
        lambda a: (torch.stack([a - thresh, -a], dim=1) >= 0).any(dim=1))
    assert float(got) == float(want)


@pytest.mark.parametrize("k", [1, 3, 9, 26])
def test_spike_plain_versions_at_block_size_12(k):
    """The plain versions of kernels #1 and #2 at the OCP shape (b = 12,
    nq = 1 and r = 1) against the JAX package's plain reference of the same
    functions (solve_kkt_soa with spike=False; the block Thomas scan):
    within 1e-10."""
    s = random_kkt_system(k, 12, 1, seed=k)
    js = JaxSystem(*(jnp.asarray(a.numpy()) for a in
                     (s.D, s.E, s.B, s.C, s.gx, s.gp)))
    want = jax_solve_kkt_soa(js, 1e-3, with_dmax=True)
    got = spike.kkt_solve_spike_fused_ref(s.D, s.E, s.B, s.gx, s.C, s.gp, 1e-3)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)
    D, E, G = random_chain(k, 12, 1, seed=k + 1)
    aos = [jnp.asarray(a.permute(2, 0, 1).numpy()) for a in (D, E, G)]
    want = np.moveaxis(np.asarray(jax_scan(*aos)), 0, -1)
    _close(spike.blocktri_solve_spike_fused_ref(D, E, G), want, 1e-10)


# ---- whole solves ----------------------------------------------------------------


def _jax_run(jprob, options):
    z, st = jax_make_ocp_solver(jprob, options)(jprob.initial_guess())
    return np.asarray(z.V), np.asarray(z.p), np.asarray(st.history), st


def _hold_solve(prob, jax_out, options, method, p_tol=1e-6):
    """The port's solve on ``method`` against the JAX run: the objective and
    cviol of the first three outer rounds within 1e-9 (relative), the
    final objective, V and p within 1e-6."""
    V, p, hist, jst = jax_out
    z, st = make_ocp_solver(prob, options)(prob.initial_guess())
    _close(st.history[:3, :2], hist[:3, :2], 1e-9)
    _close(st.objective, jst.objective, 1e-6)
    _close(z.V, V, 1e-6)
    if p.size:
        _close(z.p, p, p_tol)
    return z, st


@pytest.fixture(scope="module")
def pendulum_jax():
    jprob = JaxOCP.build(JaxPendulum(), jax_uniform_mesh(0.0, 2.5, 25, 4),
                         x0=[0.0, 0.0], xf=[np.pi, 0.0])
    return _jax_run(jprob, JaxOptions(method="cr"))


@pytest.mark.parametrize("method", ["cr", "spike"])
def test_pendulum_swingup_matches_jax(pendulum_jax, method):
    """Config 3 itself (N = 25, b = 12, nq = 0), 14 outer rounds:
    tolerances of _hold_solve; feasible (cviol < 1e-8, g < 0) with the
    torque bound active (tests/test_ocp.py's bars)."""
    prob, _ = configs.build_config3_problem(25, dtype=F64, device="cpu")
    z, st = _hold_solve(prob, pendulum_jax, ALBarrierOptions(method=method),
                        method)
    u = z.V[:, 2].numpy()
    assert float(st.cviol) < 1e-8 and float(st.gviol) < 0
    assert 2.0 - 1e-2 < np.abs(u).max() <= 2.0 + 1e-6


@pytest.fixture(scope="module")
def split_jax():
    jprob = JaxOCP.build(JaxSplitActuator(), jax_uniform_mesh(0.0, 1.0, 4, 4),
                         x0=[0.0, 0.0], xf=[1.0, 0.0])
    return _jax_run(jprob, JaxOptions(n_outer=16, method="cr"))


@pytest.mark.parametrize("method", ["cr", "spike"])
def test_split_actuator_matches_jax(split_jax, method):
    """tests/test_ocp.py's equality-path-constraint model (nu = 2, ne = 1:
    b = 16) at N = 4, 16 outer rounds: tolerances of _hold_solve, and
    u1 = 2 u2 at every node within 1e-8."""
    prob = OptimalControlProblem.build(
        SplitActuator(), uniform_mesh(0.0, 1.0, 4, 4), x0=[0.0, 0.0],
        xf=[1.0, 0.0], dtype=F64, device="cpu")
    z, _ = _hold_solve(prob, split_jax, ALBarrierOptions(n_outer=16,
                                                         method=method),
                       method)
    np.testing.assert_allclose(z.V[:, 2].numpy(), 2.0 * z.V[:, 3].numpy(),
                               atol=1e-8)


@pytest.fixture(scope="module")
def free_time_jax():
    jprob, jftm = jax_free_time_ocp(JaxDoubleIntegrator(), 8, 4,
                                    x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
                                    time_weight=1.0)
    return _jax_run(jprob, JaxOptions(n_outer=16, method="cr"))


@pytest.mark.parametrize("method", ["cr", "spike"])
def test_free_time_matches_jax(free_time_jax, method):
    """The minimum-time double integrator (examples/min_time_ocp.py's
    model, N = 8; the horizon is the one parameter, b = 12, nq = 1), 16
    outer rounds: tolerances of _hold_solve (p, the log-horizon, within
    1e-6), and 2 - 1e-3 < tf < 1.06 x 2 (tests/test_ocp_time.py's
    bracket)."""
    prob, ftm = free_time_ocp(configs.DoubleIntegrator(), 8, 4,
                              x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
                              time_weight=1.0, dtype=F64, device="cpu")
    z, st = _hold_solve(prob, free_time_jax,
                        ALBarrierOptions(n_outer=16, method=method), method)
    tf = float(ftm.final_time(z.p))
    assert 2.0 - 1e-3 < tf < 2.0 * 1.06
    assert float(st.gviol) <= 1e-10


@pytest.fixture(scope="module")
def free_time_degree3_jax():
    jprob, jftm = jax_free_time_ocp(JaxDoubleIntegrator(), 8, 3,
                                    x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
                                    time_weight=1.0)
    out = _jax_run(jprob, JaxOptions(n_outer=16, method="cr"))
    return out, float(jftm.final_time(jnp.asarray(out[1])))


def test_free_time_at_degree_3_matches_jax(free_time_degree3_jax):
    """The minimum-time double integrator at tests/test_ocp_time.py:61's
    degree 3 (N = 8; [x; u] at 3 nodes an element and the horizon as the
    one parameter: b = 9, nq = 1, kernel #1 at (9, 1) on the card), 16
    outer rounds on 'spike' (its plain version here): tolerances of
    _hold_solve, and tf and the objective within 1e-9 (relative) of the
    JAX package's float64 run."""
    jax_out, jax_tf = free_time_degree3_jax
    prob, ftm = free_time_ocp(configs.DoubleIntegrator(), 8, 3,
                              x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
                              time_weight=1.0, dtype=F64, device="cpu")
    assert prob.mesh.degree * prob.nv == 9 and ftm.nq == 1
    z, st = _hold_solve(prob, jax_out, ALBarrierOptions(n_outer=16,
                                                        method="spike"),
                        "spike")
    _close(float(ftm.final_time(z.p)), jax_tf, 1e-9)
    _close(st.objective, jax_out[3].objective, 1e-9)
