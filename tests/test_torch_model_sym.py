"""Port parity, the symbolic front end: ``collocfem_tpu_torch.symbolic_model``
against the JAX package's ``symbolic_model`` on the same expressions and
inputs, one test for each case of tests/test_model_sym.py (f and h, the
Jacobians, a constant component and time, the optimal-control groups and the
validation, the end-to-end estimation, the terminal cost's refusal of 't'),
plus a float32 case that checks the dtypes.  float64 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from collocfem_tpu.model_sym import symbolic_model as jax_symbolic_model
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve.newton import make_gn_solver as jax_make_gn_solver
from collocfem_tpu.utils.simulate import rk4_trajectory as jax_rk4
from collocfem_tpu_torch import symbolic_model
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

F64 = torch.float64
VDP = dict(name="VanDerPolSym", states="x0 x1", inputs="u0", params="mu b",
           f=["x1", "mu*(1 - x0**2)*x1 - x0 + b*u0"], h=["x0"])
TOY = dict(name="Toy", states="a b", inputs="u0", params=None,
           f=["b", "u0"], g=["u0 - 2", "-u0 - 2"], g_eq=["a - b"],
           running_cost_residual=["u0"], terminal_cost_residual=["a - 1"])


def _both(spec):
    return symbolic_model(**spec)(), jax_symbolic_model(**spec)()


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_f_and_h_match_jax():
    sym, ref = _both(VDP)
    assert (sym.nx, sym.nu, sym.nq, sym.ny) == (ref.nx, ref.nu, ref.nq, 1)
    rng = np.random.default_rng(0)
    for _ in range(5):
        x, u = rng.standard_normal(2), rng.standard_normal(1)
        p, t = rng.uniform(0.1, 2.0, 2), float(rng.uniform(0, 10))
        for fn in ("f", "h"):
            _close(getattr(sym, fn)(_t(x), _t(u), _t(p), _t(t)),
                   getattr(ref, fn)(jnp.asarray(x), jnp.asarray(u),
                                    jnp.asarray(p), t))
        # The handwritten model agrees too.
        _close(sym.f(_t(x), _t(u), _t(p), t),
               VanDerPol().f(_t(x), _t(u), _t(p), _t(t)))


def test_jacobians_match_jax():
    sym, ref = _both(VDP)
    x, u, p = np.array([0.3, -1.2]), np.array([0.7]), np.array([1.0, 1.0])
    for arg in (0, 2):
        got = jacfwd(sym.f, argnums=arg)(_t(x), _t(u), _t(p), _t(0.0))
        want = jax.jacfwd(ref.f, argnums=arg)(jnp.asarray(x), jnp.asarray(u),
                                              jnp.asarray(p), 0.0)
        _close(got, want)


def test_constant_component_and_time_match_jax():
    spec = dict(name="Decay", states="x0", params="k", f=["-k*x0 + sin(t)"])
    sym, ref = _both(spec)
    args = (np.array([2.0]), np.zeros((0,)), np.array([0.5]))
    _close(sym.f(*map(_t, args), _t(np.pi / 2)),
           ref.f(*map(jnp.asarray, args), jnp.asarray(np.pi / 2)))
    _close(sym.h(_t([3.0]), _t(np.zeros(0)), _t([0.5]), 0.0), [3.0])
    const = symbolic_model(name="C", states="x0 x1", f=["2", "-x0"])()
    out = const.f(_t([1.0, 5.0]), _t(np.zeros(0)), _t(np.zeros(0)), 0.0)
    assert out.dtype == F64
    _close(out, jax_symbolic_model(name="C", states="x0 x1",
                                   f=["2", "-x0"])().f(
        jnp.asarray([1.0, 5.0]), jnp.zeros(0), jnp.zeros(0), 0.0))


def test_ocp_groups_and_validation_match_jax():
    sym, ref = _both(TOY)
    assert (sym.ng, sym.ne) == (ref.ng, ref.ne) == (2, 1)
    x, u, p = np.array([1.0, 1.0]), np.array([3.0]), np.zeros(0)
    for fn in ("g", "g_eq", "running_cost_residual"):
        _close(getattr(sym, fn)(_t(x), _t(u), _t(p), 0.0),
               getattr(ref, fn)(jnp.asarray(x), jnp.asarray(u),
                                jnp.asarray(p), 0.0))
    _close(sym.terminal_cost_residual(_t(x), _t(p)),
           ref.terminal_cost_residual(jnp.asarray(x), jnp.asarray(p)))
    with pytest.raises(ValueError, match="undeclared"):
        symbolic_model(name="Bad", states="x0", f=["x0 + y"])
    with pytest.raises(ValueError, match="components"):
        symbolic_model(name="Bad2", states="x0 x1", f=["x0"])
    with pytest.raises(ValueError, match="inputs"):
        symbolic_model(name="Bad3", states="x0", inputs="u0", f=["u0"],
                       terminal_cost_residual=["u0"])


def test_terminal_cost_rejects_time():
    with pytest.raises(ValueError, match="'t'"):
        symbolic_model(name="BadT", states="x0", f=["-x0"],
                       terminal_cost_residual=["x0 - t"])


def test_end_to_end_estimation_matches_jax():
    """tests/test_model_sym.py's estimation (degree 2, 48 elements, 80
    noisy samples): the port's make_gn_solver with the symbolic model
    against the JAX package's with its own, p within 1e-9."""
    jmodel = jax_symbolic_model(**VDP)()
    tf = 6.0
    jmesh = jax_uniform_mesh(0.0, tf, 48, 2)
    t_meas = np.linspace(0.1, tf - 0.1, 80)
    t_fine = np.linspace(0.0, tf, 2001)
    xs = jax_rk4(jmodel.f, jnp.array([1.0, 0.0]), t_fine,
                 u_fn=lambda t: jnp.sin(0.9 * t)[None],
                 p=jnp.array([1.0, 1.0]))
    y = np.interp(t_meas, t_fine, np.asarray(xs[:, 0]))[:, None]
    y = y + 0.01 * np.random.default_rng(1).standard_normal(np.shape(y))
    u_nodes = np.sin(0.9 * np.asarray(jmesh.elem_times))[..., None]

    jprob = JaxProblem.build(jmodel, jmesh, t_meas, defect_weight=100.0)
    jz, _ = jax_make_gn_solver(jprob, JaxSolverOptions(maxiter=25,
                                                       gtol=1e-10))(
        jprob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5]),
        jprob.pack_data(y, t_meas, u_nodes=u_nodes))

    prob = EstimationProblem.build(symbolic_model(**VDP)(),
                                   uniform_mesh(0.0, tf, 48, 2), t_meas,
                                   defect_weight=100.0, device="cpu",
                                   dtype=F64)
    z, stats = make_gn_solver(prob, SolverOptions(maxiter=25, gtol=1e-10))(
        prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5]),
        prob.pack_data(y, t_meas, u_nodes=u_nodes))
    np.testing.assert_allclose(z.p.numpy(), np.asarray(jz.p), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(z.p.numpy(), [1.0, 1.0], atol=0.08)


def test_float32_keeps_the_working_dtype():
    """Every output and Jacobian of a float32 call is float32, also for a
    constant component and for 0-d arithmetic with a Python number (x0 -
    2.0, 2.5*u0), where jacfwd of 0-d tensors gives float64."""
    m = symbolic_model(name="D", states="x0 x1", inputs="u0", params="k",
                       f=["x1", "2"], h=["x0 - 2.0"], g=["2.5*u0*x0 - k"])()
    f32 = torch.float32
    args = (_t([1.0, 2.0], f32), _t([3.0], f32), _t([0.5], f32),
            _t(0.1, f32))
    for fn in (m.f, m.h, m.g):
        assert fn(*args).dtype == f32
        assert fn(*args[:3], 0.3).dtype == f32
        for j in jacfwd(fn, argnums=(0, 1, 2))(*args):
            assert j.dtype == f32
