"""Port parity, configs 2 and 4: the Duffing and aircraft models, the nu = 0
and time-dependent residual, the assembled systems, Gauss-Newton solves at
small size, and the full-size set-ups of ``collocfem_tpu_torch.configs``
against what ``benchmarks/configs_bench.py`` builds through the JAX package
(float64, on the CPU)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.models import AircraftLongitudinal as JaxAircraft
from collocfem_tpu.models import Duffing as JaxDuffing
from collocfem_tpu.ops.assemble import assemble_gn_soa as jax_assemble
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import Decision as JaxDecision
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve.newton import make_gn_solver as jax_make_gn_solver
from collocfem_tpu.utils.io import load_measurements as jax_load
from collocfem_tpu_torch import configs
from collocfem_tpu_torch.convert import data_from_numpy, decision_from_numpy
from collocfem_tpu_torch.models import AircraftLongitudinal, Duffing
from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
from collocfem_tpu_torch.utils.io import load_measurements

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "examples", "data", "aircraft_doublet.csv")


def _close(got, want, tol):
    """Relative tolerance ``tol`` with an absolute floor of tol x the
    array's magnitude (entries that cancel to nearly zero)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _example(name):
    """The module examples/<name>.py (numpy constants and generators)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["duffing", "aircraft"])
def test_models_match(which):
    """f and h of both packages on 32 seeded (x, u, p, t): within 1e-13;
    ny equal."""
    if which == "duffing":
        jm, tm = JaxDuffing(gamma=8.0, omega=0.5), Duffing(gamma=8.0, omega=0.5)
    else:
        jm, tm = JaxAircraft(V=60.0, g0=9.81), AircraftLongitudinal(60.0, 9.81)
    assert (tm.nx, tm.nu, tm.nq, tm.ny) == (jm.nx, jm.nu, jm.nq, jm.ny)
    rng = np.random.default_rng(11)
    for _ in range(32):
        x, u = rng.standard_normal(tm.nx), rng.standard_normal(tm.nu)
        p, t = rng.uniform(-3, 3, tm.nq), rng.uniform(0, 20)
        args = [torch.as_tensor(a, dtype=F64) for a in (x, u, p, t)]
        jargs = [jnp.asarray(a) for a in (x, u, p, t)]
        for fn in ("f", "h"):
            _close(getattr(tm, fn)(*args), getattr(jm, fn)(*jargs), 1e-13)


# ---- the full-size set-ups of benchmarks/configs_bench.py, through JAX -------


def _jax_config2():
    dj = _example("duffing_joint")
    rng = np.random.default_rng(7)
    ts, xs = dj.simulate_sde(rng, dj.TF)
    t_meas = np.linspace(0.05, dj.TF - 0.05, 2000)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += dj.MEAS_NOISE * rng.standard_normal(y.shape)
    prob = JaxProblem.build(
        JaxDuffing(gamma=dj.GAMMA, omega=dj.OMEGA),
        jax_uniform_mesh(0.0, dj.TF, 1000, 4), t_meas,
        defect_weight=1.0 / dj.PROC_NOISE)
    data = prob.pack_data(y, t_meas, meas_weight=1.0 / dj.MEAS_NOISE,
                          p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
    return prob, prob.initial_guess_from_data(t_meas, y,
                                              p0=[0.5, 1.0, 0.5]), data


def _jax_config4():
    t_meas, vals = jax_load(RECORD)
    y, u_rec = vals[:, :3], vals[:, 3]
    noise = np.array([0.002, 0.005, 0.05])
    mesh = jax_uniform_mesh(0.0, 8.0, 200, 4)
    prob = JaxProblem.build(JaxAircraft(V=60.0, g0=9.81), mesh, t_meas,
                            defect_weight=1e4)
    u_nodes = np.interp(mesh.elem_times, t_meas, u_rec)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes, meas_weight=1.0 / noise)
    return prob, prob.initial_guess_from_data(
        t_meas, y[:, :2], p0=[-1.0, -5.0, -1.0, -0.1, -5.0]), data


SETUPS = {"config2": (_jax_config2, configs.build_config2_problem),
          "config4": (_jax_config4, configs.build_config4_problem)}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def config_pair(request):
    jax_build, port_build = SETUPS[request.param]
    return jax_build(), port_build(dtype=F64, device="cpu")


def test_config_setups_match_bit_for_bit(config_pair):
    """y, u, the weights, the priors and z0 of configs.build_config*_problem
    equal the JAX package's set-up bit for bit."""
    (_, jz0, jdata), (_, tz0, tdata) = config_pair
    for got, want in zip(tdata, jdata):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tz0.V.numpy(), np.asarray(jz0.V))
    np.testing.assert_array_equal(tz0.p.numpy(), np.asarray(jz0.p))


def test_config_residual_and_system_match(config_pair):
    """At a seeded iterate: one element's residual (the live t of Duffing's
    forcing, config 2's nu = 0 inputs) and every leaf of the assembled SoA
    system and its cost, within 1e-10 of the JAX package's."""
    (jprob, jz0, jdata), (tprob, tz0, tdata) = config_pair
    rng = np.random.default_rng(3)
    V = np.asarray(jz0.V) + 0.1 * rng.standard_normal(np.shape(jz0.V))
    p = np.asarray(jz0.p) * rng.uniform(0.8, 1.2, np.size(jz0.p))
    jz = JaxDecision(V=jnp.asarray(V), p=jnp.asarray(p))
    tz = decision_from_numpy(V, p, "cpu", F64)
    e = tprob.mesh.num_elements // 3
    jed, ted = jprob._elem_data(jdata), tprob._elem_data(tdata)
    _close(tprob.elem_residual(tprob.gather_elements(tz.V)[e], tz.p,
                               type(ted)(*(a[e] for a in ted))),
           jprob.elem_residual(jprob.gather_elements(jz.V)[e], jz.p,
                               type(jed)(*(a[e] for a in jed))), 1e-10)
    jsys, jcost = jax_assemble(jprob, jz, jdata, with_cost=True)
    tsys, tcost = assemble_gn_soa(tprob, tz, tdata, with_cost=True)
    for name in ("D", "E", "B", "C", "gx", "gp"):
        _close(getattr(tsys, name), getattr(jsys, name), 1e-10)
    _close(tcost, float(jcost.hi) + float(jcost.lo), 1e-10)


# ---- Gauss-Newton at tests/test_configs.py's sizes ----------------------------


def _duffing_pair():
    """Duffing over [0, 10] on 200 elements of degree 2, 300 samples of a
    seeded SDE path."""
    ts, xs = configs.simulate_sde(np.random.default_rng(2), 10.0)
    t_meas = np.linspace(0.05, 9.95, 300)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += 0.01 * np.random.default_rng(3).standard_normal(y.shape)
    kw = dict(defect_weight=1.0 / configs.PROC_NOISE)
    jprob = JaxProblem.build(JaxDuffing(gamma=8.0, omega=0.5),
                             jax_uniform_mesh(0.0, 10.0, 200, 2), t_meas, **kw)
    tprob = EstimationProblem.build(Duffing(gamma=8.0, omega=0.5),
                                    uniform_mesh(0.0, 10.0, 200, 2), t_meas,
                                    device="cpu", dtype=F64, **kw)
    jdata = jprob.pack_data(y, t_meas, meas_weight=100.0, p_weight=1e-3)
    return jprob, tprob, jdata, jprob.initial_guess_from_data(
        t_meas, y, p0=list(configs.P2_0))


def _aircraft_pair():
    """The aircraft model over [0, 6] on 240 elements of degree 2, the
    flight record's samples before t = 6."""
    t_all, vals = load_measurements(RECORD)
    keep = t_all < 5.99
    t_meas, y, u_rec = t_all[keep], vals[keep, :3], vals[:, 3]
    jprob = JaxProblem.build(JaxAircraft(V=60.0, g0=9.81),
                             jax_uniform_mesh(0.0, 6.0, 240, 2), t_meas,
                             defect_weight=1e4)
    tprob = EstimationProblem.build(AircraftLongitudinal(60.0, 9.81),
                                    uniform_mesh(0.0, 6.0, 240, 2), t_meas,
                                    defect_weight=1e4, device="cpu", dtype=F64)
    u_nodes = np.interp(jprob.mesh.elem_times, t_all, u_rec)[..., None]
    jdata = jprob.pack_data(y, t_meas, u_nodes=u_nodes,
                            meas_weight=1.0 / np.array(configs.NOISE4))
    return jprob, tprob, jdata, jprob.initial_guess_from_data(
        t_meas, y[:, :2], p0=list(configs.P4_0))


@pytest.mark.parametrize("pair", [_duffing_pair, _aircraft_pair],
                         ids=["duffing", "aircraft"])
def test_gn_solve_matches_jax(pair):
    """make_gn_solver(method='cr'), 6 fixed-work LM iterations, float64, from
    the same iterate and data: V, p and the cost within 1e-9."""
    jprob, tprob, jdata, jz0 = pair()
    tdata = data_from_numpy(*map(np.asarray, jdata), device="cpu", dtype=F64)
    tz0 = decision_from_numpy(jz0.V, jz0.p, "cpu", F64)
    opts = dict(maxiter=6, gtol=0.0, lam0=1e-6, method="cr")
    jz, jst = jax_make_gn_solver(jprob, JaxSolverOptions(**opts))(jz0, jdata)
    tz, tst = make_gn_solver(tprob, SolverOptions(**opts))(tz0, tdata)
    np.testing.assert_array_equal(tst.history.numpy()[:, 4],
                                  np.asarray(jst.history)[:, 4])
    assert float(tst.cost) < float(tprob.cost(tz0, tdata))
    _close(tz.V, jz.V, 1e-9)
    _close(tz.p, jz.p, 1e-9)
    _close(tst.cost, jst.cost, 1e-9)
