"""Port parity, the online estimator: ``defect_rule='full'``, the full
sqrt-information x0 prior in every assembly, and
``collocfem_tpu_torch.mhe.MovingHorizonEstimator`` against ``collocfem_tpu``
in float64 on the CPU.

Assembly leaves within 1e-12 (relative, with that floor on the leaf's
magnitude); MHE estimates and ``current_covariance`` within 1e-8 of the JAX
package's at every step (the linear set-up of ``tests/test_mhe.py`` and a
Van der Pol stream at degree 3); the full-rule smoother parity of
``tests/test_kalman_parity.py`` at its own bar (1.5e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.kalman.disc import van_loan as jax_van_loan
from collocfem_tpu.mhe import MovingHorizonEstimator as JaxMHE
from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.models.lti import LinearSystem as JaxLinearSystem
from collocfem_tpu.ops import assemble as ja
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import Decision as JaxDecision
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve.newton import SolverOptions as JaxOptions
from collocfem_tpu_torch.convert import data_from_numpy, decision_from_numpy
from collocfem_tpu_torch.kalman import kalman_filter, van_loan
from collocfem_tpu_torch.mhe import MovingHorizonEstimator
from collocfem_tpu_torch.models import LinearSystem, VanDerPol
from collocfem_tpu_torch.ops import assemble as ta
from collocfem_tpu_torch.ops.basis import make_basis
from collocfem_tpu_torch.ops.mesh import Mesh, interpolate_trajectory
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

F64 = torch.float64
RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _pair(rule, full_prior, n=7, d=3):
    """The same Van der Pol problem (``rule``), data and seeded iterate in
    both packages; the x0 prior a full lower-triangular sqrt-information
    matrix or per-state weights."""
    rng = np.random.default_rng(n + d)
    tf = 3.0
    t_meas = np.sort(rng.uniform(0.0, tf, 3 * n))
    y = np.sin(t_meas)[:, None] + 0.01 * rng.standard_normal((3 * n, 1))
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, n, d),
                             t_meas, defect_weight=[30.0, 3.0],
                             defect_rule=rule)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, n, d),
                                    t_meas, defect_weight=[30.0, 3.0],
                                    device="cpu", dtype=F64, defect_rule=rule)
    x0w = (np.array([[2.0, 0.0], [-0.7, 1.5]]) if full_prior
           else np.array([0.5, 0.25]))
    kw = dict(u_nodes=np.cos(0.7 * jprob.mesh.elem_times)[..., None],
              meas_weight=2.0, p_prior=[1.0, 0.8], p_weight=0.1,
              x0_prior=[0.1, 0.9], x0_weight=x0w)
    jdata = jprob.pack_data(y, t_meas, **kw)
    tdata = tprob.pack_data(y, t_meas, **kw)
    V = rng.standard_normal((jprob.num_nodes, 2))
    p = rng.uniform(0.5, 1.5, 2)
    return (jprob, JaxDecision(V=jnp.asarray(V), p=jnp.asarray(p)), jdata,
            tprob, decision_from_numpy(V, p, "cpu", F64), tdata)


def _hold_system(tsys, jsys):
    for name in ("D", "E", "B", "C", "gx", "gp"):
        got, want = getattr(tsys, name), getattr(jsys, name)
        assert tuple(got.shape) == np.shape(want), name
        _close(got, want)


@pytest.mark.parametrize("full_prior", [False, True])
@pytest.mark.parametrize("rule", ["interior", "full"])
def test_residuals_and_assemblies_match_jax(rule, full_prior):
    """The element residual (d+1 defect rows per state under 'full'), the
    residual vector and cost, assemble_gn_soa, assemble_gn and the exact
    Newton assembly against the JAX package's."""
    jprob, jz, jdata, tprob, tz, tdata = _pair(rule, full_prior)
    d, nx = tprob.mesh.degree, 2
    rows = (d + 1 if rule == "full" else d) * nx
    assert tprob.dscale.shape == (7, rows // nx, nx)
    r = tprob.residual_vector(tz, tdata)
    _close(r, jprob.residual_vector(jz, jdata))
    assert r.numel() == 7 * (rows + tprob.mrows.shape[1]) + 2 + 2
    _close(tprob.cost(tz, tdata), jprob.cost(jz, jdata))
    tsys, tcost = ta.assemble_gn_soa(tprob, tz, tdata, with_cost=True)
    jsys, jcost = ja.assemble_gn_soa(jprob, jz, jdata, with_cost=True)
    _hold_system(tsys, jsys)
    _close(tcost, float(jcost.hi) + float(jcost.lo))
    _hold_system(ta.assemble_gn(tprob, tz, tdata),
                 ja.assemble_gn(jprob, jz, jdata))
    _hold_system(ta.assemble_newton(tprob, tz, tdata),
                 ja.assemble_newton_soa(jprob, jz, jdata))


@pytest.mark.parametrize("full_prior", [False, True])
def test_batched_assemblies_match_jax(full_prior):
    """assemble_gn_batched and assemble_gn_soa_batched under the 'full'
    rule, with a per-experiment x0 prior, against the JAX package's
    vmap(assemble_gn) and assemble_gn_soa_batched."""
    jprob, jz, jdata, tprob, tz, _ = _pair("full", full_prior)
    n_exp = 3
    rng = np.random.default_rng(1)
    Vb = np.asarray(jz.V)[None] + 0.1 * rng.standard_normal(
        (n_exp,) + jz.V.shape)
    scale = np.array([1.0, 0.5, 2.0])
    leaves = [np.stack([np.asarray(x)] * n_exp) for x in jdata]
    leaves[6] = leaves[6] * scale.reshape((n_exp,) + (1,) * (leaves[6].ndim
                                                             - 1))
    jbatch = type(jdata)(*(jnp.asarray(x) for x in leaves))
    tbatch = data_from_numpy(*leaves, device="cpu", dtype=F64)
    tVb = torch.as_tensor(Vb)
    got, tcost = ta.assemble_gn_batched(tprob, tVb, tz.p, tbatch,
                                        with_cost=True)
    want = jax.vmap(lambda V, dat: ja.assemble_gn(
        jprob, JaxDecision(V=V, p=jz.p), dat))(jnp.asarray(Vb), jbatch)
    _hold_system(got, want)
    jcost = sum(float(jprob.cost(JaxDecision(V=jnp.asarray(Vb[e]), p=jz.p),
                                 type(jdata)(*(x[e] for x in jbatch))))
                for e in range(n_exp))
    _close(tcost, jcost)
    got = ta.assemble_gn_soa_batched(tprob, tVb, tz.p, tbatch)
    _hold_system(got, ja.assemble_gn_soa_batched(jprob, jnp.asarray(Vb),
                                                 jz.p, jbatch))


def _sim_linear(A, Qd, C, R, m0, P0, T, rng):
    nx, ny = A.shape[0], C.shape[0]
    x = rng.multivariate_normal(m0, P0)
    ys = []
    for _ in range(T):
        ys.append(C @ x + rng.multivariate_normal(np.zeros(ny), R))
        x = A @ x + rng.multivariate_normal(np.zeros(nx), Qd)
    return np.asarray(ys)


def _run(mhe, ys, horizon, m0, P0, to_numpy):
    state = mhe.init(ys[:horizon], m0=m0, P0=P0)
    ests = [to_numpy(mhe.estimate(state))]
    for k in range(horizon, ys.shape[0]):
        state, est = mhe.step(state, ys[k])
        ests.append(to_numpy(est))
    return np.asarray(ests), to_numpy(mhe.current_covariance(state))


def test_linear_mhe_matches_jax_and_the_kalman_filter():
    """tests/test_mhe.py's linear set-up (horizon 8, degree 4, substeps 8,
    'cr'), T = 16: each step's estimate and the final covariance within
    1e-8 of the JAX package's, and within 2e-6 of the port's own Kalman
    filter (the JAX test's bar)."""
    rng = np.random.default_rng(7)
    A = np.array([[0.0, 1.0], [-2.0, -0.4]])
    C = np.array([[1.0, 0.0]])
    dt, sig_w, sig_v = 0.1, 0.4, 0.05
    Qc = np.diag([sig_w**2, sig_w**2])
    Ad, Qd = (np.asarray(a) for a in jax_van_loan(A, Qc, dt))
    R = np.array([[sig_v**2]])
    m0, P0 = np.array([0.3, -0.2]), 0.5 * np.eye(2)
    T, H = 16, 8
    ys = _sim_linear(Ad, Qd, C, R, m0, P0, T, rng)
    kw = dict(horizon=H, dt=dt, sig_w=sig_w, sig_v=sig_v, degree=4,
              substeps=8)
    jests, jcov = _run(JaxMHE(JaxLinearSystem(A, C=C), **kw, options=JaxOptions(
        maxiter=30, gtol=1e-12, method="cr")), ys, H, m0, P0, np.asarray)
    ests, cov = _run(MovingHorizonEstimator(
        LinearSystem(A, C=C), **kw, options=SolverOptions(
            maxiter=30, gtol=1e-12, method="cr"), device="cpu"),
        ys, H, m0, P0, lambda t: t.numpy())
    np.testing.assert_allclose(ests, jests, rtol=0, atol=1e-8)
    np.testing.assert_allclose(cov, jcov, rtol=0, atol=1e-8)

    tAd, tQd = van_loan(torch.as_tensor(A), torch.as_tensor(Qc), dt)
    Ad_seq = torch.cat([torch.eye(2, dtype=F64)[None], tAd.expand(T - 1, 2, 2)])
    Qd_seq = torch.cat([torch.zeros(1, 2, 2, dtype=F64),
                        tQd.expand(T - 1, 2, 2)])
    kf = kalman_filter(Ad_seq, Qd_seq, C, R, torch.as_tensor(ys), m0, P0,
                       device="cpu")
    np.testing.assert_allclose(ests, kf.mean_f[H - 1:].numpy(), atol=2e-6)
    np.testing.assert_allclose(cov, kf.cov_f[-1].numpy(), atol=2e-6)


def test_vdp_mhe_matches_jax():
    """A Van der Pol stream at degree 3 (b = 6), horizon 6, 10 steps, on
    'auto' (the plain chain solve on the CPU): each estimate and the final
    covariance within 1e-8 of the JAX package's."""
    dt, sig_v, H = 0.05, 0.02, 6
    ts = np.arange(H + 10) * dt
    rng = np.random.default_rng(0)
    ys = (2.0 * np.cos(ts) + sig_v * rng.standard_normal(ts.size))[:, None]
    kw = dict(horizon=H, dt=dt, sig_w=0.5, sig_v=sig_v, degree=3,
              p_fixed=np.array([1.0, 1.0]))
    m0, P0 = np.array([1.5, 0.5]), np.eye(2)
    jests, jcov = _run(JaxMHE(JaxVanDerPol(), **kw, options=JaxOptions(
        maxiter=20, gtol=1e-9)), ys, H, m0, P0, np.asarray)
    ests, cov = _run(MovingHorizonEstimator(
        VanDerPol(), **kw, options=SolverOptions(maxiter=20, gtol=1e-9),
        device="cpu"), ys, H, m0, P0, lambda t: t.numpy())
    assert ests.shape == (11, 2)
    np.testing.assert_allclose(ests, jests, rtol=0, atol=1e-8)
    np.testing.assert_allclose(cov, jcov, rtol=0, atol=1e-8)


def test_mhe_rejects_bad_inputs():
    """tests/test_mhe.py's cases: unknown parameters without p_fixed, a
    one-sample horizon, a wrong window shape; and a p_fixed of the wrong
    length."""
    with pytest.raises(ValueError):
        MovingHorizonEstimator(VanDerPol(), horizon=5, dt=0.1, sig_w=1.0,
                               sig_v=1.0, device="cpu")
    with pytest.raises(ValueError):
        MovingHorizonEstimator(LinearSystem(np.eye(2)), horizon=1, dt=0.1,
                               sig_w=1.0, sig_v=1.0, device="cpu")
    with pytest.raises(ValueError):
        MovingHorizonEstimator(VanDerPol(), horizon=5, dt=0.1, sig_w=1.0,
                               sig_v=1.0, p_fixed=[1.0], device="cpu")
    mhe = MovingHorizonEstimator(LinearSystem(np.eye(2)), horizon=4, dt=0.1,
                                 sig_w=1.0, sig_v=1.0, device="cpu")
    with pytest.raises(ValueError):
        mhe.init(np.zeros((3, 2)), m0=np.zeros(2), P0=np.eye(2))


def test_full_defect_rule_smoother_parity():
    """tests/test_kalman_parity.py:123: under defect_rule='full' the MAP
    path of the linear-Gaussian problem (60 samples, elements between
    them, degree 4) converges and lies within 1.5e-3 of the numpy RTS
    smoother."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_kalman_parity import A, SIG_V, SIG_W, _simulate_and_smooth

    t_meas, y, x_smooth = _simulate_and_smooth(np.random.default_rng(7))
    mesh = Mesh(make_basis(4), t_meas)
    prob = EstimationProblem.build(
        LinearSystem(A, C=np.array([[1.0, 0.0]])), mesh, t_meas,
        defect_weight=[1e3, 1.0 / SIG_W], defect_rule="full", device="cpu",
        dtype=F64)
    data = prob.pack_data(y[:, None], t_meas, meas_weight=1.0 / SIG_V)
    z0 = prob.initial_guess_from_data(t_meas, y[:, None], p0=np.zeros(0))
    z, stats = make_gn_solver(
        prob, SolverOptions(maxiter=30, gtol=1e-8, xtol=1e-12))(z0, data)
    assert bool(stats.converged)
    x_map = interpolate_trajectory(mesh, z.V, t_meas).numpy()
    assert np.max(np.abs(x_map - x_smooth)) < 1.5e-3
