"""Port parity, the Kalman tier: ``collocfem_tpu_torch.kalman`` (Van Loan
discretization, the linear KF / RTS pair, both square-root forms, the
continuous-discrete EKF and UKF with ``cd_smoother``, the PEM likelihoods
and their gradients, ``run_lbfgs`` and ``smoother_initial_guess``) and
``utils.simulate.rk4_trajectory`` against ``collocfem_tpu`` on the same
seeded numpy inputs, float64 on the CPU.  The set-ups are those of
``tests/test_kalman.py``.  Tolerances (absolute on values of order one,
relative on the likelihoods): 1e-12 for the discretization, 1e-10 for the
linear filters, 1e-9 for the nonlinear filters, the likelihoods and their
gradients; run_lbfgs's optimum within 1e-5 of the JAX package's and its
NLL within 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu import kalman as jk
from collocfem_tpu.models import Duffing as JaxDuffing
from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.models.lti import LinearSystem as JaxLinearSystem
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.utils.simulate import rk4_trajectory as jax_rk4
from collocfem_tpu_torch import kalman as tk
from collocfem_tpu_torch.models import Duffing, LinearSystem, VanDerPol
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.utils.simulate import rk4_trajectory

F64 = torch.float64
A = np.array([[0.0, 1.0], [-4.0, -0.4]])
QC = np.array([[0.0, 0.0], [0.0, 0.15**2]])
H = np.array([[1.0, 0.0]])
R = np.array([[0.05**2]])
M0 = np.array([0.8, 0.2])
P0 = np.eye(2) * 4.0


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _problem(rng, T=50, irregular=True):
    """tests/test_kalman.py's damped oscillator, exactly discretized by the
    JAX package: (ts, y, Ad, Qd)."""
    ts = (np.cumsum(0.05 + 0.1 * rng.random(T)) if irregular
          else 0.1 * np.arange(1, T + 1))
    dts = np.diff(ts, prepend=ts[:1])
    Ad, Qd = (np.asarray(a) for a in jk.discretize_lti(A, QC, dts))
    x = np.array([1.0, 0.0])
    ys = []
    for k in range(T):
        x = Ad[k] @ x + np.linalg.cholesky(
            Qd[k] + 1e-14 * np.eye(2)) @ rng.standard_normal(2)
        ys.append(H @ x + 0.05 * rng.standard_normal(1))
    return ts, np.asarray(ys), Ad, Qd


def _vdp_series(T=40, seed=9):
    """Noisy Van der Pol positions at T times in (0.1, 6), from the JAX
    package's RK4 truth."""
    rng = np.random.default_rng(seed)
    t_meas = np.linspace(0.1, 6.0, T)
    ts_fine = np.linspace(0.0, 6.0, 1201)
    xs = np.asarray(jax_rk4(
        JaxVanDerPol().f, jnp.array([2.0, 0.0]), jnp.asarray(ts_fine),
        u_fn=lambda t: jnp.zeros((1,)), p=jnp.array([1.0, 1.0])))
    y = np.interp(t_meas, ts_fine, xs[:, 0])[:, None]
    return t_meas, y + 0.02 * rng.standard_normal(y.shape)


def test_van_loan_and_discretize_match_jax():
    dts = np.random.default_rng(0).random(7) * 0.3
    dts[0] = 0.0
    Ad, Qd = tk.van_loan(_t(A), _t(QC), 0.17)
    jAd, jQd = jk.van_loan(A, QC, 0.17)
    _close(Ad, jAd, 1e-12)
    _close(Qd, jQd, 1e-12)
    Ad, Qd = tk.discretize_lti(_t(A), _t(QC), dts)
    jAd, jQd = jk.discretize_lti(A, QC, dts)
    _close(Ad, jAd, 1e-12)
    _close(Qd, jQd, 1e-12)
    assert torch.equal(Ad[0], torch.eye(2, dtype=F64))


def test_rk4_trajectory_matches_jax():
    ts = np.linspace(0.0, 3.0, 61)
    got = rk4_trajectory(VanDerPol().f, _t([2.0, 0.0]), ts,
                         u_fn=lambda t: torch.zeros(1, dtype=F64),
                         p=[1.0, 0.5], device="cpu")
    want = jax_rk4(JaxVanDerPol().f, jnp.array([2.0, 0.0]), jnp.asarray(ts),
                   u_fn=lambda t: jnp.zeros((1,)), p=jnp.array([1.0, 0.5]))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_kf_rts_and_sqrt_forms_match_jax(masked):
    rng = np.random.default_rng(2)
    ts, y, Ad, Qd = _problem(rng)
    mask = (np.arange(50) % 3 != 0).astype(float) if masked else None
    res = tk.kalman_filter(Ad, Qd, H, R, _t(y), M0, P0, mask=mask,
                           device="cpu")
    jres = jk.kalman_filter(Ad, Qd, H, R, y, M0, P0, mask=mask)
    for got, want in zip(res, jres):
        _close(got, want, 1e-10)
    for got, want in zip(tk.cd_smoother(res), jk.cd_smoother(jres)):
        _close(got, want, 1e-10)
    for got, want in zip(tk.rts_smoother(res), jk.rts_smoother(jres)):
        _close(got, want, 1e-10)
    sq = tk.sqrt_kalman_filter(Ad, Qd, H, R, _t(y), M0, P0, mask=mask,
                               device="cpu")
    jsq = jk.sqrt_kalman_filter(Ad, Qd, H, R, y, M0, P0, mask=mask)
    for got, want in zip(sq, jsq):
        _close(got, want, 1e-10)
    for got, want in zip(tk.sqrt_rts_smoother(sq, Ad, Qd),
                         jk.sqrt_rts_smoother(jsq, Ad, Qd)):
        _close(got, want, 1e-10)


def _nonlinear_cases():
    rng = np.random.default_rng(1)
    ts, y, _, _ = _problem(rng, T=40)
    lin = (LinearSystem(A, C=H), JaxLinearSystem(A, C=H), np.zeros(0), ts,
           y, R, QC, M0, P0, 8)
    t_v, y_v = _vdp_series()
    vdp = (VanDerPol(), JaxVanDerPol(), np.array([0.8, 0.9]), t_v, y_v,
           np.array([[0.02**2]]), np.diag([1e-6, 1e-2]),
           np.array([2.0, 0.0]), np.eye(2) * 0.1, 3)
    return {"linear": lin, "vdp": vdp}


@pytest.mark.parametrize("case", ["linear", "vdp"])
@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_nonlinear_filters_and_smoother_match_jax(case, kind):
    model, jmodel, p, ts, y, Rm, Qc, m0, P0_, sub = _nonlinear_cases()[case]
    filt, jfilt = getattr(tk, f"{kind}_filter"), getattr(jk, f"{kind}_filter")
    res = filt(model, p, ts, _t(y), Rm, Qc, m0, P0_, substeps=sub,
               device="cpu")
    jres = jfilt(jmodel, jnp.asarray(p), ts, y, Rm, Qc, m0, P0_,
                 substeps=sub)
    for got, want in zip(res[:5], jres[:5]):
        _close(got, want, 1e-9)
    np.testing.assert_allclose(float(res.loglik), float(jres.loglik),
                               rtol=1e-9)
    for got, want in zip(tk.cd_smoother(res), jk.cd_smoother(jres)):
        _close(got, want, 1e-9)


def _lti_build(xp):
    def build(p):
        if xp is jnp:
            Ap = jnp.array([[0.0, 1.0], [-p[0], -p[1]]])
            return (Ap, *(jnp.asarray(m) for m in (QC, H, R, M0, P0)))
        zero, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
        Ap = torch.stack([torch.stack([zero, one]),
                          torch.stack([-p[0], -p[1]])])
        return (Ap, *(_t(m) for m in (QC, H, R, M0, P0)))

    return build


def _value_and_grad(nll, p):
    x = _t(p).requires_grad_(True)
    v = nll(x)
    v.backward()
    return v.item(), x.grad.numpy()


def _hold_nll(nll, jnll, p):
    v, g = _value_and_grad(nll, p)
    jv, jg = jax.value_and_grad(jnll)(jnp.asarray(p))
    np.testing.assert_allclose(v, float(jv), rtol=1e-9)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-9,
                               atol=1e-9 * float(np.abs(jg).max()))


def test_pem_nlls_and_gradients_match_jax():
    """make_lti_nll, make_ekf_nll and make_ukf_nll: values and gradients."""
    rng = np.random.default_rng(5)
    ts, y, _, _ = _problem(rng, T=60, irregular=False)
    _hold_nll(tk.make_lti_nll(_lti_build(torch), ts, y, device="cpu"),
              jk.make_lti_nll(_lti_build(jnp), ts, y), [3.0, 1.0])
    t_v, y_v = _vdp_series()
    args = (t_v, y_v, np.array([[0.02**2]]), np.diag([1e-6, 1e-2]),
            np.array([2.0, 0.0]), np.eye(2) * 0.1)
    _hold_nll(tk.make_ekf_nll(VanDerPol(), *args, substeps=3, device="cpu"),
              jk.make_ekf_nll(JaxVanDerPol(), *args, substeps=3), [0.8, 0.9])
    _hold_nll(tk.make_ukf_nll(VanDerPol(), *args, substeps=3, device="cpu"),
              jk.make_ukf_nll(JaxVanDerPol(), *args, substeps=3), [0.8, 0.9])
    # The Duffing EKF of examples/pem_kalman.py, on a short record.
    t_d = np.linspace(0.05, 4.0, 40)
    y_d = np.cos(1.3 * t_d)[:, None] + 0.01 * rng.standard_normal((40, 1))
    args = (t_d, y_d, np.array([[1e-4]]), np.diag([1e-8, 0.05**2]),
            np.array([y_d[0, 0], 0.0]), np.diag([0.1, 4.0]))
    _hold_nll(tk.make_ekf_nll(Duffing(gamma=8.0, omega=0.5), *args,
                            device="cpu"),
              jk.make_ekf_nll(JaxDuffing(gamma=8.0, omega=0.5), *args),
              [0.5, 1.0, 0.5])


def test_run_lbfgs_reaches_the_jax_optimum():
    """tests/test_kalman.py's PEM problem (T = 400, regular grid): the
    optimum within 1e-5 of the JAX package's L-BFGS optimum, the NLL within
    1e-8 (relative), and the stats contract (value, gradient norm,
    iterations).  Every evaluation runs through the NLL's one scan plan (the
    step bodies that a CUDA device replays), whose value at the optimum is
    the tape-recording loop's within 1e-12."""
    rng = np.random.default_rng(5)
    ts, y, _, _ = _problem(rng, T=400, irregular=False)
    jnll = jk.make_lti_nll(_lti_build(jnp), ts, y)
    jp, (jval, _, _) = jk.run_lbfgs(jax.jit(jnll), jnp.array([3.0, 1.0]),
                                    maxiter=200)
    nll = tk.make_lti_nll(_lti_build(torch), ts, y, device="cpu")
    p, (val, gnorm, it) = tk.run_lbfgs(nll, _t([3.0, 1.0]), maxiter=200,
                                       device="cpu")
    assert isinstance(nll, tk.ScanNLL) and len(nll.scan._plans) == 1
    _close(p, jp, 1e-5)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-8)
    assert float(gnorm) <= 1e-8 and 0 < it < 200
    np.testing.assert_allclose(float(val), float(nll(p)), rtol=1e-15)
    np.testing.assert_allclose(float(val), float(nll.plain(p)), rtol=1e-12)


def test_run_lbfgs_evaluates_each_point_once():
    """The optimiser's re-evaluation at the accepted point and the stop
    test read the stored value and gradient: ``fun`` never runs twice at
    one point, and the path is that of re-evaluating."""
    rng = np.random.default_rng(5)
    ts, y, _, _ = _problem(rng, T=60, irregular=False)
    nll = tk.make_lti_nll(_lti_build(torch), ts, y, device="cpu")
    points = []

    def counted(x):
        points.append(x.detach().clone())
        return nll(x)

    p, (val, _, it) = tk.run_lbfgs(counted, [3.0, 1.0], maxiter=20,
                                   device="cpu")
    assert it > 0 and len(points) >= it + 1
    for i in range(len(points)):
        for j in range(i):
            assert not torch.equal(points[i], points[j])
    assert float(val) == float(nll(p))


def test_run_lbfgs_shortens_a_step_that_raises_the_value():
    """Rosenbrock's function from (-1.2, 1), whose first trial step raises
    the value: the line search shortens it (it has 20 trials a step) and
    L-BFGS reaches (1, 1) with ||g|| <= 1e-8, each point
    evaluated once."""
    points = []

    def rosenbrock(x):
        points.append(x.detach().clone())
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    p, (val, gnorm, it) = tk.run_lbfgs(rosenbrock, [-1.2, 1.0], maxiter=200,
                                       device="cpu")
    _close(p, [1.0, 1.0], 1e-8)
    assert float(gnorm) <= 1e-8 and 0 < it < 200 and float(val) < 1e-16
    assert len({tuple(q.tolist()) for q in points}) == len(points)


@pytest.mark.parametrize("x0", [[-1.2, 1.0], [2.0, -1.0], [0.0, 0.0]])
def test_run_lbfgs_searches_lines_as_the_jax_package_does(x0):
    """Rosenbrock's function, whose line searches bracket and zoom: the
    port's search picks optax's step sizes, so the run takes the JAX
    package's iteration count to gtol 1e-8 and lands within 1e-9 of its x."""
    rosenbrock = lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
    jx, (_, jgnorm, jit) = jk.run_lbfgs(jax.jit(rosenbrock), jnp.array(x0),
                                        maxiter=200)
    p, (_, gnorm, it) = tk.run_lbfgs(rosenbrock, x0, maxiter=200,
                                     device="cpu")
    assert it == int(jit) < 200
    np.testing.assert_allclose(p.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)


@pytest.mark.parametrize("gtol", [1e-2, 1e-6, 1e-10])
def test_run_lbfgs_stops_as_the_jax_package_does(gtol):
    """The JAX package's stop rule on f = 1/2 sum d_i (x_i - 1)^2, d = (1,
    2, 3, 5, 8), from x0 = 0 in float64: an iteration tests the gradient
    at the point it starts from and still takes its step, so the run takes
    JAX's iteration count, lands within 1e-9 of JAX's x and reports the
    same gradient norm (the last pre-step one) and the value at x."""
    d = np.array([1.0, 2.0, 3.0, 5.0, 8.0])
    jd, td = jnp.asarray(d), _t(d)
    jx, (jval, jgnorm, jit) = jk.run_lbfgs(
        jax.jit(lambda x: 0.5 * jnp.sum(jd * (x - 1.0) ** 2)),
        jnp.zeros(5), maxiter=100, gtol=gtol)
    fun = lambda x: 0.5 * torch.sum(td * (x - 1.0) ** 2)
    x, (val, gnorm, it) = tk.run_lbfgs(fun, np.zeros(5), maxiter=100,
                                       gtol=gtol, device="cpu")
    assert it == int(jit) < 100
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    assert float(gnorm) <= gtol
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
    assert float(val) == float(fun(x))


class _FlooredValue(torch.autograd.Function):
    """d0^2 + 10 d1^2 + d0^4 (d = x - 1) with its value held at 1e-3 or
    above, as a likelihood's rounding hides decreases near its minimum,
    and its gradient exact."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        d = x - 1.0
        return torch.clamp(d[0] ** 2 + 10 * d[1] ** 2 + d[0] ** 4, min=1e-3)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = x - 1.0
        return g * torch.stack([2 * d[0] + 4 * d[0] ** 3, 20 * d[1]])


@jax.custom_vjp
def _jax_floored_value(x):
    d = x - 1.0
    return jnp.maximum(d[0] ** 2 + 10 * d[1] ** 2 + d[0] ** 4, 1e-3)


def _jax_floored_fwd(x):
    return _jax_floored_value(x), x


def _jax_floored_bwd(x, g):
    d = x - 1.0
    return (g * jnp.stack([2 * d[0] + 4 * d[0] ** 3, 20 * d[1]]),)


_jax_floored_value.defvjp(_jax_floored_fwd, _jax_floored_bwd)


def test_run_lbfgs_crosses_a_floored_value_as_the_jax_package_does():
    """Where the value sits at its floor and hides every decrease, the
    line search still takes a step that meets the approximate decrease
    condition, as optax's does: from (3, -2) the run reaches (1, 1) by
    gtol with the JAX package's iteration count, x and gradient norm."""
    jx, (_, jgnorm, jit) = jk.run_lbfgs(
        jax.jit(_jax_floored_value), jnp.array([3.0, -2.0]), maxiter=100)
    fun = _FlooredValue.apply
    p, (val, gnorm, it) = tk.run_lbfgs(fun, [3.0, -2.0], maxiter=100,
                                       device="cpu")
    assert it == int(jit) < 100 and float(gnorm) <= 1e-8
    np.testing.assert_allclose(p.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
    _close(p, [1.0, 1.0], 1e-2)
    assert float(val) == float(fun(p)) == 1e-3


def _walled(xp, inf):
    """d0^2 + 10 d1^2 + d0^4 (d = x - 1) where x0 <= 0.995 and inf beyond,
    as a likelihood that is not defined past its domain's edge: the
    minimum in the domain lies on the edge, where the gradient is not 0."""
    return lambda x: xp.where(
        x[0] <= 0.995,
        (x[0] - 1.0) ** 2 + 10 * (x[1] - 1.0) ** 2 + (x[0] - 1.0) ** 4, inf)


def test_run_lbfgs_stops_where_no_step_is_found():
    """Where every trial step leaves the function's domain, an iteration's
    line search leaves x where it was: run_lbfgs stops after it instead of
    repeating it until maxiter, as the JAX package does, and reports the
    gradient norm it could not bring below gtol (the run one iteration
    shorter ends at the same x, and the JAX package's run to maxiter ends
    there too)."""
    fun = _walled(torch, torch.inf)
    p, (val, gnorm, it) = tk.run_lbfgs(fun, [-1.0, -2.0], maxiter=100,
                                       device="cpu")
    assert 1 < it < 100 and float(gnorm) > 1e-8
    _close(p, [1.0, 1.0], 1e-2)
    assert float(val) == float(fun(p))
    p2, (_, _, it2) = tk.run_lbfgs(fun, [-1.0, -2.0], maxiter=it - 1,
                                   device="cpu")
    assert it2 == it - 1 and torch.equal(p2, p)
    jx, (_, jgnorm, jit) = jk.run_lbfgs(jax.jit(_walled(jnp, jnp.inf)),
                                        jnp.array([-1.0, -2.0]), maxiter=100)
    assert int(jit) == 100
    np.testing.assert_allclose(p.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)


def test_kalman_tier_runs_on_its_device_and_copies_nothing():
    """Arrays land on ``device=`` in float64 (tensors keep their dtype);
    a tensor on another device raises instead of being copied."""
    rng = np.random.default_rng(2)
    ts, y, Ad, Qd = _problem(rng, T=10)
    res = tk.kalman_filter(Ad, Qd, H, R, y, M0, P0, device="cpu")
    assert res.mean_f.device.type == "cpu" and res.mean_f.dtype == F64
    res32 = tk.kalman_filter(Ad, Qd, H, R, _t(y).float(), M0, P0,
                             device="cpu")
    assert res32.mean_f.dtype == torch.float32
    elsewhere = torch.empty((10, 2, 2), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="runs on"):
        tk.kalman_filter(elsewhere, Qd, H, R, y, M0, P0, device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        tk.sqrt_kalman_filter(Ad, Qd, H, R, _t(y).to("meta"), M0, P0,
                              device="cpu")
    args = (ts, y, R, np.diag([1e-6, 1e-2]), M0, P0)
    with pytest.raises(ValueError, match="runs on"):
        tk.make_ekf_nll(VanDerPol(), *args, device="cpu")(
            torch.zeros(2, dtype=F64, device="meta"))
    with pytest.raises(ValueError, match="runs on"):
        tk.make_lti_nll(_lti_build(torch), ts, y, device="cpu")(
            torch.zeros(2, dtype=F64, device="meta"))
    with pytest.raises(ValueError, match="runs on"):
        tk.run_lbfgs(lambda x: x @ x, torch.zeros(2, device="meta"),
                     device="cpu")
    with pytest.raises(TypeError, match="device"):
        tk.kalman_filter(Ad, Qd, H, R, y, M0, P0)
    with pytest.raises(ValueError, match="runs on"):
        rk4_trajectory(VanDerPol().f, _t([2.0, 0.0]).to("meta"), ts,
                       device="cpu")


@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_smoother_initial_guess_matches_jax(kind):
    """tests/test_kalman.py's Van der Pol warm start (40 elements of degree
    4, 60 samples, u = 0): V0 within 1e-9 of the JAX package's."""
    rng = np.random.default_rng(6)
    t_meas = np.linspace(0.2, 9.9, 60)
    ts_fine = np.linspace(0.0, 10.0, 2001)
    xs = np.asarray(jax_rk4(
        JaxVanDerPol().f, jnp.array([2.0, 0.0]), jnp.asarray(ts_fine),
        u_fn=lambda t: jnp.zeros((1,)), p=jnp.array([1.0, 1.0])))
    y = np.interp(t_meas, ts_fine, xs[:, 0])[:, None]
    y += 0.02 * rng.standard_normal(y.shape)
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, 10.0, 40, 4),
                             t_meas, defect_weight=100.0)
    prob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, 10.0, 40, 4),
                                   t_meas, defect_weight=100.0, dtype=F64,
                                   device="cpu")
    kw = dict(R=np.array([[0.02**2]]), Qc=np.diag([1e-4, 1e-2]), substeps=6,
              kind=kind)
    z = tk.smoother_initial_guess(prob, t_meas, y, [0.6, 0.6], **kw)
    jz = jk.smoother_initial_guess(jprob, t_meas, y, [0.6, 0.6], **kw)
    _close(z.V, jz.V, 1e-9)
    _close(z.p, jz.p, 0.0)
