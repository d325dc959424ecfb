"""Configs 2, 3 and 4 and the constrained set-ups: the Duffing joint MAP
estimation, the pendulum swing-up, the aircraft output-error estimation,
the free-time OCP and estimation under bounds and inequality constraints.

Counterparts of the set-ups in ``benchmarks/configs_bench.py``
(``config2_duffing``, ``config3_pendulum``, ``config3_large``,
``config4_aircraft``), of the constants and the Euler-Maruyama generator of
``examples/duffing_joint.py``, and of the set-ups of
``examples/min_time_ocp.py``, ``examples/constrained_estimation.py``,
``tests/test_bounds.py``, ``tests/test_ocp.py``'s split actuator and
``tests/test_multi_experiment.py``'s batch, in numpy, scipy and torch only:
the same data and the same initial guesses.

  * Config 2: Duffing (nx 2, nu 0, nq 3: b = 8, r = 4) on N = 1,000
    elements of degree 4 over [0, 20], 2,000 samples of x1 from a seeded
    SDE path (seed 7); defects weighted by the process-noise information.
  * Config 4: the aircraft short-period model (nx 2, nu 1, nq 5, ny 3:
    b = 8, r = 6) on N = 200 elements of degree 4 over [0, 8], the 400
    samples of ``examples/data/aircraft_doublet.csv`` (alpha, q, az and the
    recorded elevator, which becomes the input at the collocation nodes).

  * Config 3: the pendulum swing-up (nx 2, nu 1, nq 0, ng 2: b = 12, the
    chain solve at r = 1) on N = 25 elements of degree 4 over [0, 2.5]
    (``config3_large``: N = 500), from rest at 0 to rest at pi, |u| <= 2.
    At N = 500 a cold start lands in an infeasible basin (the JAX package's
    float64 run on the CPU: cviol 0.68; its BASELINE.md row 3L), so N =
    500 starts from the N = 25 solution (:func:`config3_warm_start`, the
    nested protocol of docs/guide.md).

``C2_*`` and ``C4_*`` are the ``SolverOptions`` of each config's fixed-work
benchmark run and of its example's converged run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from collocfem_tpu_torch.model import Model
from collocfem_tpu_torch.models import (AircraftLongitudinal, Duffing,
                                        Pendulum, VanDerPol)
from collocfem_tpu_torch.ocp import OptimalControlProblem
from collocfem_tpu_torch.ocp_time import free_time_ocp
from collocfem_tpu_torch.ops.mesh import interpolate_trajectory, uniform_mesh
from collocfem_tpu_torch.problem import Decision, EstimationProblem
from collocfem_tpu_torch.utils.io import load_measurements

DEGREE = 4

# ---- config 2: Duffing joint MAP --------------------------------------------
ALPHA, BETA, DELTA = 1.0, 5.0, 0.2      # truth
GAMMA, OMEGA = 8.0, 0.5                 # known forcing
TF2, ELEMENTS2 = 20.0, 1000
PROC_NOISE = 0.05                       # SDE diffusion on x2
MEAS_NOISE = 0.01
P2_TRUE = (ALPHA, BETA, DELTA)
P2_0 = (0.5, 1.0, 0.5)
C2_FIXED = dict(maxiter=40, gtol=0.0, lam0=1e-6)
C2_CONVERGED = dict(maxiter=80, gtol=1e-6, xtol=1e-10)

# ---- config 4: aircraft output error ----------------------------------------
P4_TRUE = (-1.2, -8.0, -2.5, -0.15, -12.0)   # Za, Ma, Mq, Zd, Md
P4_0 = (-1.0, -5.0, -1.0, -0.1, -5.0)
TF4, ELEMENTS4 = 8.0, 200
V_AIR, G0 = 60.0, 9.81
NOISE4 = (0.002, 0.005, 0.05)               # alpha, q, az channel sigmas
AIRCRAFT_RECORD = (Path(__file__).resolve().parent.parent / "examples"
                   / "data" / "aircraft_doublet.csv")
C4_FIXED = dict(maxiter=40, gtol=0.0, lam0=1e-6, lam_max=1e30)
C4_CONVERGED = dict(maxiter=60, gtol=1e-6, xtol=1e-12)

# ---- config 3: pendulum swing-up --------------------------------------------
TF3, ELEMENTS3, ELEMENTS3_LARGE = 2.5, 25, 500
U_MAX3 = 2.0
U_MARGIN3 = 1e-3        # the warm start's controls stay this far inside U_MAX3

# ---- examples/min_time_ocp.py: minimum-time double integrator ---------------
DIST, U_MAX_MT, ELEMENTS_MT, TF_REF_MT = 1.0, 1.0, 16, 3.0
MIN_TIME_OPTIONS = dict(n_outer=16)

# ---- examples/constrained_estimation.py: aircraft with a damping spec -------
ZETA_MIN = 0.6
P4_0_CONSTRAINED = (-1.0, -4.0, -4.0, -0.1, -5.0)   # zeta(p0) ~ 0.88
CONSTRAINED4_OPTIONS = dict(n_outer=12, inner_maxiter=40, mu_min=1e-12)

# ---- tests/test_bounds.py: Van der Pol with a parameter cap -----------------
MU_VDP, B_VDP, TF_VDP, ELEMENTS_VDP, DEGREE_VDP = 1.0, 0.7, 8.0, 60, 2
MU_CAP = 0.8
BOUNDED_VDP_OPTIONS = dict(n_outer=12, inner_maxiter=40, mu_min=1e-12)


def simulate_sde(rng, tf, dt=1e-3):
    """Euler-Maruyama simulation of the noisy Duffing oscillator from
    (1, 0): returns (ts (n+1,), x (n+1, 2)), n = tf / dt."""
    n = int(tf / dt)
    ts = np.linspace(0.0, tf, n + 1)
    x = np.zeros((n + 1, 2))
    x[0] = [1.0, 0.0]
    for i in range(n):
        t, (x1, x2) = ts[i], x[i]
        drift = np.array([
            x2,
            -DELTA * x2 - ALPHA * x1 - BETA * x1**3
            + GAMMA * np.cos(OMEGA * t),
        ])
        x[i + 1] = x[i] + dt * drift
        x[i + 1, 1] += PROC_NOISE * np.sqrt(dt) * rng.standard_normal()
    return ts, x


def make_config2_data():
    """(t_meas (2000,), y (2000, 1)): x1 of the SDE path with Gaussian
    measurement noise, from one generator of seed 7."""
    rng = np.random.default_rng(7)
    ts, xs = simulate_sde(rng, TF2)
    t_meas = np.linspace(0.05, TF2 - 0.05, 2000)
    y = np.interp(t_meas, ts, xs[:, 0])[:, None]
    y += MEAS_NOISE * rng.standard_normal(y.shape)
    return t_meas, y


def build_config2_problem(*, dtype, device):
    """Config 2 on its ELEMENTS2 elements of degree 4.  Returns ``(prob, z0,
    data)`` for ``solve.newton.make_gn_solver(prob, options)(z0, data)``:
    defect weight 1 / PROC_NOISE, measurement weight 1 / MEAS_NOISE, a zero
    prior of weight 1e-3 on p, the initial guess from the data with
    p0 = P2_0."""
    t_meas, y = make_config2_data()
    mesh = uniform_mesh(0.0, TF2, ELEMENTS2, DEGREE)
    prob = EstimationProblem.build(Duffing(gamma=GAMMA, omega=OMEGA), mesh,
                                   t_meas, defect_weight=1.0 / PROC_NOISE,
                                   device=device, dtype=dtype)
    data = prob.pack_data(y, t_meas, meas_weight=1.0 / MEAS_NOISE,
                          p_prior=[0.0, 0.0, 0.0], p_weight=1e-3)
    z0 = prob.initial_guess_from_data(t_meas, y, p0=P2_0)
    return prob, z0, data


def build_config4_problem(*, dtype, device):
    """Config 4 on its ELEMENTS4 elements of degree 4 from the flight record
    (columns t, alpha, q, az, elevator).  Returns ``(prob, z0, data)``:
    defect weight 1e4, per-channel measurement weights 1 / NOISE4, the
    elevator interpolated at the collocation nodes as the input, the
    initial guess from the alpha and q channels with p0 = P4_0."""
    t_meas, vals = load_measurements(str(AIRCRAFT_RECORD))
    y, u_rec = vals[:, :3], vals[:, 3]
    mesh = uniform_mesh(0.0, TF4, ELEMENTS4, DEGREE)
    prob = EstimationProblem.build(AircraftLongitudinal(V=V_AIR, g0=G0), mesh,
                                   t_meas, defect_weight=1e4, device=device,
                                   dtype=dtype)
    u_nodes = np.interp(mesh.elem_times, t_meas, u_rec)[..., None]
    data = prob.pack_data(y, t_meas, u_nodes=u_nodes,
                          meas_weight=1.0 / np.array(NOISE4))
    z0 = prob.initial_guess_from_data(t_meas, y[:, :2], p0=P4_0)
    return prob, z0, data


def build_config3_problem(elements: int, *, dtype, device):
    """Config 3, the pendulum swing-up, on ``elements`` elements of degree
    4 (ELEMENTS3 = 25, or ELEMENTS3_LARGE = 500).  Returns ``(prob, z0)``
    for ``solve.auglag.make_ocp_solver(prob, ALBarrierOptions())(z0)``: z0
    is ``prob.initial_guess()``, the straight line between the boundary
    states with u = 0."""
    prob = OptimalControlProblem.build(
        Pendulum(m=1.0, l=0.5, grav=9.81, u_max=U_MAX3),
        uniform_mesh(0.0, TF3, elements, DEGREE), x0=[0.0, 0.0],
        xf=[np.pi, 0.0], dtype=dtype, device=device)
    return prob, prob.initial_guess()


def config3_warm_start(coarse, z, fine) -> Decision:
    """The nested start of config 3 on a fine mesh (docs/guide.md): the
    coarse solution ``z`` of problem ``coarse`` interpolated by its
    collocation polynomial at the fine problem's nodes, the controls
    clipped to |u| <= U_MAX3 - U_MARGIN3 (strictly inside the barrier)."""
    V = interpolate_trajectory(coarse.mesh, z.V, fine.mesh.node_times)
    u = torch.clamp(V[:, 2:], -(U_MAX3 - U_MARGIN3), U_MAX3 - U_MARGIN3)
    return Decision(V=torch.cat([V[:, :2], u], dim=1).to(fine.dtype),
                    p=z.p.to(fine.dtype))


class DoubleIntegrator(Model):
    """x1' = x2, x2' = u with |u| <= U_MAX_MT (``examples/min_time_ocp.py``)."""

    nx, nu, nq, ng = 2, 1, 0, 2

    def f(self, x, u, p, t):
        del p, t
        return torch.stack([x[1], u[0]])

    def g(self, x, u, p, t):
        del x, p, t
        return torch.stack([u[0] - U_MAX_MT, -u[0] - U_MAX_MT])


def build_min_time_problem(*, dtype, device, degree: int = DEGREE):
    """The minimum-time rest-to-rest transfer of ``examples/min_time_ocp.py``
    (distance DIST, |u| <= 1, 16 elements of degree 4 in normalized time,
    tf_ref 3, time weight 1; bang-bang optimum T* = 2 sqrt(DIST / U_MAX)).
    The horizon is the one parameter: b = 3 degree (12 at degree 4, 9 at
    ``tests/test_ocp_time.py``'s degree 3), nq = 1.  Returns ``(prob,
    ftmodel, z0)``; solve with ``ALBarrierOptions(**MIN_TIME_OPTIONS)``."""
    prob, ftm = free_time_ocp(
        DoubleIntegrator(), num_elements=ELEMENTS_MT, degree=degree,
        x0=[0.0, 0.0], xf=[DIST, 0.0], tf_ref=TF_REF_MT, time_weight=1.0,
        dtype=dtype, device=device)
    return prob, ftm, prob.initial_guess()


def zeta_constraint(p):
    """The short-period damping spec of ``examples/constrained_estimation.py``
    as g(p) = ZETA_MIN - zeta(p) <= 0, zeta = -(Z_a + M_q) / (2 sqrt(Z_a M_q
    - M_a))."""
    za, ma, mq = p[0], p[1], p[2]
    zeta = -(za + mq) / (2.0 * torch.sqrt(za * mq - ma))
    return torch.atleast_1d(ZETA_MIN - zeta)


def build_constrained_aircraft_problem(*, dtype, device):
    """Config 4's problem with the strictly feasible start of
    ``examples/constrained_estimation.py`` (p0 = P4_0_CONSTRAINED).
    Returns ``(prob, z0, data)``; solve with
    ``make_constrained_solver(prob, ConstrainedOptions(
    **CONSTRAINED4_OPTIONS), g_param=zeta_constraint)``."""
    prob, _, data = build_config4_problem(dtype=dtype, device=device)
    t_meas, vals = load_measurements(str(AIRCRAFT_RECORD))
    z0 = prob.initial_guess_from_data(t_meas, vals[:, :2],
                                      p0=P4_0_CONSTRAINED)
    return prob, z0, data


def build_bounded_vdp_problem(degree: int = DEGREE_VDP, *, dtype, device):
    """The Van der Pol set-up of ``tests/test_bounds.py``: x(0) = (2, 0),
    u = 0.5 sin(1.1 t), truth (MU_VDP, B_VDP) integrated by scipy's
    ``solve_ivp`` (rtol 1e-11), 160 noise-free samples of x1 on [0.025,
    7.975], on ELEMENTS_VDP elements of the test's degree 2 (b = 4, nq =
    2), defect weight 30, p0 = (0.6, 0.4); ``degree`` 4 gives b = 8.
    Returns ``(prob, z0, data)``; the active-bound case caps mu at MU_CAP
    with ``BoundedOptions(**BOUNDED_VDP_OPTIONS)``."""
    from scipy.integrate import solve_ivp

    def u_fn(t):
        return 0.5 * np.sin(1.1 * t)

    def rhs(t, x):
        return [x[1], MU_VDP * (1 - x[0] ** 2) * x[1] - x[0]
                + B_VDP * u_fn(t)]

    sol = solve_ivp(rhs, (0.0, TF_VDP), (2.0, 0.0), rtol=1e-11, atol=1e-12,
                    dense_output=True)
    mesh = uniform_mesh(0.0, TF_VDP, ELEMENTS_VDP, degree)
    t_meas = np.linspace(0.025, TF_VDP - 0.025, 160)
    y = sol.sol(t_meas)[0][:, None]
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=30.0, dtype=dtype,
                                   device=device)
    data = prob.pack_data(y, t_meas, u_nodes=u_fn(mesh.elem_times)[..., None])
    z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.6, 0.4])
    return prob, z0, data


# ---- tests/test_ocp.py: the split actuator (an equality path constraint) ----
ELEMENTS_SPLIT = 8
SPLIT_OPTIONS = dict(n_outer=16)


class SplitActuator(Model):
    """x1' = x2, x2' = u1 + u2 with the equality path constraint u1 = 2 u2
    and cost 0.5 int (u1^2 + u2^2) (``tests/test_ocp.py``): the minimum-
    effort transfer, J* = 10/3."""

    nx, nu, nq, ng, ne = 2, 2, 0, 0, 1

    def f(self, x, u, p, t):
        del p, t
        return torch.stack([x[1], u[0] + u[1]])

    def g_eq(self, x, u, p, t):
        del x, p, t
        return torch.stack([u[0] - 2.0 * u[1]])

    def running_cost_residual(self, x, u, p, t):
        del x, p, t
        return u


def build_split_actuator_problem(elements: int = ELEMENTS_SPLIT, *, dtype,
                                 device):
    """The split actuator from rest at 0 to rest at 1 over [0, 1] on
    ``elements`` elements of degree 4 ([x; u] at 4 nodes an element: b =
    16, nq = 0).  Returns ``(prob, z0)``; solve with
    ``ALBarrierOptions(**SPLIT_OPTIONS)``."""
    prob = OptimalControlProblem.build(
        SplitActuator(), uniform_mesh(0.0, 1.0, elements, DEGREE),
        x0=[0.0, 0.0], xf=[1.0, 0.0], dtype=dtype, device=device)
    return prob, prob.initial_guess()


# ---- tests/test_multi_experiment.py: a batch of Van der Pol experiments -----
MU_MULTI, B_MULTI, TF_MULTI = 1.3, 0.5, 8.0
N_EXP_MULTI, ELEMENTS_MULTI, DEGREE_MULTI = 8, 48, 2
MULTI_OPTIONS = dict(maxiter=40, gtol=1e-9, xtol=1e-10)


def build_multi_experiment_problem(*, dtype, device):
    """``tests/test_multi_experiment.py``'s batch: N_EXP_MULTI Van der Pol
    experiments (truth MU_MULTI, B_MULTI; x0 uniform in [-2, 2]^2 from a
    generator of seed 42, input sin((0.7 + 0.15 i) t)), 80 samples of x1
    each on ELEMENTS_MULTI elements of degree 2 (b = 4, nq = 2), defect
    weight 300, the shared prior (1, 1) of weight 1e-3, p0 = (2, 0.2).
    Returns ``(prob, z0, data, p_prior, p_w)`` for
    ``parallel.batch.make_multi_experiment_solver(prob, SolverOptions(
    **MULTI_OPTIONS), layout=...)(z0, data, p_prior, p_w)``."""
    from scipy.integrate import solve_ivp

    from collocfem_tpu_torch.testing import batch_inputs

    mesh = uniform_mesh(0.0, TF_MULTI, ELEMENTS_MULTI, DEGREE_MULTI)
    t_meas = np.linspace(0.05, TF_MULTI - 0.05, 80)
    rng = np.random.default_rng(42)
    ys, us = [], []
    for i in range(N_EXP_MULTI):
        x0, freq = rng.uniform(-2, 2, size=2), 0.7 + 0.15 * i
        sol = solve_ivp(
            lambda t, x: [x[1], MU_MULTI * (1 - x[0] ** 2) * x[1] - x[0]
                          + B_MULTI * np.sin(freq * t)],
            (0.0, TF_MULTI), x0, rtol=1e-10, atol=1e-11, dense_output=True)
        ys.append(sol.sol(t_meas)[0][:, None])
        us.append(np.sin(freq * mesh.elem_times)[..., None])
    return batch_inputs(dict(
        kind="vdp_batch", breakpoints=mesh.breakpoints, degree=DEGREE_MULTI,
        t_meas=t_meas, y=np.stack(ys), u_nodes=np.stack(us),
        defect_weight=300.0, p0=[2.0, 0.2], p_prior=[1.0, 1.0],
        p_w=[1e-3, 1e-3]), dtype=dtype, device=device)
