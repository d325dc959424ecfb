"""Configs 2 and 4: the Duffing joint MAP estimation and the aircraft
output-error estimation.

Counterparts of the set-ups in ``benchmarks/configs_bench.py``
(``config2_duffing``, ``config4_aircraft``) and of the constants and the
Euler-Maruyama generator of ``examples/duffing_joint.py``, in numpy and
torch only: the same data, bit for bit, and the same initial guesses.

  * Config 2: Duffing (nx 2, nu 0, nq 3: b = 8, r = 4) on N = 1,000
    elements of degree 4 over [0, 20], 2,000 samples of x1 from a seeded
    SDE path (seed 7); defects weighted by the process-noise information.
  * Config 4: the aircraft short-period model (nx 2, nu 1, nq 5, ny 3:
    b = 8, r = 6) on N = 200 elements of degree 4 over [0, 8], the 400
    samples of ``examples/data/aircraft_doublet.csv`` (alpha, q, az and the
    recorded elevator, which becomes the input at the collocation nodes).

``C2_*`` and ``C4_*`` are the ``SolverOptions`` of each config's fixed-work
benchmark run and of its example's converged run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from collocfem_tpu_torch.models import AircraftLongitudinal, Duffing
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
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
