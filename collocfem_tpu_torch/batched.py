"""Config 5: batched multi-experiment Van der Pol estimation.

Counterpart of ``baseline_cpu/configs_baseline.py::make_config5_data`` and of
the packing in ``benchmarks/configs_bench.py::config5_batched``, in numpy and
torch only (``baseline_cpu`` imports JAX).  Each experiment starts from its
own random state and is driven by u = sin(f t) at its own frequency; the true
parameters (mu, b) = (1.3, 0.5) are shared.  The trajectories are an RK4
simulation on 2001 points; the samples are interpolated and get Gaussian
noise of 0.01, all from one seeded generator.
"""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem, ProblemData

MU_TRUE, B_TRUE, TF = 1.3, 0.5, 8.0
P0 = (2.0, 0.2)


def make_config5_data(n_exp: int, elements: int = 10, seed: int = 1):
    """Returns (mesh, t_meas (S,), y_all (E, S, 1), u_nodes_all
    (E, N, d+1, 1)), bit for bit the JAX package's."""
    mesh = uniform_mesh(0.0, TF, elements, 4)
    t_meas = np.linspace(0.05, TF - 0.05, 8 * elements)
    rng = np.random.default_rng(seed)
    x0s = rng.uniform(-2, 2, size=(n_exp, 2))
    freqs = rng.uniform(0.6, 1.4, size=n_exp)
    tt = np.linspace(0.0, TF, 2001)
    dt = tt[1] - tt[0]

    def f(x, t):
        u = np.sin(freqs * t)
        return np.stack([x[:, 1],
                         MU_TRUE * (1 - x[:, 0] ** 2) * x[:, 1] - x[:, 0]
                         + B_TRUE * u], axis=1)

    x = x0s.copy()
    paths = np.empty((tt.size, n_exp, 2))
    paths[0] = x
    for i in range(tt.size - 1):
        t = tt[i]
        k1 = f(x, t)
        k2 = f(x + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = f(x + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = f(x + dt * k3, t + dt)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        paths[i + 1] = x
    y_all = np.empty((n_exp, t_meas.size, 1))
    for e in range(n_exp):
        y_all[e, :, 0] = np.interp(t_meas, tt, paths[:, e, 0])
    y_all += 0.01 * rng.standard_normal(y_all.shape)
    u_nodes_all = np.stack([np.sin(freqs[e] * mesh.elem_times)[..., None]
                            for e in range(n_exp)])
    return mesh, t_meas, y_all, u_nodes_all


def stack_data(datas) -> ProblemData:
    """Stack per-experiment ProblemData along a new leading experiment axis."""
    return ProblemData(*(torch.stack(leaves) for leaves in zip(*datas)))


def build_config5_problem(n_exp: int = 1024, elements: int = 10, *, dtype,
                          device):
    """Config 5 at ``n_exp`` experiments of ``elements`` degree-4 elements.

    Returns ``(prob, z0, data_batch, p_prior, p_w)`` for
    ``parallel.batch.make_multi_experiment_solver(prob, options)(z0,
    data_batch, p_prior, p_w)``: defect weight 300, measurement weight 100,
    initial guess from the data with p0 = (2.0, 0.2), a shared zero prior of
    weight 1e-3 on p.
    """
    from collocfem_tpu_torch.parallel.batch import BatchDecision

    mesh, t_meas, y_all, u_nodes_all = make_config5_data(n_exp, elements)
    # Built and packed on the host, then moved to the device once per field.
    prob = EstimationProblem.build(VanDerPol(), mesh, t_meas,
                                   defect_weight=300.0, device="cpu",
                                   dtype=dtype)
    datas = [prob.pack_data(y_all[e], t_meas, u_nodes=u_nodes_all[e],
                            meas_weight=100.0) for e in range(n_exp)]
    v0s = [prob.initial_guess_from_data(t_meas, y_all[e], p0=[0, 0]).V
           for e in range(n_exp)]
    prob = prob.to(device)
    data_batch = ProblemData(*(x.to(device) for x in stack_data(datas)))
    z0 = BatchDecision(V=torch.stack(v0s).to(device),
                       p=torch.tensor(P0, dtype=dtype, device=device))
    p_prior = torch.zeros(2, dtype=dtype, device=device)
    p_w = torch.full((2,), 1e-3, dtype=dtype, device=device)
    return prob, z0, data_batch, p_prior, p_w
