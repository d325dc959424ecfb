"""The headline estimation problem: Van der Pol on a uniform LGL mesh.

Counterpart of ``baseline_cpu/run_baseline.py::build_headline_problem``, in
numpy and scipy only: the same horizon, measurement times, reference
trajectory (``solve_ivp`` at rtol 1e-10, atol 1e-11) and input at the
collocation nodes.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

from collocfem_tpu_torch.ops.mesh import uniform_mesh

MU_TRUE, B_TRUE = 1.0, 1.0
TF = 10.0


def build_headline_problem(num_elements: int, degree: int = 4):
    """Returns (mesh, t_meas (N,), y (N, 1), u_nodes (N, d+1, 1))."""
    mesh = uniform_mesh(0.0, TF, num_elements, degree)
    t_meas = np.linspace(0.02, TF - 0.02, num_elements)
    sol = solve_ivp(
        lambda t, x: [
            x[1],
            MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0] + B_TRUE * np.sin(0.9 * t),
        ],
        (0, TF), [1.0, 0.0], rtol=1e-10, atol=1e-11, dense_output=True,
    )
    y = sol.sol(t_meas)[0][:, None]
    u_nodes = np.sin(0.9 * mesh.elem_times)[..., None]
    return mesh, t_meas, y, u_nodes
