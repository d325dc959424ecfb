"""Solver layer: chain solves, the damped KKT solve, the
Levenberg-Marquardt driver and the uncertainty reports."""

from collocfem_tpu_torch.solve.blocktri import (
    SOLVERS,
    blocktri_inverse_blocks,
    blocktri_solve_cr,
    blocktri_solve_dense,
    blocktri_solve_scan,
)
from collocfem_tpu_torch.solve.covariance import (
    element_covariance,
    parameter_covariance,
    parameter_std,
    state_covariance_blocks,
    state_covariance_nodes,
    state_std,
    trajectory_std,
)
from collocfem_tpu_torch.solve.newton import (
    SolverOptions,
    SolveStats,
    make_gn_solver,
    make_irls_solver,
)

__all__ = [
    "SOLVERS",
    "blocktri_inverse_blocks",
    "blocktri_solve_cr",
    "blocktri_solve_dense",
    "blocktri_solve_scan",
    "element_covariance",
    "parameter_covariance",
    "parameter_std",
    "state_covariance_blocks",
    "state_covariance_nodes",
    "state_std",
    "trajectory_std",
    "SolverOptions",
    "SolveStats",
    "make_gn_solver",
    "make_irls_solver",
]
