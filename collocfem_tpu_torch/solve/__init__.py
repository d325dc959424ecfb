"""Solver layer: chain solves, the damped KKT solve, the
Levenberg-Marquardt driver, the uncertainty reports, and the constrained
solvers (AL + barrier OCP, bounded and inequality-constrained
estimation)."""

from collocfem_tpu_torch.solve.auglag import (
    OUTER_HISTORY_COLS,
    ALBarrierOptions,
    OCPStats,
    make_ocp_solver,
    solve_ocp,
)
from collocfem_tpu_torch.solve.blocktri import (
    SOLVERS,
    blocktri_inverse_blocks,
    blocktri_solve_cr,
    blocktri_solve_dense,
    blocktri_solve_scan,
)
from collocfem_tpu_torch.solve.bounds import (
    BOUNDS_HISTORY_COLS,
    BoundedOptions,
    BoundedStats,
    Bounds,
    bounded_gauss_newton,
    make_bounded_solver,
    make_bounds,
    project_interior,
)
from collocfem_tpu_torch.solve.constrained import (
    CONSTRAINED_HISTORY_COLS,
    ConstrainedOptions,
    ConstrainedStats,
    constrained_gauss_newton,
    make_constrained_solver,
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
    gauss_newton,
    make_gn_solver,
    make_irls_solver,
)

__all__ = [
    "OUTER_HISTORY_COLS",
    "ALBarrierOptions",
    "OCPStats",
    "make_ocp_solver",
    "solve_ocp",
    "BOUNDS_HISTORY_COLS",
    "BoundedOptions",
    "BoundedStats",
    "Bounds",
    "bounded_gauss_newton",
    "make_bounded_solver",
    "make_bounds",
    "project_interior",
    "CONSTRAINED_HISTORY_COLS",
    "ConstrainedOptions",
    "ConstrainedStats",
    "constrained_gauss_newton",
    "make_constrained_solver",
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
    "gauss_newton",
    "make_gn_solver",
    "make_irls_solver",
]
