"""collocfem_tpu_torch — the PyTorch/CUDA port of ``collocfem_tpu``.

LGL-collocation parameter estimation for ODE models, on one NVIDIA H100.
Plain tensor code is PyTorch; every chain solve of a Levenberg-Marquardt
iteration is a hand-written CUDA kernel (``csrc/``), built at first use.
Module names mirror ``collocfem_tpu``'s so each counterpart is easy to find.
The package never imports JAX.

Main paths:
  * one experiment: ``EstimationProblem.build`` -> ``pack_data`` ->
    ``initial_guess_from_data`` ->
    ``solve.newton.make_gn_solver(problem, options)(z0, data)``;
  * a batch sharing p (config 5): ``batched.build_config5_problem`` ->
    ``parallel.batch.make_multi_experiment_solver(problem, options,
    layout=...)(z0, data_batch, p_prior, p_w)``;
  * configs 2 and 4: ``configs.build_config2_problem`` /
    ``build_config4_problem`` -> ``make_gn_solver`` (``hessian='newton'``
    for exact Newton) or ``solve.newton.make_irls_solver``;
  * trajectory optimization (config 3): ``OptimalControlProblem.build``
    (or ``configs.build_config3_problem``; ``free_time_ocp`` for a free
    horizon) -> ``solve.auglag.make_ocp_solver(problem, options)(z0)``;
  * estimation under bounds or inequality constraints:
    ``solve.bounds.make_bounded_solver`` and
    ``solve.constrained.make_constrained_solver``;
  * online estimation (the serving path): ``mhe.MovingHorizonEstimator``
    (``init``, then ``step`` per sample); the Kalman tier in ``kalman``;
  * several ranks (``torch.distributed``): ``parallel.make_device_mesh``,
    then ``parallel.make_sp_gn_solver`` (the element chain sharded over
    "sp") or ``make_multi_experiment_solver(..., dp_axis=mesh.dp_group)``
    (experiments over "dp"; ``chain_solver=parallel.spike_chain_solver``
    composes dp x sp);
  * models from sympy strings: ``symbolic_model``; checkpoints and debug
    guards in ``utils`` (``save_pytree`` / ``load_pytree``, ``checkified``,
    ``assert_all_finite``).

On a CUDA device ``make_gn_solver``'s and ``make_multi_experiment_solver``'s
solves and ``MovingHorizonEstimator.step`` run from CUDA graphs captured at
their first call, as the JAX package runs them jitted
(:mod:`collocfem_tpu_torch.solve.graph`); so do the sharded solves, with
their all-reduces (the peer-memory kernel of :mod:`parallel.peer`) inside
the graphs, on ranks sharing one card or one rank a card.  ``solve.eager``
and ``step_eager`` are the eager loops.

Importing the package turns TF32 off for float32 matmuls
(:mod:`collocfem_tpu_torch.precision`).
"""

from collocfem_tpu_torch import precision

precision.apply()

from collocfem_tpu_torch.model import Model  # noqa: E402
from collocfem_tpu_torch.model_sym import symbolic_model  # noqa: E402
from collocfem_tpu_torch.ocp import (  # noqa: E402
    Multipliers,
    OptimalControlProblem,
)
from collocfem_tpu_torch.ocp_time import (  # noqa: E402
    FreeTimeModel,
    free_time_ocp,
)
from collocfem_tpu_torch.ops.basis import LGLBasis, make_basis  # noqa: E402
from collocfem_tpu_torch.ops.mesh import Mesh, uniform_mesh  # noqa: E402
from collocfem_tpu_torch.problem import (  # noqa: E402
    Decision,
    EstimationProblem,
    ProblemData,
)

__all__ = [
    "Model",
    "symbolic_model",
    "LGLBasis",
    "make_basis",
    "Mesh",
    "uniform_mesh",
    "EstimationProblem",
    "ProblemData",
    "Decision",
    "Multipliers",
    "OptimalControlProblem",
    "FreeTimeModel",
    "free_time_ocp",
]
