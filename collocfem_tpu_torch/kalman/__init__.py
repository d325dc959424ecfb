"""Kalman filtering / smoothing subpackage.

Counterpart of ``collocfem_tpu/kalman/``: every filter and smoother is a
step function run over time by :class:`Scan` (the JAX package's
``lax.scan``s; on a CUDA device a CUDA graph of one step replayed once a
sample, and of its VJP once a sample backwards; on the CPU a loop), the
float32-safe path is a QR-based square-root form, and the innovations
negative log-likelihood (prediction-error method) is differentiable by
autograd for ML parameter estimation.

Public API:
  Scan                               - captured scan (scan)
  van_loan, discretize_lti           - exact LTI discretization (disc)
  kalman_filter, rts_smoother        - linear KF / RTS      (filtering)
  ekf_filter, ukf_filter, cd_smoother- continuous-discrete EKF/UKF + RTS
  sqrt_kalman_filter, sqrt_rts_smoother - square-root forms  (sqrt)
  make_ekf_nll, make_ukf_nll, run_lbfgs - PEM / ML estimation (pem;
                                       the NLLs are ScanNLL objects)
  smoother_initial_guess             - warm start for EstimationProblem
"""

from collocfem_tpu_torch.kalman.disc import discretize_lti, van_loan
from collocfem_tpu_torch.kalman.filtering import (
    FilterResult,
    cd_smoother,
    ekf_filter,
    kalman_filter,
    rts_smoother,
    ukf_filter,
)
from collocfem_tpu_torch.kalman.initialize import smoother_initial_guess
from collocfem_tpu_torch.kalman.pem import (
    ScanNLL,
    make_ekf_nll,
    make_lti_nll,
    make_ukf_nll,
    run_lbfgs,
)
from collocfem_tpu_torch.kalman.scan import Scan
from collocfem_tpu_torch.kalman.sqrt import (
    sqrt_kalman_filter,
    sqrt_rts_smoother,
)

__all__ = [
    "Scan",
    "ScanNLL",
    "van_loan",
    "discretize_lti",
    "FilterResult",
    "kalman_filter",
    "rts_smoother",
    "ekf_filter",
    "ukf_filter",
    "cd_smoother",
    "sqrt_kalman_filter",
    "sqrt_rts_smoother",
    "make_ekf_nll",
    "make_ukf_nll",
    "make_lti_nll",
    "run_lbfgs",
    "smoother_initial_guess",
]
