"""Utilities: checkpointing, debug guards, measurement-data loading,
trajectory simulation, timing and tracing."""

from collocfem_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from collocfem_tpu_torch.utils.debugging import assert_all_finite, checkified
from collocfem_tpu_torch.utils.io import load_measurements, save_measurements
from collocfem_tpu_torch.utils.profiling import timed, trace
from collocfem_tpu_torch.utils.simulate import rk4_trajectory

__all__ = ["save_pytree", "load_pytree", "timed", "trace", "rk4_trajectory",
           "checkified", "assert_all_finite", "load_measurements",
           "save_measurements"]
