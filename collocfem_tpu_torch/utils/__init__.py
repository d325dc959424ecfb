"""Utilities: measurement-data loading, trajectory simulation, timing and
tracing."""

from collocfem_tpu_torch.utils.io import load_measurements, save_measurements
from collocfem_tpu_torch.utils.profiling import timed, trace
from collocfem_tpu_torch.utils.simulate import rk4_trajectory

__all__ = ["load_measurements", "save_measurements", "rk4_trajectory",
           "timed", "trace"]
