"""Utilities: measurement-data loading."""

from collocfem_tpu_torch.utils.io import load_measurements, save_measurements

__all__ = ["load_measurements", "save_measurements"]
