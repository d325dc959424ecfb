"""Measurement-data loading (counterpart of ``collocfem_tpu/utils/io.py``).

Two formats: delimited text (CSV / whitespace, first column time) and .npz
archives with ``t``/``y`` (and optionally ``u``) arrays.  Returns plain
numpy; feed the result to ``EstimationProblem.pack_data``.
"""

from __future__ import annotations

import os

import numpy as np


def load_measurements(path: str, *, time_column: int = 0, delimiter=None):
    """Load (times, values) from a .csv/.txt/.dat or .npz file.

    Text files: one row per sample, ``time_column`` holds the sample time,
    every other column is a measured channel (header lines starting with
    '#' or non-numeric text are skipped).  NPZ: arrays ``t`` (T,) and
    ``y`` (T, ny) (a 1-D ``y`` is promoted to one channel).

    Returns:
      (times (T,), values (T, ny)) float64, sorted by time.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as data:
            if "t" not in data or "y" not in data:
                raise ValueError(f"{path}: .npz needs arrays 't' and 'y'")
            t = np.asarray(data["t"], dtype=np.float64).ravel()
            y = np.atleast_2d(np.asarray(data["y"], dtype=np.float64))
            if y.shape[0] != t.size:
                y = y.T
    else:
        if delimiter is None and ext == ".csv":
            delimiter = ","  # .csv means comma; None = any whitespace
        raw = np.atleast_2d(np.genfromtxt(path, delimiter=delimiter,
                                          comments="#", dtype=np.float64))
        # Drop rows that failed to parse (headers -> NaN rows).
        raw = raw[~np.all(np.isnan(raw), axis=1)]
        t = raw[:, time_column]
        y = np.delete(raw, time_column, axis=1)
    if y.ndim == 1:
        y = y[:, None]
    if t.size != y.shape[0]:
        raise ValueError(f"{path}: {t.size} times vs {y.shape[0]} rows")
    order = np.argsort(t, kind="stable")
    return t[order], y[order]


def save_measurements(path: str, times, values, u=None) -> None:
    """Save a measurement set as .npz (round-trips with load_measurements)."""
    arrays = {"t": np.asarray(times, dtype=np.float64),
              "y": np.asarray(values, dtype=np.float64)}
    if u is not None:
        arrays["u"] = np.asarray(u, dtype=np.float64)
    np.savez(path, **arrays)
