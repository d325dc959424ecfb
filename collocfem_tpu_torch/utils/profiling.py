"""Timing and tracing helpers.

Counterpart of ``collocfem_tpu/utils/profiling.py``:

  * :func:`timed`: best-of-``reps`` wall time of a call after ``warmup``
    calls, each bracketed by ``torch.cuda.synchronize()`` when the work runs
    on a CUDA device (the counterpart of ``jax.block_until_ready``: the
    host clock then covers the device's work, not its enqueueing);
  * :func:`trace`: a context manager around ``torch.profiler`` that writes
    a Chrome/Perfetto trace into a directory (the counterpart of
    ``jax.profiler``'s trace directory).

The solvers' stats carry per-iteration history tables beside these.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elif device.type != "cpu":
        raise ValueError(f"no timing for work on {device}")


def timed(fn, *args, device, reps: int = 5, warmup: int = 1, **kwargs):
    """Best-of-``reps`` wall time of ``fn(*args, **kwargs)``, whose work runs
    on ``device``, after ``warmup`` untimed calls.  Returns (seconds, last
    output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _sync(device)
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str, *, device):
    """Profile a region into ``log_dir`` (a ``*.pt.trace.json`` file, for
    Perfetto or TensorBoard): host activity, and the card's kernels when
    ``device`` is a CUDA device.  Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` sum the region by operator and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        _sync(device)
