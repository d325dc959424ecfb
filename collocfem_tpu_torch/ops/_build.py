"""Build the package's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
object with a plain C interface, in ``collocfem_tpu_torch/build/``, under a
name keyed on a hash of every file in ``csrc/`` and the compiler flags.  A
later process with the same sources loads the existing file.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall of this process's build, 0.0 when it was reused
    log: str        # nvcc's output, including ptxas register/spill lines


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    so = BUILD_DIR / f"{name}-{_digest()}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False,
        )
        seconds = time.perf_counter() - t0
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    return Built(lib=ctypes.CDLL(str(so)), path=so, seconds=seconds,
                 log=log.read_text() if log.exists() else "")
