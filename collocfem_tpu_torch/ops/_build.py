"""Build the package's CUDA sources at first use and load them with ctypes.

Each library ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared object with a plain C interface, in
``collocfem_tpu_torch/build/``, under a name keyed on a hash of every file in
``csrc/`` and the compiler flags.  A later process with the same sources
loads the existing file.  :func:`load_all` runs one ``nvcc`` per library, all
started together.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def count_launches(fn, shape, n: int = 1) -> None:
    """Add ``n`` launches of the kernel behind wrapper ``fn`` to its count
    (``fn.launches``) and to its count at ``shape`` (``fn.shapes``: (b, r),
    or (b,) for a kernel that takes no right-hand side -> launches)."""
    fn.launches += n
    fn.shapes[shape] = fn.shapes.get(shape, 0) + n


# Every counted function: the kernel wrappers and their plain versions.
COUNTED: list = []


def register(fn, shapes: bool) -> None:
    """Give ``fn`` a count of 0 (``fn.launches``; with ``shapes``, a kernel
    wrapper's count by shape ``fn.shapes`` too) and list it in
    :data:`COUNTED`."""
    fn.launches = 0
    if shapes:
        fn.shapes = {}
    COUNTED.append(fn)


def snapshot() -> dict:
    """Every counted function's counts: {fn: (launches, {shape: n})}."""
    return {fn: (fn.launches, dict(getattr(fn, "shapes", {})))
            for fn in COUNTED}


def restore(snap: dict) -> None:
    """Set every count back to what ``snap`` (:func:`snapshot`) holds (0
    for a function registered since)."""
    for fn in COUNTED:
        launches, shapes = snap.get(fn, (0, {}))
        fn.launches = launches
        if hasattr(fn, "shapes"):
            fn.shapes = dict(shapes)


def difference(before: dict, after: dict) -> dict:
    """The counts made between two snapshots: {fn: (launches, {shape:
    n})}, for the functions whose count moved."""
    out = {}
    for fn, (launches, shapes) in after.items():
        n0, s0 = before.get(fn, (0, {}))
        if launches != n0:
            out[fn] = (launches - n0,
                       {s: n - s0.get(s, 0) for s, n in shapes.items()
                        if n != s0.get(s, 0)})
    return out


def add_counts(share: dict) -> None:
    """Add ``share`` (:func:`difference`) to the counts: what a captured
    CUDA graph's replay launches, which no wrapper counts."""
    for fn, (launches, shapes) in share.items():
        fn.launches += launches
        for shape, n in shapes.items():
            fn.shapes[shape] = fn.shapes.get(shape, 0) + n


@contextlib.contextmanager
def counts_held():
    """Run the block and leave every count as it was before it.  Yields a
    dict that holds, once the block has ended, the counts the block made
    (:func:`difference`): a CUDA graph's warm-up and capture count nothing,
    and its replays add this share."""
    before = snapshot()
    share = {}
    try:
        yield share
        share.update(difference(before, snapshot()))
    finally:
        restore(before)


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


def _paths(name: str) -> tuple[Path, Path]:
    so = BUILD_DIR / f"{name}-{_digest()}.so"
    return so, so.with_suffix(".log")


def _compile_one(name: str) -> float:
    """Run nvcc on ``csrc/<name>.cu``; returns its wall in seconds."""
    so, log = _paths(name)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return seconds


def _compile(names) -> dict[str, float]:
    """Compile the libraries whose shared object is missing, one nvcc each,
    all at once; returns each one's build wall in seconds."""
    todo = [n for n in names if not _paths(n)[0].exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(todo)) as pool:
        return dict(zip(todo, pool.map(_compile_one, todo)))


_LOADED: dict[str, Built] = {}


def load_all(names) -> dict[str, Built]:
    """Compile the missing libraries concurrently and load every one."""
    seconds = _compile([n for n in names if n not in _LOADED])
    for name in names:
        if name not in _LOADED:
            so, log = _paths(name)
            _LOADED[name] = Built(
                lib=ctypes.CDLL(str(so)), path=so,
                seconds=seconds.get(name, 0.0),
                log=log.read_text() if log.exists() else "")
    return {name: _LOADED[name] for name in names}


def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    return load_all([name])[name]


def check_operands(operands, contiguous=None) -> None:
    """Raise ValueError unless every (name, tensor, shape) in ``operands``
    has that shape and the first tensor's device and dtype (float32 or
    float64), and every tensor named in ``contiguous`` (default: all) is
    contiguous: what a kernel reading raw pointers needs."""
    ref = operands[0][1]
    for name, x, want in operands:
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(want)}")
        if x.device != ref.device or x.dtype != ref.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected "
                             f"{ref.dtype} on {ref.device}")
        if (contiguous is None or name in contiguous) and \
                not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, not "
                         f"{ref.dtype}")
