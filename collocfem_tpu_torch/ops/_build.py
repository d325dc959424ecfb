"""Build the package's CUDA sources at first use and load them with ctypes.

A kernel library is compiled once per shape, as Pallas traces a kernel once
per shape: an :class:`Instance` is a library (``kkt_spike``, ``spike_chain``,
``thomas``, ``cr`` or ``gn_elements``; ``graph_loop`` and ``peer_reduce`` at
b = r = 0) at one block size b and one right-hand-side count r (and, for
``gn_elements``, the further sizes its ``more`` names),
and ``nvcc`` compiles its source in ``csrc/`` for Hopper (``sm_90a``) with
the shape as defines (``-DCF_B=<b> -DCF_R=<r>``) into a shared object with a
plain C interface, ``collocfem_tpu_torch/build/<lib>-b<b>-r<r>-<digest>.so``.
The digest is a hash of every file in ``csrc/`` and the compiler flags, so a
later process with the same sources loads the existing file.  ctypes loads
each instance under its own handle (``RTLD_LOCAL``), so the instances' equal
symbol names stay apart.  :func:`prebuild` runs one ``nvcc`` per missing
instance, as many at once as the machine has cores; :func:`load` builds one
instance if needed and loads it.
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

from collocfem_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Library -> (its source in csrc/, the defines that select it there).
LIBRARIES = {
    "kkt_spike": ("kkt_spike.cu", ("-DCF_KKT=1",)),    # kernel #1, r = 1 + nq
    "spike_chain": ("kkt_spike.cu", ("-DCF_KKT=0",)),  # kernel #2
    "thomas": ("thomas.cu", ()),                       # kernel #7
    "cr": ("cr.cu", ()),   # r = 0: kernel #4; r >= 1: kernels #3, #5, #6
    "graph_loop": ("graph_loop.cu", ()),   # solve/graph.py's loop; b = r = 0
    "peer_reduce": ("peer_reduce.cu", ()),  # parallel/peer.py; b = r = 0
    "gn_elements": ("gn_elements.cu", ()),  # ops/gn_elements.py; r = nq
}
MAX_BLOCK = 16   # the largest block size any library is built for


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


def _snapshot() -> dict:
    return {fn: (fn.launches, dict(getattr(fn, "shapes", {})))
            for fn in COUNTED}


def snapshot() -> dict:
    """Every counted function's counts, settled (:func:`settle`): {fn:
    (launches, {shape: n})}."""
    settle()
    return _snapshot()


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


def add_counts(share: dict, times: int = 1) -> None:
    """Add ``times`` x ``share`` (:func:`difference`) to the counts: what
    a captured CUDA graph's replays launch, which no wrapper counts."""
    for fn, (launches, shapes) in share.items():
        fn.launches += times * launches
        for shape, n in shapes.items():
            fn.shapes[shape] = fn.shapes.get(shape, 0) + times * n


class Tally:
    """The steps of a loop that runs on the device, counted there: a 0-d
    int64 ``counter`` the loop adds its steps to, one step's ``share`` of
    the counts (:func:`difference`), and the steps already counted."""

    def __init__(self, counter: torch.Tensor, share: dict):
        self.counter, self.share, self.taken = counter, share, 0


# The tallies whose loop ran since the last settle (held until then, so a
# solver that is gone by then still counts).
_PENDING: dict = {}


def pending(tally: Tally) -> None:
    """Mark ``tally``'s loop as run: the next :func:`settle` counts it."""
    _PENDING[id(tally)] = tally


def settle() -> None:
    """Add the launches of the steps that device loops ran since the last
    settle: one read of each such loop's counter to the host, made when the
    counts are read (:func:`snapshot`), not while a solve runs."""
    for tally in _PENDING.values():
        steps = int(tally.counter)
        add_counts(tally.share, steps - tally.taken)
        tally.taken = steps
    _PENDING.clear()


@contextlib.contextmanager
def counts_held():
    """Run the block and leave every count as it was before it.  Yields a
    dict that holds, once the block has ended, the counts the block made
    (:func:`difference`): a CUDA graph's warm-up and capture count nothing,
    and its replays add this share."""
    before = _snapshot()
    share = {}
    try:
        yield share
        share.update(difference(before, _snapshot()))
    finally:
        restore(before)


@dataclasses.dataclass(frozen=True)
class Instance:
    """One library compiled for one shape: block size ``b`` and ``r``
    right-hand sides (for ``kkt_spike`` r = 1 + nq, the group [gx | B]; for
    ``cr`` r = 0 is the factor kernel, which needs only b).  ``more`` holds
    further (name, size) pairs of a library whose shape b and r do not name
    (``gn_elements``: the degree, samples per element, outputs and defect
    rule), each a define ``-DCF_<name>=<size>`` and a part of the name."""

    lib: str
    b: int
    r: int
    more: tuple[tuple[str, int], ...] = ()

    def __post_init__(self):
        if self.lib not in LIBRARIES:
            raise ValueError(f"unknown library {self.lib!r}")

    @property
    def name(self) -> str:
        return "-".join([f"{self.lib}-b{self.b}-r{self.r}",
                         *(f"{k.lower()}{v}" for k, v in self.more)])

    @property
    def source(self) -> Path:
        return CSRC / LIBRARIES[self.lib][0]

    @property
    def defines(self) -> tuple[str, ...]:
        return (f"-DCF_B={self.b}", f"-DCF_R={self.r}",
                *(f"-DCF_{k}={v}" for k, v in self.more),
                *LIBRARIES[self.lib][1])

    def paths(self) -> tuple[Path, Path]:
        """(the shared object, the log of its nvcc run beside it)."""
        so = BUILD_DIR / f"{self.name}-{digest()}.so"
        return so, so.with_suffix(".log")


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


def digest() -> str:
    """Hash of the compiler flags :data:`NVCC_FLAGS` and every file in
    ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile_one(inst: Instance) -> float:
    """Run nvcc on the instance's source; returns its wall in seconds."""
    so, log = inst.paths()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    profiling.count("kernel_compiles")
    t0 = time.perf_counter()
    with profiling.span("build.compile"):
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *inst.defines, "-o", str(tmp),
             str(inst.source)],
            capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {inst.name}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return seconds


def prebuild(instances) -> dict[Instance, float]:
    """Compile the instances whose shared object is missing, one nvcc each,
    as many at once as the machine has cores, the largest shapes first.
    Returns each compiled instance's build wall in seconds; raises, naming
    every instance that failed, once all have run."""
    todo = sorted({i for i in instances if not i.paths()[0].exists()},
                  key=lambda i: (-i.b * (i.b + i.r), i.name))
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workers = min(len(todo), os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        futures = {inst: pool.submit(_compile_one, inst) for inst in todo}
    walls, failed = {}, []
    for inst, future in futures.items():
        try:
            walls[inst] = future.result()
        except RuntimeError as err:
            failed.append(str(err))
    if failed:
        raise RuntimeError("\n".join(failed))
    return walls


_LOADED: dict[Instance, Built] = {}


def load_all(instances) -> dict[Instance, Built]:
    """Compile the missing instances concurrently and load every one."""
    instances = list(dict.fromkeys(instances))
    seconds = prebuild([i for i in instances if i not in _LOADED])
    for inst in instances:
        if inst not in _LOADED:
            so, log = inst.paths()
            profiling.count("kernel_loads")
            with profiling.span("build.load"):
                lib = ctypes.CDLL(str(so))
            _LOADED[inst] = Built(
                lib=lib, path=so,
                seconds=seconds.get(inst, 0.0),
                log=log.read_text() if log.exists() else "")
    return {inst: _LOADED[inst] for inst in instances}


def load(inst: Instance) -> Built:
    """Compile the instance if needed and load it."""
    return load_all([inst])[inst]


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
