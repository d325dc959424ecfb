"""Batched block-Thomas solve: the CUDA kernel's wrapper and its plain version.

Counterpart of ``collocfem_tpu/ops/blocktri_pallas.py::batched_thomas_solve``:
many independent short SPD block-tridiagonal chains (config 5's block-major
layout: 1024 experiments of K = 11 blocks), each solved by a pivot-free
block-Cholesky forward sweep and back-substitution.

:func:`batched_thomas_solve` launches the hand-written CUDA kernel
``csrc/thomas.cu`` on a CUDA tensor (or raises) and calls
:func:`batched_thomas_solve_ref`, the plain version, on a CPU tensor.  Each
counts its calls in a plain integer attribute (``.launches``); the kernel
wrapper also counts its launches at each (b, r) in ``.shapes``.  The kernel
is built for each (b, r) at its first use (``ops._build``), for 1 <= b <= 16
and 1 <= r <= 17; a shape outside that range raises ValueError before any
launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.ops import smallblocks as sb


MAX_RHS = 17    # r = 1 + nq at nq = 16


def kernel_supports(block_size: int, nrhs: int) -> bool:
    """Whether the kernel takes (block size, r): 1 <= b <= 16, 1 <= r <=
    17."""
    return 1 <= block_size <= _build.MAX_BLOCK and 1 <= nrhs <= MAX_RHS


def instance(block_size: int, nrhs: int) -> _build.Instance:
    """The library instance at (block size, r); raises ValueError, naming
    the range, for a shape the kernel does not take."""
    if not kernel_supports(block_size, nrhs):
        raise ValueError(
            f"kernel #7 takes 1 <= b <= {_build.MAX_BLOCK} and 1 <= r <= "
            f"{MAX_RHS}, not b={block_size}, r={nrhs}")
    return _build.Instance("thomas", block_size, nrhs)


@functools.cache
def _library(b: int, r: int) -> ctypes.CDLL:
    """The instance at (b, r), built at its first use and loaded."""
    lib = _build.load(instance(b, r)).lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("thomas_f32", "thomas_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32, i32, i64, i32, ptr]
        fn.restype = i32
    lib.thomas_supported.argtypes = [i32, i32]
    lib.thomas_supported.restype = i32
    lib.thomas_error_string.argtypes = [i32]
    lib.thomas_error_string.restype = ctypes.c_char_p
    if not lib.thomas_supported(b, r):
        raise RuntimeError(f"the library loaded for thomas-b{b}-r{r} is "
                           "another instance")
    return lib


def batched_thomas_solve_ref(D, E, G):
    """Plain version: the algorithm of the TPU kernel's ``_thomas_kernel``,
    a loop over the chain with batched block ops over the experiments."""
    batched_thomas_solve_ref.launches += 1
    k = D.shape[1]
    ls, ys = [sb.chol(D[:, 0])], [G[:, 0]]
    for i in range(1, k):
        e_prev = E[:, i - 1]
        w = sb.chol_solve(ls[-1], e_prev)                    # S^-1 E
        ls.append(sb.chol(D[:, i] - e_prev.mT @ w))          # D - E^T S^-1 E
        ys.append(G[:, i] - w.mT @ ys[-1])
    xs = [sb.chol_solve(ls[-1], ys[-1])]
    for i in range(k - 2, -1, -1):
        xs.append(sb.chol_solve(ls[i], ys[i] - E[:, i] @ xs[-1]))
    return torch.stack(xs[::-1], dim=1)


_build.register(batched_thomas_solve_ref, shapes=False)


def batched_thomas_solve(D, E, G):
    """Solve a batch of SPD block-tridiagonal systems.

    D, E (n_exp, K, b, b) with E[:, K-1] ignored, G (n_exp, K, b, r).
    Returns X (n_exp, K, b, r) with A_e X_e = G_e for every experiment e.
    """
    if D.device.type == "cpu":
        return batched_thomas_solve_ref(D, E, G)
    if D.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {D.device}")
    n_exp, k, b, _ = D.shape
    r = G.shape[-1]
    _build.check_operands([("D", D, (n_exp, k, b, b)),
                           ("E", E, (n_exp, k, b, b)),
                           ("G", G, (n_exp, k, b, r))])
    if n_exp < 1 or k < 1:
        raise ValueError(f"kernel #7 needs n_exp >= 1 and K >= 1, not "
                         f"n_exp={n_exp}, K={k}")
    lib = _library(b, r)
    X = G.new_empty(G.shape)
    lf = D.new_empty((n_exp, k, b, 2 * b))      # each lane's row and column
    fn = lib.thomas_f32 if D.dtype == torch.float32 else lib.thomas_f64
    with torch.cuda.device(D.device):
        rc = fn(*(x.data_ptr() for x in (D, E, G, X, lf)), b, r, n_exp, k,
                torch.cuda.current_stream(D.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("thomas launch failed: "
                           + lib.thomas_error_string(rc).decode())
    _build.count_launches(batched_thomas_solve, (b, r))
    return X


_build.register(batched_thomas_solve, shapes=True)
