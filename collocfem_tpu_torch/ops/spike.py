"""Fused damped-KKT solve: the CUDA kernel's wrapper and its plain version.

Counterpart of ``collocfem_tpu/ops/spike_pallas.py::kkt_solve_spike_fused``.
:func:`kkt_solve_spike_fused` does in torch what the JAX wrapper does in XLA
around its kernel (damping scale, Jacobi scales, the scaled Schur corner and
the right-hand-side group [gx | B inv_sp]), launches the hand-written CUDA
kernel ``csrc/kkt_spike.cu`` on the current stream, and forms
dp = -t inv_sp.  On a CPU tensor it calls :func:`kkt_solve_spike_fused_ref`,
the plain version; on a CUDA tensor it launches the kernel or raises.

Each function counts its calls in a plain integer attribute
(``kkt_solve_spike_fused.launches``, ``kkt_solve_spike_fused_ref.launches``)
so that a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA
from collocfem_tpu_torch.solve.kkt import damping_scales, solve_kkt_plain


def _plan(K: int) -> tuple[int, int]:
    """Tiles (T, L) for a K-block chain: L >= 3 blocks per tile, T L >= K.

    The kernel's time is about a L (the per-tile sweeps) + b T (the
    one-thread interface chain); measured on the H100, a/b is about 4 (the
    tile sweep in PERF.md), so T ~ 2 sqrt(K) minimises it.  T is then
    trimmed so fewer than L blocks are padding.
    """
    T = max(1, min(round(2.0 * math.sqrt(K)), K // 3))
    L = max(3, -(-K // T))
    return -(-K // L), L


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("kkt_spike").lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("kkt_spike_f32", "kkt_spike_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32, i32, i64, i32, i32, ptr]
        fn.restype = i32
    lib.kkt_spike_supported.argtypes = [i32, i32]
    lib.kkt_spike_supported.restype = i32
    lib.kkt_spike_scratch_elems.argtypes = [i32, i32, i32, i32]
    lib.kkt_spike_scratch_elems.restype = i64
    lib.kkt_spike_error_string.argtypes = [i32]
    lib.kkt_spike_error_string.restype = ctypes.c_char_p
    return lib


def build_kernel() -> _build.Built:
    """Build (or reuse) and load the kernel library; returns the build record."""
    return _build.load("kkt_spike")


def kernel_supports(block_size: int, nq: int) -> bool:
    """Whether the CUDA library is compiled for this (block size, nq)."""
    return bool(_library().kkt_spike_supported(block_size, nq))


def kkt_solve_spike_fused_ref(D, E, B, gx, C, gp, lam, damp_scale=None):
    """Plain version of the fused kernel: equilibrate, cyclic reduction on
    [gx | B], Schur solve, compose and unscale (``solve.kkt``)."""
    kkt_solve_spike_fused_ref.launches += 1
    return solve_kkt_plain(BlockTriSystemSoA(D=D, E=E, B=B, C=C, gx=gx, gp=gp),
                           lam, damp_scale)


kkt_solve_spike_fused_ref.launches = 0


def _check(D, E, B, gx, C, gp):
    b, b2, K = D.shape
    nq = B.shape[1]
    want = {"D": (b, b, K), "E": (b, b, K), "B": (b, nq, K), "gx": (b, K),
            "C": (nq, nq), "gp": (nq,)}
    for name, x in zip(want, (D, E, B, gx, C, gp)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if x.device != D.device or x.dtype != D.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected "
                             f"{D.dtype} on {D.device}")
    if b != b2 or nq < 1:
        raise ValueError("D must be (b, b, K) and B must have nq >= 1 columns")
    if D.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {D.dtype}")
    if not (D.is_contiguous() and E.is_contiguous()):
        raise ValueError("D and E must be contiguous")
    if not kernel_supports(b, nq):
        raise ValueError(f"the kernel is not built for b={b}, nq={nq}")


def kkt_solve_spike_fused(D, E, B, gx, C, gp, lam, damp_scale=None):
    """One-kernel damped KKT solve (equilibrate + SPIKE + arrowhead Schur).

    Raw SoA inputs: D, E (b, b, K) with E[..., K-1] ignored, B (b, nq, K)
    with nq >= 1, gx (b, K), C (nq, nq), gp (nq,); ``lam`` is the
    dimensionless damping and ``damp_scale`` optionally overrides the
    damping scale.  Returns (dx (b, K), dp (nq,), dmax) for
    [[A + lam_abs I, B], [B^T, C + lam_abs I]] [dx, dp] = -[gx, gp].
    """
    if D.device.type == "cpu":
        return kkt_solve_spike_fused_ref(D, E, B, gx, C, gp, lam, damp_scale)
    if D.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {D.device}")
    _check(D, E, B, gx, C, gp)
    b, _, K = D.shape
    nq = B.shape[1]
    lam_abs, dmax, inv, c_damped, inv_sp = damping_scales(D, C, lam,
                                                          damp_scale)
    G = torch.cat([gx[:, None, :], B * inv_sp[None, :, None]], dim=1)
    cg = torch.cat([c_damped * inv_sp[:, None] * inv_sp[None, :],
                    (gp * inv_sp)[:, None]], dim=1)
    T, L = _plan(K)
    lib = _library()
    scratch = D.new_empty(lib.kkt_spike_scratch_elems(b, nq, T, L))
    dx = D.new_empty((b, K))
    t = D.new_empty((nq,))
    fn = lib.kkt_spike_f32 if D.dtype == torch.float32 else lib.kkt_spike_f64
    operands = (D, E, G.contiguous(), inv.contiguous(), cg.contiguous(), dx,
                t, scratch)
    with torch.cuda.device(D.device):
        rc = fn(*(x.data_ptr() for x in operands), b, nq, K, T, L,
                torch.cuda.current_stream(D.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("kkt_spike launch failed: "
                           + lib.kkt_spike_error_string(rc).decode())
    kkt_solve_spike_fused.launches += 1
    return dx, -t * inv_sp, dmax


kkt_solve_spike_fused.launches = 0
