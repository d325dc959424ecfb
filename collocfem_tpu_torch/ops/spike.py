"""SPIKE chain solves: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``collocfem_tpu/ops/spike_pallas.py``.  Both kernels live in
the CUDA library ``csrc/kkt_spike.cu`` and share one SPIKE core:

  * :func:`kkt_solve_spike_fused` (``kkt_solve_spike_fused``, kernel #1)
    does in torch what the JAX wrapper does in XLA around its kernel
    (damping scale, Jacobi scales, the scaled Schur corner and the
    right-hand-side group [gx | B inv_sp]), launches the fused damped-KKT
    solve, and forms dp = -t inv_sp.
  * :func:`blocktri_solve_spike_fused` (``blocktri_solve_spike_fused``,
    kernel #2) solves A X = G for the raw chain: no scaling, no Schur step.

On a CPU tensor each wrapper calls its plain version
(:func:`kkt_solve_spike_fused_ref`, :func:`blocktri_solve_spike_fused_ref`);
on a CUDA tensor it launches the kernel or raises.  Each function counts its
calls in a plain integer attribute (``.launches``) so that a run can show
which path it took; a kernel wrapper also counts its launches at each (b,
nq or r) in ``.shapes``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA
from collocfem_tpu_torch.solve.blocktri import blocktri_cr_factor_plain
from collocfem_tpu_torch.solve.kkt import damping_scales, solve_kkt_plain


def _plan(K: int, T: int | None = None) -> tuple[int, int]:
    """Tiles (T, L) for a K-block chain: L >= 3 blocks per tile, T L >= K.
    ``T`` asks for about that many tiles (``tools/spike_tiles.py`` sweeps
    it); by default it comes from the cost model below.

    The kernel's time is about a L + b T: the tile phases take a forward
    and a backward block step per block of a tile (then one of the
    back-substitution), all tiles at once, and the interface chain takes a
    forward and a backward step per boundary block, two per tile, on one
    lane group.  Measured on the H100 (PERF.md, ``tools/spike_tiles.py``):
    a ~ 5.2 us and b ~ 5.0 us in float32, a ~ 10 us and b ~ 7.4 us in
    float64, so T = sqrt(a K / b) ~ 1.0-1.2 sqrt(K) minimises it; T = 1.1
    sqrt(K).  T is then trimmed so fewer than L blocks are padding.
    """
    if T is None:
        T = max(1, min(round(1.1 * math.sqrt(K)), K // 3))
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
    for name in ("spike_chain_f32", "spike_chain_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32, i32, i64, i32, i32, ptr]
        fn.restype = i32
    for name in ("kkt_spike_supported", "spike_chain_supported"):
        getattr(lib, name).argtypes = [i32, i32]
        getattr(lib, name).restype = i32
    for name in ("kkt_spike_scratch_elems", "spike_chain_scratch_elems"):
        getattr(lib, name).argtypes = [i32, i32, i32, i32]
        getattr(lib, name).restype = i64
    lib.kkt_spike_error_string.argtypes = [i32]
    lib.kkt_spike_error_string.restype = ctypes.c_char_p
    return lib


def kernel_supports(block_size: int, nq: int) -> bool:
    """Whether the fused KKT kernel is compiled for this (block size, nq)."""
    return bool(_library().kkt_spike_supported(block_size, nq))


def chain_kernel_supports(block_size: int, nrhs: int) -> bool:
    """Whether the plain chain kernel is compiled for this (block size, r)."""
    return bool(_library().spike_chain_supported(block_size, nrhs))


def kkt_solve_spike_fused_ref(D, E, B, gx, C, gp, lam, damp_scale=None):
    """Plain version of the fused kernel: equilibrate, cyclic reduction on
    [gx | B], Schur solve, compose and unscale (``solve.kkt``)."""
    kkt_solve_spike_fused_ref.launches += 1
    return solve_kkt_plain(BlockTriSystemSoA(D=D, E=E, B=B, C=C, gx=gx, gp=gp),
                           lam, damp_scale)


_build.register(kkt_solve_spike_fused_ref, shapes=False)


def _check(D, E, B, gx, C, gp):
    b, _, K = D.shape
    nq = B.shape[1]
    _build.check_operands(
        [("D", D, (b, b, K)), ("E", E, (b, b, K)), ("B", B, (b, nq, K)),
         ("gx", gx, (b, K)), ("C", C, (nq, nq)), ("gp", gp, (nq,))],
        contiguous=("D", "E"))
    if nq < 1 or not kernel_supports(b, nq):
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
    _build.count_launches(kkt_solve_spike_fused, (b, nq))
    return dx, -t * inv_sp, dmax


_build.register(kkt_solve_spike_fused, shapes=True)


# ---- kernel #2: the plain SPIKE chain solve -----------------------------------


def blocktri_solve_spike_fused_ref(Ds, Es, Gs):
    """Plain version of the chain kernel: the plain cyclic reduction
    (``solve.blocktri.blocktri_cr_factor_plain``, no kernel on any device),
    what the JAX package's ``parallel.batch.concat_chain_solver`` runs off
    the TPU."""
    blocktri_solve_spike_fused_ref.launches += 1
    return blocktri_cr_factor_plain(Ds, Es)(Gs)


_build.register(blocktri_solve_spike_fused_ref, shapes=False)


def blocktri_solve_spike_fused(Ds, Es, Gs):
    """SPIKE solve of the SPD block-tridiagonal chain A X = G in one kernel
    library call (three launches).

    SoA inputs: Ds, Es (b, b, K) with Es[..., K-1] ignored, Gs (b, r, K).
    Returns X (b, r, K).  Couplings that are exactly zero (experiment
    boundaries of a concatenated chain) are ordinary blocks to the kernel.
    """
    if Ds.device.type == "cpu":
        return blocktri_solve_spike_fused_ref(Ds, Es, Gs)
    if Ds.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {Ds.device}")
    b, _, K = Ds.shape
    r = Gs.shape[1]
    _build.check_operands([("Ds", Ds, (b, b, K)), ("Es", Es, (b, b, K)),
                           ("Gs", Gs, (b, r, K))])
    if not chain_kernel_supports(b, r):
        raise ValueError(f"the chain kernel is not built for b={b}, r={r}")
    T, L = _plan(K)
    lib = _library()
    scratch = Ds.new_empty(lib.spike_chain_scratch_elems(b, r, T, L))
    X = Ds.new_empty((b, r, K))
    fn = lib.spike_chain_f32 if Ds.dtype == torch.float32 else \
        lib.spike_chain_f64
    with torch.cuda.device(Ds.device):
        rc = fn(*(x.data_ptr() for x in (Ds, Es, Gs, X, scratch)), b, r, K,
                T, L, torch.cuda.current_stream(Ds.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("spike_chain launch failed: "
                           + lib.kkt_spike_error_string(rc).decode())
    _build.count_launches(blocktri_solve_spike_fused, (b, r))
    return X


_build.register(blocktri_solve_spike_fused, shapes=True)
