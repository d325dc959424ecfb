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
on a CUDA tensor it launches the kernel or raises.  The library is built
for each shape at its first use (``ops._build``): kernel #1 for any block
size 1 <= b <= 16 and 1 <= nq <= 16 (the instance ``kkt_spike`` at r = 1 +
nq), kernel #2 for 1 <= b <= 16 and 1 <= r <= 1 + 16 + 2 b (the sharded
interior's [G | U | V], ``parallel/spike.py``; the instance
``spike_chain``).  A shape outside that range raises ValueError before any
launch.  Each function counts its
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


MAX_NQ = 16    # the parameters of kernel #1's unrolled Schur solve


def kernel_supports(block_size: int, nq: int) -> bool:
    """Whether the fused KKT kernel takes (block size, nq): 1 <= b <= 16,
    1 <= nq <= 16."""
    return 1 <= block_size <= _build.MAX_BLOCK and 1 <= nq <= MAX_NQ


def chain_kernel_supports(block_size: int, nrhs: int) -> bool:
    """Whether the plain chain kernel takes (block size, r): 1 <= b <= 16,
    1 <= r <= 1 + 16 + 2 b (the sharded interior's [G | U | V] at nq =
    16)."""
    return (1 <= block_size <= _build.MAX_BLOCK
            and 1 <= nrhs <= 1 + MAX_NQ + 2 * block_size)


def kkt_instance(block_size: int, nq: int) -> _build.Instance:
    """The library instance of kernel #1 at (block size, nq); raises
    ValueError, naming the range, for a shape the kernel does not take."""
    if not kernel_supports(block_size, nq):
        raise ValueError(
            f"kernel #1 takes 1 <= b <= {_build.MAX_BLOCK} and 1 <= nq <= "
            f"{MAX_NQ}, not b={block_size}, nq={nq}")
    return _build.Instance("kkt_spike", block_size, 1 + nq)


def chain_instance(block_size: int, nrhs: int) -> _build.Instance:
    """The library instance of kernel #2 at (block size, r); raises
    ValueError, naming the range, for a shape the kernel does not take."""
    if not chain_kernel_supports(block_size, nrhs):
        raise ValueError(
            f"kernel #2 takes 1 <= b <= {_build.MAX_BLOCK} and 1 <= r <= 1 + "
            f"{MAX_NQ} + 2 b, not b={block_size}, r={nrhs}")
    return _build.Instance("spike_chain", block_size, nrhs)


@functools.cache
def _library(inst: _build.Instance) -> ctypes.CDLL:
    """The instance ``inst`` (``kkt_spike`` or ``spike_chain``), built at its
    first use and loaded."""
    cdll = _build.load(inst).lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    kkt = inst.lib == "kkt_spike"
    for suffix in ("_f32", "_f64"):
        fn = getattr(cdll, inst.lib + suffix)
        fn.argtypes = [ptr] * (8 if kkt else 5) + [i32, i32, i64, i32, i32,
                                                   ptr]
        fn.restype = i32
    supported = getattr(cdll, inst.lib + "_supported")
    supported.argtypes, supported.restype = [i32, i32], i32
    elems = getattr(cdll, inst.lib + "_scratch_elems")
    elems.argtypes, elems.restype = [i32, i32, i32, i32], i64
    cdll.kkt_spike_error_string.argtypes = [i32]
    cdll.kkt_spike_error_string.restype = ctypes.c_char_p
    if not supported(inst.b, inst.r - kkt):      # (b, nq) for kernel #1
        raise RuntimeError(f"the library loaded for {inst.name} is another "
                           "instance")
    return cdll


def kkt_solve_spike_fused_ref(D, E, B, gx, C, gp, lam, damp_scale=None):
    """Plain version of the fused kernel: equilibrate, cyclic reduction on
    [gx | B], Schur solve, compose and unscale (``solve.kkt``)."""
    kkt_solve_spike_fused_ref.launches += 1
    return solve_kkt_plain(BlockTriSystemSoA(D=D, E=E, B=B, C=C, gx=gx, gp=gp),
                           lam, damp_scale)


_build.register(kkt_solve_spike_fused_ref, shapes=False)


def _check(D, E, B, gx, C, gp) -> _build.Instance:
    """Check the operands; returns kernel #1's instance at their shape."""
    b, _, K = D.shape
    nq = B.shape[1]
    _build.check_operands(
        [("D", D, (b, b, K)), ("E", E, (b, b, K)), ("B", B, (b, nq, K)),
         ("gx", gx, (b, K)), ("C", C, (nq, nq)), ("gp", gp, (nq,))],
        contiguous=("D", "E"))
    return kkt_instance(b, nq)


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
    inst = _check(D, E, B, gx, C, gp)
    b, _, K = D.shape
    nq = B.shape[1]
    lam_abs, dmax, inv, c_damped, inv_sp = damping_scales(D, C, lam,
                                                          damp_scale)
    G = torch.cat([gx[:, None, :], B * inv_sp[None, :, None]], dim=1)
    cg = torch.cat([c_damped * inv_sp[:, None] * inv_sp[None, :],
                    (gp * inv_sp)[:, None]], dim=1)
    T, L = _plan(K)
    lib = _library(inst)
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
    lib = _library(chain_instance(b, r))
    T, L = _plan(K)
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
