"""Cyclic-reduction levels: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``collocfem_tpu/ops/cr_pallas.py``.  One level of block cyclic
reduction on an SPD chain in SoA layout (blocks (b, b, m), right-hand sides
(b, r, m), m even) eliminates the odd blocks and halves the chain:

  * :func:`cr_level` (kernel #3): both halves of a level in one pass;
  * :func:`cr_level_factor` (kernel #4): the G-independent half, returning
    the halved (D, E) and a :class:`LevelFactor` for later sweeps;
  * :func:`cr_level_apply` (kernel #5): reduces G through a stored factor;
  * :func:`cr_backsub` (kernel #6): recovers the odd blocks of the solution
    and interleaves them with the even ones.

The plain math is :func:`level_factor_plain`, :func:`level_apply_plain`,
:func:`level_plain` and :func:`backsub_plain`: pure torch, never a kernel.
The plain versions (``*_ref``) count their calls and run it; so do the
plain chain solves of ``solve.blocktri`` that kernels #1 and #2 are held
against.  On a CPU tensor each wrapper calls its plain version; on a CUDA
tensor it launches the kernel of ``csrc/cr.cu`` or raises.  Each function
counts its calls in a plain integer attribute (``.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.ops import smallblocks_soa as soa


class LevelFactor(NamedTuple):
    """What a level's later sweeps need: L (b, b, h), the lower Cholesky
    factor of the odd blocks (zeros above the diagonal); s_up = D_odd^-1
    e_up^T and s_lo = D_odd^-1 e_lo (b, b, h); and E (b, b, 2h), the
    level's input couplings, kept rather than copied."""

    L: torch.Tensor
    s_up: torch.Tensor
    s_lo: torch.Tensor
    E: torch.Tensor

    @property
    def e_up(self):
        """(b, b, h) couplings even -> odd."""
        return self.E[..., 0::2]

    @property
    def e_lo(self):
        """(b, b, h) couplings odd -> next even."""
        return self.E[..., 1::2]


def _subtract_shifted(A, cross):
    """A[..., j] -= cross[..., j - 1]: pair j - 1's cross term lands on
    pair j."""
    A[..., 1:] -= cross[..., :-1]
    return A


# ---- the plain math -----------------------------------------------------------


def level_factor_plain(Ds, Es):
    """G-independent half of one level: ((d_new, e_new), LevelFactor)."""
    d_even, d_odd = Ds[..., 0::2], Ds[..., 1::2]
    e_up, e_lo = Es[..., 0::2], Es[..., 1::2]
    L = soa.chol(d_odd)
    s_up = soa.chol_solve(L, soa.transpose(e_up))
    s_lo = soa.chol_solve(L, e_lo)
    d_new = _subtract_shifted(d_even - soa.mm(e_up, s_up),
                              soa.mtm(e_lo, s_lo))
    return (d_new, -soa.mm(e_up, s_lo)), LevelFactor(L, s_up, s_lo, Es)


def level_apply_plain(fac: LevelFactor, Gs):
    """Right-hand-side half of one level: (g_new, s_g)."""
    s_g = soa.chol_solve(fac.L, Gs[..., 1::2])
    g_new = _subtract_shifted(Gs[..., 0::2] - soa.mm(fac.e_up, s_g),
                              soa.mtm(fac.e_lo, s_g))
    return g_new, s_g


def level_plain(Ds, Es, Gs):
    """One whole level: ((d_new, e_new, g_new), (s_up, s_lo, s_g))."""
    (d_new, e_new), fac = level_factor_plain(Ds, Es)
    g_new, s_g = level_apply_plain(fac, Gs)
    return (d_new, e_new, g_new), (fac.s_up, fac.s_lo, s_g)


def backsub_plain(x_even, s_up, s_lo, s_g):
    """x_odd = s_g - s_up x_even - s_lo x_right, interleaved with x_even:
    (b, r, h) -> (b, r, 2h)."""
    b, r, h = x_even.shape
    x_right = torch.cat([x_even[..., 1:], torch.zeros_like(x_even[..., :1])],
                        dim=-1)
    x_odd = s_g - soa.mm(s_up, x_even) - soa.mm(s_lo, x_right)
    return torch.stack([x_even, x_odd], dim=-1).reshape(b, r, 2 * h)


# ---- plain versions (counted) -------------------------------------------------


def cr_level_ref(Ds, Es, Gs):
    """Plain version of kernel #3."""
    cr_level_ref.launches += 1
    return level_plain(Ds, Es, Gs)


def cr_level_factor_ref(Ds, Es):
    """Plain version of kernel #4."""
    cr_level_factor_ref.launches += 1
    return level_factor_plain(Ds, Es)


def cr_level_apply_ref(fac, Gs):
    """Plain version of kernel #5."""
    cr_level_apply_ref.launches += 1
    return level_apply_plain(fac, Gs)


def cr_backsub_ref(x_even, s_up, s_lo, s_g):
    """Plain version of kernel #6."""
    cr_backsub_ref.launches += 1
    return backsub_plain(x_even, s_up, s_lo, s_g)


for _fn in (cr_level_ref, cr_level_factor_ref, cr_level_apply_ref,
            cr_backsub_ref):
    _fn.launches = 0


# ---- the kernels --------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("cr").lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {"cr_factor": [ptr] * 8 + [i32, i64, ptr],
                  "cr_apply": [ptr] * 6 + [i32, i32, i64, ptr],
                  "cr_level": [ptr] * 11 + [i32, i32, i64, ptr],
                  "cr_backsub": [ptr] * 5 + [i32, i32, i64, ptr]}
    for name, argtypes in signatures.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = i32
    lib.cr_supported.argtypes = [i32, i32]
    lib.cr_supported.restype = i32
    lib.cr_error_string.argtypes = [i32]
    lib.cr_error_string.restype = ctypes.c_char_p
    return lib


def kernel_supports(block_size: int, nrhs: int) -> bool:
    """Whether the CR kernels are compiled for (block size, r); ``nrhs=0``
    asks for the factor kernel alone, which needs only the block size."""
    return bool(_library().cr_supported(block_size, nrhs))


def _launch(name, dtype, device, *args):
    lib = _library()
    fn = getattr(lib, name + ("_f32" if dtype == torch.float32 else "_f64"))
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.cr_error_string(rc).decode())


def _on_card(x) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    tensor; any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    return True


def _level_shape(Ds, nrhs):
    b, _, m = Ds.shape
    if m < 2 or m % 2:
        raise ValueError(f"a CR level needs an even chain length, not {m}")
    if not kernel_supports(b, nrhs):
        raise ValueError(f"the CR kernels are not built for b={b}, r={nrhs}")
    return b, m // 2


def cr_level_factor(Ds, Es):
    """G-independent half of one level (kernel #4).

    Ds, Es (b, b, m), m even.  Returns ((d_new, e_new) (b, b, m/2),
    :class:`LevelFactor`); the factor keeps a reference to ``Es``.
    """
    if not _on_card(Ds):
        return cr_level_factor_ref(Ds, Es)
    b, m = Ds.shape[0], Ds.shape[-1]
    _build.check_operands([("Ds", Ds, (b, b, m)), ("Es", Es, (b, b, m))])
    b, h = _level_shape(Ds, 0)
    dn, en, su, sl, lo, cd = (Ds.new_empty((b, b, h)) for _ in range(6))
    _launch("cr_factor", Ds.dtype, Ds.device,
            *(x.data_ptr() for x in (Ds, Es, dn, en, su, sl, lo, cd)), b, h)
    cr_level_factor.launches += 1
    return (dn, en), LevelFactor(lo, su, sl, Es)


def cr_level_apply(fac: LevelFactor, Gs):
    """Right-hand-side half of one level through a stored factor (kernel
    #5).  Gs (b, r, m).  Returns (g_new, s_g), each (b, r, m/2)."""
    if not _on_card(Gs):
        return cr_level_apply_ref(fac, Gs)
    b, r, m = Gs.shape
    _build.check_operands([("Gs", Gs, (b, r, m)), ("L", fac.L, (b, b, m // 2)),
                           ("E", fac.E, (b, b, m))])
    b, h = _level_shape(fac.E, r)
    gn, sg, cg = (Gs.new_empty((b, r, h)) for _ in range(3))
    _launch("cr_apply", Gs.dtype, Gs.device,
            *(x.data_ptr() for x in (fac.L, fac.E, Gs, gn, sg, cg)), b, r, h)
    cr_level_apply.launches += 1
    return gn, sg


def cr_level(Ds, Es, Gs):
    """One whole level in one pass (kernel #3).

    Ds, Es (b, b, m), Gs (b, r, m).  Returns ((d_new, e_new, g_new),
    (s_up, s_lo, s_g)), every array of chain length m/2.
    """
    if not _on_card(Ds):
        return cr_level_ref(Ds, Es, Gs)
    b, r, m = Gs.shape
    _build.check_operands([("Ds", Ds, (b, b, m)), ("Es", Es, (b, b, m)),
                           ("Gs", Gs, (b, r, m))])
    b, h = _level_shape(Ds, r)
    dn, en, su, sl, cd = (Ds.new_empty((b, b, h)) for _ in range(5))
    gn, sg, cg = (Ds.new_empty((b, r, h)) for _ in range(3))
    _launch("cr_level", Ds.dtype, Ds.device,
            *(x.data_ptr() for x in (Ds, Es, Gs, dn, en, gn, su, sl, sg, cd,
                                     cg)), b, r, h)
    cr_level.launches += 1
    return (dn, en, gn), (su, sl, sg)


def cr_backsub(x_even, s_up, s_lo, s_g):
    """Back-substitution of one level (kernel #6): (b, r, h) -> X (b, r, 2h)
    with X[..., 0::2] = x_even and X[..., 1::2] = x_odd."""
    if not _on_card(x_even):
        return cr_backsub_ref(x_even, s_up, s_lo, s_g)
    b, r, h = x_even.shape
    _build.check_operands([("x_even", x_even, (b, r, h)),
                           ("s_up", s_up, (b, b, h)), ("s_lo", s_lo, (b, b, h)),
                           ("s_g", s_g, (b, r, h))])
    if not kernel_supports(b, r):
        raise ValueError(f"the CR kernels are not built for b={b}, r={r}")
    X = x_even.new_empty((b, r, 2 * h))
    _launch("cr_backsub", x_even.dtype, x_even.device,
            *(x.data_ptr() for x in (x_even, s_up, s_lo, s_g, X)), b, r, h)
    cr_backsub.launches += 1
    return X


for _fn in (cr_level, cr_level_factor, cr_level_apply, cr_backsub):
    _fn.launches = 0
del _fn
