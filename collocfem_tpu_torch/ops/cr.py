"""Cyclic-reduction levels: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``collocfem_tpu/ops/cr_pallas.py``.  One level of block cyclic
reduction on an SPD chain in SoA layout (blocks (b, b, m), right-hand sides
(b, r, m), m even) eliminates the odd blocks and halves the chain:

  * :func:`cr_level` (kernel #3): both halves of a level in one pass;
  * :func:`cr_level_factor` (kernel #4): the G-independent half, returning
    the halved (D, E) and a :class:`LevelFactor` for later sweeps;
  * :func:`cr_level_apply` (kernel #5): reduces G through a stored factor;
  * :func:`cr_backsub` (kernel #6): recovers the odd blocks of the solution
    and interleaves them with the even ones;
  * :func:`cr_factor_sweep` and :func:`cr_apply_sweep`: kernels #4 and #5
    level after level down to a tail, each one call of the library on a
    CUDA tensor, with every level's outputs a view of one workspace.

The plain math is :func:`level_factor_plain`, :func:`level_apply_plain`,
:func:`level_plain` and :func:`backsub_plain`: pure torch, never a kernel.
The plain versions (``*_ref``) count their calls and run it; so do the
plain chain solves of ``solve.blocktri`` that kernels #1 and #2 are held
against.  On a CPU tensor each wrapper calls its plain version; on a CUDA
tensor it launches the kernel of ``csrc/cr.cu`` or raises.  Each function
counts its calls in a plain integer attribute (``.launches``); a sweep adds
its number of levels to the count of its per-level wrapper.
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


def sweep_levels(m: int, tail: int) -> int:
    """Levels a sweep runs on a chain of m blocks: it halves the chain while
    it has more than ``tail`` blocks.  Every level needs an even chain."""
    levels = 0
    while m > tail:
        if m % 2:
            raise ValueError("a CR level needs an even chain length, not "
                             f"{m} (level {levels} of the sweep)")
        m //= 2
        levels += 1
    return levels


def _walk_factor(factor, Ds, Es, tail):
    """``factor`` level after level while the chain has more than ``tail``
    blocks: ((Ds, Es) of the tail, [LevelFactor per level])."""
    facs = []
    for _ in range(sweep_levels(Ds.shape[-1], tail)):
        (Ds, Es), fac = factor(Ds, Es)
        facs.append(fac)
    return (Ds, Es), facs


def _walk_apply(apply, facs, Gs):
    """``apply`` through every level's factor: (Gs of the tail, [s_g per
    level])."""
    s_gs = []
    for fac in facs:
        Gs, s_g = apply(fac, Gs)
        s_gs.append(s_g)
    return Gs, s_gs


def factor_sweep_plain(Ds, Es, tail):
    """:func:`cr_factor_sweep` on the plain level math, on any device."""
    return _walk_factor(level_factor_plain, Ds, Es, tail)


def apply_sweep_plain(facs, Gs):
    """:func:`cr_apply_sweep` on the plain level math, on any device."""
    return _walk_apply(level_apply_plain, facs, Gs)


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
    signatures = {"cr_factor_sweep": [ptr] * 3 + [i32, i64, i32, ptr],
                  "cr_apply_sweep": [ptr] * 4 + [i32, i32, i64, i32, ptr],
                  "cr_level": [ptr] * 9 + [i32, i32, i64, ptr],
                  "cr_backsub": [ptr] * 5 + [i32, i32, i64, ptr]}
    for name, argtypes in signatures.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = i32
    lib.cr_supported.argtypes = [i32, i32]
    lib.cr_supported.restype = i32
    lib.cr_device_launches.argtypes = []
    lib.cr_device_launches.restype = ctypes.c_ulonglong
    lib.cr_error_string.argtypes = [i32]
    lib.cr_error_string.restype = ctypes.c_char_p
    return lib


def kernel_supports(block_size: int, nrhs: int) -> bool:
    """Whether the CR kernels are compiled for (block size, r); ``nrhs=0``
    asks for the factor kernel alone, which needs only the block size."""
    return bool(_library().cr_supported(block_size, nrhs))


def device_launches() -> int:
    """Kernel launches the CR library has made since it was loaded."""
    return int(_library().cr_device_launches())


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


def sweep_layout(arrays: int, rows: int, h0: int, levels: int):
    """Where a sweep's levels lie in its one workspace: ([start of level lv,
    in elements], total elements).  Level lv (h = h0 >> lv pairs) holds
    ``arrays`` outputs of ``rows`` rows and h columns each, one after the
    other, and the levels follow each other, so level lv starts at arrays *
    rows * 2 (h0 - h): ``cr::sweep_offset`` of ``csrc/cr_kernels.cuh``."""
    start = lambda h: arrays * rows * 2 * (h0 - h)
    return [start(h0 >> lv) for lv in range(levels)], start(h0 >> levels)


def _level_views(ws, start, arrays, rows_shape, h):
    """The ``arrays`` outputs (*rows_shape, h) of the level at ``start``."""
    shape, strides = (arrays, *rows_shape, h), [1]
    for d in reversed(shape[1:]):
        strides.insert(0, strides[0] * d)
    return ws.as_strided(shape, strides, start).unbind(0)


def _factor_levels(Ds, Es, levels):
    """``levels`` levels of kernel #4 on a CUDA chain, one library call."""
    b, m = Ds.shape[0], Ds.shape[-1]
    _build.check_operands([("Ds", Ds, (b, b, m)), ("Es", Es, (b, b, m))])
    b, h0 = _level_shape(Ds, 0)
    starts, total = sweep_layout(5, b * b, h0, levels)
    ws = Ds.new_empty(total)
    _launch("cr_factor_sweep", Ds.dtype, Ds.device, Ds.data_ptr(),
            Es.data_ptr(), ws.data_ptr(), b, h0, levels)
    cr_level_factor.launches += levels
    facs = []
    for lv, start in enumerate(starts):
        dn, en, su, sl, lo = _level_views(ws, start, 5, (b, b), h0 >> lv)
        facs.append(LevelFactor(lo, su, sl, Es))
        Es = en
    return (dn, en), facs


def _apply_levels(facs, Gs):
    """Kernel #5 through every level's factor on CUDA tensors, one library
    call."""
    b, r, m = Gs.shape
    levels = len(facs)
    operands = [("Gs", Gs, (b, r, m))]
    for lv, fac in enumerate(facs):
        operands += [("L", fac.L, (b, b, m >> (lv + 1))),
                     ("E", fac.E, (b, b, m >> lv))]
    _build.check_operands(operands)
    if m % (1 << levels):
        raise ValueError(f"a CR level needs an even chain length: {m} blocks "
                         f"do not halve {levels} times")
    b, h0 = _level_shape(facs[0].E, r)
    starts, total = sweep_layout(2, b * r, h0, levels)
    ws = Gs.new_empty(total)
    pointers = ctypes.c_void_p * levels
    _launch("cr_apply_sweep", Gs.dtype, Gs.device,
            pointers(*(fac.L.data_ptr() for fac in facs)),
            pointers(*(fac.E.data_ptr() for fac in facs)), Gs.data_ptr(),
            ws.data_ptr(), b, r, h0, levels)
    cr_level_apply.launches += levels
    s_gs = []
    for lv, start in enumerate(starts):
        gn, sg = _level_views(ws, start, 2, (b, r), h0 >> lv)
        s_gs.append(sg)
    return gn, s_gs


def cr_level_factor(Ds, Es):
    """G-independent half of one level (kernel #4).

    Ds, Es (b, b, m), m even.  Returns ((d_new, e_new) (b, b, m/2),
    :class:`LevelFactor`); the factor keeps a reference to ``Es``.
    """
    if not _on_card(Ds):
        return cr_level_factor_ref(Ds, Es)
    (dn, en), (fac,) = _factor_levels(Ds, Es, 1)
    return (dn, en), fac


def cr_level_apply(fac: LevelFactor, Gs):
    """Right-hand-side half of one level through a stored factor (kernel
    #5).  Gs (b, r, m).  Returns (g_new, s_g), each (b, r, m/2)."""
    if not _on_card(Gs):
        return cr_level_apply_ref(fac, Gs)
    gn, (sg,) = _apply_levels([fac], Gs)
    return gn, sg


def cr_factor_sweep(Ds, Es, tail: int):
    """Kernel #4 level after level while the chain has more than ``tail``
    blocks.  Returns ((Ds, Es) of the tail, [:class:`LevelFactor` per
    level]).  On a CUDA tensor the whole sweep is one call of the library
    (a kernel launch per level) and every level's outputs are views of one
    workspace; on a CPU tensor it walks the per-level plain version.  Adds
    its levels to ``cr_level_factor.launches``."""
    if not _on_card(Ds):
        return _walk_factor(cr_level_factor_ref, Ds, Es, tail)
    levels = sweep_levels(Ds.shape[-1], tail)
    return _factor_levels(Ds, Es, levels) if levels else ((Ds, Es), [])


def cr_apply_sweep(facs, Gs):
    """Kernel #5 through the factors of :func:`cr_factor_sweep`.  Returns
    (Gs of the tail, [s_g per level]); one call of the library on a CUDA
    tensor, the per-level plain version on a CPU tensor.  Adds its levels to
    ``cr_level_apply.launches``."""
    if not _on_card(Gs):
        return _walk_apply(cr_level_apply_ref, facs, Gs)
    return _apply_levels(facs, Gs) if facs else (Gs, [])


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
    dn, en, su, sl = (Ds.new_empty((b, b, h)) for _ in range(4))
    gn, sg = (Ds.new_empty((b, r, h)) for _ in range(2))
    _launch("cr_level", Ds.dtype, Ds.device,
            *(x.data_ptr() for x in (Ds, Es, Gs, dn, en, gn, su, sl, sg)),
            b, r, h)
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
