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
  * :func:`cr_factor_sweep`, :func:`cr_apply_sweep` and
    :func:`cr_backsub_sweep`: kernels #4, #5 and #6 level after level (down
    to a tail, and back up), each one call of the library on a CUDA tensor.
    The factor and apply sweeps write every level into one workspace and
    hand it back as :class:`SweepArrays`, whose levels' addresses the next
    sweep computes without making a view.

The plain math is :func:`level_factor_plain`, :func:`level_apply_plain`,
:func:`level_plain` and :func:`backsub_plain`: pure torch, never a kernel.
The plain versions (``*_ref``) count their calls and run it; so do the
plain chain solves of ``solve.blocktri`` that kernels #1 and #2 are held
against.  On a CPU tensor each wrapper calls its plain version; on a CUDA
tensor it launches the kernel of ``csrc/cr.cu`` or raises.  Each function
counts its calls in a plain integer attribute (``.launches``); a sweep adds
its number of levels to the count of its per-level wrapper.  A kernel
wrapper also counts its launches at each (b, r) in ``.shapes`` ((b,) for
kernel #4, which takes no right-hand side).  The library is built for each
shape at its first use (``ops._build``): kernel #4 at (b, r = 0), kernels
#3, #5 and #6 at (b, r), for 1 <= b <= 16 and 1 <= r <= 17; a shape outside
that range raises ValueError before any launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Sequence
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


def _walk_backsub(backsub, X, s_up, s_lo, s_g):
    """``backsub`` through every level from the last (the tail's X) up to
    level 0."""
    for lv in reversed(range(len(s_g))):
        X = backsub(X, s_up[lv], s_lo[lv], s_g[lv])
    return X


def factor_sweep_plain(Ds, Es, tail):
    """:func:`cr_factor_sweep` on the plain level math, on any device."""
    return _walk_factor(level_factor_plain, Ds, Es, tail)


def apply_sweep_plain(facs, Gs):
    """:func:`cr_apply_sweep` on the plain level math, on any device."""
    return _walk_apply(level_apply_plain, facs, Gs)


def backsub_sweep_plain(X, s_up, s_lo, s_g):
    """:func:`cr_backsub_sweep` on the plain level math, on any device."""
    return _walk_backsub(backsub_plain, X, s_up, s_lo, s_g)


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
    _build.register(_fn, shapes=False)


# ---- the kernels --------------------------------------------------------------

# Levels of at most this many pairs run in one launch of the back-substitution
# sweep (``backsub_small`` of ``csrc/cr_kernels.cuh``); chosen by measurement
# (``tools/cr_sweeps.py``, PERF.md).
BACKSUB_SMALL_PAIRS = 64


MAX_RHS = 17    # r = 1 + nq at nq = 16
# The shared memory a block may have on the card (227 KB): what
# backsub_small's two buffers of its largest level may take.
MAX_SMEM_BYTES = 232448


def kernel_supports(block_size: int, nrhs: int) -> bool:
    """Whether the CR kernels take (block size, r): 1 <= b <= 16 and 1 <= r
    <= 17; ``nrhs=0`` asks for the factor kernel alone, which needs only the
    block size."""
    return 1 <= block_size <= _build.MAX_BLOCK and 0 <= nrhs <= MAX_RHS


def instance(block_size: int, nrhs: int) -> _build.Instance:
    """The library instance at (block size, r) (r = 0: the factor kernel);
    raises ValueError, naming the range, for a shape the kernels do not
    take."""
    if not kernel_supports(block_size, nrhs):
        raise ValueError(
            f"the CR kernels take 1 <= b <= {_build.MAX_BLOCK} and 1 <= r <= "
            f"{MAX_RHS} (r = 0: the factor kernel), not b={block_size}, "
            f"r={nrhs}")
    return _build.Instance("cr", block_size, nrhs)


@functools.cache
def _library(b: int, r: int) -> ctypes.CDLL:
    """The instance at (b, r), built at its first use and loaded: r = 0
    holds ``cr_factor_sweep_*``, r >= 1 ``cr_apply_sweep_*``,
    ``cr_backsub_sweep_*`` and ``cr_level_*``."""
    lib = _build.load(instance(b, r)).lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {"cr_factor_sweep": [ptr] * 3 + [i32, i64, i32, ptr]} \
        if r == 0 else {
            "cr_apply_sweep": [ptr] * 4 + [i32, i32, i64, i32, ptr],
            "cr_backsub_sweep": [ptr] * 6 + [i32, i32, i64, i32, i64, ptr],
            "cr_level": [ptr] * 9 + [i32, i32, i64, ptr]}
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
    if not lib.cr_supported(b, r):
        raise RuntimeError(f"the library loaded for cr-b{b}-r{r} is "
                           "another instance")
    return lib


def device_launches() -> int:
    """Kernel launches the CR library's loaded instances have made since
    each was loaded."""
    return sum(int(_library(i.b, i.r).cr_device_launches())
               for i in list(_build._LOADED) if i.lib == "cr")


def backsub_small_pairs(block_size: int, nrhs: int, itemsize: int) -> int:
    """The largest level (in pairs) that the back-substitution sweep's
    one-launch walk takes: BACKSUB_SMALL_PAIRS, halved until its two
    buffers of x_even fit in a block's shared memory."""
    small = BACKSUB_SMALL_PAIRS
    while small and 2 * block_size * nrhs * small * itemsize > MAX_SMEM_BYTES:
        small //= 2
    return small


def _launch(name, dtype, device, b, r, *args):
    """Call entry ``name`` of the instance (b, r) for ``dtype``."""
    lib = _library(b, r)
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
    instance(b, nrhs)
    if m < 2 or m % 2:
        raise ValueError(f"a CR level needs an even chain length, not {m}")
    return b, m // 2


def sweep_layout(arrays: int, rows: int, h0: int, levels: int):
    """Where a sweep's levels lie in its one workspace: ([start of level lv,
    in elements], total elements).  Level lv (h = h0 >> lv pairs) holds
    ``arrays`` outputs of ``rows`` rows and h columns each, one after the
    other, and the levels follow each other, so level lv starts at arrays *
    rows * 2 (h0 - h): ``cr::sweep_offset`` of ``csrc/cr_kernels.cuh``."""
    start = lambda h: arrays * rows * 2 * (h0 - h)
    return [start(h0 >> lv) for lv in range(levels)], start(h0 >> levels)


def backsub_layout(rows: int, h0: int, levels: int):
    """Where a back-substitution sweep's levels put their X in its
    workspace: ([start of level lv's X (rows, 2 (h0 >> lv)) for lv = 1 ..
    levels - 1, in elements], total elements).  Level 0 writes the sweep's
    output instead; levels 1, 2, ... follow each other, so level lv starts
    at 2 rows (h0 - 2h): ``cr::backsub_offset`` of ``csrc/cr_kernels.cuh``."""
    start = lambda h: 2 * rows * (h0 - 2 * h)
    last = h0 >> (levels - 1)
    return ([start(h0 >> lv) for lv in range(1, levels)],
            start(last) + 2 * rows * last)


def backsub_sweep_launches(h0: int, levels: int,
                           small: int = BACKSUB_SMALL_PAIRS) -> int:
    """Device launches of a back-substitution sweep of ``levels`` levels
    from h0 pairs: one for each level of more than ``small`` pairs, one for
    all the others together."""
    big = sum((h0 >> lv) > small for lv in range(levels))
    return big + (big < levels)


def _array(ws, start, shape):
    """The contiguous array ``shape`` at element ``start`` of ws (a view)."""
    return ws.narrow(0, start, math.prod(shape)).view(shape)


def _level_views(ws, start, arrays, rows_shape, h):
    """The ``arrays`` outputs (*rows_shape, h) of the level at ``start``."""
    shape = (*rows_shape, h)
    n = math.prod(shape)
    return tuple(_array(ws, start + a * n, shape) for a in range(arrays))


class SweepArrays(Sequence):
    """Output ``index`` of every level of a sweep on a CUDA chain.

    Level lv's array (*rows_shape, h0 >> lv) lies in the sweep's workspace
    ``ws`` (:func:`sweep_layout`).  ``pointers()`` is arithmetic on the
    workspace's address: the chain solve hands the levels from sweep to
    sweep that way.  Indexing makes the level's view, for those who read the
    levels (the tests, ``chip_smoke.py``).
    """

    def __init__(self, ws, arrays, rows_shape, h0, levels, index):
        self.ws, self.arrays, self.rows_shape = ws, arrays, tuple(rows_shape)
        self.h0, self.index = h0, index
        rows = math.prod(rows_shape)
        self.starts = sweep_layout(arrays, rows, h0, levels)[0]
        # Element offset of this output at each level.
        self.offsets = [start + index * rows * (h0 >> lv)
                        for lv, start in enumerate(self.starts)]

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, lv):
        lv = range(len(self))[lv]
        return _level_views(self.ws, self.starts[lv], self.arrays,
                            self.rows_shape, self.h0 >> lv)[self.index]

    def shape(self, lv):
        return (*self.rows_shape, self.h0 >> lv)

    def pointers(self):
        """Every level's device address."""
        base, size = self.ws.data_ptr(), self.ws.element_size()
        return [base + offset * size for offset in self.offsets]

    def tail(self):
        """The last level's array, which the chain solve reads."""
        lv = len(self) - 1
        return _array(self.ws, self.offsets[lv], self.shape(lv))


class FactorLevels(Sequence):
    """What :func:`cr_factor_sweep` returns for the levels of a CUDA chain.

    Indexing makes level lv's :class:`LevelFactor` from the sweep's
    workspace; ``L``, ``s_up``, ``s_lo``, ``d_new`` and ``e_new`` are
    every level's arrays (:class:`SweepArrays`); ``Es`` is the chain's own
    E, level 0's input couplings (level lv's are level lv - 1's e_new).
    """

    def __init__(self, ws, b, h0, levels, Es):
        (self.d_new, self.e_new, self.s_up, self.s_lo, self.L) = (
            SweepArrays(ws, 5, (b, b), h0, levels, a) for a in range(5))
        self.Es = Es

    def __len__(self):
        return len(self.L)

    def __getitem__(self, lv):
        lv = range(len(self))[lv]
        E = self.Es if lv == 0 else self.e_new[lv - 1]
        return LevelFactor(self.L[lv], self.s_up[lv], self.s_lo[lv], E)

    def E_pointers(self):
        """Every level's input couplings' device address."""
        return [self.Es.data_ptr()] + _pointers(self.e_new)[:-1]


def factor_columns(facs):
    """(s_up, s_lo) of every level of :func:`cr_factor_sweep`'s factors, as
    :func:`cr_backsub_sweep` takes them: a CUDA sweep's :class:`SweepArrays`
    (no view made), else lists of the factors' own tensors."""
    if isinstance(facs, FactorLevels):
        return facs.s_up, facs.s_lo
    return [f.s_up for f in facs], [f.s_lo for f in facs]


def _pointers(arrays):
    """Every level's device address: computed for :class:`SweepArrays`,
    each tensor's own for a list."""
    if isinstance(arrays, SweepArrays):
        return arrays.pointers()
    return [a.data_ptr() for a in arrays]


def _factor_levels(Ds, Es, levels):
    """``levels`` levels of kernel #4 on a CUDA chain, one library call:
    ((d_new, e_new) of the tail, :class:`FactorLevels`)."""
    b, m = Ds.shape[0], Ds.shape[-1]
    _build.check_operands([("Ds", Ds, (b, b, m)), ("Es", Es, (b, b, m))])
    b, h0 = _level_shape(Ds, 0)
    ws = Ds.new_empty(sweep_layout(5, b * b, h0, levels)[1])
    _launch("cr_factor_sweep", Ds.dtype, Ds.device, b, 0, Ds.data_ptr(),
            Es.data_ptr(), ws.data_ptr(), b, h0, levels)
    _build.count_launches(cr_level_factor, (b,), levels)
    facs = FactorLevels(ws, b, h0, levels, Es)
    return (facs.d_new.tail(), facs.e_new.tail()), facs


def _apply_levels(facs, Gs):
    """Kernel #5 through every level's factor on CUDA tensors, one library
    call: (g_new of the tail, s_g of every level as :class:`SweepArrays`).
    ``facs`` is a :class:`FactorLevels` or a list of :class:`LevelFactor`."""
    b, r, m = Gs.shape
    levels = len(facs)
    operands = [("Gs", Gs, (b, r, m))]
    if isinstance(facs, FactorLevels):
        operands.append(("Es", facs.Es, (b, b, m)))
        lo, E = _pointers(facs.L), facs.E_pointers()
    else:
        for lv, fac in enumerate(facs):
            operands += [("L", fac.L, (b, b, m >> (lv + 1))),
                         ("E", fac.E, (b, b, m >> lv))]
        lo, E = [f.L.data_ptr() for f in facs], [f.E.data_ptr() for f in facs]
    _build.check_operands(operands)
    if m % (1 << levels):
        raise ValueError(f"a CR level needs an even chain length: {m} blocks "
                         f"do not halve {levels} times")
    b, h0 = _level_shape(Gs, r)
    ws = Gs.new_empty(sweep_layout(2, b * r, h0, levels)[1])
    pointers = ctypes.c_void_p * levels
    _launch("cr_apply_sweep", Gs.dtype, Gs.device, b, r, pointers(*lo),
            pointers(*E), Gs.data_ptr(), ws.data_ptr(), b, r, h0, levels)
    _build.count_launches(cr_level_apply, (b, r), levels)
    g_new, s_g = (SweepArrays(ws, 2, (b, r), h0, levels, a) for a in range(2))
    return g_new.tail(), s_g


def _backsub_levels(X, s_up, s_lo, s_g, small=BACKSUB_SMALL_PAIRS):
    """Kernel #6 through every level on CUDA tensors, one library call: the
    tail's X (b, r, h) -> (b, r, 2 h0), h0 = h << (levels - 1).  The levels
    of at most ``small`` pairs, and at most what fits in a block's shared
    memory (:func:`backsub_small_pairs`), run in one launch."""
    b, r, m = X.shape
    levels = len(s_g)
    h0 = m << (levels - 1)
    operands = [("X", X, (b, r, m))]
    for name, arrays, rows in (("s_up", s_up, (b, b)), ("s_lo", s_lo, (b, b)),
                               ("s_g", s_g, (b, r))):
        if len(arrays) != levels:
            raise ValueError(f"{name} has {len(arrays)} levels, s_g {levels}")
        if isinstance(arrays, SweepArrays):
            if arrays.shape(0) != (*rows, h0):
                raise ValueError(f"{name} has levels of {arrays.shape(0)}, "
                                 f"expected {(*rows, h0)} at level 0")
            operands.append((name, arrays.ws, arrays.ws.shape))
        else:
            operands += [(f"{name}[{lv}]", a, (*rows, h0 >> lv))
                         for lv, a in enumerate(arrays)]
    _build.check_operands(operands)
    instance(b, r)
    small = min(small, backsub_small_pairs(b, r, X.element_size()))
    out = X.new_empty((b, r, 2 * h0))
    ws = X.new_empty(backsub_layout(b * r, h0, levels)[1])
    pointers = ctypes.c_void_p * levels
    _launch("cr_backsub_sweep", X.dtype, X.device, b, r, X.data_ptr(),
            *(pointers(*_pointers(a)) for a in (s_up, s_lo, s_g)),
            out.data_ptr(), ws.data_ptr(), b, r, h0, levels, small)
    _build.count_launches(cr_backsub, (b, r), levels)
    return out


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


def cr_backsub(x_even, s_up, s_lo, s_g):
    """Back-substitution of one level (kernel #6): (b, r, h) -> X (b, r, 2h)
    with X[..., 0::2] = x_even and X[..., 1::2] = x_odd."""
    if not _on_card(x_even):
        return cr_backsub_ref(x_even, s_up, s_lo, s_g)
    return _backsub_levels(x_even, [s_up], [s_lo], [s_g])


def cr_factor_sweep(Ds, Es, tail: int):
    """Kernel #4 level after level while the chain has more than ``tail``
    blocks.  Returns ((Ds, Es) of the tail, [:class:`LevelFactor` per
    level]).  On a CUDA tensor the whole sweep is one call of the library
    (a kernel launch per level) and the factors are a
    :class:`FactorLevels` over its one workspace; on a CPU tensor it walks
    the per-level plain version.  Adds its levels to
    ``cr_level_factor.launches``."""
    if not _on_card(Ds):
        return _walk_factor(cr_level_factor_ref, Ds, Es, tail)
    levels = sweep_levels(Ds.shape[-1], tail)
    return _factor_levels(Ds, Es, levels) if levels else ((Ds, Es), [])


def cr_apply_sweep(facs, Gs):
    """Kernel #5 through the factors of :func:`cr_factor_sweep`.  Returns
    (Gs of the tail, [s_g per level]); one call of the library on a CUDA
    tensor (s_g then a :class:`SweepArrays`), the per-level plain version
    on a CPU tensor.  Adds its levels to ``cr_level_apply.launches``."""
    if not _on_card(Gs):
        return _walk_apply(cr_level_apply_ref, facs, Gs)
    return _apply_levels(facs, Gs) if facs else (Gs, [])


def cr_backsub_sweep(X, s_up, s_lo, s_g):
    """Kernel #6 level after level from the tail up.

    X (b, r, h) is the tail's solution; s_up, s_lo (b, b, h0 >> lv) and s_g
    (b, r, h0 >> lv) are level lv's, lv = 0 .. levels - 1 (lists of
    tensors, or the sweeps' :class:`SweepArrays`: :func:`factor_columns`
    and :func:`cr_apply_sweep`).  Returns X (b, r, 2 h0).  On a CUDA tensor
    one call of the library (one launch for the levels of at most
    ``BACKSUB_SMALL_PAIRS`` pairs, one for each bigger level); on a CPU
    tensor the per-level plain version.  Adds its levels to
    ``cr_backsub.launches``.
    """
    if not _on_card(X):
        return _walk_backsub(cr_backsub_ref, X, s_up, s_lo, s_g)
    return _backsub_levels(X, s_up, s_lo, s_g) if len(s_g) else X


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
    _launch("cr_level", Ds.dtype, Ds.device, b, r,
            *(x.data_ptr() for x in (Ds, Es, Gs, dn, en, gn, su, sl, sg)),
            b, r, h)
    _build.count_launches(cr_level, (b, r))
    return (dn, en, gn), (su, sl, sg)


for _fn in (cr_level, cr_level_factor, cr_level_apply, cr_backsub):
    _build.register(_fn, shapes=True)
del _fn
