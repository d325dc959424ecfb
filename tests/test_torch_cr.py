"""Port parity, cyclic reduction: the CR kernels' plain versions against the
Pallas kernels of ``collocfem_tpu/ops/cr_pallas.py`` (interpret mode, as the
JAX package's own tests run them on the CPU), and the chain solves of
``solve/blocktri.py`` against the JAX package's, in float64.  The CUDA
kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _cr_level_count
from collocfem_tpu.ops import cr_pallas
from collocfem_tpu.solve import blocktri as jax_bt
from collocfem_tpu_torch.ops import cr
from collocfem_tpu_torch.solve import blocktri as bt
from collocfem_tpu_torch.testing import random_chain


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol):
    """max|got - want| <= rtol * max|want|, array by array."""
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.fixture(scope="module", params=[(8, 3), (4, 1), (2, 2), (4, 3)],
                ids=str)
def level(request):
    """One level's inputs at m = 64 (torch and JAX) and the JAX kernels'
    outputs, each computed once."""
    b, r = request.param
    Ds, Es, Gs = random_chain(64, b, r, seed=b + r)
    J = [jnp.asarray(a.numpy()) for a in (Ds, Es, Gs)]
    (dn, en), fac_rows = cr_pallas.cr_level_factor(*J[:2], interpret=True)
    applied = cr_pallas.cr_level_apply(fac_rows, J[2], interpret=True)
    fused = cr_pallas.cr_level(*J, interpret=True)
    x_even = J[2][..., :32]
    s_up, s_lo = (a.reshape(b, b, 32) for a in fac_rows[3:])
    back = cr_pallas.cr_backsub(x_even, s_up, s_lo, applied[1],
                                interpret=True)
    return (Ds, Es, Gs), dict(factor=((dn, en), fac_rows), apply=applied,
                              level=fused, backsub=back)


def test_level_factor_ref_matches_pallas(level):
    """cr_level_factor_ref against the Pallas factor kernel: the halved
    (D, E) and the factor rows (L, e_up, e_lo, s_up, s_lo) within 1e-10."""
    (Ds, Es, _), jax_out = level
    (dn, en), fac = cr.cr_level_factor_ref(Ds, Es)
    (jdn, jen), rows = jax_out["factor"]
    b, h = Ds.shape[0], Ds.shape[-1] // 2
    _close([dn, en, fac.L, fac.e_up, fac.e_lo, fac.s_up, fac.s_lo],
           [jdn, jen] + [np.asarray(a).reshape(b, b, h) for a in rows],
           1e-10)


def test_level_apply_ref_matches_pallas(level):
    """cr_level_apply_ref through the port's own factor against the Pallas
    apply kernel through the JAX factor: (g_new, s_g) within 1e-10."""
    (Ds, Es, Gs), jax_out = level
    _, fac = cr.cr_level_factor_ref(Ds, Es)
    _close(cr.cr_level_apply_ref(fac, Gs), jax_out["apply"], 1e-10)


def test_level_ref_matches_pallas(level):
    """cr_level_ref against the fused Pallas level: every output within
    1e-10."""
    (Ds, Es, Gs), jax_out = level
    (got_sys, got_fac), (want_sys, want_fac) = (cr.cr_level_ref(Ds, Es, Gs),
                                                jax_out["level"])
    _close(list(got_sys) + list(got_fac), list(want_sys) + list(want_fac),
           1e-10)


def test_backsub_ref_matches_pallas(level):
    """cr_backsub_ref against the Pallas back-substitution: within 1e-10."""
    (Ds, Es, Gs), jax_out = level
    _, fac = cr.cr_level_factor_ref(Ds, Es)
    _, s_g = cr.cr_level_apply_ref(fac, Gs)
    got = cr.cr_backsub_ref(Gs[..., :Gs.shape[-1] // 2], fac.s_up, fac.s_lo,
                            s_g)
    _close([got], [jax_out["backsub"]], 1e-10)


@pytest.mark.parametrize("k", [1, 2, 9, 130, 300])
def test_chain_solves_match_jax(k):
    """The port's chain solves against JAX blocktri_solve_cr (pallas_min =
    16, the XLA path on the CPU) at b = 8, r = 3: blocktri_solve_cr,
    blocktri_cr_factor, blocktri_cr_factor_soa, the plain CRs of the same
    schedule, the unrolled CR and the dense solve, all within 1e-9."""
    D, E, G = random_chain(k, 8, 3, seed=k)
    aos = [a.permute(2, 0, 1).contiguous() for a in (D, E, G)]
    want = np.asarray(jax_bt.blocktri_solve_cr(
        *(jnp.asarray(a.numpy()) for a in aos), pallas_min=16))
    got = [bt.blocktri_solve_cr(*aos), bt.blocktri_cr_factor(*aos[:2])(aos[2]),
           bt.blocktri_cr_factor_soa(D, E)(G).permute(2, 0, 1),
           bt.blocktri_cr_factor_plain(D, E)(G).permute(2, 0, 1),
           bt.blocktri_solve_cr_plain(*aos),
           bt.blocktri_solve_cr_unrolled(*aos), bt.blocktri_solve_dense(*aos)]
    _close(got, [want] * len(got), 1e-9)
    # A vector right-hand side (K, b) comes back as a vector.
    x1 = bt.blocktri_solve_cr(aos[0], aos[1], aos[2][..., 0])
    _close([x1], [want[..., 0]], 1e-9)


@pytest.mark.parametrize("b,r", [(2, 2), (4, 3), (12, 1), (16, 1),
                                 (16, 17)])
def test_chain_solves_match_jax_at_other_block_sizes(b, r):
    """The port's CR chain solves (the plain walk the CR kernels are held
    against, and blocktri_solve_cr) at the block sizes the card now runs
    (config 3's 12, the split actuator's 16 up to r = 17) against the JAX
    package's plain block Thomas solve, blocktri_solve_scan (its CR and the
    Pallas levels' interpret mode take minutes to compile at b = 16):
    within 1e-9."""
    D, E, G = random_chain(130, b, r, seed=b + r)
    aos = [a.permute(2, 0, 1).contiguous() for a in (D, E, G)]
    want = np.asarray(jax_bt.blocktri_solve_scan(
        *(jnp.asarray(a.numpy()) for a in aos)))
    got = [bt.blocktri_cr_factor_soa(D, E)(G).permute(2, 0, 1),
           bt.blocktri_solve_cr(*aos)]
    _close(got, [want] * len(got), 1e-9)


@pytest.mark.parametrize("k", [1, 2, 9, 130])
def test_inverse_blocks_match_jax(k):
    """blocktri_inverse_blocks against JAX's Takahashi recursion: the
    diagonal and super-diagonal blocks of A^-1 within 1e-9."""
    D, E, _ = random_chain(k, 8, 1, seed=k + 1)
    D, E = (a.permute(2, 0, 1).contiguous() for a in (D, E))
    E[-1] = 0.0
    want = jax_bt.blocktri_inverse_blocks(jnp.asarray(D.numpy()),
                                          jnp.asarray(E.numpy()))
    got = bt.blocktri_inverse_blocks(D, E)
    assert tuple(got[1].shape) == (k - 1, 8, 8)
    _close(got[:1] if k == 1 else got, want[:1] if k == 1 else want, 1e-9)


def test_wrappers_dispatch_on_the_device():
    """On CPU tensors the wrappers run their plain versions and count
    nothing themselves; a device with no kernel raises."""
    Ds, Es, Gs = random_chain(16, 8, 3, seed=0)
    kernels = [f.launches for f in (cr.cr_level, cr.cr_level_factor,
                                    cr.cr_level_apply, cr.cr_backsub)]
    refs = [f.launches for f in (cr.cr_level_ref, cr.cr_level_factor_ref,
                                 cr.cr_level_apply_ref, cr.cr_backsub_ref)]
    (_, _, g), sol = cr.cr_level(Ds, Es, Gs)
    _, fac = cr.cr_level_factor(Ds, Es)
    cr.cr_level_apply(fac, Gs)
    cr.cr_backsub(g, *sol)
    # A back-substitution sweep of two levels: two plain calls.
    X = cr.cr_backsub_sweep(g[..., :4].contiguous(), *([a, a[..., ::2]]
                                                       for a in sol))
    assert X.shape == (8, 3, 16)
    assert [f.launches for f in (cr.cr_level, cr.cr_level_factor,
                                 cr.cr_level_apply, cr.cr_backsub)] == kernels
    assert [f.launches for f in (cr.cr_level_ref, cr.cr_level_factor_ref,
                                 cr.cr_level_apply_ref,
                                 cr.cr_backsub_ref)] == [n + 1 for n in
                                                         refs[:3]] + [
        refs[3] + 3]
    meta = [a.to("meta") for a in (Ds, Es, Gs)]
    with pytest.raises(ValueError, match="no kernel"):
        cr.cr_level(*meta)
    with pytest.raises(ValueError, match="no kernel"):
        cr.cr_level_factor(*meta[:2])
    with pytest.raises(ValueError, match="no kernel"):
        cr.cr_backsub_sweep(meta[2][..., :8], [meta[0][..., :8]],
                            [meta[1][..., :8]], [meta[2][..., :8]])
    # The plain chain solves call none of the wrappers or plain versions.
    counts = [f.launches for f in (cr.cr_level_ref, cr.cr_level_factor_ref,
                                   cr.cr_level_apply_ref, cr.cr_backsub_ref)]
    bt.blocktri_cr_factor_plain(Ds, Es)(Gs)
    bt.blocktri_solve_cr_plain(*(a.permute(2, 0, 1) for a in (Ds, Es, Gs)))
    assert [f.launches for f in (cr.cr_level_ref, cr.cr_level_factor_ref,
                                 cr.cr_level_apply_ref,
                                 cr.cr_backsub_ref)] == counts


@pytest.mark.parametrize("k", [1, 2, 9, 130, 300])
def test_sweeps_equal_the_per_level_walk_and_match_jax(k):
    """On the CPU cr_factor_sweep / cr_apply_sweep give exactly what the
    per-level plain walk gives (every level's factor and s_g, and the
    tail), count one plain call per level, and blocktri_cr_factor_soa, which
    runs them, matches the JAX package's blocktri_cr_factor within 1e-9."""
    D, E, G = random_chain(k, 8, 3, seed=k)
    Ds, Es = bt._pad_pow2_soa(D, E)
    Gs = bt._pad_rhs(G, Ds.shape[-1])
    levels = _cr_level_count(k)
    assert cr.sweep_levels(Ds.shape[-1], bt.TAIL) == levels
    before = (cr.cr_level_factor_ref.launches, cr.cr_level_apply_ref.launches)
    (dt, et), facs = cr.cr_factor_sweep(Ds, Es, bt.TAIL)
    gt, s_gs = cr.cr_apply_sweep(facs, Gs)
    assert (cr.cr_level_factor_ref.launches - before[0],
            cr.cr_level_apply_ref.launches - before[1]) == (levels, levels)
    assert len(facs) == len(s_gs) == levels
    d, e, g = Ds, Es, Gs
    for fac_s, sg_s in zip(facs, s_gs):
        (d, e), fac = cr.level_factor_plain(d, e)
        g, sg = cr.level_apply_plain(fac, g)
        for a, b in zip((*fac, sg), (*fac_s, sg_s)):
            assert torch.equal(a, b)
    assert torch.equal(d, dt) and torch.equal(e, et) and torch.equal(g, gt)
    (dp, ep), facs_p = cr.factor_sweep_plain(Ds, Es, bt.TAIL)
    assert torch.equal(dp, dt) and torch.equal(ep, et)
    assert torch.equal(cr.apply_sweep_plain(facs_p, Gs)[0], gt)
    aos = [jnp.asarray(a.permute(2, 0, 1).contiguous().numpy())
           for a in (D, E, G)]
    want = np.asarray(jax_bt.blocktri_cr_factor(*aos[:2])(aos[2]))
    _close([bt.blocktri_cr_factor_soa(D, E)(G).permute(2, 0, 1)], [want],
           1e-9)


@pytest.mark.parametrize("arrays,rows", [(5, 64), (2, 24), (2, 8)])
@pytest.mark.parametrize("k", [9, 16, 17, 130, 20001, 100001])
def test_sweep_workspace_layout(k, arrays, rows):
    """The views of a sweep's workspace (5 arrays of b b rows for the factor
    sweep, 2 of b r for the apply sweep) follow each other without gap or
    overlap, fill the allocation, and there is one level per kernel level
    of the chain solve."""
    kp = 1 << (k - 1).bit_length()
    levels = cr.sweep_levels(kp, bt.TAIL)
    assert levels == _cr_level_count(k) >= 1
    h0 = kp // 2
    starts, total = cr.sweep_layout(arrays, rows, h0, levels)
    assert len(starts) == levels and starts[0] == 0
    ws = torch.zeros(total, dtype=torch.int32)
    for lv, start in enumerate(starts):
        views = cr._level_views(ws, start, arrays, (rows,), h0 >> lv)
        assert len(views) == arrays
        for v in views:
            assert tuple(v.shape) == (rows, h0 >> lv) and v.is_contiguous()
            v += 1
    assert bool((ws == 1).all())
    assert total == arrays * rows * sum(h0 >> lv for lv in range(levels))


def test_sweeps_refuse_an_odd_level():
    """A chain that does not halve evenly down to the tail raises."""
    D, E, _ = random_chain(24, 8, 1, seed=0)
    with pytest.raises(ValueError, match="even"):
        cr.cr_factor_sweep(D[..., :18].contiguous(), E[..., :18].contiguous(),
                           bt.TAIL)
    (Dt, Et), facs = cr.cr_factor_sweep(D[..., :8], E[..., :8], bt.TAIL)
    assert facs == [] and Dt.shape[-1] == 8


def _level_walk(k, r):
    """The levels of a seeded chain of k blocks padded to a power of two, by
    the plain walk in float64: ([s_up], [s_lo], [s_g]) per level and the
    tail's solution."""
    D, E, G = random_chain(k, 8, r, seed=k + r)
    Ds, Es = bt._pad_pow2_soa(D, E)
    (dt, et), facs = cr.factor_sweep_plain(Ds, Es, bt.TAIL)
    gt, s_g = cr.apply_sweep_plain(facs, bt._pad_rhs(G, Ds.shape[-1]))
    X = bt._tail_solve(bt._tail_factor(dt, et), gt).contiguous()
    return (*cr.factor_columns(facs), s_g), X


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("k", [9, 16, 17, 130, 300])
def test_backsub_sweep_matches_the_walk_and_pallas(k, r):
    """backsub_sweep_plain gives exactly the per-level backsub_plain walk
    and, level by level on the same x_even, what the Pallas cr_backsub
    gives in interpret mode (float64, within 1e-12 relative); on CPU
    tensors cr_backsub_sweep runs the counted plain version once per level
    and launches nothing."""
    (s_up, s_lo, s_g), X = _level_walk(k, r)
    levels = len(s_g)
    assert levels == _cr_level_count(k)
    xs = [X]
    for lv in reversed(range(levels)):
        xs.append(cr.backsub_plain(xs[-1], s_up[lv], s_lo[lv], s_g[lv]))
    assert torch.equal(cr.backsub_sweep_plain(X, s_up, s_lo, s_g), xs[-1])
    for lv, x_even, want in zip(reversed(range(levels)), xs, xs[1:]):
        got = cr_pallas.cr_backsub(
            *(jnp.asarray(a.numpy()) for a in (x_even, s_up[lv], s_lo[lv],
                                               s_g[lv])), interpret=True)
        _close([want], [got], 1e-12)
    before = (cr.cr_backsub.launches, cr.cr_backsub_ref.launches)
    assert torch.equal(cr.cr_backsub_sweep(X, s_up, s_lo, s_g), xs[-1])
    assert (cr.cr_backsub.launches - before[0],
            cr.cr_backsub_ref.launches - before[1]) == (0, levels)


def _cuda_function(name):
    """The expression a one-line ``inline long long name(...)`` of
    csrc/cr_kernels.cuh returns, as Python."""
    import re
    from pathlib import Path

    src = (Path(cr.__file__).parent.parent / "csrc" /
           "cr_kernels.cuh").read_text()
    body = re.search(rf"inline long long {name}\([^)]*\) {{\s*return "
                     r"([^;]*);", src).group(1)
    return re.sub(r"\(long long\)|(?<=\d)LL", "", body)


@pytest.mark.parametrize("rows", [24, 16, 8])
@pytest.mark.parametrize("k", [9, 16, 17, 130, 20001, 100001])
def test_backsub_workspace_layout(k, rows):
    """A back-substitution sweep's intermediate X (rows, 2h), levels 1 ..
    levels - 1, follow each other without gap or overlap and fill the
    allocation, and backsub_layout computes what cr::backsub_offset of the
    CUDA source computes."""
    kp = 1 << (k - 1).bit_length()
    levels = cr.sweep_levels(kp, bt.TAIL)
    h0 = kp // 2
    starts, total = cr.backsub_layout(rows, h0, levels)
    assert len(starts) == levels - 1
    ws = torch.zeros(total, dtype=torch.int32)
    for lv, start in enumerate(starts, 1):
        ws[start:start + rows * 2 * (h0 >> lv)] += 1
    assert bool((ws == 1).all())
    expr = _cuda_function("backsub_offset")
    for lv, start in enumerate(starts, 1):
        assert eval(expr, {"rows": rows, "h0": h0, "h": h0 >> lv}) == start


@pytest.mark.parametrize("arrays,rows", [(5, 64), (2, 24)])
def test_sweep_layout_matches_the_cuda_source(arrays, rows):
    """sweep_layout computes what cr::sweep_offset computes."""
    expr = _cuda_function("sweep_offset")
    starts, _ = cr.sweep_layout(arrays, rows, 16384, 12)
    assert starts == [eval(expr, {"arrays": arrays, "rows": rows,
                                  "h0": 16384, "h": 16384 >> lv})
                      for lv in range(12)]


@pytest.mark.parametrize("k", [16, 130, 20001])
def test_sweep_views_on_demand(k):
    """FactorLevels and SweepArrays over a sweep's workspace give, level by
    level, the views the sweeps made eagerly before (each level's arrays at
    sweep_layout's start, E of level lv > 0 the e_new of level lv - 1),
    their pointers() are the views' addresses, and the tails are the last
    level's arrays; the backsub sweep's pointers take no view."""
    kp = 1 << (k - 1).bit_length()
    levels, h0, b, r = cr.sweep_levels(kp, bt.TAIL), kp // 2, 8, 3
    Es = torch.randn(b, b, kp, dtype=torch.float64)
    starts, total = cr.sweep_layout(5, b * b, h0, levels)
    ws = torch.randn(total, dtype=torch.float64)
    facs = cr.FactorLevels(ws, b, h0, levels, Es)
    assert len(facs) == levels
    E = Es
    for lv, start in enumerate(starts):
        h = h0 >> lv
        dn, en, su, sl, lo = ws.as_strided(
            (5, b, b, h), (b * b * h, b * h, h, 1), start).unbind(0)
        want = cr.LevelFactor(lo, su, sl, E)
        got = facs[lv]
        for g, w in zip(got, want):
            assert torch.equal(g, w) and g.data_ptr() == w.data_ptr()
        assert facs.s_up.pointers()[lv] == su.data_ptr()
        assert facs.E_pointers()[lv] == E.data_ptr()
        E = en
    assert torch.equal(facs.d_new.tail(), dn) and torch.equal(
        facs.e_new.tail(), en)
    assert facs[-1].L.data_ptr() == lo.data_ptr()
    s_up, s_lo = cr.factor_columns(facs)
    assert s_up is facs.s_up and s_lo is facs.s_lo
    starts, total = cr.sweep_layout(2, b * r, h0, levels)
    ws2 = torch.randn(total, dtype=torch.float64)
    s_g = cr.SweepArrays(ws2, 2, (b, r), h0, levels, 1)
    assert [tuple(a.shape) for a in s_g] == [(b, r, h0 >> lv)
                                             for lv in range(levels)]
    assert cr._pointers(s_g) == [a.data_ptr() for a in s_g]
    assert cr._pointers(list(s_g)) == cr._pointers(s_g)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_layout_at_the_ladders_fine_chain(itemsize):
    """The fine level of bench.py's ladder past CR_DW_CHAIN: K = 100,001
    blocks padded to 131,072, 14 levels a sweep (12 at K = 20,001); the
    back-substitution sweep launches once for each of the 10 levels of more
    than 64 pairs and once for the other 4; the workspaces' offsets are the
    CUDA source's, and the largest (the factor sweep's 5 b^2 rows at b = 16)
    stays below 2^31 elements, though the library passes them as 64-bit."""
    k, b, r = 100_001, 8, 3
    kp = 1 << (k - 1).bit_length()
    D, E, _ = random_chain(1, b, 1, seed=0)
    assert bt._pad_pow2_soa(D.expand(b, b, k), E.expand(b, b, k))[0].shape[
        -1] == kp == 131_072
    levels, h0 = cr.sweep_levels(kp, bt.TAIL), kp // 2
    assert levels == _cr_level_count(k) == 14
    small = cr.backsub_small_pairs(b, r, itemsize)
    assert small == cr.BACKSUB_SMALL_PAIRS == 64
    assert cr.backsub_sweep_launches(h0, levels, small) == 11
    for arrays, rows in ((5, b * b), (2, b * r)):
        starts, total = cr.sweep_layout(arrays, rows, h0, levels)
        assert starts == [eval(_cuda_function("sweep_offset"), {
            "arrays": arrays, "rows": rows, "h0": h0, "h": h0 >> lv})
            for lv in range(levels)]
        assert total == arrays * rows * 2 * (h0 - (h0 >> levels))
    starts, total = cr.backsub_layout(b * r, h0, levels)
    assert starts == [eval(_cuda_function("backsub_offset"), {
        "rows": b * r, "h0": h0, "h": h0 >> lv}) for lv in range(1, levels)]
    assert cr.sweep_layout(5, 16 * 16, h0, levels)[1] < 2 ** 31
