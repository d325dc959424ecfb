"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Kernel #1 (fused damped KKT), kernel #2 (SPIKE chain solve), kernels #3-#6
(the per-level cyclic reduction), kernel #7 (batched block Thomas) and the
multi-rank tier's peer all-reduce (``parallel/peer.py``, in worlds of
ranks sharing the card), the GN element kernel (``ops/gn_elements.py``;
also against the JAX package's assembly that ``tests/test_torch_assemble.py``
stores in ``tests/data``); and the solves captured as CUDA graphs
(``solve/graph.py``) against their eager loops, bit for bit.
Every test here is marked ``cuda`` and skips where
there is no GPU (the kernels have no CPU mode).  The file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools

import pytest
import torch

from collocfem_tpu_torch.ops import cr, spike, thomas
from collocfem_tpu_torch.solve import blocktri as bt
from collocfem_tpu_torch.testing import (
    batch_residual,
    chain_residual,
    cr_level_comparison,
    kkt_residual,
    level_bar,
    random_chain,
    random_chain_batch,
    random_kkt_system,
    rel_err,
)

CR_KERNELS = (cr.cr_level, cr.cr_level_factor, cr.cr_level_apply,
              cr.cr_backsub)
KERNELS = CR_KERNELS + (spike.kkt_solve_spike_fused,
                        spike.blocktri_solve_spike_fused,
                        thomas.batched_thomas_solve)
# Chain lengths at the edges of the tile plan of kernels #1 and #2
# (ops/spike.py _plan): one tile (K <= 5, L = 3 for K <= 3), three tiles of
# L = 3 (K = 9), a last tile that is mostly padding (K = 13: four tiles of
# 4, the last with one block), and a tile count that is not a multiple of
# the four tiles of a warp (K = 97: 11 tiles).
EDGES = [1, 2, 3, 4, 5, 9, 13, 97]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _solve_both(sys_, lam, damp_scale):
    args = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, lam, damp_scale)
    launches = spike.kkt_solve_spike_fused.launches
    got = spike.kkt_solve_spike_fused(*args)
    torch.cuda.synchronize()
    assert spike.kkt_solve_spike_fused.launches == launches + 1
    return got, spike.kkt_solve_spike_fused_ref(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("damp_scale", [None, 40.0])
@pytest.mark.parametrize("k", EDGES + [7, 1000, 10001])
def test_kernel_matches_plain_float64(cuda_device, k, damp_scale):
    """float64: max|dx - dx_ref| / max|dx_ref| <= 1e-9, the same for dp."""
    sys_ = random_kkt_system(k, 8, 2, seed=k, device=cuda_device)
    got, want = _solve_both(sys_, 1e-3, damp_scale)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-9
    assert float(got[2]) == float(want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("k", EDGES + [7, 10001])
def test_kernel_matches_plain_float32(cuda_device, k):
    """float32 on a well-conditioned chain: relative difference <= 1e-4."""
    sys_ = random_kkt_system(k, 8, 2, seed=k, dtype=torch.float32,
                             device=cuda_device)
    got, want = _solve_both(sys_, 1e-3, None)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", EDGES + [201, 1001])
@pytest.mark.parametrize("nq", [3, 5])
def test_kernel_matches_plain_at_the_config_shapes(cuda_device, nq, k):
    """Kernel #1 at nq = 3 (Duffing, config 2) and nq = 5 (the aircraft
    model, config 4) on seeded chains, K at the tile plan's edges and the
    configs' own 201 and 1,001 blocks.  float64: relative difference <=
    1e-9; float32: the KKT residual at most 10x the plain version's."""
    for dtype in (torch.float64, torch.float32):
        sys_ = random_kkt_system(k, 8, nq, seed=k + nq, dtype=dtype,
                                 device=cuda_device)
        got, want = _solve_both(sys_, 1e-3, None)
        if dtype == torch.float64:
            for g, w in zip(got[:2], want[:2]):
                assert rel_err(g, w) <= 1e-9
        else:
            assert kkt_residual(sys_, got[0], got[1], 1e-3, got[2]) <= \
                10 * kkt_residual(sys_, want[0], want[1], 1e-3, want[2])


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    """Two runs of kernel #1 on the same input give bit-identical dx and dp
    (the Schur partial sums are reduced in tile order, no atomics)."""
    sys_ = random_kkt_system(10001, 8, 2, seed=3, device=cuda_device)
    args = (sys_.D, sys_.E, sys_.B, sys_.gx, sys_.C, sys_.gp, 1e-3)
    first = spike.kkt_solve_spike_fused(*args)
    second = spike.kkt_solve_spike_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    """Kernel #1 refuses a non-contiguous D and, before any launch, a shape
    outside its range (b = 17, nq = 17), with the range in the message."""
    sys_ = random_kkt_system(9, 8, 2, seed=0, device=cuda_device)
    args = (sys_.B, sys_.gx, sys_.C, sys_.gp, 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        spike.kkt_solve_spike_fused(sys_.D.transpose(0, 1), sys_.E, *args)
    launches = spike.kkt_solve_spike_fused.launches
    for b, nq in ((8, 17), (17, 2)):
        other = random_kkt_system(9, b, nq, seed=0, device=cuda_device)
        with pytest.raises(ValueError, match=r"1 <= b <= 16 and 1 <= nq <= "
                                             r"16"):
            spike.kkt_solve_spike_fused(*other[:2], other.B, other.gx,
                                        other.C, other.gp, 1e-3)
    assert spike.kkt_solve_spike_fused.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("k", EDGES + [7, 1000, 11264])
def test_chain_kernel_matches_plain(cuda_device, k, r):
    """Kernel #2 on chains with zero couplings every 11 blocks (config 5's
    experiment boundaries).  float64: max|X - X_ref| / max|X_ref| <= 1e-9;
    float32: relative residual ||AX - G|| / ||G|| (in float64) at most 10x
    the plain version's."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain(k, 8, r, seed=k + r, boundary=11, dtype=dtype,
                               device=cuda_device)
        launches = spike.blocktri_solve_spike_fused.launches
        got = spike.blocktri_solve_spike_fused(D, E, G)
        torch.cuda.synchronize()
        assert spike.blocktri_solve_spike_fused.launches == launches + 1
        want = spike.blocktri_solve_spike_fused_ref(D, E, G)
        if dtype == torch.float64:
            assert rel_err(got, want) <= 1e-9
        else:
            assert chain_residual(D, E, G, got) <= \
                10 * chain_residual(D, E, G, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 11, 64])
@pytest.mark.parametrize("n_exp", [1, 3, 4, 5, 1000, 1023, 1024])
def test_thomas_kernel_matches_plain(cuda_device, n_exp, k):
    """Kernel #7 with the same bars as kernel #2, on batches that fill the
    four chains of a warp and the eight of a block, and that leave a ragged
    last warp (n_exp not a multiple of 4)."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain_batch(n_exp, k, 8, 3, seed=n_exp + k,
                                     dtype=dtype, device=cuda_device)
        launches = thomas.batched_thomas_solve.launches
        got = thomas.batched_thomas_solve(D, E, G)
        torch.cuda.synchronize()
        assert thomas.batched_thomas_solve.launches == launches + 1
        want = thomas.batched_thomas_solve_ref(D, E, G)
        if dtype == torch.float64:
            assert rel_err(got, want) <= 1e-9
        else:
            assert batch_residual(D, E, G, got) <= \
                10 * batch_residual(D, E, G, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,refine", [(2, 1), (0, 0), (0, 2)])
def test_refined_kkt_runs_the_chain_kernel(cuda_device, nq, refine):
    """solve_kkt_soa(spike=True) with refinement or nq = 0 runs kernel #2
    (1 + refine launches) and agrees with the plain CPU solve: float64
    relative difference <= 1e-9."""
    from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA
    from collocfem_tpu_torch.solve.kkt import solve_kkt_soa

    s = random_kkt_system(1000, 8, max(nq, 1), seed=nq, device=cuda_device)
    if nq == 0:
        s = BlockTriSystemSoA(D=s.D, E=s.E, B=s.B[:, :0], C=s.C[:0, :0],
                              gx=s.gx, gp=s.gp[:0])
    launches = spike.blocktri_solve_spike_fused.launches
    got = solve_kkt_soa(s, 1e-3, refine=refine, spike=True)
    torch.cuda.synchronize()
    assert spike.blocktri_solve_spike_fused.launches == launches + 1 + refine
    want = solve_kkt_soa(BlockTriSystemSoA(*(a.cpu() for a in s)), 1e-3,
                         refine=refine)
    assert rel_err(got[0].cpu(), want[0]) <= 1e-9
    if nq:
        assert rel_err(got[1].cpu(), want[1]) <= 1e-9


@pytest.mark.cuda
def test_chain_kernels_reject_what_they_do_not_take(cuda_device):
    """Kernels #2 and #7 refuse, before any launch, a shape outside their
    range (#2: r past 1 + 16 + 2 b, b = 17; #7: r = 18, b = 17), with the
    range in the message, and kernel #2 a non-contiguous G."""
    D, E, G = random_chain(9, 8, 34, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match=r"1 <= r <= 1 \+ 16 \+ 2 b"):
        spike.blocktri_solve_spike_fused(D, E, G)
    with pytest.raises(ValueError, match="contiguous"):
        spike.blocktri_solve_spike_fused(D, E, G[:, :1])
    D, E, G = random_chain(9, 17, 1, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match=r"1 <= b <= 16"):
        spike.blocktri_solve_spike_fused(D, E, G)
    for b, r in ((8, 18), (17, 3)):
        D, E, G = random_chain_batch(4, 3, b, r, seed=0, device=cuda_device)
        with pytest.raises(ValueError, match=r"1 <= b <= 16 and 1 <= r <= "
                                             r"17"):
            thomas.batched_thomas_solve(D, E, G)


def _launches(fns):
    """The launch counts of ``fns``, with the steps of every device loop
    that ran so far settled in (``_build.settle``)."""
    from collocfem_tpu_torch.ops import _build

    _build.settle()
    return [f.launches for f in fns]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("k", [16, 17, 130, 1000])
def test_cr_kernels_match_plain(cuda_device, k, r):
    """Kernels #3-#6 on the first level of a seeded chain padded to a power
    of two, each against its plain version (``testing.level_bar``: float64
    relative difference <= 1e-9; float32 error against the float64 plain
    level at most 10x the plain version's), then whole solves through
    blocktri_cr_factor_soa and blocktri_solve_cr against the plain solves
    of the same schedule (float64 <= 1e-9; float32 residual at most 10x the
    plain one)."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain(k, 8, r, seed=k + r, dtype=dtype,
                               device=cuda_device)
        Ds, Es = bt._pad_pow2_soa(D, E)
        Gs = bt._pad_rhs(G, Ds.shape[-1])
        before = _launches(CR_KERNELS)
        for name, outs in cr_level_comparison(Ds, Es, Gs).items():
            ok, worst = level_bar(*outs)
            assert ok, (name, dtype, worst)
        assert _launches(CR_KERNELS) == [n + 1 for n in before]
        aos = [a.permute(2, 0, 1) for a in (D, E, G)]
        for got, want in (
                (bt.blocktri_cr_factor_soa(D, E)(G),
                 bt.blocktri_cr_factor_plain(D, E)(G)),
                (bt.blocktri_solve_cr(*aos).permute(1, 2, 0),
                 bt.blocktri_solve_cr_plain(*aos).permute(1, 2, 0))):
            torch.cuda.synchronize()
            if dtype == torch.float64:
                assert rel_err(got, want) <= 1e-9
            else:
                assert chain_residual(D, E, G, got) <= \
                    10 * chain_residual(D, E, G, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("m", [2, 4, 62, 64, 66, 126, 1000])
def test_cr_pair_passes_at_the_block_edges(cuda_device, m, r):
    """Kernels #3-#6 on one level of m blocks, m / 2 pairs on both sides of
    the 31 pairs a thread block of the pair passes stores (one pair, two, 31,
    32, 33, 63, 500), each against its plain version with
    ``testing.level_bar``."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain(m, 8, r, seed=m + r, dtype=dtype,
                               device=cuda_device)
        for name, outs in cr_level_comparison(D, E, G).items():
            torch.cuda.synchronize()
            ok, worst = level_bar(*outs)
            assert ok, (name, dtype, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 17, 130, 1000, 20001])
def test_cr_sweeps_equal_the_per_level_calls(cuda_device, k):
    """cr_factor_sweep and cr_apply_sweep (one library call each, a device
    launch per level) give bit for bit what the per-level kernel calls give,
    count their levels, and two runs are bit-identical; the apply sweep at
    r = 3 (Van der Pol), 4 (Duffing) and 6 (the aircraft model)."""
    for dtype, r in itertools.product((torch.float64, torch.float32),
                                      (3, 4, 6)):
        D, E, G = random_chain(k, 8, r, seed=k, dtype=dtype,
                               device=cuda_device)
        Ds, Es = bt._pad_pow2_soa(D, E)
        Gs = bt._pad_rhs(G, Ds.shape[-1])
        levels = cr.sweep_levels(Ds.shape[-1], bt.TAIL)
        before, n0 = _launches(CR_KERNELS), cr.device_launches()
        (dt, et), facs = cr.cr_factor_sweep(Ds, Es, bt.TAIL)
        n1 = cr.device_launches()
        gt, s_gs = cr.cr_apply_sweep(facs, Gs)
        assert (n1 - n0, cr.device_launches() - n1) == (levels, levels)
        assert [a - b for a, b in zip(_launches(CR_KERNELS), before)] == \
            [0, levels, levels, 0]
        (dt2, et2), facs2 = cr.cr_factor_sweep(Ds, Es, bt.TAIL)
        gt2, s_gs2 = cr.cr_apply_sweep(facs2, Gs)
        d, e, g = Ds, Es, Gs
        for fac_s, sg_s, fac_2, sg_2 in zip(facs, s_gs, facs2, s_gs2):
            (d, e), fac = cr.cr_level_factor(d, e)
            g, sg = cr.cr_level_apply(fac, g)
            torch.cuda.synchronize()
            for a, b, c in zip((*fac, sg), (*fac_s, sg_s), (*fac_2, sg_2)):
                assert torch.equal(a, b) and torch.equal(b, c)
        for a, b, c in zip((d, e, g), (dt, et, gt), (dt2, et2, gt2)):
            assert torch.equal(a, b) and torch.equal(b, c)


def _hold_backsub_sweep(Ds, Es, Gs, tail):
    """Kernel #6's sweep through the kernel factor and apply sweeps of a
    chain down to ``tail`` blocks: one library call with the device
    launches the design says, bit for bit the per-level kernel calls, and
    within ``testing.level_bar`` of the plain walk (float64 exact: the walk
    on the same levels in float64)."""
    (dt, et), facs = cr.cr_factor_sweep(Ds, Es, tail)
    gt, s_g = cr.cr_apply_sweep(facs, Gs)
    X = bt._tail_solve(bt._tail_factor(dt, et), gt).contiguous()
    s_up, s_lo = cr.factor_columns(facs)
    levels, h0 = len(facs), Ds.shape[-1] // 2
    before, n0 = cr.cr_backsub.launches, cr.device_launches()
    got = cr.cr_backsub_sweep(X, s_up, s_lo, s_g)
    small = cr.backsub_small_pairs(Ds.shape[0], Gs.shape[1],
                                   Gs.element_size())
    assert cr.device_launches() - n0 == cr.backsub_sweep_launches(h0, levels,
                                                                  small)
    assert cr.cr_backsub.launches - before == levels
    per_level = X
    for lv in reversed(range(levels)):
        per_level = cr.cr_backsub(per_level, s_up[lv], s_lo[lv], s_g[lv])
    torch.cuda.synchronize()
    assert torch.equal(got, per_level)
    views = [list(a) for a in (s_up, s_lo, s_g)]
    want = cr.backsub_sweep_plain(X, *views)
    exact = cr.backsub_sweep_plain(X.double(), *([v.double() for v in a]
                                                 for a in views))
    ok, worst = level_bar([got], [want], [exact])
    assert ok, (Ds.dtype, levels, worst)
    return levels


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("k", [16, 17, 130, 1000, 20001])
def test_cr_backsub_sweep_equals_the_per_level_calls(cuda_device, k, r):
    """Kernel #6's sweep (one library call: one launch for the levels of at
    most BACKSUB_SMALL_PAIRS pairs, one per bigger level) on chains down to
    the tail's 8 blocks, and down to tails that leave exactly one small
    level (BACKSUB_SMALL_PAIRS pairs) and none: bit for bit the per-level
    calls, within the bar of the plain walk."""
    small = cr.BACKSUB_SMALL_PAIRS
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain(k, 8, r, seed=k + r, dtype=dtype,
                               device=cuda_device)
        Ds, Es = bt._pad_pow2_soa(D, E)
        Gs = bt._pad_rhs(G, Ds.shape[-1])
        for tail in (bt.TAIL, small, 2 * small):
            if Ds.shape[-1] > tail:
                _hold_backsub_sweep(Ds, Es, Gs, tail)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("levels", range(1, 13))
def test_cr_backsub_sweep_at_every_level_count(cuda_device, levels, r):
    """Kernel #6's sweep on chains of 8 << levels blocks, 1 to 12 levels
    down to the tail, as _hold_backsub_sweep holds it."""
    for dtype in (torch.float64, torch.float32):
        Ds, Es, Gs = random_chain(bt.TAIL << levels, 8, r, seed=levels + r,
                                  dtype=dtype, device=cuda_device)
        assert _hold_backsub_sweep(Ds, Es, Gs, bt.TAIL) == levels


@pytest.mark.cuda
def test_cr_solve_makes_no_level_view(cuda_device, monkeypatch):
    """A CR solve on the card hands the sweeps' workspaces on by address:
    no per-level view is made, and the back-substitution is one library
    call."""
    made = []
    views = cr._level_views
    monkeypatch.setattr(cr, "_level_views",
                        lambda *a: made.append(a) or views(*a))
    D, E, G = random_chain(20001, 8, 3, seed=5, device=cuda_device)
    levels = cr.sweep_levels(32768, bt.TAIL)
    n0 = cr.device_launches()
    solve = bt.blocktri_cr_factor_soa(D, E)
    n1 = cr.device_launches()
    x = solve(G)
    aos = [a.permute(2, 0, 1) for a in (D, E, G)]
    x2 = bt.blocktri_solve_cr(*aos)
    torch.cuda.synchronize()
    assert made == []
    assert n1 - n0 == levels
    assert cr.device_launches() - n1 == (
        2 * levels + 2 * cr.backsub_sweep_launches(16384, levels))
    assert rel_err(x, bt.blocktri_cr_factor_plain(D, E)(G)) <= 1e-9
    assert rel_err(x2, bt.blocktri_solve_cr_plain(*aos)) <= 1e-9


@pytest.mark.cuda
def test_cr_sweep_on_a_tail_launches_nothing(cuda_device):
    """A chain of at most TAIL blocks has no level: the sweeps return their
    inputs and launch no kernel."""
    D, E, G = random_chain(bt.TAIL, 8, 3, seed=0, device=cuda_device)
    before, n0 = _launches(CR_KERNELS), cr.device_launches()
    (Dt, Et), facs = cr.cr_factor_sweep(D, E, bt.TAIL)
    Gt, s_gs = cr.cr_apply_sweep(facs, G)
    assert facs == [] and s_gs == []
    assert Dt is D and Et is E and Gt is G
    assert _launches(CR_KERNELS) == before and cr.device_launches() == n0
    with pytest.raises(ValueError, match="even"):
        cr.cr_factor_sweep(*random_chain(18, 8, 1, seed=0,
                                         device=cuda_device)[:2], bt.TAIL)


@pytest.mark.cuda
def test_cr_kernels_reject_what_they_do_not_take(cuda_device):
    """The CR kernels refuse, before any launch, r = 18 and b = 17, with the
    range in the message, an odd chain and a non-contiguous D."""
    D, E, G = random_chain(16, 8, 18, seed=0, device=cuda_device)
    before = _launches(CR_KERNELS)
    with pytest.raises(ValueError, match=r"1 <= b <= 16 and 1 <= r <= 17"):
        cr.cr_level(D, E, G)
    (_, _), fac = cr.cr_level_factor(D, E)
    with pytest.raises(ValueError, match=r"1 <= b <= 16 and 1 <= r <= 17"):
        cr.cr_level_apply(fac, G)
    D17, E17, _ = random_chain(16, 17, 1, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match=r"1 <= b <= 16"):
        cr.cr_level_factor(D17, E17)
    assert _launches(CR_KERNELS) == [before[0], before[1] + 1, *before[2:]]
    with pytest.raises(ValueError, match="even"):
        cr.cr_level_factor(D[..., :15].contiguous(), E[..., :15].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cr.cr_level_factor(D.transpose(0, 1), E)


@pytest.mark.cuda
def test_method_cr_runs_only_the_cr_kernels(cuda_device):
    """make_gn_solver(method='cr') on the card: 3 LM iterations of a small
    Van der Pol problem (K = 101, padded to 128: 4 kernel levels) launch
    the factor, apply and back-substitution kernels 3 x 4 times each and no
    other kernel or plain version, and land on the CPU run's p (float64,
    relative difference <= 1e-9)."""
    from collocfem_tpu_torch.headline import build_headline_problem
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    mesh, t, y, u = build_headline_problem(100)
    ps = []
    for device in (cuda_device, "cpu"):
        prob = EstimationProblem.build(VanDerPol(), mesh, t,
                                       defect_weight=100.0, device=device,
                                       dtype=torch.float64)
        data = prob.pack_data(y, t, u_nodes=u)
        z0 = prob.initial_guess_from_data(t, y, p0=[0.5, 0.5])
        solve = make_gn_solver(prob, SolverOptions(maxiter=3, gtol=0.0,
                                                   method="cr"))
        plain = (spike.kkt_solve_spike_fused_ref,
                 spike.blocktri_solve_spike_fused_ref,
                 thomas.batched_thomas_solve_ref, cr.cr_level_ref,
                 cr.cr_level_factor_ref, cr.cr_level_apply_ref,
                 cr.cr_backsub_ref)
        before, before_plain = _launches(KERNELS), _launches(plain)
        z, _ = solve(z0, data)
        if device != "cpu":
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(_launches(KERNELS), before)]
            assert ran == [0, 12, 12, 12, 0, 0, 0]
            assert _launches(plain) == before_plain
        ps.append(z.p.cpu())
    assert rel_err(ps[0], ps[1]) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["config2", "config4"])
def test_auto_resolves_to_spike_for_the_configs(cuda_device, which):
    """'auto' runs kernel #1 on the card for configs 2 (nq = 3) and 4
    (nq = 5), and the CR kernels are built for their r = 1 + nq."""
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve.kkt import (require_cr_shapes,
                                               resolve_auto_method)

    build = getattr(configs, f"build_{which}_problem")
    prob, _, _ = build(dtype=torch.float64, device=cuda_device)
    b, nq = prob.mesh.degree * prob.nv, prob.model.nq
    assert (b, nq) == ((8, 3) if which == "config2" else (8, 5))
    assert resolve_auto_method(b, nq, cuda_device) == "spike"
    require_cr_shapes(b, nq, cuda_device)


def _config4_small(device, elements=50):
    """Config 4's model, flight record, weights and initial guess on
    ``elements`` elements (``configs.build_config4_problem`` builds the
    full 200)."""
    import numpy as np

    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.models import AircraftLongitudinal
    from collocfem_tpu_torch.ops.mesh import uniform_mesh
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.utils.io import load_measurements

    t, vals = load_measurements(str(configs.AIRCRAFT_RECORD))
    y, u_rec = vals[:, :3], vals[:, 3]
    mesh = uniform_mesh(0.0, configs.TF4, elements, configs.DEGREE)
    prob = EstimationProblem.build(
        AircraftLongitudinal(V=configs.V_AIR, g0=configs.G0), mesh, t,
        defect_weight=1e4, device=device, dtype=torch.float64)
    u_nodes = np.interp(mesh.elem_times, t, u_rec)[..., None]
    data = prob.pack_data(y, t, u_nodes=u_nodes,
                          meas_weight=1.0 / np.array(configs.NOISE4))
    z0 = prob.initial_guess_from_data(t, y[:, :2], p0=configs.P4_0)
    return prob, z0, data


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["newton", "irls"])
def test_newton_and_irls_run_only_kernel_1(cuda_device, robust):
    """An exact-Newton solve and an IRLS solve (two reweighting rounds) of
    config 4's model on 50 elements (b = 8, nq = 5), 8 fixed-work LM
    iterations a solve, launch kernel #1 once per LM iteration and no other
    kernel or plain version, return a stats entry per solve (IRLS), and
    land on the CPU run's p (float64, relative difference <= 1e-9)."""
    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_gn_solver,
                                                  make_irls_solver)

    plain = (spike.kkt_solve_spike_fused_ref,
             spike.blocktri_solve_spike_fused_ref,
             thomas.batched_thomas_solve_ref, cr.cr_level_ref,
             cr.cr_level_factor_ref, cr.cr_level_apply_ref, cr.cr_backsub_ref)
    ps = []
    for device in (cuda_device, "cpu"):
        prob, z0, data = _config4_small(device)
        opts = dict(maxiter=8, gtol=0.0)
        if robust == "newton":
            solve = make_gn_solver(prob, SolverOptions(**opts,
                                                       hessian="newton"))
            rounds = 1
        else:
            solve = make_irls_solver(prob, SolverOptions(**opts,
                                                         irls_delta=2.0),
                                     n_rounds=2)
            rounds = 3
        before, before_plain = _launches(KERNELS), _launches(plain)
        z, stats = solve(z0, data)[:2]
        if robust == "irls":
            assert len(stats) == rounds
        if device != "cpu":
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(_launches(KERNELS), before)]
            assert ran == [0, 0, 0, 0, 8 * rounds, 0, 0]
            assert _launches(plain) == before_plain
        ps.append(z.p.cpu())
    assert bool(torch.isfinite(ps[0]).all())
    assert rel_err(ps[0], ps[1]) <= 1e-9


@pytest.mark.cuda
def test_plain_versions_launch_no_kernel(cuda_device):
    """The plain versions of kernels #1-#7 on CUDA tensors run plain torch
    only: no kernel's launch count moves."""
    from collocfem_tpu_torch.solve.kkt import solve_kkt_plain

    s = random_kkt_system(300, 8, 2, seed=1, device=cuda_device)
    D, E, G = random_chain(300, 8, 3, seed=2, device=cuda_device)
    Ds, Es = bt._pad_pow2_soa(D, E)
    Gs = bt._pad_rhs(G, Ds.shape[-1])
    Db, Eb, Gb = random_chain_batch(4, 11, 8, 3, seed=3, device=cuda_device)
    before = _launches(KERNELS)
    spike.kkt_solve_spike_fused_ref(s.D, s.E, s.B, s.gx, s.C, s.gp, 1e-3)
    solve_kkt_plain(s, 1e-3)
    spike.blocktri_solve_spike_fused_ref(D, E, G)
    bt.blocktri_cr_factor_plain(D, E)(G)
    bt.blocktri_solve_cr_plain(*(a.permute(2, 0, 1) for a in (D, E, G)))
    (dn, en, gn), sol = cr.cr_level_ref(Ds, Es, Gs)
    cr.cr_backsub_ref(gn, *sol)
    _, fac = cr.cr_level_factor_ref(Ds, Es)
    cr.cr_level_apply_ref(fac, Gs)
    thomas.batched_thomas_solve_ref(Db, Eb, Gb)
    torch.cuda.synchronize()
    assert _launches(KERNELS) == before


# ---- every block size (per-shape builds, ops/_build.py) ---------------------

# The block sizes of the CR sweep: the powers of two, odd b (3: a block of
# 96 threads; backsub_small of 480), the MHE window's 6, config 3's 12 and
# the split actuator's 16 (float64 tiles of 16 pairs).
CR_BLOCKS = [1, 2, 3, 4, 6, 12, 16]
# The instances the sweeps below and the range-edge test run, built at once.
SWEEP_INSTANCES = (
    [spike.kkt_instance(b, 2) for b in range(1, 17)]
    + [spike.chain_instance(b, r) for b in range(1, 17) for r in (1, 3)]
    + [thomas.instance(b, 3) for b in range(1, 17)]
    + [cr.instance(b, r) for b in CR_BLOCKS for r in (0, 1, 3)]
    + [spike.kkt_instance(16, 16), spike.chain_instance(16, 49),
       spike.chain_instance(1, 19), thomas.instance(16, 17),
       thomas.instance(1, 17), cr.instance(16, 17), cr.instance(13, 0),
       cr.instance(13, 17), cr.instance(1, 17)])


@pytest.fixture(scope="module")
def sweep_built():
    """Every instance of SWEEP_INSTANCES, built concurrently
    (``_build.prebuild``) and loaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    from collocfem_tpu_torch.ops import _build

    _build.load_all(SWEEP_INSTANCES)


def _hold(dtype, got, want, residual):
    """Phase 2's bars: float64 relative difference <= 1e-9; float32 the
    kernel's residual at most 10x the plain version's."""
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float64:
        assert rel_err(got, want) <= 1e-9
    else:
        assert residual(got) <= 10 * residual(want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, 17))
def test_kkt_kernel_at_every_block_size(cuda_device, sweep_built, b):
    """Kernel #1 at (b, nq = 2) for every 1 <= b <= 16 (lane groups of 1,
    2, 4, 8 and 16, lanes b..W-1 idle) on seeded systems, K at the tile
    plan's edges and 1,000, against its plain version at phase 2's bars;
    each call one launch counted at (b, 2)."""
    for dtype, k in itertools.product((torch.float64, torch.float32),
                                      EDGES + [1000]):
        s = random_kkt_system(k, b, 2, seed=k + b, dtype=dtype,
                              device=cuda_device)
        before = spike.kkt_solve_spike_fused.shapes.get((b, 2), 0)
        got, want = _solve_both(s, 1e-3, None)
        assert spike.kkt_solve_spike_fused.shapes[(b, 2)] == before + 1
        assert all(bool(torch.isfinite(g).all()) for g in got[:2])
        if dtype == torch.float64:
            assert rel_err(got[0], want[0]) <= 1e-9
            assert rel_err(got[1], want[1]) <= 1e-9
        else:
            assert kkt_residual(s, got[0], got[1], 1e-3, got[2]) <= \
                10 * kkt_residual(s, want[0], want[1], 1e-3, want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, 17))
def test_chain_kernel_at_every_block_size(cuda_device, sweep_built, b):
    """Kernel #2 at (b, 1) and (b, 3) for every 1 <= b <= 16, on seeded
    chains with zero couplings every 11 blocks, K at the tile plan's edges
    and 1,000, against its plain version at phase 2's bars."""
    for dtype, k, r in itertools.product((torch.float64, torch.float32),
                                         EDGES + [1000], (1, 3)):
        D, E, G = random_chain(k, b, r, seed=k + r + b, boundary=11,
                               dtype=dtype, device=cuda_device)
        launches = spike.blocktri_solve_spike_fused.launches
        got = spike.blocktri_solve_spike_fused(D, E, G)
        assert spike.blocktri_solve_spike_fused.launches == launches + 1
        _hold(dtype, got, spike.blocktri_solve_spike_fused_ref(D, E, G),
              lambda X: chain_residual(D, E, G, X))


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, 17))
def test_thomas_kernel_at_every_block_size(cuda_device, sweep_built, b):
    """Kernel #7 at (b, 3) for every 1 <= b <= 16 (a group of
    group_width(b) lanes a chain), on batches that leave a ragged last warp
    and block, against its plain version at phase 2's bars."""
    for dtype, n_exp, k in itertools.product(
            (torch.float64, torch.float32), (1, 5, 1000), (1, 2, 11)):
        D, E, G = random_chain_batch(n_exp, k, b, 3, seed=n_exp + k + b,
                                     dtype=dtype, device=cuda_device)
        launches = thomas.batched_thomas_solve.launches
        got = thomas.batched_thomas_solve(D, E, G)
        assert thomas.batched_thomas_solve.launches == launches + 1
        _hold(dtype, got, thomas.batched_thomas_solve_ref(D, E, G),
              lambda X: batch_residual(D, E, G, X))


def _hold_cr_at(b, r, dtype, device):
    """Kernels #3-#6 at (b, r): one level on both sides of a pass block's
    31 (or 15) stored pairs, the sweeps of a whole solve, each against its
    plain version (``testing.level_bar``; whole solves at phase 2's bars)."""
    for m in (2, 32, 64, 66, 1000):
        D, E, G = random_chain(m, b, r, seed=m + r + b, dtype=dtype,
                               device=device)
        for name, outs in cr_level_comparison(D, E, G).items():
            torch.cuda.synchronize()
            ok, worst = level_bar(*outs)
            assert ok, (name, b, r, m, dtype, worst)
    for k in (17, 1000):
        D, E, G = random_chain(k, b, r, seed=k + r + b, dtype=dtype,
                               device=device)
        Ds, Es = bt._pad_pow2_soa(D, E)
        _hold_backsub_sweep(Ds, Es, bt._pad_rhs(G, Ds.shape[-1]), bt.TAIL)
        _hold(dtype, bt.blocktri_cr_factor_soa(D, E)(G),
              bt.blocktri_cr_factor_plain(D, E)(G),
              lambda X: chain_residual(D, E, G, X))


@pytest.mark.cuda
@pytest.mark.parametrize("b", CR_BLOCKS)
def test_cr_kernels_at_other_block_sizes(cuda_device, sweep_built, b):
    """Kernels #3-#6 at b in CR_BLOCKS with r = 1 and 3 (_hold_cr_at)."""
    for dtype, r in itertools.product((torch.float64, torch.float32), (1, 3)):
        _hold_cr_at(b, r, dtype, cuda_device)


@pytest.mark.cuda
def test_kernels_at_the_range_edges(cuda_device, sweep_built):
    """The largest shapes of each range and the smallest block size at the
    largest r: #1 at (16, nq = 16), #2 at (16, 49) and (1, 19), #7 at (16,
    17) and (1, 17), #3-#6 at (16, 17), (13, 17) (tiles of 16 pairs, a
    half-warp with no column) and (1, 17), against their plain versions at
    phase 2's bars."""
    for dtype in (torch.float64, torch.float32):
        for k in (9, 97):
            s = random_kkt_system(k, 16, 16, seed=k, dtype=dtype,
                                  device=cuda_device)
            got, want = _solve_both(s, 1e-3, None)
            if dtype == torch.float64:
                assert rel_err(got[0], want[0]) <= 1e-9
                assert rel_err(got[1], want[1]) <= 1e-9
            else:
                assert kkt_residual(s, got[0], got[1], 1e-3, got[2]) <= \
                    10 * kkt_residual(s, want[0], want[1], 1e-3, want[2])
            for b, r in ((16, 49), (1, 19)):
                D, E, G = random_chain(k, b, r, seed=k + r, dtype=dtype,
                                       device=cuda_device)
                _hold(dtype, spike.blocktri_solve_spike_fused(D, E, G),
                      spike.blocktri_solve_spike_fused_ref(D, E, G),
                      lambda X: chain_residual(D, E, G, X))
        for b in (16, 1):
            D, E, G = random_chain_batch(37, 5, b, 17, seed=b, dtype=dtype,
                                         device=cuda_device)
            _hold(dtype, thomas.batched_thomas_solve(D, E, G),
                  thomas.batched_thomas_solve_ref(D, E, G),
                  lambda X: batch_residual(D, E, G, X))
        for b in (16, 13, 1):
            _hold_cr_at(b, 17, dtype, cuda_device)


@pytest.mark.cuda
def test_captured_solver_builds_a_new_shape_at_construction(
        cuda_device, tmp_path, monkeypatch):
    """make_gn_solver on Van der Pol at degree 3 (b = 6, nq = 2: kernel #1's
    instance (6, r = 3)), with an empty build directory: making the solver
    builds and loads the instance, before any call and so outside the
    CUDA-graph capture; the captured solve then equals solve.eager bit for
    bit with the same launches, kernel #1 at (6, 2) once per iteration."""
    from collocfem_tpu_torch.headline import build_headline_problem
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.ops import _build
    from collocfem_tpu_torch.problem import EstimationProblem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    spike._library.cache_clear()
    try:
        inst = spike.kkt_instance(6, 2)
        mesh, t, y, u = build_headline_problem(50, degree=3)
        prob = EstimationProblem.build(VanDerPol(), mesh, t,
                                       defect_weight=100.0,
                                       device=cuda_device,
                                       dtype=torch.float64)
        data = prob.pack_data(y, t, u_nodes=u)
        z0 = prob.initial_guess_from_data(t, y, p0=[0.5, 0.5])
        assert not inst.paths()[0].exists()
        solve = make_gn_solver(prob, SolverOptions(maxiter=8, gtol=0.0))
        assert inst.paths()[0].exists() and inst in _build._LOADED
        before = spike.kkt_solve_spike_fused.shapes.get((6, 2), 0)
        _hold_captured(solve, z0, data)
        assert spike.kkt_solve_spike_fused.shapes[(6, 2)] == before + 3 * 8
    finally:
        spike._library.cache_clear()


# ---- the optimal-control block size b = 12 ----------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", EDGES + [17, 26, 501])
def test_kernels_at_block_size_12_match_plain(cuda_device, k):
    """Kernels #1 (nq = 1: the free-time OCP) and #2 (r = 1: config 3) at
    b = 12, where a tile's lane group is 16 lanes with 4 idle: float64
    relative difference <= 1e-9; float32 residual at most 10x the plain
    version's; each call one counted launch at (12, 1)."""
    for dtype in (torch.float64, torch.float32):
        s = random_kkt_system(k, 12, 1, seed=k + 1, dtype=dtype,
                              device=cuda_device)
        before = dict(spike.kkt_solve_spike_fused.shapes)
        got, want = _solve_both(s, 1e-3, None)
        assert spike.kkt_solve_spike_fused.shapes[(12, 1)] == \
            before.get((12, 1), 0) + 1
        if dtype == torch.float64:
            assert rel_err(got[0], want[0]) <= 1e-9
            assert rel_err(got[1], want[1]) <= 1e-9
        else:
            assert kkt_residual(s, got[0], got[1], 1e-3, got[2]) <= \
                10 * kkt_residual(s, want[0], want[1], 1e-3, want[2])
        D, E, G = random_chain(k, 12, 1, seed=k + 1, dtype=dtype,
                               device=cuda_device)
        launches = spike.blocktri_solve_spike_fused.launches
        got = spike.blocktri_solve_spike_fused(D, E, G)
        torch.cuda.synchronize()
        assert spike.blocktri_solve_spike_fused.launches == launches + 1
        want = spike.blocktri_solve_spike_fused_ref(D, E, G)
        if dtype == torch.float64:
            assert rel_err(got, want) <= 1e-9
        else:
            assert chain_residual(D, E, G, got) <= \
                10 * chain_residual(D, E, G, want)


@pytest.mark.cuda
def test_kernels_at_block_size_12_are_deterministic(cuda_device):
    """Two runs of kernels #1 and #2 at b = 12 (K = 501) are
    bit-identical."""
    s = random_kkt_system(501, 12, 1, seed=5, device=cuda_device)
    args = (s.D, s.E, s.B, s.gx, s.C, s.gp, 1e-3)
    first, again = (spike.kkt_solve_spike_fused(*args) for _ in range(2))
    D, E, G = random_chain(501, 12, 1, seed=6, device=cuda_device)
    x1, x2 = (spike.blocktri_solve_spike_fused(D, E, G) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    assert torch.equal(x1, x2)


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# sha256 (first 16 hex digits) of kernel #1's (dx, dp) at (8, 2) on
# random_kkt_system(k, 8, 2, seed=k) with lam 1e-3, and of kernel #2's X at
# (8, 3) on random_chain(k, 8, 3, seed=k, boundary=11), float64 and float32,
# as the kernels before the lane group was separated from the block size
# computed them on an NVIDIA H100 80GB HBM3 (the same nvcc flags; the
# kernels after the change gave the same digests in the same call).
B8_DIGESTS = {
    ("kkt", "float64", 97): "e371f45615117d4b",
    ("kkt", "float32", 97): "6f7707472e1385ac",
    ("kkt", "float64", 1000): "298b6fdfb2d9bcc3",
    ("kkt", "float32", 1000): "fbfc8b01d0478ba6",
    ("chain", "float64", 97): "526094e29e0b4bc7",
    ("chain", "float32", 97): "cb58ac0a71152eb4",
    ("chain", "float64", 1000): "d724a23f09618aa3",
    ("chain", "float32", 1000): "23d9165db48c159f",
}


def b8_digests(device):
    """The digests of B8_DIGESTS computed by this tree's kernels."""
    out = {}
    for kind, name, k in B8_DIGESTS:
        dtype = getattr(torch, name)
        if kind == "kkt":
            s = random_kkt_system(k, 8, 2, seed=k, dtype=dtype, device=device)
            res = spike.kkt_solve_spike_fused(s.D, s.E, s.B, s.gx, s.C, s.gp,
                                              1e-3)[:2]
        else:
            res = (spike.blocktri_solve_spike_fused(*random_chain(
                k, 8, 3, seed=k, boundary=11, dtype=dtype, device=device)),)
        torch.cuda.synchronize()
        out[(kind, name, k)] = _digest(res)
    return out


@pytest.mark.cuda
def test_block_size_8_results_unchanged(cuda_device):
    """Kernels #1 and #2 at b = 8 give, bit for bit, what they gave before
    the lane group was separated from the block size (B8_DIGESTS)."""
    assert b8_digests(cuda_device) == B8_DIGESTS


def _ocp_on_the_card_and_the_cpu(build, options, kernels):
    """The OCP solve of ``build(device)`` on the card and on the CPU in
    float64: on the card the launch counts of KERNELS must be ``kernels(st)``
    and no plain version runs.  Returns [(V, objective), card then CPU]."""
    from collocfem_tpu_torch.solve.auglag import make_ocp_solver

    plain = (spike.kkt_solve_spike_fused_ref,
             spike.blocktri_solve_spike_fused_ref,
             thomas.batched_thomas_solve_ref, cr.cr_level_ref,
             cr.cr_level_factor_ref, cr.cr_level_apply_ref, cr.cr_backsub_ref)
    runs = []
    for device in (torch.device("cuda"), "cpu"):
        prob = build(device)
        before, before_plain = _launches(KERNELS), _launches(plain)
        z, st = make_ocp_solver(prob, options)(prob.initial_guess())
        if device != "cpu":
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(_launches(KERNELS), before)]
            assert ran == kernels(st)
            assert _launches(plain) == before_plain
            assert float(st.cviol) < 1e-8
        runs.append((z.V.cpu(), float(st.objective)))
    return runs


@pytest.mark.cuda
def test_ocp_shapes_run_on_the_card(cuda_device):
    """The two optimal-control shapes that the card could not run before
    per-shape builds: config 3 (N = 25, b = 12) with method='cr' (kernels
    #4-#6 at b = 12, once per inner LM iteration, a sweep of 2 levels
    each) and the split-actuator model of tests/test_ocp.py (nu = 2, b =
    16, N = 4) on 'auto' (kernel #2 at (16, 1) once per inner iteration),
    each in float64 against the same solve on the CPU: the objective within
    1e-9 (relative) and V within 1e-6, the card-against-CPU bar of config
    3's 'auto' test below (the inner solves' rounding moves the AL
    iterates: V lands 4.1e-9 from the CPU's on 'cr', NVIDIA H100 80GB
    HBM3)."""
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve.auglag import ALBarrierOptions

    def levels(st):
        n = int(st.history[:, 4].sum())
        lv = cr.sweep_levels(32, bt.TAIL)              # K = 26 padded to 32
        return [0, n * lv, n * lv, n * lv, 0, 0, 0]

    cases = (
        (lambda dev: configs.build_config3_problem(
            25, dtype=torch.float64, device=dev)[0],
         ALBarrierOptions(method="cr"), levels),
        (lambda dev: configs.build_split_actuator_problem(
            4, dtype=torch.float64, device=dev)[0],
         ALBarrierOptions(n_outer=16),
         lambda st: [0, 0, 0, 0, 0, int(st.history[:, 4].sum()), 0]))
    for build, options, kernels in cases:
        (v_card, obj_card), (v_cpu, obj_cpu) = _ocp_on_the_card_and_the_cpu(
            build, options, kernels)
        assert abs(obj_card - obj_cpu) <= 1e-9 * abs(obj_cpu)
        assert float((v_card - v_cpu).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_config3_solve_on_the_card_matches_the_cpu(cuda_device):
    """Config 3 (N = 25) in float64 on the card ('auto': kernel #2 once per
    inner LM iteration, no other kernel, no plain version) against the same
    solve on the CPU (plain cyclic reduction): the objective and V within
    1e-6, every outer round's objective within 1e-6 (relative)."""
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)

    plain = (spike.kkt_solve_spike_fused_ref,
             spike.blocktri_solve_spike_fused_ref,
             thomas.batched_thomas_solve_ref, cr.cr_level_ref,
             cr.cr_level_factor_ref, cr.cr_level_apply_ref, cr.cr_backsub_ref)
    runs = []
    for device in (cuda_device, "cpu"):
        prob, z0 = configs.build_config3_problem(25, dtype=torch.float64,
                                                 device=device)
        before, before_plain = _launches(KERNELS), _launches(plain)
        z, st = make_ocp_solver(prob, ALBarrierOptions())(z0)
        if device != "cpu":
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(_launches(KERNELS), before)]
            assert ran == [0, 0, 0, 0, 0, int(st.history[:, 4].sum()), 0]
            assert _launches(plain) == before_plain
        runs.append((z.V.cpu(), st.history.cpu(), float(st.objective),
                     float(st.cviol)))
    (v_card, h_card, obj_card, cv_card), (v_cpu, h_cpu, obj_cpu, _) = runs
    assert cv_card < 1e-8
    assert abs(obj_card - obj_cpu) <= 1e-6 * abs(obj_cpu)
    assert float((v_card - v_cpu).abs().max()) <= 1e-6
    assert float(((h_card[:, 0] - h_cpu[:, 0]) / h_cpu[:, 0]).abs().max()) \
        <= 1e-6


# ---- the moving-horizon estimator's block size b = 6 ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", EDGES + [8, 12, 229, 1000])
def test_chain_kernel_at_block_size_6_matches_plain(cuda_device, k):
    """Kernel #2 at (6, 1), the MHE window's shape (degree 3, nx = 2), on an
    8-lane group with lanes 6 and 7 idle: float64 relative difference <=
    1e-9; float32 residual at most 10x the plain version's; each call one
    counted launch at (6, 1), and two runs bit-identical."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain(k, 6, 1, seed=k + 6, dtype=dtype,
                               device=cuda_device)
        before = dict(spike.blocktri_solve_spike_fused.shapes)
        got = spike.blocktri_solve_spike_fused(D, E, G)
        again = spike.blocktri_solve_spike_fused(D, E, G)
        torch.cuda.synchronize()
        assert spike.blocktri_solve_spike_fused.shapes[(6, 1)] == \
            before.get((6, 1), 0) + 2
        assert torch.equal(got, again)
        want = spike.blocktri_solve_spike_fused_ref(D, E, G)
        if dtype == torch.float64:
            assert rel_err(got, want) <= 1e-9
        else:
            assert chain_residual(D, E, G, got) <= \
                10 * chain_residual(D, E, G, want)


@pytest.mark.cuda
def test_mhe_on_the_card_matches_the_cpu(cuda_device):
    """A Van der Pol moving-horizon estimator (degree 3, horizon 8: b = 6,
    K = 8) in float64 on the card ('auto': kernel #2 at (6, 1) once per LM
    iteration of every window solve, no other kernel, no plain version)
    against the same stream on the CPU: every estimate within 1e-7 and the
    final covariance within 1e-11 of its largest entry.  Each window solve
    stops at gtol = 1e-9 on the gradient, which fixes the unmeasured
    velocity only to ~1e-8, so the two chain solves' rounding moves the
    estimates by a few 1e-9; the covariance, a function of the estimate
    through the model's Jacobians, moves by a few 1e-13 of its largest
    entry.  Each bar is some 25-35 times the H100's reading."""
    import numpy as np

    from collocfem_tpu_torch.mhe import MovingHorizonEstimator
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.solve.newton import SolverOptions

    rng = np.random.default_rng(3)
    ys = np.sin(0.05 * np.arange(14))[:, None] + 0.01 * rng.standard_normal(
        (14, 1))
    plain = (spike.kkt_solve_spike_fused_ref,
             spike.blocktri_solve_spike_fused_ref,
             thomas.batched_thomas_solve_ref, cr.cr_level_ref,
             cr.cr_level_factor_ref, cr.cr_level_apply_ref, cr.cr_backsub_ref)
    runs = []
    for device in (cuda_device, "cpu"):
        mhe = MovingHorizonEstimator(
            VanDerPol(), horizon=8, dt=0.05, sig_w=0.5, sig_v=0.01, degree=3,
            p_fixed=[1.0, 1.0], options=SolverOptions(maxiter=20, gtol=1e-9),
            device=device)
        its = []
        solver = mhe._solver
        mhe._solver = lambda z0, data: (lambda out: (its.append(
            int(out[1].iterations)), out)[1])(solver(z0, data))
        before, before_plain = _launches(KERNELS), _launches(plain)
        state = mhe.init(ys[:8], m0=[0.0, 1.0], P0=np.eye(2))
        ests = [mhe.estimate(state)]
        for k in range(8, 14):
            state, est = mhe.step(state, ys[k])
            ests.append(est)
        cov = mhe.current_covariance(state)
        if device != "cpu":
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(_launches(KERNELS), before)]
            assert ran == [0, 0, 0, 0, 0, sum(its), 0]
            assert _launches(plain) == before_plain
        runs.append((torch.stack(ests).cpu(), cov.cpu()))
    (e_card, c_card), (e_cpu, c_cpu) = runs
    d_est = float((e_card - e_cpu).abs().max())
    d_cov = float((c_card - c_cpu).abs().max() / c_cpu.abs().max())
    print(f"card against CPU: estimates {d_est:.3e}, covariance {d_cov:.3e} "
          f"of max |cov| {float(c_cpu.abs().max()):.3e}")
    assert d_est <= 1e-7
    assert d_cov <= 1e-11


# ---- the solves captured as CUDA graphs (solve/graph.py) ---------------------


def _counted_call(fn, *args):
    """(fn(*args), the launch counts it made), synchronised."""
    from collocfem_tpu_torch.ops import _build

    before = _build.snapshot()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, _build.difference(before, _build.snapshot())


def _hold_captured(solve, *args):
    """The captured solve's first call (warm-up, capture, replays) and a
    second call (replays) against ``solve.eager`` on the same inputs: bit
    for bit (a NaN matches itself), and the same launch counts per call, as
    the wrappers count them.  Returns the captured result."""
    from collocfem_tpu_torch.testing import bit_equal

    got, counts = _counted_call(solve, *args)
    again, counts_again = _counted_call(solve, *args)
    want, eager_counts = _counted_call(solve.eager, *args)
    assert bit_equal(got, want) and bit_equal(again, want)
    assert counts == counts_again == eager_counts and counts
    return got


CAPTURED_CASES = {
    "fixed float64": dict(maxiter=15, gtol=0.0, lam0=3e-6, lam_max=1e30),
    "fixed float32": dict(maxiter=15, gtol=0.0, lam0=3e-6, lam_max=1e30),
    "early exit": dict(maxiter=60, gtol=1e-10, xtol=1e-12),
    "newton": dict(maxiter=30, gtol=1e-10, hessian="newton"),
    "cr": dict(maxiter=15, gtol=0.0, lam0=3e-6, lam_max=1e30, method="cr"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CAPTURED_CASES))
def test_captured_gn_solver_matches_eager(cuda_device, case):
    """make_gn_solver on the headline at N = 40: 'auto' (kernel #1) at fixed
    work in both dtypes, with early exit, exact Newton, and method='cr'
    (kernels #4-#6): the captured solve equals solve.eager bit for bit,
    with the same launches per call."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    dtype = torch.float32 if "float32" in case else torch.float64
    prob, data, z0 = headline_problem(40, dtype=dtype, device=cuda_device)
    solve = make_gn_solver(prob, SolverOptions(**CAPTURED_CASES[case]))
    z, st = _hold_captured(solve, z0, data)
    assert float(st.cost) < float(st.history[0, 0])
    assert len(solve._plans) == 1


@pytest.mark.cuda
def test_captured_ladder_past_the_chain_matches_eager(cuda_device,
                                                      monkeypatch):
    """ConvergedLadder through bench.py's branch past CR_DW_CHAIN (lowered
    to 100 blocks: 10 float32 -> 10 float64 -> 160 float64 elements on
    'cr'): the captured ladder equals ladder.eager bit for bit, with the
    same launches, and its p is float64."""
    from collocfem_tpu_torch import refine
    from collocfem_tpu_torch.headline import ConvergedLadder
    from collocfem_tpu_torch.testing import bit_equal

    monkeypatch.setattr(refine, "CR_DW_CHAIN", 100)
    ladder = ConvergedLadder(160, device=cuda_device, dtype=torch.float32)
    assert [(lv.elements, lv.problem.dtype, lv.options.method)
            for lv in ladder.levels] == [
        (10, torch.float32, "auto"), (10, torch.float64, "auto"),
        (160, torch.float64, "cr")]
    got, counts = _counted_call(ladder)
    want, eager_counts = _counted_call(ladder.eager)
    assert bit_equal(got, want) and counts == eager_counts and counts
    assert got[0].p.dtype == torch.float64


@pytest.mark.cuda
def test_captured_irls_matches_eager(cuda_device):
    """make_irls_solver (two rounds of the captured inner solve, the
    reweighting eager between them) against solve.eager; the later round's
    per-sample weights make a second plan."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_irls_solver)

    prob, data, z0 = headline_problem(40, dtype=torch.float64,
                                      device=cuda_device)
    solve = make_irls_solver(prob, SolverOptions(maxiter=30, gtol=1e-10,
                                                 irls_delta=2.0), n_rounds=2)
    _hold_captured(solve, z0, data)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["soa", "blocks"])
def test_captured_multi_experiment_solver_matches_eager(cuda_device, layout):
    """Config 5 at 4 experiments x 10 elements, float64 fixed work: kernel
    #2 ('soa') or #7 ('blocks') from the graph, bit for bit the eager
    loop's."""
    from collocfem_tpu_torch.batched import build_config5_problem
    from collocfem_tpu_torch.parallel.batch import (
        make_multi_experiment_solver)
    from collocfem_tpu_torch.solve.newton import SolverOptions

    prob, z0, data, p_prior, p_w = build_config5_problem(
        4, 10, dtype=torch.float64, device=cuda_device)
    solve = make_multi_experiment_solver(
        prob, SolverOptions(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30),
        layout=layout)
    _hold_captured(solve, z0, data, p_prior, p_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_captured_mhe_step_matches_eager(cuda_device, dtype):
    """examples/mhe_online.py's estimator, ten steps: the captured step (its
    prelude graph and the captured window solve) against step_eager, bit for
    bit in every state field and estimate, with the same launches."""
    import numpy as np

    from collocfem_tpu_torch.testing import (MHE_HORIZON, bit_equal,
                                             mhe_online_stream)

    mhe, _, ys = mhe_online_stream(dtype, cuda_device,
                                   samples=MHE_HORIZON + 10)
    a = b = mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2))
    for k in range(MHE_HORIZON, MHE_HORIZON + 10):
        (a, est_a), counts = _counted_call(mhe.step, a, ys[k])
        (b, est_b), eager_counts = _counted_call(mhe.step_eager, b, ys[k])
        assert bit_equal((a.z, a.m, a.P, a.y, a.u, est_a),
                         (b.z, b.m, b.P, b.y, b.u, est_b))
        assert counts == eager_counts and counts
    assert len(mhe._advance_graph._plans) == 1


@pytest.mark.cuda
def test_captured_outputs_do_not_alias(cuda_device):
    """A second call (another z0, same shapes) leaves the first call's
    outputs as they were and shares no storage with them; data of a new
    shape captures a new plan."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.problem import Decision
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.testing import bit_equal
    from torch.utils._pytree import tree_flatten, tree_map

    prob, data, z0 = headline_problem(40, dtype=torch.float64,
                                      device=cuda_device)
    solve = make_gn_solver(prob, SolverOptions(**CAPTURED_CASES[
        "fixed float64"]))
    first = solve(z0, data)
    kept = tree_map(torch.clone, first)
    second = solve(Decision(V=z0.V * 1.01, p=z0.p * 0.9), data)
    torch.cuda.synchronize()
    assert bit_equal(first, kept) and not torch.equal(first[0].V,
                                                      second[0].V)
    for a, b in zip(tree_flatten(first)[0], tree_flatten(second)[0]):
        assert a.data_ptr() != b.data_ptr()
    assert len(solve._plans) == 1
    per_sample = data._replace(
        meas_w=data.meas_w.expand(*prob.mmask.shape, 1).clone())
    assert bit_equal(solve(z0, per_sample), first)
    assert len(solve._plans) == 2


@pytest.mark.cuda
def test_a_failing_capture_raises(cuda_device):
    """A step that reads a value back to the host (``.item()``) cannot be
    captured: the call raises, runs nothing eagerly in its place, keeps no
    plan and leaves the launch counts as they were."""
    from collocfem_tpu_torch.ops import _build
    from collocfem_tpu_torch.solve.graph import CapturedSolve

    eager_calls = []

    def step(st, x):
        return (st[0] + x * st[0].sum().item(),)

    solve = CapturedSolve(lambda x: (2.0 * x,), step, lambda st: st[0],
                          lambda x: eager_calls.append(x),
                          maxiter=3, early_exit=False)
    before = _build.snapshot()
    with pytest.raises(RuntimeError):
        solve(torch.ones(3, device=cuda_device))
    torch.cuda.synchronize()
    assert not eager_calls and not solve._plans
    assert _build.snapshot() == before


def _barrier_driver(kind, method, device):
    """make_bounded_solver on tests/test_bounds.py's active parameter bound
    (Van der Pol, 60 elements of degree 2: kernel #1 at (4, 2) on 'auto')
    or make_constrained_solver with the cap ||p||^2 <= 1.2 on the same
    problem, float64; (solve, z0, data)."""
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve import (BoundedOptions,
                                           ConstrainedOptions,
                                           make_bounded_solver, make_bounds,
                                           make_constrained_solver,
                                           project_interior)

    prob, z0, data = configs.build_bounded_vdp_problem(
        2, dtype=torch.float64, device=device)
    opts = dict(n_outer=6, inner_maxiter=30, method=method)
    if kind == "bounded":
        b = make_bounds(prob, p_lo=[0.0, None], p_hi=[configs.MU_CAP, None])
        return (make_bounded_solver(prob, b, BoundedOptions(**opts)),
                project_interior(z0, b), data)
    return (make_constrained_solver(
        prob, ConstrainedOptions(**opts),
        g_param=lambda p: torch.atleast_1d(torch.dot(p, p) - 1.2)), z0, data)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, method", [("bounded", "auto"),
                                          ("constrained", "auto"),
                                          ("bounded", "cr")])
def test_captured_barrier_driver_matches_eager(cuda_device, kind, method):
    """The interior-point drivers replay their whole barrier homotopy from
    CUDA graphs (prelude, begin, step, end, finish): the first call and a
    second one equal solve.eager bit for bit, with the same launches per
    call (kernel #1 on 'auto', #4-#6 on 'cr')."""
    solve, z0, data = _barrier_driver(kind, method, cuda_device)
    z, st = _hold_captured(solve, z0, data)
    assert len(solve._plans) == 1
    assert float(st.history[:, 3].sum()) > 0


@pytest.mark.cuda
def test_captured_barrier_driver_captures_once(cuda_device):
    """A second call of the same key (another z0) replays the first call's
    plan, captures nothing new, leaves the first call's outputs as they
    were and shares no storage with them."""
    from collocfem_tpu_torch.testing import bit_equal
    from torch.utils._pytree import tree_flatten, tree_map

    solve, z0, data = _barrier_driver("constrained", "auto", cuda_device)
    first = solve(z0, data)
    plan = next(iter(solve._plans.values()))
    kept = tree_map(torch.clone, first)
    second = solve(z0._replace(p=z0.p * 0.99), data)
    torch.cuda.synchronize()
    assert list(solve._plans.values()) == [plan]
    assert bit_equal(first, kept) and not torch.equal(first[0].p,
                                                      second[0].p)
    for a, b in zip(tree_flatten(first)[0], tree_flatten(second)[0]):
        assert a.data_ptr() != b.data_ptr()
    assert bit_equal(second, solve.eager(z0._replace(p=z0.p * 0.99), data))


def _ocp_driver(case, method, dtype, device):
    """make_ocp_solver on config 3 (N = 25: #2 at (12, 1) on 'auto', #4-#6
    at b = 12 on 'cr') or on the free-time OCP of examples/min_time_ocp.py
    (N = 16: #1 at (12, 1)); (solve, z0)."""
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.solve.auglag import (ALBarrierOptions,
                                                  make_ocp_solver)

    if case == "config 3":
        prob, z0 = configs.build_config3_problem(25, dtype=dtype,
                                                 device=device)
        return make_ocp_solver(prob, ALBarrierOptions(method=method)), z0
    prob, _, z0 = configs.build_min_time_problem(dtype=dtype, device=device)
    return make_ocp_solver(prob, ALBarrierOptions(
        **configs.MIN_TIME_OPTIONS, method=method)), z0


@pytest.mark.cuda
@pytest.mark.parametrize("case, method, dtype", [
    ("config 3", "auto", torch.float64), ("config 3", "auto", torch.float32),
    ("config 3", "cr", torch.float64), ("free time", "auto", torch.float64)])
def test_captured_ocp_driver_matches_eager(cuda_device, case, method, dtype):
    """make_ocp_solver replays its whole AL homotopy from CUDA graphs
    (prelude, begin, step, end, finish): the first call and a second one
    equal solve.eager bit for bit (z and every OCPStats field), with the
    same launches per call; on 'auto' the SPIKE kernel once per inner LM
    iteration."""
    solve, z0 = _ocp_driver(case, method, dtype, cuda_device)
    before = _launches(KERNELS)
    z, st = _hold_captured(solve, z0)
    assert len(solve._plans) == 1
    inner = int(st.history[:, 4].sum())
    assert inner > 0
    if method == "auto":          # three calls: first, second, eager
        ran = [a - b for a, b in zip(_launches(KERNELS), before)]
        kernel = 5 if case == "config 3" else 4
        assert ran == [3 * inner if i == kernel else 0 for i in range(7)]


@pytest.mark.cuda
def test_captured_ocp_driver_captures_once(cuda_device):
    """A second call of the same key (another z0) replays the first call's
    plan, captures nothing new, leaves the first call's outputs as they
    were, shares no storage with them and equals solve.eager."""
    from collocfem_tpu_torch.testing import bit_equal
    from torch.utils._pytree import tree_flatten, tree_map

    solve, z0 = _ocp_driver("free time", "auto", torch.float64, cuda_device)
    first = solve(z0)
    plan = next(iter(solve._plans.values()))
    kept = tree_map(torch.clone, first)
    z1 = z0._replace(V=z0.V * 0.9)
    second = solve(z1)
    torch.cuda.synchronize()
    assert list(solve._plans.values()) == [plan]
    assert bit_equal(first, kept) and not torch.equal(first[0].V,
                                                      second[0].V)
    for a, b in zip(tree_flatten(first)[0], tree_flatten(second)[0]):
        assert a.data_ptr() != b.data_ptr() or not a.numel()
    assert bit_equal(second, solve.eager(z1))


@pytest.mark.cuda
def test_a_failing_outer_capture_raises(cuda_device):
    """An outer loop whose step reads a value back to the host cannot be
    captured: the call raises, runs nothing eagerly in its place, keeps no
    plan and leaves the launch counts as they were."""
    from collocfem_tpu_torch.ops import _build
    from collocfem_tpu_torch.solve.graph import CapturedOuterLoop

    from collocfem_tpu_torch.solve.lm_core import lm_constants, lm_init

    eager_calls = []
    consts = lm_constants(1e-3, maxiter=3, dtype=torch.float32,
                          device=cuda_device)

    def begin(carry, x):
        return lm_init((carry,), (), carry.sum().double(), consts), carry

    def step(inner, carry, x):
        st, y = inner
        return st, y + x * carry.sum().item()

    loop = CapturedOuterLoop(
        lambda x: 2.0 * x, begin, step, lambda inner, carry, x: inner[1],
        lambda carry, x: carry, lambda x: eager_calls.append(x), n_outer=2,
        maxiter=3)
    before = _build.snapshot()
    with pytest.raises(RuntimeError):
        loop(torch.ones(3, device=cuda_device))
    torch.cuda.synchronize()
    assert not eager_calls and not loop._plans
    assert _build.snapshot() == before


def _reads_and_hold(solve, *args):
    """_hold_captured, with the host reads of the first call and of the
    replay counted (solve.graph.HostReads); returns (the captured result,
    the reads of each call)."""
    from collocfem_tpu_torch.solve.graph import HostReads

    reads = []

    def counted(*a):
        with HostReads("cuda") as r:
            out = solve(*a)
        reads.append(r.count)
        return out

    counted.eager = solve.eager
    return _hold_captured(counted, *args), reads


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gn", "mhe", "ocp", "barrier"])
def test_converging_captured_solves_read_nothing_to_the_host(cuda_device,
                                                             case):
    """A captured solve with a tolerance runs its LM loop on the device (a
    WHILE conditional node on ~done & (it < maxiter)): the first call
    (warm-up, capture, launch) and a replay read nothing back to the host,
    and equal solve.eager bit for bit with the same launches (the steps'
    share settled from the device counter when the counts are read).
    Cases: the headline at N = 40 to gtol, one MHE window solve, config 3
    (N = 25, the AL homotopy) and the bounded Van der Pol (the barrier
    homotopy), float64."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

    if case == "gn":
        prob, data, z0 = headline_problem(40, dtype=torch.float64,
                                          device=cuda_device)
        solve = make_gn_solver(prob, SolverOptions(**CAPTURED_CASES[
            "early exit"]))
        args = (z0, data)
    elif case == "mhe":
        import numpy as np

        from collocfem_tpu_torch.testing import (MHE_HORIZON,
                                                 mhe_online_stream)

        mhe, _, ys = mhe_online_stream(torch.float64, cuda_device,
                                       samples=MHE_HORIZON + 1)
        seen = []
        solver = mhe._solver
        mhe._solver = lambda z0, data: seen.append((z0, data)) or solver(
            z0, data)
        mhe.step(mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2)),
                 ys[MHE_HORIZON])
        solve, args = solver, seen[0]
    elif case == "ocp":
        solve, z0 = _ocp_driver("config 3", "auto", torch.float64,
                                cuda_device)
        args = (z0,)
    else:
        solve, z0, data = _barrier_driver("bounded", "auto", cuda_device)
        args = (z0, data)
    out, reads = _reads_and_hold(solve, *args)
    assert reads == [0, 0]
    its = (out[1].iterations if case in ("gn", "mhe")
           else out[1].history[:, 4 if case == "ocp" else 3].sum())
    assert int(its) > 0


@pytest.mark.cuda
def test_loop_graph_stops_at_done_and_at_maxiter(cuda_device):
    """_Plan.loop on a toy state: the step adds 1 to it and sets done at
    it = 5; with maxiter 8 the loop runs 5 steps, with maxiter 3 three, and
    a state done from the start runs none.  The device counter takes the
    steps, which the counts take at the next settle."""
    from collocfem_tpu_torch.ops import _build
    from collocfem_tpu_torch.solve import graph
    from collocfem_tpu_torch.solve.lm_core import LMState
    from torch.utils._pytree import tree_flatten

    def fake(n):
        _build.count_launches(fake, (1,), n)

    _build.register(fake, shapes=True)
    try:
        for maxiter, start_done, want in ((8, False, 5), (3, False, 3),
                                          (8, True, 0)):
            x = torch.zeros(4, device=cuda_device)
            plan = graph._Plan(*tree_flatten((x,)), capture=True)
            it = torch.zeros((), dtype=torch.int64, device=cuda_device)
            done = torch.zeros((), dtype=torch.bool, device=cuda_device)
            acc = torch.zeros(4, device=cuda_device)
            st = LMState(None, None, None, None, None, it, done, None, None)

            def step():
                fake(1)
                acc.add_(1.0)
                it.add_(1)
                done.copy_(it >= 5)

            run = plan.loop(step, st, maxiter)
            done.fill_(start_done)
            n0 = fake.launches
            run()
            torch.cuda.synchronize()
            assert fake.launches == n0
            _build.settle()
            assert int(it) == want and float(acc[0]) == want
            assert fake.launches == n0 + want
            assert plan.loop_nodes["step"] > 0
    finally:
        _build.COUNTED[:] = [f for f in _build.COUNTED
                             if f.__name__ != "fake"]


@pytest.mark.cuda
def test_loop_body_runs_the_step_path_ops(cuda_device):
    """The kinds of work an LM step does, under the loop graph's WHILE node
    (maxiter 1): kernel #2 through its wrapper, a cuBLAS product,
    smallblocks.spd_solve, cuSOLVER's batched Cholesky (cholesky_ex) and an
    index_copy, each written into a static buffer.  With done False the
    body runs once and gives the eager results bit for bit (and kernel #2's
    launch is counted at the settle); with done True it is skipped: every
    buffer keeps its NaN fill and it stays 0."""
    from collocfem_tpu_torch.ops import _build, smallblocks
    from collocfem_tpu_torch.solve import graph
    from collocfem_tpu_torch.solve.lm_core import LMState
    from torch.utils._pytree import tree_flatten

    f64 = torch.float64
    gen = torch.Generator(device="cpu").manual_seed(5)
    rand = lambda *shape: torch.randn(*shape, generator=gen,
                                      dtype=f64).to(cuda_device)
    D, E, G = random_chain(12, 6, 1, seed=3, dtype=f64, device=cuda_device)
    A, B, R, row = rand(64, 64), rand(64, 8), rand(30, 6, 2), rand(1, 8)
    M = rand(30, 6, 6)
    M = M @ M.transpose(1, 2) + 6 * torch.eye(6, dtype=f64,
                                               device=cuda_device)
    H = torch.zeros(5, 8, dtype=f64, device=cuda_device)
    idx = torch.arange(2, 3, device=cuda_device)

    def body():
        return (spike.blocktri_solve_spike_fused(D, E, G), A @ B,
                smallblocks.spd_solve(M, R), torch.linalg.cholesky_ex(M).L,
                H.index_copy(0, idx, row))

    want = body()
    outs = [torch.empty_like(w) for w in want]
    it = torch.zeros((), dtype=torch.int64, device=cuda_device)
    done = torch.zeros((), dtype=torch.bool, device=cuda_device)

    def step():
        for o, v in zip(outs, body()):
            o.copy_(v)
        it.add_(1)

    plan = graph._Plan(*tree_flatten((D,)), capture=True)
    run = plan.loop(step, LMState(None, None, None, None, None, it, done,
                                  None, None), 1)
    for skip in (False, True):
        for o in outs:
            o.fill_(float("nan"))
        it.zero_()
        done.fill_(skip)
        n0 = spike.blocktri_solve_spike_fused.launches
        run()
        torch.cuda.synchronize()
        _build.settle()
        assert int(it) == (0 if skip else 1)
        assert spike.blocktri_solve_spike_fused.launches == n0 + (not skip)
        if skip:
            assert all(bool(torch.isnan(o).all()) for o in outs)
        else:
            assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.cuda
def test_a_failing_loop_capture_raises(cuda_device):
    """A converging solve whose step reads a value back to the host cannot
    be captured into the loop graph: the call raises, runs nothing eagerly
    in its place, keeps no plan and leaves the launch counts as they
    were."""
    from collocfem_tpu_torch.ops import _build
    from collocfem_tpu_torch.solve.graph import CapturedSolve
    from collocfem_tpu_torch.solve.lm_core import lm_constants, lm_init

    eager_calls = []
    consts = lm_constants(1e-3, maxiter=3, dtype=torch.float64,
                          device=cuda_device)

    def prelude(x):
        return lm_init((x,), (), x.sum(), consts)

    def step(st, x):
        return st._replace(z=(st.z[0] * st.z[0].sum().item(),))

    solve = CapturedSolve(prelude, step, lambda st: st.z,
                          lambda x: eager_calls.append(x), maxiter=3,
                          early_exit=True)
    before = _build.snapshot()
    with pytest.raises(RuntimeError):
        solve(torch.ones(3, dtype=torch.float64, device=cuda_device))
    torch.cuda.synchronize()
    assert not eager_calls and not solve._plans
    assert _build.snapshot() == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", EDGES + [2498, 4998])
def test_chain_kernel_at_r19_matches_plain(cuda_device, k):
    """Kernel #2 at (8, 19), the sharded solve's interior [G | U | V] (K =
    2,498 and 4,998: the headline's shard interiors at sp = 4 and 2), with
    kernel #2's bars: float64 1e-9 relative, float32 residual at most 10x
    the plain version's."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain(k, 8, 19, seed=k + 19, dtype=dtype,
                               device=cuda_device)
        shapes = dict(spike.blocktri_solve_spike_fused.shapes)
        got = spike.blocktri_solve_spike_fused(D, E, G)
        torch.cuda.synchronize()
        assert spike.blocktri_solve_spike_fused.shapes[(8, 19)] == \
            shapes.get((8, 19), 0) + 1
        want = spike.blocktri_solve_spike_fused_ref(D, E, G)
        if dtype == torch.float64:
            assert rel_err(got, want) <= 1e-9
        else:
            assert chain_residual(D, E, G, got) <= \
                10 * chain_residual(D, E, G, want)


@pytest.mark.cuda
def test_sp_solve_on_the_card_matches_one_rank(cuda_device, tmp_path):
    """A 2-rank gloo world sharing the card runs make_sp_gn_solver's eager
    loop on the headline problem at N = 511 (K = 512) in float64, 10
    fixed-work LM iterations: both ranks give the same bits, p within 1e-8
    of the single-rank make_gn_solver's, and each rank launches kernel #2
    once at (8, 19) and once at (8, 3) per iteration, the peer all-reduce
    9 times per iteration and 3 times around the loop (parallel.peer), and
    no plain version."""
    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_gn_solver)
    from collocfem_tpu_torch.testing import (bit_equal, estimation_inputs,
                                             run_world, sp_gn_case)

    spec = dict(kind="headline", elements=511)
    opts = dict(maxiter=10, gtol=0.0, lam0=3e-6, lam_max=1e30)
    ranks = run_world(2, [("sp", sp_gn_case,
                           dict(mesh=(1, 2), spec=spec, options=opts,
                                dtype=torch.float64, mode="eager"))],
                      tmp_path, device="cuda")
    prob, z0, data = estimation_inputs(spec, dtype=torch.float64,
                                       device=cuda_device)
    z_ref, _ = make_gn_solver(prob, SolverOptions(**opts))(z0, data)
    outs = [r["sp"] for r in ranks]
    assert bit_equal(outs[0]["out"], outs[1]["out"])
    z, _ = outs[0]["out"]
    assert float((z["p"] - z_ref.p.cpu()).abs().max()) <= 1e-8
    for r in outs:
        counts = dict(r["counts"])
        assert counts.pop("peer_reduce")[0] == 3 + 9 * 10
        assert counts == {"blocktri_solve_spike_fused":
                          (20, {(8, 19): 10, (8, 3): 10})}


# ---- the sharded solves captured (parallel/; collectives: parallel.peer) ----


@pytest.fixture(scope="module")
def card_world(tmp_path_factory):
    """One world of 4 gloo ranks sharing the card (testing.run_world), whose
    cases every test below reads: the peer kernel against its plain
    version (with a payload past one slot's CAPACITY, which goes in
    chunks), the collectives against numpy, make_sp_gn_solver on the
    headline at N = 511 and make_multi_experiment_solver on config 5 at 8
    experiments (soa) to gtol 1e-10 over 4 ranks, each captured between
    two .eager runs (testing.captured_case), a grid's buffers released and
    set up anew (testing.release_case), and last a rank that stalls
    (testing.stalled_rank_case, a 2 s bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    from collocfem_tpu_torch import testing

    f64 = torch.float64
    converging = dict(maxiter=60, gtol=1e-10, xtol=1e-12)
    cases = [
        ("peer", testing.peer_case, dict(mesh=(1, 4), seed=3,
                                         sizes=PEER_SIZES, reps=3)),
        ("collectives", testing.collective_case,
         dict(mesh=(2, 2), seed=7, sizes=(1, 1216))),
        ("sp", testing.captured_case, dict(
            kind="sp", mesh=(1, 4), spec=dict(kind="headline", elements=511),
            options=converging, dtype=f64)),
        ("dp", testing.captured_case, dict(
            kind="dp", mesh=(4, 1), spec=dict(kind="config5", n_exp=8,
                                              elements=10),
            options=dict(converging, lam0=1e-6, lam_max=1e30),
            layout="soa", dtype=f64)),
        ("released", testing.release_case, dict(mesh=(2, 2))),
        ("stalled", testing.stalled_rank_case, dict(mesh=(1, 4),
                                                    timeout_s=2.0)),
    ]
    return testing.run_world(4, cases, tmp_path_factory.mktemp("card"),
                             device="cuda")


PEER_SIZES = (1, 1216, 40000)   # one element, the SPIKE gather, two chunks


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n", PEER_SIZES)
def test_peer_kernel_matches_plain_in_a_world_on_the_card(card_world, op, n):
    """The peer all-reduce's kernel against its plain version (the exact
    gather through gloo, then the rank-ordered accumulation) at P = 4 ranks
    sharing the card, seeded float64 payloads: bit for bit on every rank,
    at 1 element, at the SPIKE interface gather's size and at 40,000
    doubles (two launches: a slot holds CAPACITY)."""
    for rank in card_world:
        assert rank["peer"][(op, n)]["same"]
        assert rank["peer"]["launches"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["sp", "dp"])
def test_collectives_on_the_card_are_rank_ordered(card_world, group):
    """meshes.all_sum / all_max / gather on the card over each group of 2
    of a 2 x 2 grid: float64 and float32 payloads, every rank's result
    numpy's accumulation in rank order (in float64, cast to the input's
    dtype) bit for bit, the gather the payloads in rank order."""
    import numpy as np

    from collocfem_tpu_torch.testing import bit_equal

    for rank in card_world:
        res = rank["collectives"][group]
        for n in (1, 1216):
            raw = [np.random.default_rng(7 + r).standard_normal(n)
                   for r in range(2)]
            for dtype in ("float64", "float32"):
                xs = [x.astype(dtype).astype(np.float64) for x in raw]
                want = {"sum": xs[0] + xs[1], "max": np.maximum(*xs)}
                for op, acc in want.items():
                    assert bit_equal(res[(op, dtype, n)], torch.as_tensor(
                        acc).to(getattr(torch, dtype)))
            assert bit_equal(res[("gather", "float64", n)],
                             torch.as_tensor(np.stack(raw)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sp", "dp"])
def test_converging_solve_on_four_ranks_runs_under_the_while_node(
        card_world, kind):
    """make_sp_gn_solver (headline, N = 511) and the dp soa solver (config
    5, 8 experiments) to gtol 1e-10 on 4 ranks sharing the card, run as
    .eager, the first captured call, a replay and .eager again on the same
    groups (the peer kernel's epochs run on through all four): the
    captured calls read nothing to the host (the WHILE node decides the
    exit), and every run gives the first call's bits, iterations and
    launches on every rank, the ranks the same bits."""
    from collocfem_tpu_torch.testing import bit_equal

    want = card_world[0][kind]["runs"]["first call"]["out"]
    its = int(want[1]["iterations"])
    assert 0 < its < 60 and bool(want[1]["converged"])
    for rank in card_world:
        runs = rank[kind]["runs"]
        assert runs["first call"]["host_reads"] == 0
        assert runs["captured"]["host_reads"] == 0
        for run in runs.values():
            assert bit_equal(run["out"], want)
            assert run["counts"] == runs["first call"]["counts"]
        assert runs["first call"]["counts"]["peer_reduce"][0] > its


@pytest.mark.cuda
def test_a_stalled_rank_makes_the_others_raise_not_hang(card_world):
    """A rank that never makes its call: the other three wait at most the
    2 s bound, get NaN and raise from parallel.peer.check of the sp group;
    the check of the mesh's other group, which made no call, does not."""
    for rank in card_world[:-1]:
        res = rank["stalled"]
        assert res["raised"] is not None and "waited more than" in \
            res["raised"]
        assert res["nan"]
        assert not res["other group raised"]
        assert res["wall"] < 60.0
    assert card_world[-1]["stalled"] == {"skipped": True}


@pytest.mark.cuda
def test_released_peer_buffers_are_set_up_anew(card_world):
    """parallel.peer.release frees a 2 x 2 grid's buffers and mappings on
    every rank and drops the groups' entries; the next all_sum sets them
    up again and gives the same bits as before the release."""
    for rank in card_world:
        assert rank["released"] == {"same": True, "gone": True}


# ---- an NCCL world of one (parallel/; collectives: parallel.peer at P = 1) --


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    """An NCCL world of one in this process (NCCL takes one rank a card):
    the default group, its peer buffers released and the group destroyed
    after the module's tests."""
    import torch.distributed as dist

    from collocfem_tpu_torch.parallel import peer

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL)")
    wd = tmp_path_factory.mktemp("nccl")
    dist.init_process_group("nccl", init_method=f"file://{wd}/init",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    peer.release()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_probe_body_captured_in_an_nccl_world_of_one(nccl_world):
    """tools/nccl_graph_probe.py's body (kernel #2, an all_sum, a halo and
    a done flag all-reduced by all_max) captured into one graph replayed
    step by step, and as the loop graph's WHILE body, on an NCCL world of
    one: both give the eager buffers bit for bit and the loop stops where
    the flag sets done.  The collectives are the peer kernel at P = 1:
    the step graph's only nodes besides kernels are the body's
    device-to-device copies (cudaGraphNodeType 1, kind 3).  Several ranks
    under the WHILE node: card_world's tests and the probe with --ranks
    4."""
    from collocfem_tpu_torch.tools.nccl_graph_probe import probe

    report = probe(nccl_world, torch.device("cuda"))
    assert report["fixed"] == "ok", report
    assert report["loop"] == "ok", report
    assert report["non_kernel_nodes"], report
    assert all(": type 1 memcpy kind 3 " in line
               for line in report["non_kernel_nodes"]), report


def _sp_solver(options, device, elements=511):
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.sharded import make_sp_gn_solver
    from collocfem_tpu_torch.solve.newton import SolverOptions
    from collocfem_tpu_torch.testing import estimation_inputs

    prob, z0, data = estimation_inputs(
        dict(kind="headline", elements=elements), dtype=torch.float64,
        device=device)
    return prob, make_sp_gn_solver(
        prob, make_device_mesh(1, 1, device=device),
        SolverOptions(**options)), (z0, data)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fixed", "converging", "irls"])
def test_captured_sp_solve_matches_eager_on_nccl(cuda_device, nccl_world,
                                                 case):
    """make_sp_gn_solver on an NCCL world of one, the headline at N = 511,
    float64: 10 fixed-work iterations, a solve to gtol 1e-10 and IRLS over
    it (2 rounds, the reweighting eager): the first call and a replay equal
    solve.eager bit for bit with the same launches (kernel #2 at (8, 19)
    and (8, 3) once each a step) and read nothing to the host (with a
    tolerance the steps run under the WHILE node, as on several
    ranks)."""
    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_irls_solver)

    opts = {"fixed": dict(maxiter=10, gtol=0.0, lam0=3e-6, lam_max=1e30),
            "converging": dict(maxiter=60, gtol=1e-10, xtol=1e-12),
            "irls": dict(maxiter=40, gtol=1e-9, xtol=1e-12,
                         irls_delta=2.0)}[case]
    prob, solve, args = _sp_solver(opts, cuda_device)
    if case == "irls":
        solve = make_irls_solver(prob, SolverOptions(**opts), 2,
                                 inner_solver=solve)
    out, reads = _reads_and_hold(solve, *args)
    rounds = out[1] if case == "irls" else (out[1],)
    assert reads == [0, 0]
    its = sum(int(st.iterations) for st in rounds)
    assert its == 10 if case == "fixed" else 0 < its
    if case == "converging":
        assert bool(out[1].converged) and its < 60


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["soa", "blocks", "dp x sp"])
@pytest.mark.parametrize("tol", ["fixed", "converging"])
def test_captured_dp_solve_matches_eager_on_nccl(cuda_device, nccl_world,
                                                 layout, tol):
    """make_multi_experiment_solver with dp_axis an NCCL group of one,
    config 5 at 8 experiments x 10 elements, float64, in each layout and
    as dp x sp (the blocks layout through spike_chain_solver over the sp
    group of one), at 15 fixed-work iterations and to gtol 1e-10: the
    first call and a replay equal solve.eager bit for bit with the same
    launches and read nothing to the host."""
    from collocfem_tpu_torch.batched import build_config5_problem
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.batch import \
        make_multi_experiment_solver
    from collocfem_tpu_torch.parallel.spike import spike_chain_solver
    from collocfem_tpu_torch.solve.newton import SolverOptions

    opts = (dict(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30)
            if tol == "fixed" else dict(maxiter=60, gtol=1e-10, xtol=1e-12,
                                        lam0=1e-6, lam_max=1e30))
    prob, z0, data, p_prior, p_w = build_config5_problem(
        8, 10, dtype=torch.float64, device=cuda_device)
    dm = make_device_mesh(1, 1, device=cuda_device)
    chain = (spike_chain_solver(prob.mesh.num_blocks, 1, group=dm.sp_group)
             if layout == "dp x sp" else None)
    solve = make_multi_experiment_solver(
        prob, SolverOptions(**opts), dp_axis=dm.dp_group, chain_solver=chain,
        layout="soa" if layout == "soa" else "blocks")
    assert solve.refused is None
    out, reads = _reads_and_hold(solve, z0, data, p_prior, p_w)
    assert reads == [0, 0]
    its = int(out[1].iterations)
    assert its == 15 if tol == "fixed" else 0 < its < 60


# ---- the Kalman tier's captured scans (kalman/scan.py) ------------------------


def _kalman_scans(device, T=30):
    """{name: (Scan, (carry0, xs, consts), reverse)} for every filter and
    smoother of the Kalman tier on seeded inputs: the linear and
    square-root filters and their smoothers (reverse scans) on a damped
    oscillator, the EKF and UKF on examples/pem_kalman.py's Duffing model
    with 2 RK4 substeps."""
    import numpy as np

    from collocfem_tpu_torch.kalman import filtering as kf
    from collocfem_tpu_torch.kalman import sqrt as ks
    from collocfem_tpu_torch.kalman.disc import discretize_lti
    from collocfem_tpu_torch.kalman.scan import Scan
    from collocfem_tpu_torch.models import Duffing

    rng = np.random.default_rng(21)
    f64 = dict(dtype=torch.float64, device=device)
    ts = np.cumsum(0.05 + 0.1 * rng.random(T))
    A = torch.tensor([[0.0, 1.0], [-4.0, -0.4]], **f64)
    Qc = torch.tensor([[0.0, 0.0], [0.0, 0.15**2]], **f64)
    Ad, Qd = discretize_lti(A, Qc, np.diff(ts, prepend=ts[:1]))
    H, R = np.array([[1.0, 0.0]]), np.array([[0.05**2]])
    y = np.cos(2.0 * ts)[:, None] + 0.05 * rng.standard_normal((T, 1))
    mask = (np.arange(T) % 4 != 1).astype(float)
    lin = (Ad, Qd, H, R, y, [0.8, 0.2], 4.0 * np.eye(2), mask, device)
    model = Duffing(gamma=8.0, omega=0.5)
    nl = (model, [0.5, 1.0, 0.5], ts, y, [[1e-4]], np.diag([1e-8, 0.05**2]),
          [y[0, 0], 0.0], np.diag([0.1, 4.0]), None, mask)
    res = kf.kalman_filter(*lin[:7], mask=mask, device=device)
    sq = ks.sqrt_kalman_filter(*lin[:7], mask=mask, device=device)
    return {
        "kf": (Scan(kf._kf_step), kf._kf_inputs(*lin), False),
        "rts": (Scan(kf._smoother_step), kf._smoother_inputs(res), True),
        "sqrt kf": (Scan(ks._sqrt_kf_step), ks._sqrt_kf_inputs(*lin), False),
        "sqrt rts": (Scan(ks._sqrt_smoother_step),
                     ks._sqrt_smoother_inputs(sq, Ad, Qd), True),
        "ekf": (Scan(kf._ekf_step(model, 2)),
                kf._ekf_inputs(*nl, device), False),
        "ukf": (Scan(kf._ukf_step(model, 2, kf._ut_lambda(2, 1.0, 0.0))),
                kf._ukf_inputs(*nl, 1.0, 2.0, 0.0, device), False),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kf", "rts", "sqrt kf", "sqrt rts", "ekf",
                                  "ukf"])
def test_captured_kalman_scan_matches_uncaptured(cuda_device, name):
    """Each filter and smoother: the captured scan (its forward graph
    replayed T times, its backward graph T times) equals the same step
    bodies run uncaptured, bit for bit, in every output and in the gradient
    of a weighted sum of them with respect to every input."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from collocfem_tpu_torch.testing import bit_equal

    scan, args, reverse = _kalman_scans(cuda_device)[name]
    leaves, spec = tree_flatten(args)

    def run(fn):
        xs = [x.detach().clone().requires_grad_(True) for x in leaves]
        out = fn(*tree_unflatten(xs, spec), reverse=reverse)
        outs = tree_flatten(out)[0]
        loss = sum((o * (1.0 + 0.1 * i)).sum() for i, o in enumerate(outs))
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        return [o.detach() for o in outs], [g for g in grads
                                            if g is not None]

    got, want = run(scan), run(scan.eager)
    torch.cuda.synchronize()
    assert bit_equal(got, want) and got[1]
    assert all(bool(torch.isfinite(o).all()) for o in got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lti", "ekf", "ukf"])
def test_captured_nll_captures_once_per_key(cuda_device, kind, monkeypatch):
    """A likelihood captures its forward and backward graphs at its first
    evaluation and replays them at every later one (new p, no new graph);
    each captured value and gradient equals the uncaptured scan's bit for
    bit and the tape-recording loop's within 1e-12."""
    import numpy as np

    from collocfem_tpu_torch import kalman
    from collocfem_tpu_torch.models import Duffing

    graphs = []

    class Counted(torch.cuda.CUDAGraph):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            graphs.append(self)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Counted)
    rng = np.random.default_rng(22)
    ts = np.linspace(0.05, 2.0, 30)
    y = np.cos(1.3 * ts)[:, None] + 0.01 * rng.standard_normal((30, 1))
    if kind == "lti":
        def build(p):
            z, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
            A = torch.stack([torch.stack([z, one]), torch.stack([-p[0],
                                                                -p[1]])])
            f = lambda m: torch.as_tensor(m, dtype=p.dtype, device=p.device)
            return (A, f([[0.0, 0.0], [0.0, 0.02]]), f([[1.0, 0.0]]),
                    f([[1e-4]]), f([y[0, 0], 0.0]), f(np.eye(2)))
        nll, p0 = kalman.make_lti_nll(build, ts, y, device=cuda_device), \
            [3.0, 1.0]
    else:
        make = getattr(kalman, f"make_{kind}_nll")
        nll = make(Duffing(gamma=8.0, omega=0.5), ts, y, [[1e-4]],
                   np.diag([1e-8, 0.05**2]), [y[0, 0], 0.0],
                   np.diag([0.1, 4.0]), substeps=2, device=cuda_device)
        p0 = [0.5, 1.0, 0.5]

    def value_and_grad(fn, p):
        x = torch.tensor(p, dtype=torch.float64, device=cuda_device,
                         requires_grad=True)
        v = fn(x)
        return v.detach(), torch.autograd.grad(v, x)[0]

    for p in (p0, [1.1 * v for v in p0], [0.9 * v for v in p0]):
        v, g = value_and_grad(nll, p)
        assert len(graphs) == 2
        ev, eg = value_and_grad(nll.eager, p)
        pv, pg = value_and_grad(nll.plain, p)
        torch.cuda.synchronize()
        assert torch.equal(v, ev) and torch.equal(g, eg)
        assert float((v - pv).abs()) <= 1e-12 * float(pv.abs())
        assert float((g - pg).abs().max()) <= 1e-12 * float(pg.abs().max())
    # One captured plan and the uncaptured one.
    assert sorted(key[0] for key in nll.scan._plans) == [False, True]


@pytest.mark.cuda
def test_a_failing_scan_capture_raises(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    scan raises, keeps no plan, and runs no loop in its place."""
    from collocfem_tpu_torch.kalman.scan import Scan

    def step(carry, x, consts):
        return (carry[0] * x[0].item(),), carry[0].sum()

    s = Scan(step)
    xs = (torch.arange(1.0, 5.0, dtype=torch.float64, device=cuda_device),)
    c0 = (torch.ones(2, dtype=torch.float64, device=cuda_device),)
    with pytest.raises(RuntimeError):
        s(c0, xs)
    torch.cuda.synchronize()
    assert not s._plans
    (c, ), ys = s.eager(c0, xs)
    assert c.tolist() == [24.0, 24.0] and ys.tolist() == [2.0, 2.0, 4.0,
                                                          12.0]


@pytest.mark.cuda
def test_device_marks_in_the_captured_loop(cuda_device):
    """make_gn_solver on the headline at N = 40 to gtol (the WHILE-node loop
    graph).  Marks off: a graph capture is counted at the first call and
    nothing at the second, and a recording leaves a later plan's node
    counts as they were.  Marks on: a second, marked plan whose step graph
    holds exactly 6 nodes more (lm.step, kkt, assemble: a begin and an end
    mark each), results bit for bit the unmarked plan's, one decoded
    ``lm.step`` per iteration, every device span of the call tied to its
    ``solve`` span and inside its call-to-synchronize wall, a calibration
    good to 50 us, and a later recording that decodes the marked plan."""
    import time

    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.testing import bit_equal
    from collocfem_tpu_torch.utils import profiling

    prob, data, z0 = headline_problem(40, dtype=torch.float64,
                                      device=cuda_device)
    opts = SolverOptions(**CAPTURED_CASES["early exit"])
    solve = make_gn_solver(prob, opts)
    c0 = profiling.counters()
    plain = solve(z0, data)
    torch.cuda.synchronize()
    c1 = profiling.counters()
    solve(z0, data)
    torch.cuda.synchronize()
    assert profiling.counters() == c1
    assert c1["graph_captures"] > c0["graph_captures"]
    with profiling.recording(device_marks=True) as rec:
        marked = solve(z0, data)
        torch.cuda.synchronize()
        rec.clear()
        t0 = time.perf_counter_ns()
        again = solve(z0, data)
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    assert bit_equal(marked, plain) and bit_equal(again, plain)
    unmarked, with_marks = solve._plans.values()
    assert with_marks.loop_nodes["step"] == unmarked.loop_nodes["step"] + 6
    assert with_marks.loop_nodes["after"] == unmarked.loop_nodes["after"]
    fresh = make_gn_solver(prob, opts)
    fresh(z0, data)
    assert next(iter(fresh._plans.values())).loop_nodes == \
        unmarked.loop_nodes
    unc = max(rec.clock[k]["uncertainty_ns"] for k in ("start", "end"))
    assert 0 < unc < 50_000 and rec.clock["dropped"] == 0
    call, = [s for s in rec.spans if s.name == "solve"]
    dev = [s for s in rec.spans if s.device]
    assert dev and all(s.solve == call.id for s in dev)
    assert all(t0 - unc <= s.start <= s.end <= t1 + unc for s in dev)
    steps = [s for s in dev if s.name == "lm.step"]
    assert len(steps) == int(plain[1].iterations)
    assert all(s.parent == call.id for s in steps)
    # A later recording replays the marked plan and reads its names.
    with profiling.recording(device_marks=True) as later:
        solve(z0, data)
    assert len(solve._plans) == 2
    assert sum(s.name == "lm.step" for s in later.spans) == len(steps)


@pytest.mark.cuda
def test_an_overfull_device_log_counts_its_drops(cuda_device):
    """Marks past the log's capacity are counted as dropped (in the
    recording's clock and the ``marks_dropped`` counter), not written."""
    from collocfem_tpu_torch.utils import profiling

    before = profiling.counters()["marks_dropped"]
    with profiling.recording(device_marks=True) as rec:
        for _ in range(profiling.MARK_CAPACITY // 2 + 3):
            with profiling.device_span("kkt", cuda_device):
                pass
    assert rec.clock["dropped"] == 6
    assert profiling.counters()["marks_dropped"] == before + 6
    assert sum(s.device for s in rec.spans) == profiling.MARK_CAPACITY // 2


# ---- the GN element kernel (ops/gn_elements.py, csrc/gn_elements.cu) --------


def _gn_case(n, dtype, device):
    """The headline's problem at N elements with priors on p and x(t0) and
    an iterate off the data's guess (seeded)."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.problem import Decision

    prob, data, z0 = headline_problem(n, dtype=dtype, device=device)
    g = torch.Generator().manual_seed(n)
    noise = 0.1 * torch.randn(z0.V.shape, generator=g, dtype=torch.float64)
    z = Decision(V=z0.V + noise.to(device, dtype), p=z0.p + 0.3)
    data = data._replace(
        p_w=torch.tensor([0.3, 0.2], dtype=dtype, device=device),
        x0_w=torch.tensor([0.7, 0.4], dtype=dtype, device=device),
        x0_prior=torch.tensor([1.0, 0.1], dtype=dtype, device=device))
    return prob, z, data


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 40, 10_000, 100_000])
def test_gn_kernel_matches_plain(cuda_device, n, dtype):
    """The kernel against its plain version on the same node values, at
    the n10k cell's shape and the ladder's fine shape (and N = 1, 40):
    every leaf within 1e-12 (float64) or 5e-5 (float32) of the leaf's
    largest entry, the float64 cost within 1e-12 / 1e-6 of it; a second
    launch equal bit for bit; assemble_gn_soa takes the kernel's path."""
    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.testing import bit_equal
    from collocfem_tpu_torch.utils import profiling

    prob, z, data = _gn_case(n, dtype, cuda_device)
    assert ge.engages(prob, z, data)
    vals = ge.node_values(prob, z, data)
    launches = ge.gn_system.launches
    got = ge.gn_system(prob, z, data, vals)
    again = ge.gn_system(prob, z, data, vals)
    torch.cuda.synchronize()
    assert ge.gn_system.launches == launches + 2
    assert bit_equal(got, again)
    sys_, cost = got
    want, want_cost = ge.gn_system_ref(prob, z, data, vals)
    tol = 1e-12 if dtype == torch.float64 else 5e-5
    for name in ("D", "E", "B", "C", "gx", "gp"):
        g, w = getattr(sys_, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= tol, (name, err)
    assert cost.dtype == torch.float64
    assert abs(float(cost - want_cost)) <= \
        (1e-12 if dtype == torch.float64 else 1e-6) * float(want_cost)
    before = profiling.counters()
    assert bit_equal(assemble_gn_soa(prob, z, data, with_cost=True), got)
    after = profiling.counters()
    assert after["assembly_fused"] == before["assembly_fused"] + 1
    assert after["assembly_generic"] == before["assembly_generic"]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["interior", "full"])
def test_gn_kernel_per_sample_weights_and_full_x0(cuda_device, rule):
    """The IRLS form of meas_w (N, S, ny) and a full x0 sqrt-information
    matrix, on both defect rules: the kernel within 1e-12 of its plain
    version (float64)."""
    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.ops.mesh import uniform_mesh
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.problem import Decision, EstimationProblem

    n, f64 = 300, torch.float64
    g = torch.Generator().manual_seed(7)
    t = torch.sort(torch.rand(3 * n, generator=g, dtype=f64) * 6.0).values
    prob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, 6.0, n, 4),
                                   t.numpy(), defect_weight=30.0,
                                   device=cuda_device, dtype=f64,
                                   defect_rule=rule)
    y = torch.randn(t.numel(), 1, generator=g, dtype=f64).numpy()
    data = prob.pack_data(y, t.numpy(), p_weight=0.2, x0_weight=[[0.5, 0.0],
                                                                 [0.2, 0.3]])
    w = torch.rand(*prob.mmask.shape, 1, generator=g, dtype=f64) + 0.5
    data = data._replace(meas_w=w.to(cuda_device))
    z = Decision(V=torch.randn(prob.num_nodes, 2, generator=g,
                               dtype=f64).to(cuda_device),
                 p=torch.tensor([0.8, 1.2], dtype=f64, device=cuda_device))
    assert ge.engages(prob, z, data)
    vals = ge.node_values(prob, z, data)
    (sys_, cost), (want, want_cost) = (ge.gn_system(prob, z, data, vals),
                                       ge.gn_system_ref(prob, z, data, vals))
    for name in ("D", "E", "B", "C", "gx", "gp"):
        g_, w_ = getattr(sys_, name), getattr(want, name)
        assert float((g_ - w_).abs().max() / w_.abs().max()) <= 1e-12, name
    assert abs(float(cost - want_cost)) <= 1e-12 * float(want_cost)


@pytest.mark.cuda
def test_gn_kernel_captured_equals_eager(cuda_device):
    """assemble_gn_soa on the kernel's path captured in a CUDA graph: each
    replay equals the eager call bit for bit, and again after the iterate
    changes in place."""
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.testing import bit_equal

    prob, z, data = _gn_case(10_000, torch.float64, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assemble_gn_soa(prob, z, data, with_cost=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = assemble_gn_soa(prob, z, data, with_cost=True)
    for shift in (0.0, 0.01):
        z.V.add_(shift)
        graph.replay()
        torch.cuda.synchronize()
        assert bit_equal(out, assemble_gn_soa(prob, z, data, with_cost=True))


@pytest.mark.cuda
def test_gn_kernel_shrinks_the_loop_graph(cuda_device, monkeypatch):
    """make_gn_solver on the headline at N = 40 to gtol: the loop graph's
    step holds fewer nodes on the kernel's path than forced onto the
    element-level path, both solves counted on their own path, and land on
    the same p (float64, relative difference <= 1e-9)."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
    from collocfem_tpu_torch.utils import profiling

    prob, data, z0 = headline_problem(40, dtype=torch.float64,
                                      device=cuda_device)
    opts = SolverOptions(**CAPTURED_CASES["early exit"])
    runs = {}
    for path in ("fused", "generic"):
        if path == "generic":
            monkeypatch.setattr(ge, "engages", lambda *args: False)
        solve = make_gn_solver(prob, opts)
        before = profiling.counters()
        z, _ = solve(z0, data)
        torch.cuda.synchronize()
        after = profiling.counters()
        moved = {k: after[f"assembly_{k}"] - before[f"assembly_{k}"]
                 for k in ("fused", "generic")}
        other = "generic" if path == "fused" else "fused"
        assert moved[path] > 0 and moved[other] == 0
        plan, = solve._plans.values()
        runs[path] = (plan.loop_nodes["step"], z.p.cpu())
    print(f"loop step nodes: fused {runs['fused'][0]}, generic "
          f"{runs['generic'][0]}")
    assert runs["fused"][0] < runs["generic"][0]
    assert rel_err(runs["fused"][1], runs["generic"][1]) <= 1e-9


@pytest.mark.cuda
def test_gn_kernel_rejects_what_it_does_not_take(cuda_device):
    """ValueError before any launch: a shape outside the kernel's range (nq
    = 0), a node value of the wrong shape, and CPU tensors."""
    from collocfem_tpu_torch.models import Pendulum
    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.ops.mesh import uniform_mesh
    from collocfem_tpu_torch.problem import Decision, EstimationProblem

    launches = ge.gn_system.launches
    mesh = uniform_mesh(0.0, 2.0, 6, 4)
    t = torch.linspace(0.05, 1.95, 12, dtype=torch.float64).numpy()
    pend = EstimationProblem.build(Pendulum(), mesh, t, device=cuda_device,
                                   dtype=torch.float64)
    pdata = pend.pack_data(torch.zeros(12, pend.model.ny).numpy(), t)
    pz = Decision(V=torch.zeros(mesh.num_nodes, 2, dtype=torch.float64,
                                device=cuda_device),
                  p=torch.zeros(0, dtype=torch.float64, device=cuda_device))
    assert not ge.engages(pend, pz, pdata)
    with pytest.raises(ValueError, match="GN element kernel takes"):
        ge.gn_system(pend, pz, pdata, ge.node_values(pend, pz, pdata))
    prob, z, data = _gn_case(40, torch.float64, cuda_device)
    vals = ge.node_values(prob, z, data)
    with pytest.raises(ValueError, match="fx has shape"):
        ge.gn_system(prob, z, data, vals._replace(fx=vals.fx[:, :3]))
    cpu = lambda x: x.cpu()
    with pytest.raises(ValueError, match="no kernel for tensors on cpu"):
        ge.gn_system(prob.to("cpu"), type(z)(*map(cpu, z)),
                     type(data)(*map(cpu, data)),
                     type(vals)(*map(cpu, vals)))
    torch.cuda.synchronize()
    assert ge.gn_system.launches == launches


@pytest.mark.cuda
def test_gn_kernel_on_a_model_with_float64_derivatives(cuda_device):
    """Config 4's aircraft in float32, whose h under jacfwd gives float64
    derivatives: assemble_gn_soa takes the kernel's path (the node values
    come in float32) and matches the plain version within 5e-5 of each
    leaf's largest entry."""
    from collocfem_tpu_torch import configs
    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa

    prob, z, data = configs.build_config4_problem(dtype=torch.float32,
                                                  device=cuda_device)
    assert ge.engages(prob, z, data)
    launches = ge.gn_system.launches
    sys_, cost = assemble_gn_soa(prob, z, data, with_cost=True)
    torch.cuda.synchronize()
    assert ge.gn_system.launches == launches + 1
    want, want_cost = ge.gn_system_ref(prob, z, data,
                                       ge.node_values(prob, z, data))
    for name in ("D", "E", "B", "C", "gx", "gp"):
        g, w = getattr(sys_, name), getattr(want, name)
        assert g.dtype == torch.float32, name
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-5, name
    assert abs(float(cost - want_cost)) <= 1e-6 * float(want_cost)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["headline", "full_per_sample"])
def test_gn_kernel_matches_the_jax_package(cuda_device, case):
    """assemble_gn_soa on the kernel's path against the JAX package's
    assembly of the same inputs, stored by tests/test_torch_assemble.py
    (the headline at N = 40 with a shared meas_w and per-state x0 weights;
    the 'full' rule with a per-sample meas_w and a full x0 matrix): every
    leaf and the cost within rtol 1e-12, with an absolute floor of 1e-12 x
    the leaf's largest entry, as the CPU parity tests hold the
    element-level path."""
    from pathlib import Path

    import numpy as np

    from collocfem_tpu_torch.ops import gn_elements as ge
    from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
    from collocfem_tpu_torch.testing import stored_assembly_case

    path = Path(__file__).parent / "data" / "gn_assembly_jax.npz"
    with np.load(path) as ref:
        (prob, z, data), want = stored_assembly_case(
            ref, case, dtype=torch.float64, device=cuda_device)
    assert ge.engages(prob, z, data)
    launches = ge.gn_system.launches
    sys_, cost = assemble_gn_soa(prob, z, data, with_cost=True)
    torch.cuda.synchronize()
    assert ge.gn_system.launches == launches + 1
    got = {**{name: getattr(sys_, name) for name in sys_._fields},
           "cost": cost}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].cpu().numpy(), w, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(w).max()),
                                   err_msg=name)
