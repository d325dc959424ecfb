"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Kernel #1 (fused damped KKT), kernel #2 (SPIKE chain solve) and kernel #7
(batched block Thomas).  Every test here is marked ``cuda`` and skips where
there is no GPU (the kernels have no CPU mode).  The file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from collocfem_tpu_torch.ops import spike, thomas
from collocfem_tpu_torch.testing import (
    batch_residual,
    chain_residual,
    random_chain,
    random_chain_batch,
    random_kkt_system,
)


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
@pytest.mark.parametrize("k", [1, 3, 7, 1000, 10001])
def test_kernel_matches_plain_float64(cuda_device, k, damp_scale):
    """float64: max|dx - dx_ref| / max|dx_ref| <= 1e-9, the same for dp."""
    sys_ = random_kkt_system(k, 8, 2, seed=k, device=cuda_device)
    got, want = _solve_both(sys_, 1e-3, damp_scale)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-9
    assert float(got[2]) == float(want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 10001])
def test_kernel_matches_plain_float32(cuda_device, k):
    """float32 on a well-conditioned chain: relative difference <= 1e-4."""
    sys_ = random_kkt_system(k, 8, 2, seed=k, dtype=torch.float32,
                             device=cuda_device)
    got, want = _solve_both(sys_, 1e-3, None)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    sys_ = random_kkt_system(9, 8, 2, seed=0, device=cuda_device)
    args = (sys_.B, sys_.gx, sys_.C, sys_.gp, 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        spike.kkt_solve_spike_fused(sys_.D.transpose(0, 1), sys_.E, *args)
    with pytest.raises(ValueError, match="not built"):
        small = random_kkt_system(9, 3, 1, seed=0, device=cuda_device)
        spike.kkt_solve_spike_fused(*small[:2], small.B, small.gx, small.C,
                                    small.gp, 1e-3)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 7, 1000, 11264])
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
            assert _rel(got, want) <= 1e-9
        else:
            assert chain_residual(D, E, G, got) <= \
                10 * chain_residual(D, E, G, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 11])
@pytest.mark.parametrize("n_exp", [1, 5, 1000])
def test_thomas_kernel_matches_plain(cuda_device, n_exp, k):
    """Kernel #7 with the same bars as kernel #2."""
    for dtype in (torch.float64, torch.float32):
        D, E, G = random_chain_batch(n_exp, k, 8, 3, seed=n_exp + k,
                                     dtype=dtype, device=cuda_device)
        launches = thomas.batched_thomas_solve.launches
        got = thomas.batched_thomas_solve(D, E, G)
        torch.cuda.synchronize()
        assert thomas.batched_thomas_solve.launches == launches + 1
        want = thomas.batched_thomas_solve_ref(D, E, G)
        if dtype == torch.float64:
            assert _rel(got, want) <= 1e-9
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
    assert _rel(got[0].cpu(), want[0]) <= 1e-9
    if nq:
        assert _rel(got[1].cpu(), want[1]) <= 1e-9


@pytest.mark.cuda
def test_chain_kernels_reject_what_they_do_not_take(cuda_device):
    D, E, G = random_chain(9, 8, 2, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="not built"):
        spike.blocktri_solve_spike_fused(D, E, G)
    with pytest.raises(ValueError, match="contiguous"):
        spike.blocktri_solve_spike_fused(D, E, G[:, :1])
    D, E, G = random_chain_batch(4, 3, 8, 2, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="not built"):
        thomas.batched_thomas_solve(D, E, G)
