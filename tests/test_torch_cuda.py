"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``cuda`` and skips where there is no GPU (the
kernel has no CPU mode).  The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from collocfem_tpu_torch.ops import spike
from collocfem_tpu_torch.testing import random_kkt_system


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
