"""Port parity, KKT solve: the plain chain solves, the fused kernel's plain
version ``kkt_solve_spike_fused_ref`` and the wrapper's dispatch, against
``collocfem_tpu`` in float64.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.ops import smallblocks_soa as jax_soa
from collocfem_tpu.ops.assemble import BlockTriSystemSoA as JaxSystem
from collocfem_tpu.ops.spike_pallas import (
    kkt_solve_spike_fused as jax_kkt_spike_fused,
)
from collocfem_tpu.solve.blocktri import blocktri_solve_scan as jax_scan
from collocfem_tpu.solve.kkt import solve_kkt_soa as jax_solve_kkt_soa
from collocfem_tpu_torch.ops import smallblocks_soa as soa
from collocfem_tpu_torch.ops import spike
from collocfem_tpu_torch.solve.blocktri import (
    blocktri_cr_factor_soa,
    blocktri_solve_scan,
)
from collocfem_tpu_torch.solve.kkt import resolve_auto_method
from collocfem_tpu_torch.testing import random_kkt_system

def _kkt_arrays(k, b, nq, seed):
    """(D, E, B, gx, C, gp) of a seeded SPD bordered system, as tensors."""
    s = random_kkt_system(k, b, nq, seed)
    return [s.D, s.E, s.B, s.gx, s.C, s.gp]


def _jax(arrays):
    return [jnp.asarray(a.numpy()) for a in arrays]


@pytest.mark.parametrize("k", [1, 5, 16, 37])
def test_cyclic_reduction_matches_scan(k):
    """Plain CR (padded to a power of two) against the block Thomas solve,
    and that against JAX's: rtol 1e-11 (float64, well-conditioned chain)."""
    D, E = _kkt_arrays(k, 4, 1, seed=k)[:2]
    G = torch.as_tensor(np.random.default_rng(k).standard_normal((4, 3, k)))
    x_cr = blocktri_cr_factor_soa(D, E)(G)
    aos = [a.permute(2, 0, 1) for a in (D, E, G)]
    x_scan = blocktri_solve_scan(*aos)
    want = np.asarray(jax_scan(*_jax(aos)))
    np.testing.assert_allclose(x_scan.numpy(), want, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(x_cr.permute(2, 0, 1).numpy(), want,
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("damp_scale", [None, 7.5])
@pytest.mark.parametrize("k", [41, 101])
def test_plain_fused_kkt_matches_jax(k, damp_scale):
    """kkt_solve_spike_fused_ref against JAX solve_kkt_soa(spike=False) at
    b = 8, nq = 2: rtol 1e-10 (float64)."""
    arrays = _kkt_arrays(k, 8, 2, seed=k)
    D, E, B, gx, C, gp = _jax(arrays)
    lam = 1e-3
    want = jax_solve_kkt_soa(JaxSystem(D, E, B, C, gx, gp), lam,
                             damp_scale=damp_scale, with_dmax=True)
    got = spike.kkt_solve_spike_fused_ref(*arrays, lam, damp_scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10 * float(np.abs(w).max()))


def test_plain_fused_kkt_matches_pallas_interpret():
    """The same function against the Pallas kernel itself, run in interpret
    mode at the size of the JAX package's own fast interpret tests (b = 3,
    nq = 1, K = 7, 4 tiles): rtol 1e-10 (float64)."""
    arrays = _kkt_arrays(7, 3, 1, seed=7)
    lam = 1e-2
    want = jax_kkt_spike_fused(*_jax(arrays), lam, tiles=4, interpret=True)
    got = spike.kkt_solve_spike_fused_ref(*arrays, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10 * float(np.abs(w).max()))


def test_plain_fused_kkt_matches_pallas_interpret_at_block_size_2():
    """The same at b = 2, nq = 1 (K = 7, 2 tiles), where the card's lane
    group is 2 lanes: rtol 1e-10 (float64)."""
    arrays = _kkt_arrays(7, 2, 1, seed=2)
    want = jax_kkt_spike_fused(*_jax(arrays), 1e-2, tiles=2, interpret=True)
    got = spike.kkt_solve_spike_fused_ref(*arrays, 1e-2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10 * float(np.abs(w).max()))


@pytest.mark.parametrize("b,nq,k", [(2, 2, 33), (4, 2, 41), (9, 1, 17),
                                    (16, 1, 21)])
def test_plain_fused_kkt_matches_jax_at_other_block_sizes(b, nq, k):
    """kkt_solve_spike_fused_ref against JAX solve_kkt_soa(spike=False) at
    the block sizes the card now runs (b = 4: degree-2 Van der Pol; b = 9:
    the free-time OCP at degree 3; b = 16, the split actuator's), where the
    Pallas kernel's interpret mode takes minutes: rtol 1e-10 (float64)."""
    arrays = _kkt_arrays(k, b, nq, seed=k + b)
    D, E, B, gx, C, gp = _jax(arrays)
    want = jax_solve_kkt_soa(JaxSystem(D, E, B, C, gx, gp), 1e-3,
                             with_dmax=True)
    got = spike.kkt_solve_spike_fused_ref(*arrays, 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10 * float(np.abs(w).max()))


def test_wrapper_dispatch():
    """A CPU tensor goes to the plain version; a tensor on a device with no
    kernel raises instead of falling back."""
    arrays = _kkt_arrays(9, 8, 2, seed=0)
    kernel0 = spike.kkt_solve_spike_fused.launches
    plain0 = spike.kkt_solve_spike_fused_ref.launches
    got = spike.kkt_solve_spike_fused(*arrays, 1e-3)
    want = spike.kkt_solve_spike_fused_ref(*arrays, 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert spike.kkt_solve_spike_fused.launches == kernel0
    assert spike.kkt_solve_spike_fused_ref.launches == plain0 + 2
    with pytest.raises(ValueError, match="no kernel"):
        spike.kkt_solve_spike_fused(*(a.to("meta") for a in arrays), 1e-3)
    assert resolve_auto_method(8, 2, "cpu") == "cr"


def test_chol_clamps_indefinite_blocks_like_jax():
    """A noise-indefinite block gives the same finite junk factor as JAX's
    smallblocks_soa.chol (pivots clamped at finfo.tiny), where
    torch.linalg.cholesky would raise."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((3, 3, 6))
    A = A + A.transpose(1, 0, 2)
    A[:, :, 0] = np.diag([1.0, -1.0, 2.0])      # indefinite
    got = soa.chol(torch.as_tensor(A))
    want = np.asarray(jax_soa.chol(jnp.asarray(A)))
    assert np.all(np.isfinite(want[:, :, 0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 100, 1000, 10001, 123457])
def test_tile_plan(k):
    T, L = spike._plan(k)
    assert L >= 3 and T >= 1
    assert T * L >= k and T * L - k < L  # no tile is all padding


@pytest.mark.parametrize("nq,refine", [(2, 1), (2, 2), (0, 0), (0, 1)])
def test_refined_and_parameter_free_kkt_match_jax(nq, refine):
    """solve_kkt_soa with refinement passes and with nq = 0 (the chain
    solve behind them is kernel #2's plain version on the CPU) against JAX
    solve_kkt_soa(spike=False): rtol 1e-10 (float64), and the damping
    scale exactly."""
    from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA
    from collocfem_tpu_torch.solve.kkt import solve_kkt_soa

    arrays = _kkt_arrays(37, 8, max(nq, 1), seed=nq + refine)
    if nq == 0:
        arrays[2] = arrays[2][:, :0, :]
        arrays[4] = arrays[4][:0, :0]
        arrays[5] = arrays[5][:0]
    D, E, B, gx, C, gp = _jax(arrays)
    want = jax_solve_kkt_soa(JaxSystem(D, E, B, C, gx, gp), 1e-3,
                             refine=refine, with_dmax=True)
    got = solve_kkt_soa(BlockTriSystemSoA(*arrays[:3], arrays[4], arrays[3],
                                          arrays[5]),
                        1e-3, refine=refine, with_dmax=True)
    for g, w in zip(got[:2], want[:2]):
        if w.size:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                       atol=1e-10 * float(np.abs(w).max()))
        else:
            assert tuple(g.shape) == (0,)
    assert float(got[2]) == float(want[2])


def test_refine_changes_nothing_in_exact_arithmetic():
    """One refinement pass on a well-conditioned float64 system moves the
    step by no more than rounding."""
    from collocfem_tpu_torch.solve.kkt import solve_kkt_soa

    s = random_kkt_system(50, 8, 2, seed=5)
    a = solve_kkt_soa(s, 1e-3)
    b = solve_kkt_soa(s, 1e-3, refine=1)
    for x, y in zip(a, b):
        assert float((x - y).abs().max() / x.abs().max()) <= 1e-13


def test_double_word_tier_raises():
    from collocfem_tpu_torch.solve.kkt import solve_kkt_soa

    with pytest.raises(NotImplementedError, match="float64"):
        solve_kkt_soa(random_kkt_system(5, 8, 2, seed=0), 1e-3, dw=True)
    assert resolve_auto_method(8, 0, "cpu") == "cr"
    assert resolve_auto_method(8, 2, "cpu", refine=1) == "cr"
