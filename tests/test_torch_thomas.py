"""Port parity, kernel #7: the batched block-Thomas solve's plain version and
its wrapper's dispatch, against ``collocfem_tpu``'s Pallas kernel run in
interpret mode, in float64.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from collocfem_tpu.ops.blocktri_pallas import (
    batched_thomas_solve as jax_batched_thomas,
)
from collocfem_tpu_torch.ops import thomas
from collocfem_tpu_torch.testing import batch_residual, random_chain_batch


# The shapes of tests/test_blocktri_pallas.py:26 and :41 (tile_e pads the
# batch there), plus single-block chains and, at config 5's b and r, the
# ragged batches the CUDA kernel's groups of four chains a warp meet.
@pytest.mark.parametrize("shape,tile_e", [((4, 5, 3, 2), 2),
                                          ((5, 9, 4, 2), 8),
                                          ((3, 1, 8, 3), 2),
                                          ((5, 2, 8, 3), 4),
                                          ((3, 4, 8, 3), 2)])
def test_plain_matches_pallas_interpret(shape, tile_e):
    """rtol 1e-9 (the JAX package's own bar for this kernel)."""
    args = random_chain_batch(*shape, seed=sum(shape))
    want = np.asarray(jax_batched_thomas(
        *(jnp.asarray(a.numpy()) for a in args), tile_e=tile_e,
        interpret=True))
    got = thomas.batched_thomas_solve_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


# The block sizes the card's kernel now runs at b < 8: lane groups of 2
# and 4 (b = 3 leaves one lane idle).
@pytest.mark.parametrize("shape,tile_e", [((3, 4, 2, 2), 2),
                                          ((5, 3, 3, 3), 2),
                                          ((4, 5, 4, 3), 4)])
def test_plain_matches_pallas_interpret_at_small_block_sizes(shape, tile_e):
    """rtol 1e-9, as at b = 8."""
    args = random_chain_batch(*shape, seed=sum(shape))
    want = np.asarray(jax_batched_thomas(
        *(jnp.asarray(a.numpy()) for a in args), tile_e=tile_e,
        interpret=True))
    got = thomas.batched_thomas_solve_ref(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("b,r", [(16, 1), (16, 17), (9, 2)])
def test_plain_matches_jax_scan_at_large_block_sizes(b, r):
    """At b = 9 and 16 (the Pallas kernel's interpret mode takes most of a
    minute there) against the JAX package's plain block Thomas solve,
    blocktri_solve_scan, chain by chain: rtol 1e-9."""
    from collocfem_tpu.solve.blocktri import blocktri_solve_scan

    D, E, G = random_chain_batch(3, 6, b, r, seed=b + r)
    got = thomas.batched_thomas_solve_ref(D, E, G).numpy()
    for e in range(D.shape[0]):
        Ee = E[e].clone()
        Ee[-1] = 0.0
        want = np.asarray(blocktri_solve_scan(
            *(jnp.asarray(a.numpy()) for a in (D[e], Ee, G[e]))))
        np.testing.assert_allclose(got[e], want, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(want).max()))


@pytest.mark.parametrize("k", [1, 2, 11])
def test_plain_solves_each_chain(k):
    """A X = G per experiment, E[:, K-1] ignored: residual <= 1e-12 x |G|."""
    D, E, G = random_chain_batch(6, k, 8, 3, seed=k)
    assert batch_residual(D, E, G,
                          thomas.batched_thomas_solve_ref(D, E, G)) <= 1e-12


def test_wrapper_dispatch():
    """A CPU tensor goes to the plain version and moves only its counter; a
    tensor on a device with no kernel raises."""
    D, E, G = random_chain_batch(5, 11, 8, 3, seed=0)
    kernel0 = thomas.batched_thomas_solve.launches
    plain0 = thomas.batched_thomas_solve_ref.launches
    np.testing.assert_array_equal(
        thomas.batched_thomas_solve(D, E, G).numpy(),
        thomas.batched_thomas_solve_ref(D, E, G).numpy())
    assert thomas.batched_thomas_solve.launches == kernel0
    assert thomas.batched_thomas_solve_ref.launches == plain0 + 2
    with pytest.raises(ValueError, match="no kernel"):
        thomas.batched_thomas_solve(*(a.to("meta") for a in (D, E, G)))


@pytest.mark.parametrize("k", [1, 2, 11])
def test_dense_yardstick_solves_the_same_systems(k):
    """chip_smoke.py times torch.linalg.solve on the chains assembled dense
    as kernel #7's library yardstick: it must solve the same systems (E[:,
    K-1] ignored); float64 relative difference <= 1e-12."""
    import torch

    from chip_smoke import _dense_batch
    from collocfem_tpu_torch.testing import rel_err

    D, E, G = random_chain_batch(4, k, 8, 3, seed=10 + k)
    A, rhs = _dense_batch(D, E, G)
    assert A.shape == (4, 8 * k, 8 * k) and rhs.shape == (4, 8 * k, 3)
    got = torch.linalg.solve(A, rhs).reshape(G.shape)
    assert rel_err(got, thomas.batched_thomas_solve_ref(D, E, G)) <= 1e-12
