"""Port parity, foundation layers: LGL basis, mesh, the Van der Pol model and
the per-element residual primitives of ``collocfem_tpu_torch`` against
``collocfem_tpu`` on the same seeded inputs, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops import basis as jax_basis
from collocfem_tpu.ops import mesh as jax_mesh
from collocfem_tpu.ops import residual as jax_residual
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops import basis, mesh, residual

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


@pytest.mark.parametrize("degree", [1, 2, 4, 7])
def test_basis_tables_match(degree):
    # Both packages run the same float64 numpy algorithm: bit-identical.
    want, got = jax_basis.make_basis(degree), basis.make_basis(degree)
    for name in ("nodes", "weights", "diff", "bary"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    s = np.random.default_rng(degree).uniform(-1, 1, 9)
    np.testing.assert_array_equal(got.interp_rows(s), want.interp_rows(s))


def test_mesh_tables_match():
    want = jax_mesh.uniform_mesh(0.0, 3.0, 13, 4)
    got = mesh.uniform_mesh(0.0, 3.0, 13, 4)
    for name in ("widths", "elem_node_idx", "node_times", "elem_times"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.num_nodes, got.num_blocks) == (want.num_nodes,
                                               want.num_blocks)
    times = np.random.default_rng(1).uniform(-0.5, 3.5, 50)
    for a, b in zip(got.interp_rows(times), want.interp_rows(times)):
        np.testing.assert_array_equal(a, b)


def test_vdp_model_matches():
    rng = np.random.default_rng(2)
    x, u, p = rng.standard_normal(2), rng.standard_normal(1), rng.uniform(
        0.2, 2.0, 2)
    jm, tm = JaxVanDerPol(), VanDerPol()
    assert tm.ny == jm.ny == 1
    # Same elementwise formula in float64: equal to the last few ulps.
    np.testing.assert_allclose(
        tm.f(_t(x), _t(u), _t(p), 0.0).numpy(),
        np.asarray(jm.f(jnp.asarray(x), jnp.asarray(u), jnp.asarray(p), 0.0)),
        rtol=1e-15)
    full = VanDerPol(measure_full_state=True)
    np.testing.assert_array_equal(full.h(_t(x), _t(u), _t(p), 0.0).numpy(), x)


def test_residual_primitives_match():
    """element_derivative, defect_residual, measurement_residual and
    interpolate_states on one element: rtol 1e-12 (float64, reordered
    matmul sums)."""
    rng = np.random.default_rng(3)
    d, s = 4, 3
    b = basis.make_basis(d)
    width = 0.37
    times = 1.0 + 0.5 * width * (b.nodes + 1.0)
    Xe = rng.standard_normal((d + 1, 2))
    Ue = rng.standard_normal((d + 1, 1))
    p = rng.uniform(0.2, 2.0, 2)
    scale = rng.uniform(0.5, 2.0, (d, 2))
    rows = b.interp_rows(rng.uniform(-1, 1, s))
    mt, y = rng.uniform(1.0, 1.37, s), rng.standard_normal((s, 1))
    w, mask = np.array([2.0]), np.array([1.0, 0.0, 1.0])
    jm, tm = JaxVanDerPol(), VanDerPol()

    def check(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(want).max()))

    check(residual.element_derivative(_t(b.diff), width, _t(Xe)),
          jax_residual.element_derivative(jnp.asarray(b.diff), width,
                                          jnp.asarray(Xe)))
    check(residual.defect_residual(tm, _t(b.diff), width, _t(times), _t(Xe),
                                   _t(Ue), _t(p), _t(scale)),
          jax_residual.defect_residual(jm, jnp.asarray(b.diff), width,
                                       jnp.asarray(times), jnp.asarray(Xe),
                                       jnp.asarray(Ue), jnp.asarray(p),
                                       jnp.asarray(scale)))
    u_meas = residual.interpolate_states(_t(rows), _t(Ue))
    ju_meas = jax_residual.interpolate_states(jnp.asarray(rows),
                                              jnp.asarray(Ue))
    check(u_meas, ju_meas)
    check(residual.measurement_residual(tm, _t(rows), _t(Xe), u_meas, _t(p),
                                        _t(mt), _t(y), _t(w), _t(mask)),
          jax_residual.measurement_residual(
              jm, jnp.asarray(rows), jnp.asarray(Xe), ju_meas,
              jnp.asarray(p), jnp.asarray(mt), jnp.asarray(y),
              jnp.asarray(w), jnp.asarray(mask)))
    assert jax.config.jax_enable_x64  # the JAX side really ran in float64
