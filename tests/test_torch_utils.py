"""Port parity, the utilities: ``utils.checkpoint`` (save, load, warm start
on a refined mesh) against the JAX package's, and ``utils.debugging``
(tests/test_debugging.py's three cases, and ``checkified`` on a real eager
solve with and without a NaN planted in the data)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.utils.checkpoint import save_pytree as jax_save_pytree
from collocfem_tpu.utils.checkpoint import (
    warm_start_on_mesh as jax_warm_start,
)
from collocfem_tpu_torch.ocp import Multipliers
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.parallel.batch import BatchDecision
from collocfem_tpu_torch.problem import Decision
from collocfem_tpu_torch.solve.newton import SolverOptions, SolveStats
from collocfem_tpu_torch.testing import bit_equal, estimation_inputs
from collocfem_tpu_torch.utils import (
    assert_all_finite,
    checkified,
    load_pytree,
    save_pytree,
)

F64 = torch.float64


def _trees():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    return [
        Decision(V=t(13, 2), p=t(2)),
        BatchDecision(V=t(3, 13, 2), p=t(2)),
        Multipliers(*(t(5) for _ in Multipliers._fields)),
        SolveStats(iterations=torch.tensor(7), converged=torch.tensor(True),
                   cost=t(), grad_norm=t().float(), lam=t(),
                   history=t(4, 5)),
    ]


@pytest.mark.parametrize("index", range(4))
def test_checkpoint_round_trip(tmp_path, index):
    """Decision, BatchDecision, Multipliers and SolveStats come back bit for
    bit, with each leaf's dtype."""
    tree = _trees()[index]
    path = tmp_path / "ck.npz"
    save_pytree(str(path), tree)
    like = type(tree)(*(torch.zeros_like(x) for x in tree))
    assert bit_equal(load_pytree(str(path), like), tree)


def test_checkpoint_mismatches_raise(tmp_path):
    path = tmp_path / "ck.npz"
    d = _trees()[0]
    save_pytree(str(path), d)
    with pytest.raises(ValueError, match="structure"):
        load_pytree(str(path), BatchDecision(*d))
    with pytest.raises(ValueError, match="structure"):
        load_pytree(str(path), (d.V, d.p, d.p))
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(path), Decision(V=d.V[:3], p=d.p))


def test_checkpoint_leaves_match_jax(tmp_path):
    """The leaves the port writes for a Decision are the JAX package's
    save_pytree leaves of the same values, key for key."""
    d = _trees()[0]
    save_pytree(str(tmp_path / "port.npz"), d)
    jax_save_pytree(str(tmp_path / "jax.npz"),
                    _jax_decision(d.V.numpy(), d.p.numpy()))
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        leaves = sorted(k for k in want.files if k.startswith("leaf_"))
        assert sorted(k for k in got.files if k.startswith("leaf_")) == leaves
        for k in leaves:
            np.testing.assert_array_equal(got[k], want[k])


def _jax_decision(V, p):
    from collocfem_tpu.problem import Decision as JaxDecision

    return JaxDecision(V=jnp.asarray(V), p=jnp.asarray(p))


def test_warm_start_on_mesh_matches_jax():
    """A degree-4 path on 6 elements onto 17 elements of degree 3: 1e-13."""
    from collocfem_tpu_torch.utils.checkpoint import warm_start_on_mesh

    V = np.random.default_rng(1).standard_normal((25, 2))
    want = jax_warm_start(jax_uniform_mesh(0.0, 2.0, 6, 4),
                          jax_uniform_mesh(0.0, 2.0, 17, 3), jnp.asarray(V))
    got = warm_start_on_mesh(uniform_mesh(0.0, 2.0, 6, 4),
                             uniform_mesh(0.0, 2.0, 17, 3), torch.tensor(V))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)


def test_checkified_catches_nan():
    err, _ = checkified(lambda x: torch.log(x) * 2.0)(torch.tensor(-1.0))
    assert "log" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()


def test_checkified_clean_pass():
    err, out = checkified(lambda x: x * 3.0)(torch.tensor(2.0))
    err.throw()
    assert err.get() is None and float(out) == 6.0


def test_assert_all_finite():
    assert_all_finite({"a": torch.ones(3)})
    with pytest.raises(FloatingPointError, match="a"):
        assert_all_finite({"a": torch.tensor([1.0, float("nan")])})


def test_checkified_on_an_eager_solve():
    """checkified(make_gn_solver(...)) on a small headline-style problem:
    clean data passes and gives the unwrapped solve's result bit for bit; a
    NaN planted in one measurement is reported."""
    from collocfem_tpu_torch.solve.newton import make_gn_solver

    mesh = uniform_mesh(0.0, 6.0, 8, 3)
    t = np.linspace(0.05, 5.95, 30)
    spec = dict(kind="vdp", breakpoints=mesh.breakpoints, degree=3, t_meas=t,
                y=np.cos(t)[:, None],
                u_nodes=np.sin(0.9 * mesh.elem_times)[..., None],
                defect_weight=100.0, p0=[0.5, 0.5])
    prob, z0, data = estimation_inputs(spec, dtype=F64, device="cpu")
    solve = make_gn_solver(prob, SolverOptions(maxiter=6, gtol=0.0))
    err, out = checkified(solve)(z0, data)
    err.throw()
    assert bit_equal(out, solve(z0, data))
    y = data.y.clone()
    y[3, 0, 0] = float("nan")
    err, _ = checkified(solve)(z0, data._replace(y=y))
    assert "nan" in err.get()
    with pytest.raises(FloatingPointError):
        err.throw()
