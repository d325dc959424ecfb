"""Port parity, uncertainty reports: the seven functions of
``solve/covariance.py`` against ``collocfem_tpu``'s, in float64, on
tests/test_covariance.py's setup (Van der Pol, 24 degree-2 elements, noisy
samples), at the JAX package's own converged solution carried across."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve import covariance as jax_cov
from collocfem_tpu.solve.newton import make_gn_solver as jax_make_gn_solver
from collocfem_tpu.utils import rk4_trajectory
from collocfem_tpu_torch.convert import data_from_numpy, decision_from_numpy
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve import covariance as cov

MU, B, TF, NOISE = 1.0, 1.0, 8.0, 0.05


@pytest.fixture(scope="module")
def solved():
    """Both packages' problems, the data and the JAX solution, each carried
    into the port."""
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, TF, 24, 2),
                             np.linspace(0.05, TF - 0.05, 80),
                             defect_weight=1e3)
    t_meas = np.linspace(0.05, TF - 0.05, 80)
    ts = np.linspace(0.0, TF, 8001)
    xs = rk4_trajectory(JaxVanDerPol().f, jnp.asarray([1.0, 0.0]), ts,
                        u_fn=lambda t: jnp.stack([jnp.sin(0.9 * t)]),
                        p=jnp.asarray([MU, B]))
    y = (np.interp(t_meas, ts, np.asarray(xs[:, 0]))[:, None]
         + NOISE * np.random.default_rng(7).standard_normal((80, 1)))
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=np.sin(0.9 * jprob.mesh.elem_times)[..., None],
                            meas_weight=1 / NOISE)
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[0.8, 0.8])
    jz, _ = jax_make_gn_solver(jprob, JaxSolverOptions(maxiter=40,
                                                       xtol=1e-12))(jz0, jdata)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, TF, 24, 2),
                                    t_meas, defect_weight=1e3, device="cpu",
                                    dtype=torch.float64)
    tdata = data_from_numpy(*map(np.asarray, jdata), device="cpu",
                            dtype=torch.float64)
    tz = decision_from_numpy(jz.V, jz.p, "cpu", torch.float64)
    node_t = np.asarray(jprob.mesh.node_times)
    times = np.r_[node_t[:9], 0.5 * (node_t[:-1] + node_t[1:])[:7]]
    return (jprob, jz, jdata), (tprob, tz, tdata), times


def _close(got, want, rtol=1e-9):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("name", [
    "parameter_covariance", "parameter_std", "state_covariance_blocks",
    "state_covariance_nodes", "state_std", "element_covariance"])
@pytest.mark.parametrize("method", ["cr", "scan"])
def test_covariance_matches_jax(solved, name, method):
    """Each function through SOLVERS['cr'] (the CR kernels' plain versions
    on the CPU) and SOLVERS['scan']: within 1e-9 of JAX's (relative to the
    largest entry of each output)."""
    (jprob, jz, jdata), (tprob, tz, tdata), _ = solved
    want = getattr(jax_cov, name)(jprob, jz, jdata, method)
    _close(getattr(cov, name)(tprob, tz, tdata, method), want)


def test_trajectory_std_matches_jax(solved):
    """trajectory_std at node times and between nodes: within 1e-9."""
    (jprob, jz, jdata), (tprob, tz, tdata), times = solved
    _close(cov.trajectory_std(tprob, tz, tdata, times),
           jax_cov.trajectory_std(jprob, jz, jdata, times))


def test_parameter_std_agrees_across_solvers(solved):
    """'cr', 'cr_unrolled', 'scan' and 'dense' give the same standard
    errors within 1e-9 (the port's SOLVERS has no 'cr_dw': float64 takes
    its place)."""
    _, (tprob, tz, tdata), _ = solved
    stds = [cov.parameter_std(tprob, tz, tdata, m)
            for m in ("cr", "cr_unrolled", "scan", "dense")]
    for s in stds[1:]:
        _close(s, stds[0].numpy())
    with pytest.raises(KeyError):
        cov.parameter_std(tprob, tz, tdata, "cr_dw")
