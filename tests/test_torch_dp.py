"""Port parity, the dp tier: ``make_multi_experiment_solver(dp_axis=...)``
with the experiments sharded over "dp" ranks in both layouts, and dp x sp
with ``parallel.spike.spike_chain_solver`` as the block layout's chain
solver, against the JAX package's unsharded multi-experiment solver on the
same inputs (distinct experiments, each from its own seeded state and input
frequency).

The port's runs share ONE spawned gloo world of 4 CPU ranks
(``testing.run_world``): dp = 4 on a 4 x 1 grid, dp = 2 and dp x sp = 2 x 2
on a 2 x 2 grid; every case's 4 ranks must agree bit for bit.  Each solve
runs twice: ``solve.eager`` and ``solve.stepwise``, the functions that the
CUDA graphs capture, in replay order, which must agree bit for bit.  The
world also runs the plain version of the peer all-reduce
(``parallel.peer``) over both groups of 2 ranks of the 2 x 2 grid, held to
numpy's rank-ordered accumulation bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.parallel.batch import BatchDecision as JaxBatchDecision
from collocfem_tpu.parallel.batch import (
    make_multi_experiment_solver as jax_multi_solver,
)
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu_torch import testing
from collocfem_tpu_torch.testing import bit_equal

F64 = torch.float64
MU_TRUE, B_TRUE = 1.3, 0.5
OPTS = dict(maxiter=40, gtol=1e-9, xtol=1e-10)
GRID = {4: (4, 1), 2: (2, 2)}
LAYOUTS = ("soa", "blocks")
COLLECTIVE_SIZES = (1, 2 * 8 * 19)   # one element; the SPIKE gather's row


def _batch(n_exp, tf, elements, degree, n_meas, seed):
    """Distinct Van der Pol experiments (tests/test_multi_experiment.py's
    recipe): x0 from default_rng(seed), input sin((0.7 + 0.15 e) t),
    solve_ivp at rtol 1e-10; defect weight 300, p0 = (2, 0.2), a shared
    prior of weight 1e-3 at (1, 1)."""
    mesh = jax_uniform_mesh(0.0, tf, elements, degree)
    t_meas = np.linspace(0.05, tf - 0.05, n_meas)
    rng = np.random.default_rng(seed)
    ys, us = [], []
    for e in range(n_exp):
        x0 = rng.uniform(-2, 2, size=2)
        freq = 0.7 + 0.15 * e
        sol = solve_ivp(
            lambda t, x: [x[1], MU_TRUE * (1 - x[0] ** 2) * x[1] - x[0]
                          + B_TRUE * np.sin(freq * t)],
            (0.0, tf), x0, rtol=1e-10, atol=1e-11, dense_output=True)
        ys.append(sol.sol(t_meas)[0][:, None])
        us.append(np.sin(freq * np.asarray(mesh.elem_times))[..., None])
    return dict(kind="vdp_batch", breakpoints=np.asarray(mesh.breakpoints),
                degree=degree, t_meas=t_meas, y=np.stack(ys),
                u_nodes=np.stack(us), defect_weight=300.0, p0=[2.0, 0.2],
                p_prior=[1.0, 1.0], p_w=[1e-3, 1e-3])


# tests/test_multi_experiment.py's batch_setup: 8 experiments, N = 48,
# degree 2; and four experiments on tests/test_sharded_sp.py's mesh (N =
# 15, degree 3: K = 16 splits over sp = 2; batch_setup's K = 49 does not).
SPECS = {"dp": (8, 8.0, 48, 2, 80, 42), "dpsp": (4, 6.0, 15, 3, 60, 7)}


@pytest.fixture(scope="module")
def specs():
    return {name: _batch(*args) for name, args in SPECS.items()}


@pytest.fixture(scope="module")
def world(specs, tmp_path_factory):
    cases = []
    for mode, tag in (("eager", ""), ("stepwise", " stepwise")):
        cases += [(f"dp={dp} {layout}{tag}", testing.dp_case,
                   dict(mesh=GRID[dp], spec=specs["dp"], options=OPTS,
                        layout=layout, dtype=F64, mode=mode))
                  for dp in GRID for layout in LAYOUTS]
        cases.append((f"dp x sp{tag}", testing.dp_case,
                      dict(mesh=(2, 2), spec=specs["dpsp"], options=OPTS,
                           layout="blocks", dtype=F64, sp_chain=True,
                           mode=mode)))
    cases.append(("collectives 2 x 2", testing.collective_case,
                  dict(mesh=(2, 2), seed=9, sizes=COLLECTIVE_SIZES)))
    return testing.run_world(4, cases, tmp_path_factory.mktemp("world"))


def _jax_solution(spec):
    """The JAX package's unsharded (soa) solve of ``spec``'s batch."""
    mesh = jax_uniform_mesh(0.0, spec["breakpoints"][-1],
                            len(spec["breakpoints"]) - 1, spec["degree"])
    t = spec["t_meas"]
    prob = JaxProblem.build(JaxVanDerPol(), mesh, t,
                            defect_weight=spec["defect_weight"])
    datas = [prob.pack_data(y, t, u_nodes=u, p_weight=0.0)
             for y, u in zip(spec["y"], spec["u_nodes"])]
    v0s = [prob.initial_guess_from_data(t, y, p0=[0.0, 0.0]).V
           for y in spec["y"]]
    data = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)
    z0 = JaxBatchDecision(V=jnp.stack(v0s), p=jnp.asarray(spec["p0"]))
    return jax_multi_solver(prob, JaxSolverOptions(**OPTS))(
        z0, data, jnp.asarray(spec["p_prior"]), jnp.asarray(spec["p_w"]))


@pytest.fixture(scope="module")
def jax_dp(specs):
    return _jax_solution(specs["dp"])


def _rank0(world, name):
    out = world[0][name]["out"]
    for rank in world[1:]:
        assert bit_equal(rank[name]["out"], out), name
    return out


@pytest.mark.parametrize("dp", list(GRID))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_dp_sharded_solver_matches_jax(world, jax_dp, dp, layout):
    """The multi-experiment solver with the 8 experiments over dp ranks
    against the JAX unsharded solver: p rtol / atol 1e-8, V rtol 1e-6 /
    atol 1e-8 (tests/test_multi_experiment.py's sharded bars)."""
    z, stats = _rank0(world, f"dp={dp} {layout}")
    z_ref, _ = jax_dp
    np.testing.assert_allclose(z["p"].numpy(), np.asarray(z_ref.p),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(z["V"].numpy(), np.asarray(z_ref.V),
                               rtol=1e-6, atol=1e-8)
    assert bool(stats["converged"])


def test_dp_times_sp_matches_jax(world, specs):
    """dp x sp = 2 x 2: two experiments a dp rank, each chain solved by
    SPIKE over the sp pair (spike_chain_solver), against the JAX unsharded
    solver on the four experiments: p rtol / atol 1e-8."""
    z, stats = _rank0(world, "dp x sp")
    z_ref, _ = _jax_solution(specs["dpsp"])
    np.testing.assert_allclose(z["p"].numpy(), np.asarray(z_ref.p),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(z["V"].numpy(), np.asarray(z_ref.V),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", [f"dp={dp} {layout}" for dp in GRID
                                  for layout in LAYOUTS] + ["dp x sp"])
def test_dp_stepwise_matches_eager(world, name):
    """The captured structure over ranks: solve.stepwise (prelude, then the
    step maxiter times with no read of done, as the loop graph's WHILE body
    runs; a step after done leaves the state as it is) equals solve.eager
    bit for bit on every rank, V, p and every SolveStats field,
    in both layouts at dp = 4 and 2 and for dp x sp (so it meets the JAX
    bars above as the eager loop does)."""
    want = _rank0(world, name)
    assert 0 < int(want[1]["iterations"]) < OPTS["maxiter"]
    for rank in world:
        assert bit_equal(rank[f"{name} stepwise"]["out"], want)


@pytest.mark.parametrize("group", ["sp", "dp"])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_collective_over_two_ranks_is_rank_ordered(world, group, op,
                                                         dtype):
    """The peer all-reduce's plain version through meshes.all_sum /
    all_max over each group of 2 ranks of the 2 x 2 grid (the sp rows and
    the dp columns): the ranks of a group get the same bits, numpy's
    float64 accumulation in rank order cast to the input's dtype, exactly;
    the gather gives both payloads in rank order."""
    results = [rank["collectives 2 x 2"][group] for rank in world]
    for n in COLLECTIVE_SIZES:
        raw = [np.random.default_rng(9 + r).standard_normal(n)
               for r in range(2)]
        xs = [x.astype(dtype).astype(np.float64) for x in raw]
        acc = xs[0] + xs[1] if op == "sum" else np.maximum(xs[0], xs[1])
        want = torch.as_tensor(acc).to(getattr(torch, dtype))
        for r in results:
            assert r["size"] == 2
            assert bit_equal(r[(op, dtype, n)], want)
            assert bit_equal(r[("gather", "float64", n)],
                             torch.as_tensor(np.stack(raw)))
