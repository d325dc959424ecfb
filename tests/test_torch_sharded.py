"""Port parity, the sp tier: ``parallel.spike`` (SPIKE over ranks),
``parallel.sharded.make_sp_gn_solver`` and ``make_irls_solver`` with the
sharded inner solver, against the JAX package on the same inputs.

The port's sharded solvers run in ONE spawned gloo world of 4 CPU ranks
(``testing.run_world``) that runs every case of this module: sp = 4 on a
1 x 4 grid and sp = 2 on a 2 x 2 grid, whose two dp rows solve the same
problem, so every case has 4 ranks whose results must agree bit for bit.
Each GN solve runs twice: ``solve.eager`` and ``solve.stepwise``, the
functions that the CUDA graphs capture, in replay order, which must agree
bit for bit (a converging solve runs its steps as the loop graph's WHILE
body does, with no read of ``done``, on several ranks and on one).  The
world also runs the plain version of the peer all-reduce
(``parallel.peer``) over 4 ranks, held to numpy's rank-ordered
accumulation bit for bit.  The JAX references
run here on the conftest's virtual CPU mesh (SPIKE) or on one device (the
solvers), in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.parallel.meshes import make_device_mesh as jax_mesh
from collocfem_tpu.parallel.spike import (
    spike_sharded_solver as jax_spike_sharded_solver,
)
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve.newton import make_gn_solver as jax_make_gn_solver
from collocfem_tpu.solve.newton import make_irls_solver as jax_irls_solver
from collocfem_tpu.utils import rk4_trajectory as jax_rk4
from collocfem_tpu_torch import testing
from collocfem_tpu_torch.testing import bit_equal
from tests.test_blocktri import random_spd_blocktri

F64 = torch.float64
TF = 6.0
# (K, b, r): tests/test_spike.py's shape and the two-blocks-per-rank edge.
SPIKE_SHAPES = {4: [(16, 4, 3), (8, 5, 2)], 2: [(16, 4, 3), (4, 5, 2)]}
GRID = {4: (1, 4), 2: (2, 2)}
OPTS = dict(maxiter=30, gtol=1e-9, xtol=1e-12)
IRLS = dict(OPTS, irls_delta=2.0)
# The all-reduces of one sp LM step: the halo of the trial assembly's
# element flats, the spill to the right neighbour, the Schur pieces' sum,
# the max, the scaling's halo, SPIKE's interface gather, the reduced Schur
# sum, and the trial cost's halo and sum.  A prelude makes 2 (the cost's
# halo and sum).
SP_STEP_ALL_REDUCES, SP_PRELUDE_ALL_REDUCES = 9, 2
# The plain collective's payload lengths: one element and the SPIKE
# interface gather's at sp = 4, (8, 19): P x 2 x b x r / P.
COLLECTIVE_SIZES = (1, 2 * 8 * 19)


def _sp_problem():
    """tests/test_sharded_sp.py's problem: Van der Pol, N = 15, degree 3
    (K = 16), 60 noiseless samples of x0 from an RK4 reference."""
    mesh = jax_uniform_mesh(0.0, TF, 15, 3)
    t_meas = np.linspace(0.05, TF - 0.05, 60)
    ts = np.linspace(0.0, TF, 6001)
    xs = jax_rk4(JaxVanDerPol().f, jnp.asarray([1.0, 0.0]), ts,
                 u_fn=lambda t: jnp.stack([jnp.sin(0.9 * t)]),
                 p=jnp.asarray([1.0, 1.0]))
    y = np.interp(t_meas, ts, np.asarray(xs[:, 0]))[:, None]
    return dict(kind="vdp", breakpoints=np.asarray(mesh.breakpoints),
                degree=3, t_meas=t_meas, y=y,
                u_nodes=np.sin(0.9 * np.asarray(mesh.elem_times))[..., None],
                defect_weight=100.0, p0=[0.5, 0.5])


def _jax_problem(spec):
    mesh = jax_uniform_mesh(0.0, TF, 15, 3)
    prob = JaxProblem.build(JaxVanDerPol(), mesh, spec["t_meas"],
                            defect_weight=spec["defect_weight"])
    data = prob.pack_data(spec["y"], spec["t_meas"], u_nodes=spec["u_nodes"])
    z0 = prob.initial_guess_from_data(spec["t_meas"], spec["y"],
                                      p0=spec["p0"])
    return prob, z0, data


def _chain(k, b, r):
    return random_spd_blocktri(k, b, r, seed=k + b)


@pytest.fixture(scope="module")
def spec():
    return _sp_problem()


@pytest.fixture(scope="module")
def world(spec, tmp_path_factory):
    """Every rank's results of every case, in rank order."""
    cases = []
    for sp, shapes in SPIKE_SHAPES.items():
        for k, b, r in shapes:
            D, E, G = _chain(k, b, r)
            cases.append((f"spike sp={sp} K={k}", testing.spike_case,
                          dict(mesh=GRID[sp], D=D, E=E, G=G, dtype=F64)))
        for mode in ("eager", "stepwise"):
            # sp = 2 also counts its reads to the host and its all-reduces,
            # in both runs: on the CPU the counting dispatch mode changes
            # the sp assembly's last bits.
            cases.append((f"gn sp={sp}" + (" stepwise" if mode == "stepwise"
                                           else ""), testing.sp_gn_case,
                          dict(mesh=GRID[sp], spec=spec, options=OPTS,
                               dtype=F64, mode=mode, traffic=sp == 2)))
    cases.append(("irls sp=4", testing.sp_gn_case,
                  dict(mesh=GRID[4], spec=spec, options=IRLS, dtype=F64,
                       irls_rounds=2)))
    cases.append(("collectives sp=4", testing.collective_case,
                  dict(mesh=GRID[4], seed=5, sizes=COLLECTIVE_SIZES)))
    return testing.run_world(4, cases, tmp_path_factory.mktemp("world"))


def _rank0(world, name):
    """Rank 0's result of case ``name``, after checking that every rank's
    is the same bit for bit."""
    out = world[0][name]["out"]
    for rank in world[1:]:
        assert bit_equal(rank[name]["out"], out), name
    return out


@pytest.mark.parametrize("sp,k,b,r", [(sp, *s) for sp, shapes in
                                      SPIKE_SHAPES.items() for s in shapes])
def test_spike_over_ranks_matches_jax(world, eight_devices, sp, k, b, r):
    """blocktri_solve_spike through spike_sharded_solver at sp ranks against
    the JAX spike_sharded_solver on the virtual mesh at the same sp: 1e-12
    (float64)."""
    D, E, G = _chain(k, b, r)
    with jax_mesh(dp=1, sp=sp, devices=eight_devices[:sp]) as mesh:
        want = np.asarray(jax.jit(jax_spike_sharded_solver(mesh))(
            jnp.asarray(D), jnp.asarray(E), jnp.asarray(G)))
    got = _rank0(world, f"spike sp={sp} K={k}").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_solver(spec):
    """The JAX make_gn_solver (one jit, shared with the IRLS reference)."""
    prob, z0, data = _jax_problem(spec)
    return prob, z0, data, jax_make_gn_solver(prob, JaxSolverOptions(**OPTS))


@pytest.fixture(scope="module")
def jax_gn(jax_solver):
    _, z0, data, solve = jax_solver
    return solve(z0, data)


@pytest.mark.parametrize("sp", [4, 2])
def test_sp_gn_solver_matches_jax(world, jax_gn, sp):
    """make_sp_gn_solver at sp ranks against the JAX make_gn_solver with
    tests/test_sharded_sp.py's tolerances (p rtol 1e-7 / atol 1e-9, V rtol
    1e-6 / atol 1e-8); every rank's result the same bit for bit."""
    z, stats = _rank0(world, f"gn sp={sp}")
    z_ref, _ = jax_gn
    np.testing.assert_allclose(z["p"].numpy(), np.asarray(z_ref.p),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(z["V"].numpy(), np.asarray(z_ref.V),
                               rtol=1e-6, atol=1e-8)
    assert bool(stats["converged"])


@pytest.mark.parametrize("sp", [4, 2])
def test_sp_gn_stepwise_matches_eager(world, sp):
    """The captured structure over ranks: solve.stepwise (prelude, then the
    step maxiter times, as the graphs replay) equals solve.eager bit for
    bit on every rank, z and every SolveStats field (so it meets the JAX
    bars above as the eager loop does)."""
    want = _rank0(world, f"gn sp={sp}")
    for rank in world:
        assert bit_equal(rank[f"gn sp={sp} stepwise"]["out"], want)


def _loop_traffic(eager, stepwise, maxiter):
    """The loop schedule's traffic against the eager loop's, on one rank:
    the same iterations; no read to the host in the step-wise solve (the
    eager loop reads done before each step); the eager loop's all-reduces
    a prelude, one step each iteration and the gather of V, the step-wise
    solve's a prelude more (its plan's warm-up) and one step each of the
    maxiter steps the WHILE body may run (a step after done leaves the
    state as it is)."""
    its = int(eager["out"][1]["iterations"])
    assert 0 < its < maxiter
    assert int(stepwise["out"][1]["iterations"]) == its
    assert stepwise["host_reads"] == 0
    assert eager["host_reads"] > its
    assert eager["all_reduces"] == (SP_PRELUDE_ALL_REDUCES
                                    + its * SP_STEP_ALL_REDUCES + 1)
    assert stepwise["all_reduces"] == (2 * SP_PRELUDE_ALL_REDUCES
                                       + maxiter * SP_STEP_ALL_REDUCES + 1)


def test_sp_gn_stepwise_on_several_ranks_reads_nothing_during_the_solve(
        world):
    """With a tolerance (gtol 1e-9) on an sp group of 2 ranks the step-wise
    solve runs the loop graph's schedule, whose WHILE body the device
    repeats while ~done: on every rank no read to the host, .eager's
    iterations, and the all-reduces of maxiter steps (_loop_traffic)."""
    for rank in world:
        _loop_traffic(rank["gn sp=2"], rank["gn sp=2 stepwise"],
                      OPTS["maxiter"])


def _world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    return dist.group.WORLD


def test_sp_gn_stepwise_on_one_rank_reads_nothing_during_the_solve(
        spec, tmp_path):
    """With a tolerance on an sp group of one rank (here a gloo world of
    one in this process) the step-wise solve runs the same loop schedule
    as on several ranks: no read to the host, .eager's iterations and
    result bit for bit, and the all-reduces of maxiter steps
    (_loop_traffic)."""
    import torch.distributed as dist

    _world_of_one(tmp_path)
    try:
        run = {mode: testing.sp_gn_case(
            mesh=(1, 1), spec=spec, options=OPTS, dtype=F64, device="cpu",
            mode=mode, traffic=True) for mode in ("eager", "stepwise")}
    finally:
        dist.destroy_process_group()
    assert bit_equal(run["stepwise"]["out"], run["eager"]["out"])
    _loop_traffic(run["eager"], run["stepwise"], OPTS["maxiter"])


def test_capture_is_refused_only_where_the_ranks_cannot_map_each_other(
        spec, tmp_path, monkeypatch):
    """What capture_refusal still refuses: a group whose ranks cannot map
    each other's buffers for the peer all-reduce.  A solver made for a CUDA
    device in a process without one (this box) is refused with the reason
    when it is made; then a call and .stepwise raise ValueError naming it,
    while .eager runs the plain collectives on CPU tensors.  A gloo group
    whose ranks do map each other (set-up faked here, as on ranks sharing
    one card) has no refusal, nor has a CPU device or no group: the
    backend no longer decides."""
    import torch.distributed as dist

    from collocfem_tpu_torch.parallel import peer
    from collocfem_tpu_torch.parallel.meshes import (DeviceMesh,
                                                      capture_refusal)
    from collocfem_tpu_torch.parallel.sharded import make_sp_gn_solver
    from collocfem_tpu_torch.solve.newton import SolverOptions

    prob, z0, data = testing.estimation_inputs(spec, dtype=F64, device="cpu")
    group = _world_of_one(tmp_path)
    monkeypatch.setattr(peer, "_GROUPS", {})
    try:
        cuda = torch.device("cuda")
        refusal = capture_refusal(group, cuda)
        assert "cannot map each other's memory" in refusal
        assert "no CUDA device" in refusal
        assert capture_refusal(group, "cpu") is None
        assert capture_refusal(None, cuda) is None
        solve = make_sp_gn_solver(
            prob, DeviceMesh(dp=1, sp=1, dp_rank=0, sp_rank=0,
                             dp_group=group, sp_group=group, device=cuda),
            SolverOptions(**OPTS))
        with pytest.raises(ValueError, match="no CUDA device"):
            solve(z0, data)
        with pytest.raises(ValueError, match="no CUDA device"):
            solve.stepwise(z0, data)
        z, stats = solve.eager(z0, data)
        assert bool(stats.converged)
        monkeypatch.setattr(peer, "_GROUPS", {})
        monkeypatch.setattr(peer, "_open_group", lambda g, d: object())
        assert capture_refusal(group, cuda) is None
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_collective_over_four_ranks_is_rank_ordered(world, op, dtype):
    """The peer all-reduce's plain version (parallel.peer.peer_reduce_ref)
    through meshes.all_sum / all_max over the sp group of 4: every rank
    gets the same bits, and they are numpy's accumulation in rank order,
    acc = x0; acc = acc + x1; ... (np.maximum for max) in float64, cast to
    the input's dtype (float32 inputs are summed in float64), exactly; the
    gather gives every rank's payload in rank order."""
    results = [rank["collectives sp=4"]["sp"] for rank in world]
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    for n in COLLECTIVE_SIZES:
        raw = [np.random.default_rng(5 + r).standard_normal(n)
               for r in range(4)]
        xs = [x.astype(dtype).astype(np.float64) for x in raw]
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x if op == "sum" else np.maximum(acc, x)
        want = torch.as_tensor(acc).to(getattr(torch, dtype))
        for r in results:
            assert bit_equal(r[(op, dtype, n)], want)
            assert bit_equal(r[("gather", "float64", n)],
                             torch.as_tensor(np.stack(raw)))


def test_irls_with_sharded_inner_solver_matches_jax(world, jax_solver):
    """make_irls_solver(inner_solver=make_sp_gn_solver) at sp = 4 against
    the JAX package's single-device IRLS (its default inner solver,
    make_gn_solver with these options, which ignores irls_delta): p rtol
    1e-6 (atol 1e-8), the final per-sample weights rtol 1e-5
    (tests/test_sharded_sp.py's bars)."""
    prob, z0, data, solve = jax_solver
    z_ref, _, d_ref = jax_irls_solver(prob, JaxSolverOptions(**IRLS),
                                      n_rounds=2, inner_solver=solve)(z0, data)
    z, stats, d = _rank0(world, "irls sp=4")
    assert len(stats) == 3
    np.testing.assert_allclose(z["p"].numpy(), np.asarray(z_ref.p),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(d["meas_w"].numpy(), np.asarray(d_ref.meas_w),
                               rtol=1e-5, atol=1e-8)


def test_sp_gn_solver_validates_its_grid(spec):
    """K must divide by sp with >= 2 blocks a shard (checked before any
    collective runs)."""
    import collocfem_tpu_torch.parallel.sharded as sharded
    from collocfem_tpu_torch.parallel.meshes import DeviceMesh

    prob, _, _ = testing.estimation_inputs(spec, dtype=F64, device="cpu")
    for sp in (3, 16):
        dm = DeviceMesh(dp=1, sp=sp, dp_rank=0, sp_rank=0, dp_group=None,
                        sp_group=None, device=torch.device("cpu"))
        with pytest.raises(ValueError, match="sp"):
            sharded.make_sp_gn_solver(prob, dm)
