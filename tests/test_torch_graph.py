"""The captured solve path (``collocfem_tpu_torch.solve.graph``) on the CPU.

On a CUDA device a solve replays CUDA graphs: the prelude (assembly at z0
and the initial LM state) and the LM iterations, each reading and writing
static buffers; at fixed work one iteration graph replayed maxiter times,
with a tolerance one loop graph whose WHILE node runs the step until
``done`` or maxiter.  Here, with no card, ``solve.stepwise`` runs the same
functions in replay order on the same static buffers (the loop's step
maxiter times, a step after ``done`` leaving the state as it is), and every
case below holds it bit for bit (``torch.equal``) against the eager loop
(``lm_core.lm_loop``): the headline at fixed work, to a tolerance and
capped by maxiter, config 5 in both layouts at fixed work and to a
tolerance, exact Newton, and ten MHE steps.  A converging step-wise solve
reads nothing to the host, and its captured functions pass the dispatch
mode that refuses what a capture refuses.  One case holds the step-wise run
against the JAX package's ``make_gn_solver``.  The launch-count accounting
of the graphs (counts held through a warm-up and a capture, a graph's share
added per replay, a loop's steps tallied on the device and settled when the
counts are read) is unit-tested with a fake wrapper.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_constrained_graph import _NoHostTraffic
from test_torch_newton import _carry, _vdp_data

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops.mesh import uniform_mesh as jax_uniform_mesh
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.solve.newton import make_gn_solver as jax_make_gn_solver
from collocfem_tpu_torch.batched import build_config5_problem
from collocfem_tpu_torch.headline import headline_problem
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops import _build, cr
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.parallel.batch import make_multi_experiment_solver
from collocfem_tpu_torch.problem import Decision, EstimationProblem
from collocfem_tpu_torch.solve import graph
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver
from collocfem_tpu_torch.testing import (MHE_HORIZON, bit_equal,
                                         mhe_online_stream)

F64 = torch.float64
FIXED = dict(maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0, lam0=3e-6,
             lam_max=1e30)
EARLY = dict(maxiter=60, gtol=1e-10, xtol=1e-12)
# A tolerance the loop does not reach in maxiter iterations: the loop graph
# runs to its cap.
CAPPED = dict(maxiter=4, gtol=1e-10, xtol=1e-12)


def _assert_same(got, want):
    """Every tensor leaf of ``got`` equal to ``want``'s bit for bit, with
    the same dtype and shape (a NaN in a rejected step's history row
    matches the same NaN)."""
    assert bit_equal(got, want)


def _stepwise_and_eager(solve, *args):
    """(step-wise result, eager result, the step-wise call's counts, the
    eager call's counts)."""
    before = _build.snapshot()
    got = solve.stepwise(*args)
    mid = _build.snapshot()
    want = solve.eager(*args)
    return (got, want, _build.difference(before, mid),
            _build.difference(mid, _build.snapshot()))


@pytest.mark.parametrize("opts", [FIXED, EARLY, CAPPED],
                         ids=["fixed", "early_exit", "capped"])
def test_headline_stepwise_matches_eager(opts):
    """The headline at N = 40, float64: the step-wise replay order gives
    the eager loop's z and SolveStats bit for bit and the same launch
    counts (the plain CR versions on the CPU); the early-exit run stops
    before maxiter, the capped one (a tolerance not reached) at it."""
    prob, data, z0 = headline_problem(40, dtype=F64, device="cpu")
    solve = make_gn_solver(prob, SolverOptions(**opts))
    got, want, counts, eager_counts = _stepwise_and_eager(solve, z0, data)
    _assert_same(got, want)
    assert counts == eager_counts and counts
    its = int(got[1].iterations)
    assert its < opts["maxiter"] if opts is EARLY else its == opts["maxiter"]
    assert bool(got[1].converged) == (opts is EARLY)
    _assert_same(solve(z0, data), want)      # on the CPU: the eager loop


@pytest.mark.parametrize("layout", ["soa", "blocks"])
def test_config5_stepwise_matches_eager(layout):
    """Config 5 at 4 experiments x 10 elements, float64, 15 fixed-work
    iterations in each layout."""
    prob, z0, data, p_prior, p_w = build_config5_problem(4, 10, dtype=F64,
                                                         device="cpu")
    solve = make_multi_experiment_solver(
        prob, SolverOptions(maxiter=15, gtol=0.0, lam0=1e-6, lam_max=1e30),
        layout=layout)
    got, want, counts, eager_counts = _stepwise_and_eager(
        solve, z0, data, p_prior, p_w)
    _assert_same(got, want)
    assert counts == eager_counts and counts
    assert float(got[1].cost) < 0.1 * float(got[1].history[0, 0])


@pytest.mark.parametrize("layout", ["soa", "blocks"])
def test_config5_converging_stepwise_matches_eager(layout):
    """make_multi_experiment_solver with a tolerance (config 5 at 4
    experiments x 10 elements, float64, chip_smoke.py's converged options):
    the loop stops before maxiter, bit for bit the eager loop's, with the
    same launch counts."""
    prob, z0, data, p_prior, p_w = build_config5_problem(4, 10, dtype=F64,
                                                         device="cpu")
    solve = make_multi_experiment_solver(
        prob, SolverOptions(maxiter=60, gtol=1e-10, xtol=1e-12, lam0=1e-6,
                            lam_max=1e30), layout=layout)
    got, want, counts, eager_counts = _stepwise_and_eager(
        solve, z0, data, p_prior, p_w)
    _assert_same(got, want)
    assert counts == eager_counts and counts
    assert int(got[1].iterations) < 60 and bool(got[1].converged)


def test_newton_stepwise_matches_eager():
    """hessian='newton' (the trial cost a separate residual pass) on the
    headline at N = 40, float64, to convergence."""
    prob, data, z0 = headline_problem(40, dtype=F64, device="cpu")
    solve = make_gn_solver(prob, SolverOptions(maxiter=30, gtol=1e-10,
                                               hessian="newton"))
    got, want, counts, eager_counts = _stepwise_and_eager(solve, z0, data)
    _assert_same(got, want)
    assert counts == eager_counts


def test_mhe_stepwise_matches_eager():
    """examples/mhe_online.py's estimator, ten steps from its first window:
    the step's prelude and the window solve run step-wise on their static
    buffers give the eager step's state and estimate bit for bit."""
    mhe, _, ys = mhe_online_stream(F64, "cpu", samples=MHE_HORIZON + 10)
    first = mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2))
    a = b = first
    for k in range(MHE_HORIZON, MHE_HORIZON + 10):
        a, est_a = mhe._step(a, ys[k], None, mhe._advance_graph.stepwise,
                             mhe._solver.stepwise)
        b, est_b = mhe.step_eager(b, ys[k])
        _assert_same((a.z, a.m, a.P, a.y, a.u, est_a),
                     (b.z, b.m, b.P, b.y, b.u, est_b))
        assert a.k == b.k == k + 1
    c, est_c = mhe.step(first, ys[MHE_HORIZON])   # on the CPU: eager
    assert torch.isfinite(est_c).all()


def test_stepwise_matches_jax():
    """The step-wise run against the JAX package's make_gn_solver on
    tests/test_torch_newton.py's N = 40 Van der Pol problem, 15 fixed-work
    iterations, float64, at that file's bars: the accept column identical,
    the history cost within rtol 1e-8, V and p within rtol 1e-7."""
    tf, t_meas, y, u_fn = _vdp_data()
    jprob = JaxProblem.build(JaxVanDerPol(), jax_uniform_mesh(0.0, tf, 40, 4),
                             t_meas, defect_weight=30.0)
    tprob = EstimationProblem.build(VanDerPol(), uniform_mesh(0.0, tf, 40, 4),
                                    t_meas, defect_weight=30.0, device="cpu",
                                    dtype=F64)
    jdata = jprob.pack_data(y, t_meas,
                            u_nodes=u_fn(jprob.mesh.elem_times)[..., None],
                            meas_weight=1.0, p_prior=[1.0, 1.0], p_weight=1e-3)
    jz0 = jprob.initial_guess_from_data(t_meas, y, p0=[2.0, 0.3])
    tdata, tz0 = _carry(jdata, jz0)
    fixed = dict(maxiter=15, gtol=0.0, ftol=0.0, xtol=0.0)
    jz, jst = jax_make_gn_solver(jprob, JaxSolverOptions(**fixed))(jz0, jdata)
    tz, tst = make_gn_solver(tprob, SolverOptions(**fixed)).stepwise(tz0,
                                                                     tdata)
    jhist, thist = np.asarray(jst.history), tst.history.numpy()
    np.testing.assert_array_equal(thist[:, 4], jhist[:, 4])
    assert int(tst.iterations) == int(jst.iterations) == 15
    np.testing.assert_allclose(thist[:, 0], jhist[:, 0], rtol=1e-8)
    np.testing.assert_allclose(tz.V.numpy(), np.asarray(jz.V), rtol=1e-7,
                               atol=1e-7 * float(jnp.abs(jz.V).max()))
    np.testing.assert_allclose(tz.p.numpy(), np.asarray(jz.p), rtol=1e-7)


def test_a_second_call_leaves_the_first_result_alone():
    """The outputs are clones of the state buffers: a second call on the
    same plan (same shapes, another z0) leaves the first call's z and stats
    as they were and shares no storage with them.  Data of another shape
    (per-sample weights, as IRLS's later rounds pass) makes a second plan;
    a device with no CUDA graph raises."""
    prob, data, z0 = headline_problem(40, dtype=F64, device="cpu")
    solve = make_gn_solver(prob, SolverOptions(**FIXED))
    first = solve.stepwise(z0, data)
    kept = torch.utils._pytree.tree_map(torch.clone, first)
    second = solve.stepwise(Decision(V=z0.V * 1.01, p=z0.p * 0.9), data)
    assert len(solve._plans) == 1
    _assert_same(first, kept)
    assert not torch.equal(first[0].V, second[0].V)
    for a, b in zip(torch.utils._pytree.tree_flatten(first)[0],
                    torch.utils._pytree.tree_flatten(second)[0]):
        assert a.data_ptr() != b.data_ptr()
    per_sample = data._replace(
        meas_w=data.meas_w.expand(*prob.mmask.shape, 1).clone())
    _assert_same(solve.stepwise(z0, per_sample), first)
    assert len(solve._plans) == 2
    with pytest.raises(ValueError, match="meta"):
        solve.stepwise(*torch.utils._pytree.tree_map(
            lambda x: x.to("meta"), (z0, data)))


def _mhe_window(device="cpu"):
    """The estimator of examples/mhe_online.py and the (z0, data) of its
    first step's window solve."""
    mhe, _, ys = mhe_online_stream(F64, device, samples=MHE_HORIZON + 1)
    seen, solver = [], mhe._solver
    mhe._solver = lambda z0, data: seen.append((z0, data)) or solver(z0, data)
    mhe.step(mhe.init(ys[:MHE_HORIZON], m0=[1.5, 0.5], P0=np.eye(2)),
             ys[MHE_HORIZON])
    mhe._solver = solver
    return mhe, seen[0]


def _converging(case):
    """(solve, args) of a converging solve: the headline to gtol, config 5
    to gtol, the MHE window solve."""
    if case == "headline":
        prob, data, z0 = headline_problem(40, dtype=F64, device="cpu")
        return make_gn_solver(prob, SolverOptions(**EARLY)), (z0, data)
    if case == "config 5":
        prob, z0, data, p_prior, p_w = build_config5_problem(
            4, 10, dtype=F64, device="cpu")
        return make_multi_experiment_solver(
            prob, SolverOptions(maxiter=60, gtol=1e-10, xtol=1e-12,
                                lam0=1e-6, lam_max=1e30)), (z0, data,
                                                            p_prior, p_w)
    mhe, args = _mhe_window()
    return mhe._solver, args


@pytest.mark.parametrize("case", ["headline", "config 5", "mhe"])
def test_a_converging_stepwise_solve_reads_nothing_to_the_host(case):
    """A whole step-wise solve with a tolerance makes no read to the host
    (solve.graph.HostReads counts every _local_scalar_dense: .item(),
    bool(t), ...): the loop does not read done, and the steps' launch
    counts wait in a device counter until the counts are read.  It stops
    before maxiter and equals the eager loop, which reads done once an
    iteration."""
    solve, args = _converging(case)
    with graph.HostReads() as reads:
        got = solve.stepwise(*args)
    assert reads.count == 0
    with graph.HostReads() as eager_reads:
        want = solve.eager(*args)
    _assert_same(got, want)
    its = int(got[1].iterations)
    assert 0 < its < solve.maxiter
    assert eager_reads.count >= its


@pytest.mark.parametrize("case", ["headline", "config 5", "mhe"])
def test_captured_functions_make_no_host_traffic(case, monkeypatch):
    """Every function the graphs capture (the prelude, the step under the
    WHILE node, the loop's tally) runs under _NoHostTraffic, which refuses
    what a CUDA graph capture refuses, and gives the eager result."""
    plain_graph = graph._Plan.graph

    def guarded(plan, body):
        def run():
            with _NoHostTraffic():
                body()
        return plain_graph(plan, run)

    monkeypatch.setattr(graph._Plan, "graph", guarded)
    solve, args = _converging(case)
    _assert_same(solve.stepwise(*args), solve.eager(*args))


def test_device_tally_settles_when_counts_are_read():
    """A loop's steps are counted on the device: a _build.Tally holds the
    counter and one step's share; once marked pending the counts take share
    x (counter - steps already taken) at settle, which snapshot() runs and
    counts_held does not; a pending tally whose solver is gone still
    counts."""
    fake = _fake_wrapper()
    try:
        tally = _build.Tally(torch.zeros((), dtype=torch.int64),
                             {fake: (2, {(8, 3): 2})})
        tally.counter.add_(3)
        _build.pending(tally)
        assert fake.launches == 0
        with _build.counts_held():
            pass
        assert fake.launches == 0
        assert _build.snapshot()[fake] == (6, {(8, 3): 6})
        tally.counter.add_(1)
        _build.settle()
        assert fake.launches == 6          # not pending: not read
        _build.pending(tally)
        del tally
        _build.settle()
        assert fake.launches == 8 and fake.shapes == {(8, 3): 8}
        assert not _build._PENDING
    finally:
        _build.COUNTED[:] = [f for f in _build.COUNTED
                             if f.__name__ != "fake"]


def test_host_reads_counts_reads():
    """HostReads counts .item(), bool() and int() of a tensor, and nothing
    for work that stays on the device."""
    x = torch.arange(4.0)
    with graph.HostReads() as reads:
        y = (x * 2).sum()
        z = torch.where(y > 3, x, -x)
    assert reads.count == 0
    with graph.HostReads() as reads:
        y.item(), bool(y > 3), int(z[1])
    assert reads.count == 3


def _fake_wrapper():
    def fake(n, shape):
        _build.count_launches(fake, shape, n)
    _build.register(fake, shapes=True)
    return fake


def test_counts_held_and_replay_accounting():
    """counts_held leaves every count as it was and yields the block's
    share; add_counts adds that share once per replay; a function
    registered inside the block is reset to 0."""
    fake = _fake_wrapper()
    try:
        fake(2, (8, 3))
        before = _build.snapshot()
        with _build.counts_held() as share:
            fake(3, (8, 3))
            fake(1, (6, 1))
            late = _fake_wrapper()
            late(5, (8, 1))
        assert _build.snapshot() == {**before, late: (0, {})}
        assert share == {fake: (4, {(8, 3): 3, (6, 1): 1}),
                         late: (5, {(8, 1): 5})}
        for _ in range(3):           # three replays of a captured graph
            _build.add_counts(share)
        assert fake.launches == 2 + 3 * 4
        assert fake.shapes == {(8, 3): 2 + 9, (6, 1): 3}
        assert late.launches == 15 and late.shapes == {(8, 1): 15}
        assert _build.difference(before, _build.snapshot())[fake] == (
            12, {(8, 3): 9, (6, 1): 3})
    finally:
        _build.COUNTED[:] = [f for f in _build.COUNTED
                             if f.__name__ != "fake"]


def test_counts_held_restores_after_an_error():
    """A capture that raises leaves the counts as they were."""
    n = cr.cr_level_factor_ref.launches
    with pytest.raises(RuntimeError, match="capture failed"):
        with _build.counts_held():
            cr.cr_level_factor_ref.launches += 7
            raise RuntimeError("capture failed")
    assert cr.cr_level_factor_ref.launches == n


# Each LM step's device spans (their direct children of lm.step) by solver.
STEP_PARTS = {"headline": {"kkt": 1, "assemble": 1},
              "soa": {"kkt": 1, "shared": 1, "assemble": 1},
              "blocks": {"assemble": 2, "kkt": 1, "shared": 1}}


def _span_case(case):
    """(solve, args) at 3 fixed-work iterations: the headline at N = 40,
    config 5 at 4 x 10 in either layout."""
    opts = SolverOptions(maxiter=3, gtol=0.0, lam0=1e-6, lam_max=1e30)
    if case == "headline":
        prob, data, z0 = headline_problem(40, dtype=F64, device="cpu")
        return make_gn_solver(prob, opts), (z0, data)
    prob, z0, data, p_prior, p_w = build_config5_problem(4, 10, dtype=F64,
                                                         device="cpu")
    return (make_multi_experiment_solver(prob, opts, layout=case),
            (z0, data, p_prior, p_w))


@pytest.mark.parametrize("case", list(STEP_PARTS))
def test_device_spans_mark_each_lm_step(case):
    """With device marks on (on the CPU, host times at the marks' places),
    ``.stepwise`` and ``.eager`` each give one host ``solve`` span holding
    the prelude, one ``lm.step`` a step with its kkt / assemble / shared
    spans, and the solve's loads and outputs, every device span tied to its
    solve; the results equal those with recording off bit for bit, and
    marks on make a marked plan beside the unmarked one."""
    from collections import Counter

    from collocfem_tpu_torch.utils import profiling

    solve, args = _span_case(case)
    plain = solve.stepwise(*args), solve.eager(*args)
    with profiling.recording(device_marks=True) as rec:
        marked = solve.stepwise(*args), solve.eager(*args)
    _assert_same(marked, plain)
    assert len(solve._plans) == 2
    solves = [s for s in rec.spans if s.name == "solve"]
    assert len(solves) == 2 and not any(s.device for s in solves)
    for sv in solves:
        mine = [s for s in rec.spans if s.device and s.solve == sv.id]
        assert all(sv.start <= s.start <= s.end <= sv.end for s in mine)
        steps = [s for s in mine if s.name == "lm.step"]
        assert len(steps) == 3 and all(s.parent == sv.id for s in steps)
        for st in steps:
            assert Counter(s.name for s in mine if s.parent == st.id) == \
                STEP_PARTS[case]
        assert sum(s.name == "lm.prelude" for s in mine) >= 1
    stepwise = next(s for s in solves if any(
        c.name == "solve.outputs" and c.solve == s.id for c in rec.spans))
    assert stepwise.start < solves[1].start


def test_a_plan_counts_its_set_up_once():
    """The set-up counter moves at a key's first call (the plan's warm-up)
    and stays put at a second call of the same shapes; on the CPU nothing
    is captured.  The assembly counters count every assembly a call builds
    (on the CPU the element-level path's): the prelude's and one a step,
    and at the first call the plan's warm-up besides."""
    from collocfem_tpu_torch.utils import profiling

    assembly = ("assembly_fused", "assembly_generic")
    solve, args = _span_case("headline")
    before = profiling.counters()
    solve.stepwise(*args)
    first = profiling.counters()
    solve.stepwise(*args)
    second = profiling.counters()
    assert {k: v for k, v in second.items() if k not in assembly} == \
        {k: v for k, v in first.items() if k not in assembly}
    assert first["graph_setup_ns"] > before["graph_setup_ns"]
    assert first["graph_captures"] == before["graph_captures"]
    built = second["assembly_generic"] - first["assembly_generic"]
    assert built == 1 + 3
    assert first["assembly_generic"] - before["assembly_generic"] > built
    assert second["assembly_fused"] == before["assembly_fused"]
