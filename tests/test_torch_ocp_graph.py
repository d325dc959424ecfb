"""The AL + barrier OCP driver captured (``solve.auglag.make_ocp_solver`` on
``solve.graph.CapturedOuterLoop``) on the CPU.

On a CUDA device ``make_ocp_solver`` replays a prelude graph (the outer
carry: z, the multipliers, rho, mu, the warm-start damping, the last
violation, the history and the outer index), for each AL round one round
graph (*begin*, the inner LM state; *step*, one decrease-mode ``lm_step``,
under a WHILE node on ``~done & (it < maxiter)``; *end*, the multiplier,
history, rho and mu updates), then a *finish* graph.  Here, with no card,
``solve.stepwise`` runs the same functions in replay order on the same
static buffers (each inner step ``inner_maxiter`` times, a step after
``done`` leaving the state as it is), and
every case below holds it bit for bit (``testing.bit_equal``) against the
eager loop, with the same launch counts: config 3 (the pendulum swing-up)
on 8 elements in both dtypes, the free-time double integrator of
tests/test_torch_ocp.py (N = 8, the horizon the one parameter) and the
split actuator (b = 16, an equality path constraint, no inequality), each
on 'cr' and on 'spike' (on the CPU both run the plain chain solves).  A
recorder around ``lm_step`` shows that inner solves end both by gtol before
their cap and at the cap.  One case holds the step-wise config 3 solve at N
= 25 against the JAX package's, at tests/test_torch_ocp.py's tolerances,
and says where its inner iterations differ from JAX's; others run every
captured function under a dispatch mode that refuses a read to the host and
a copy from it, which a CUDA graph capture refuses.
"""

import dataclasses

import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from test_torch_constrained_graph import _NoHostTraffic
from test_torch_ocp import _close, pendulum_jax  # noqa: F401

from collocfem_tpu_torch import configs
from collocfem_tpu_torch.ocp_time import free_time_ocp
from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.solve import auglag, graph
from collocfem_tpu_torch.solve.auglag import ALBarrierOptions, make_ocp_solver
from collocfem_tpu_torch.testing import bit_equal

F64 = torch.float64
# Config 3 on 8 elements: six AL rounds of at most 20 inner iterations (in
# float64 the third and fourth end by gtol, the rest at the cap).
SHORT3 = dict(n_outer=6, inner_maxiter=20)


def _driver(case, method, dtype=F64, **short):
    """(solve, z0, options) of ``case`` on ``method``; ``short`` overrides
    options."""
    if case == "config 3":
        prob, z0 = configs.build_config3_problem(8, dtype=dtype,
                                                 device="cpu")
        opt = ALBarrierOptions(**SHORT3, method=method)
    elif case == "free time":
        prob, _ = free_time_ocp(configs.DoubleIntegrator(), 8, 4,
                                x0=[0.0, 0.0], xf=[1.0, 0.0], tf_ref=3.0,
                                time_weight=1.0, dtype=dtype, device="cpu")
        z0 = prob.initial_guess()
        opt = ALBarrierOptions(n_outer=16, method=method)
    else:
        prob, z0 = configs.build_split_actuator_problem(4, dtype=dtype,
                                                        device="cpu")
        opt = ALBarrierOptions(n_outer=16, method=method)
    opt = dataclasses.replace(opt, **short)
    return make_ocp_solver(prob, opt), z0, opt


def _recorder(monkeypatch):
    """Patch the driver's ``lm_step`` (the step-wise run's; the eager
    loop's is lm_core's own) to record each inner solve's early exit:
    (reason, iterations), reason 'gtol' or 'other' (a step below xtol or a
    railed damping)."""
    exits, lm_step = [], auglag.lm_step

    def recorded(st, trial_fn, *, gtol, **kw):
        new = lm_step(st, trial_fn, gtol=gtol, **kw)
        if bool(new.done) and not bool(st.done):
            reason = "gtol" if float(new.gnorm) < float(gtol) else "other"
            exits.append((reason, int(new.it)))
        return new

    monkeypatch.setattr(auglag, "lm_step", recorded)
    return exits


CASES = [("config 3", F64, "cr"), ("config 3", F64, "spike"),
         ("config 3", torch.float32, "spike"), ("free time", F64, "cr"),
         ("free time", F64, "spike"), ("split actuator", F64, "cr"),
         ("split actuator", F64, "spike")]


@pytest.mark.parametrize("case, dtype, method", CASES)
def test_stepwise_matches_eager(case, dtype, method, monkeypatch):
    """The step-wise replay order gives the eager loop's z and every
    OCPStats field (objective, cviol, gviol, grad_norm, history,
    multipliers, mu) bit for bit, with the same launch counts (on 'spike'
    the chain's plain version once per inner iteration: #2's at nq = 0,
    #1's with the free horizon); in float64 inner solves end by gtol
    before their cap, and on config 3 others run to it."""
    solve, z0, opt = _driver(case, method, dtype)
    exits = _recorder(monkeypatch)
    before = _build.snapshot()
    got = solve.stepwise(z0)
    mid = _build.snapshot()
    want = solve.eager(z0)
    counts = _build.difference(before, mid)
    assert bit_equal(got, want)
    assert counts == _build.difference(mid, _build.snapshot())
    assert len(solve._plans) == 1
    inner = [int(i) for i in got[1].history[:, 4]]
    if method == "spike":
        assert {fn.__name__: n for fn, (n, _) in counts.items()} == {
            ("kkt_solve_spike_fused_ref" if case == "free time" else
             "blocktri_solve_spike_fused_ref"): sum(inner)}
    cap = opt.inner_maxiter
    assert [i for _, i in exits if i < cap] == [i for i in inner if i < cap]
    assert any(r == "gtol" and i < cap for r, i in exits) or \
        dtype == torch.float32
    if case == "config 3":
        assert cap in inner
    assert bit_equal(solve(z0), want)      # on the CPU: the eager loop


def test_a_second_call_leaves_the_first_result_alone():
    """A second step-wise call on the same plan (another z0) leaves the
    first call's outputs as they were, shares no storage with them (the
    empty p and path_eq multipliers have none) and gives the eager
    result."""
    solve, z0, _ = _driver("split actuator", "spike")
    first = solve.stepwise(z0)
    kept = tree_map(torch.clone, first)
    second = solve.stepwise(z0._replace(V=z0.V * 0.9))
    assert len(solve._plans) == 1
    assert bit_equal(first, kept) and not torch.equal(first[0].V,
                                                      second[0].V)
    for a, b in zip(tree_flatten(first)[0], tree_flatten(second)[0]):
        assert a.data_ptr() != b.data_ptr() or not a.numel()
    assert bit_equal(second, solve.eager(z0._replace(V=z0.V * 0.9)))


def test_a_converging_stepwise_solve_reads_nothing_to_the_host():
    """A whole step-wise AL homotopy (config 3, six rounds, the third and
    fourth ending by gtol) makes no read to the host
    (solve.graph.HostReads): no inner loop reads ``done``; the eager loop
    reads it before every inner step."""
    solve, z0, _ = _driver("config 3", "spike")
    with graph.HostReads() as reads:
        got = solve.stepwise(z0)
    assert reads.count == 0
    with graph.HostReads() as eager_reads:
        want = solve.eager(z0)
    assert bit_equal(got, want)
    assert eager_reads.count >= int(got[1].history[:, 4].sum())


@pytest.mark.parametrize("case", ["config 3", "free time", "split actuator"])
def test_captured_functions_make_no_host_traffic(case, monkeypatch):
    """Every function the graphs capture (prelude, begin, step, end,
    finish: the assembly, the merit, the line search, the constraints and
    the objective) runs under _NoHostTraffic and gives the eager result:
    what a CUDA graph capture would refuse does not occur in them (three
    AL rounds: nothing in them branches on a value).  Config
    3 has a torque bound g <= 0 and no parameter, the free-time OCP the
    torque bound, the horizon's bracket and the horizon as a parameter; the
    split actuator has no g (the line search's alpha0 = 1 from a constant)
    and an equality path constraint."""
    plain_graph = graph._Plan.graph

    def guarded(plan, body):
        def run():
            with _NoHostTraffic():
                body()
        return plain_graph(plan, run)

    monkeypatch.setattr(graph._Plan, "graph", guarded)
    solve, z0, _ = _driver(case, "spike", n_outer=3)
    assert bit_equal(solve.stepwise(z0), solve.eager(z0))


def test_stepwise_matches_jax(pendulum_jax):
    """The step-wise config 3 solve (N = 25, float64, 14 AL rounds, 'cr')
    against the JAX package's make_ocp_solver at tests/test_torch_ocp.py's
    tolerances (_hold_solve's): the objective and cviol of the first three
    rounds within 1e-9 (relative), the final objective and V within 1e-6;
    feasible with the torque bound active.  The inner iterations of the AL
    rounds are not held to JAX's: with the float64 trial cost (JAX's is
    double-word) rounds 8 and 14 take 22 and 19 where JAX's take 21 and 16,
    412 in all against 408."""
    V, _, hist, jst = pendulum_jax
    prob, z0 = configs.build_config3_problem(25, dtype=F64, device="cpu")
    z, st = make_ocp_solver(prob, ALBarrierOptions(method="cr")).stepwise(z0)
    _close(st.history[:3, :2], hist[:3, :2], 1e-9)
    _close(st.objective, jst.objective, 1e-6)
    _close(z.V, V, 1e-6)
    assert float(st.cviol) < 1e-8 and float(st.gviol) < 0
    assert 2.0 - 1e-2 < float(z.V[:, 2].abs().max()) <= 2.0 + 1e-6
