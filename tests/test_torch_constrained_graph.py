"""The interior-point drivers captured (``solve.bounds.barrier_homotopy`` on
``solve.graph.CapturedOuterLoop``) on the CPU.

On a CUDA device ``make_bounded_solver`` and ``make_constrained_solver``
replay a prelude graph (the outer carry), for each barrier subproblem one
round graph (*begin*, the inner LM state; *step*, one ``lm_step``, under a
WHILE node on ``~done & (it < maxiter)``; *end*, the outer update), then a
*finish* graph.  Here, with no card, ``solve.stepwise`` runs the same
functions in replay order on the same static buffers (each inner step
``inner_maxiter`` times, a step after ``done`` leaving the state as it is),
and every case below holds it bit for bit
(``testing.bit_equal``) against the eager loop, with the same launch counts:
the bounded solver on an active parameter bound and on a state envelope,
the constrained solver on node constraints (``model.g``) and on a parameter
constraint, each on 'cr' and on 'spike' (on the CPU both run the plain
chain solves).  The problems are tests/test_torch_constrained.py's Van der
Pol set-ups at 20 elements of degree 2.  A recorder around ``lm_step``
shows which inner solves ended by gtol before their cap and which on a
railed damping.  One case holds the step-wise run against the JAX
package's bounded solver at tests/test_torch_constrained.py's tolerances,
and one runs every captured function under a dispatch mode that refuses a
read to the host and a copy from it, which a CUDA graph capture refuses.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from test_torch_constrained import (
    JaxVdPEnvelope,
    TF,
    VdPEnvelope,
    _hold,
    _setups,
    _truth,
)

from collocfem_tpu.solve import BoundedOptions as JaxBoundedOptions
from collocfem_tpu.solve import make_bounded_solver as jax_make_bounded_solver
from collocfem_tpu.solve import make_bounds as jax_make_bounds
from collocfem_tpu.solve import project_interior as jax_project_interior
from collocfem_tpu_torch.ops import _build
from collocfem_tpu_torch.solve import (
    BoundedOptions,
    ConstrainedOptions,
    bounds,
    graph,
    make_bounded_solver,
    make_bounds,
    make_constrained_solver,
    project_interior,
)
from collocfem_tpu_torch.testing import bit_equal

ELEMENTS, SAMPLES = 20, 40
MU_CAP, R2 = 0.8, 1.2
SHORT = dict(n_outer=5, inner_maxiter=12)
# lam_max = 1e-2 rails the fifth subproblem's damping after six rejected
# steps (the float64 merit cannot resolve the decrease there).
RAILED = dict(n_outer=6, inner_maxiter=30, lam_max=1e-2)


def _x_cap():
    y = _truth()(np.linspace(0.025, TF - 0.025, SAMPLES))[0]
    return 0.95 * float(np.max(np.abs(y)))


def _driver(case, method):
    """(solve, z0, data, options) of ``case`` on ``method``."""
    if case == "node constraints":
        x_cap = _x_cap()
        _, (prob, data, z0), _ = _setups(ELEMENTS, SAMPLES,
                                         JaxVdPEnvelope(x_cap),
                                         VdPEnvelope(x_cap), x_cap)
        opt = ConstrainedOptions(**SHORT, method=method)
        return make_constrained_solver(prob, opt), z0, data, opt
    _, (prob, data, z0), _ = _setups(ELEMENTS, SAMPLES)
    if case == "parameter constraint":
        opt = ConstrainedOptions(**SHORT, method=method)
        g_param = lambda p: torch.atleast_1d(torch.dot(p, p) - R2)
        return (make_constrained_solver(prob, opt, g_param=g_param), z0,
                data, opt)
    if case == "parameter bound":
        b = make_bounds(prob, p_lo=[0.0, None], p_hi=[MU_CAP, None])
        opt = BoundedOptions(**RAILED, method=method)
    else:
        x_cap = _x_cap()
        b = make_bounds(prob, x_lo=[-x_cap, None], x_hi=[x_cap, None])
        opt = BoundedOptions(**SHORT, method=method)
    return (make_bounded_solver(prob, b, opt), project_interior(z0, b), data,
            opt)


def _recorder(monkeypatch):
    """Patch the drivers' ``lm_step`` (the step-wise run's; the eager
    loop's is lm_core's own) to record each inner solve's exit: (reason,
    iterations), reason 'gtol' or 'railed'."""
    exits, lm_step = [], bounds.lm_step

    def recorded(st, trial_fn, *, gtol, lam_max, **kw):
        new = lm_step(st, trial_fn, gtol=gtol, lam_max=lam_max, **kw)
        if bool(new.done) and not bool(st.done):
            reason = ("railed" if float(new.lam) >= lam_max else
                      "gtol" if float(new.gnorm) < float(gtol) else "other")
            exits.append((reason, int(new.it)))
        return new

    monkeypatch.setattr(bounds, "lm_step", recorded)
    return exits


CASES = ["parameter bound", "state envelope", "node constraints",
         "parameter constraint"]


@pytest.mark.parametrize("method", ["cr", "spike"])
@pytest.mark.parametrize("case", CASES)
def test_stepwise_matches_eager(case, method, monkeypatch):
    """The step-wise replay order gives the eager loop's z and every stats
    field bit for bit, with the same launch counts; an inner solve ends by
    gtol before its cap, and on the parameter bound one ends on a railed
    damping."""
    solve, z0, data, opt = _driver(case, method)
    exits = _recorder(monkeypatch)
    before = _build.snapshot()
    got = solve.stepwise(z0, data)
    mid = _build.snapshot()
    want = solve.eager(z0, data)
    counts = _build.difference(before, mid)
    assert bit_equal(got, want)
    assert counts == _build.difference(mid, _build.snapshot()) and counts
    assert len(solve._plans) == 1
    assert any(r == "gtol" and it < opt.inner_maxiter for r, it in exits)
    if case == "parameter bound":
        assert any(r == "railed" for r, _ in exits)
    assert bit_equal(solve(z0, data), want)      # on the CPU: the eager loop


def test_a_second_call_leaves_the_first_result_alone():
    """A second step-wise call on the same plan (another z0) leaves the
    first call's outputs as they were and shares no storage with them."""
    solve, z0, data, _ = _driver("parameter constraint", "cr")
    first = solve.stepwise(z0, data)
    kept = torch.utils._pytree.tree_map(torch.clone, first)
    second = solve.stepwise(z0._replace(p=z0.p * 0.99), data)
    assert len(solve._plans) == 1
    assert bit_equal(first, kept) and not torch.equal(first[0].p,
                                                      second[0].p)
    for a, b in zip(tree_flatten(first)[0], tree_flatten(second)[0]):
        assert a.data_ptr() != b.data_ptr()


class _NoHostTraffic(TorchDispatchMode):
    """Raise at a read to the host (``.item()``, ``bool(t)``, indexing by a
    0-d tensor), at a tensor of one or more dimensions made from host data
    (``torch.tensor`` of a list), and at any use but a fill of a 0-d tensor
    made from a Python number (``torch.as_tensor(x, device=...)`` or ``t[i]
    = True``: on a CUDA device a copy from the host).  Such a number filled
    into a larger tensor (``t[i, :] = 1.0``) passes: on a CUDA device that
    is a fill."""

    def __init__(self):
        super().__init__()
        self._lifted = {}

    def _is_lifted(self, x):
        return torch.is_tensor(x) and self._lifted.get(
            id(x), lambda: None)() is x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten._local_scalar_dense.default
                or (func is torch.ops.aten.lift_fresh.default
                    and args[0].dim() > 0)
                or (func is not torch.ops.aten.fill_.Tensor
                    and any(map(self._is_lifted,
                                tree_flatten((args, kwargs))[0])))):
            raise RuntimeError(f"{func} inside a captured function")
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.lift_fresh.default:
            self._lifted[id(out)] = weakref.ref(out)
        return out


@pytest.mark.parametrize("case", ["parameter bound", "parameter constraint"])
def test_a_converging_stepwise_solve_reads_nothing_to_the_host(case):
    """A whole step-wise barrier homotopy makes no read to the host
    (solve.graph.HostReads): no inner loop reads ``done``; the eager loop
    reads it before every inner step."""
    solve, z0, data, _ = _driver(case, "cr")
    with graph.HostReads() as reads:
        got = solve.stepwise(z0, data)
    assert reads.count == 0
    with graph.HostReads() as eager_reads:
        want = solve.eager(z0, data)
    assert bit_equal(got, want)
    assert eager_reads.count >= int(got[1].history[:, 3].sum())


@pytest.mark.parametrize("case", ["parameter bound", "node constraints"])
def test_captured_functions_make_no_host_traffic(case, monkeypatch):
    """Every function the graphs capture (prelude, begin, step, end,
    finish) runs under _NoHostTraffic and gives the eager result: what a
    CUDA graph capture would refuse does not occur in them."""
    plain_graph = graph._Plan.graph

    def guarded(plan, body):
        def run():
            with _NoHostTraffic():
                body()
        return plain_graph(plan, run)

    monkeypatch.setattr(graph._Plan, "graph", guarded)
    solve, z0, data, _ = _driver(case, "spike")
    assert bit_equal(solve.stepwise(z0, data), solve.eager(z0, data))


def test_stepwise_matches_jax():
    """The step-wise bounded solve of the parameter bound against the JAX
    package's make_bounded_solver (method='cr'), at
    tests/test_torch_constrained.py's tolerances: the first three outer
    rounds' estimation cost within 1e-9, p within 1e-6, the final cost
    within 1e-9."""
    opts = dict(n_outer=6, inner_maxiter=30)
    (jprob, jdata, jz0), (prob, data, z0), _ = _setups(ELEMENTS, SAMPLES)
    jb = jax_make_bounds(jprob, p_lo=[0.0, None], p_hi=[MU_CAP, None])
    jz, jst = jax_make_bounded_solver(jprob, jb, JaxBoundedOptions(
        **opts, method="cr"))(jax_project_interior(jz0, jb), jdata)
    b = make_bounds(prob, p_lo=[0.0, None], p_hi=[MU_CAP, None])
    z, st = make_bounded_solver(prob, b, BoundedOptions(**opts)).stepwise(
        project_interior(z0, b), data)
    _hold(z, st, jz, jst)
    assert 0.0 < MU_CAP - float(z.p[0]) < 1e-4
