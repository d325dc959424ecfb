"""Port parity, mesh functions and refinement: ``ops/mesh.py``'s
interpolation, prolongation and graded meshes, ``refine.py``'s indicator,
nested iteration and adaptive refinement, against ``collocfem_tpu`` in
float64 on the shapes of tests/test_refine.py's fast tier."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.ops import mesh as jax_mesh
from collocfem_tpu.problem import Decision as JaxDecision
from collocfem_tpu.problem import EstimationProblem as JaxProblem
from collocfem_tpu import refine as jax_refine
from collocfem_tpu.solve import SolverOptions as JaxSolverOptions
from collocfem_tpu.utils import rk4_trajectory
from collocfem_tpu_torch import refine
from collocfem_tpu_torch.convert import decision_from_numpy, mesh_from_numpy
from collocfem_tpu_torch.models import VanDerPol
from collocfem_tpu_torch.ops import mesh as port_mesh
from collocfem_tpu_torch.problem import EstimationProblem
from collocfem_tpu_torch.solve.newton import SolverOptions

MU, B, TF = 2.0, 0.0, 8.0
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def vdp_data():
    """tests/test_refine.py's relaxation oscillation, sampled at 200 times."""
    ts = np.linspace(0.0, TF, 20001)
    xs = rk4_trajectory(JaxVanDerPol().f, jnp.asarray([2.0, 0.0]), ts,
                        u_fn=lambda t: jnp.zeros(1), p=jnp.asarray([MU, B]))
    t_meas = np.linspace(0.02, TF - 0.02, 200)
    return t_meas, np.interp(t_meas, ts, np.asarray(xs[:, 0]))[:, None]


def _mesh_pair(n, degree, bp=None):
    jm = (jax_mesh.uniform_mesh(0.0, TF, n, degree) if bp is None else
          jax_mesh.Mesh(basis=jax_mesh.make_basis(degree), breakpoints=bp))
    return jm, mesh_from_numpy(jm.breakpoints, jm.degree)


def test_mesh_functions_match_jax():
    """interpolate_trajectory (values and d/dt), make_prolongation,
    refined_mesh and Mesh.t0 / tf on a graded degree-3 mesh: within 1e-12
    (float64)."""
    rng = np.random.default_rng(0)
    jm, tm = _mesh_pair(0, 3, bp=np.sort(np.r_[0.0, rng.uniform(0, TF, 9),
                                               TF]))
    V = rng.standard_normal((jm.num_nodes, 2))
    times = np.r_[rng.uniform(-0.5, TF + 0.5, 40), jm.node_times[:5]]
    want = jax_mesh.interpolate_trajectory(jm, jnp.asarray(V), times,
                                           derivative=True)
    got = port_mesh.interpolate_trajectory(tm, torch.as_tensor(V), times,
                                           derivative=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    fine_jm, fine_tm = _mesh_pair(23, 2)
    want = jax_mesh.make_prolongation(jm, fine_jm.node_times)(jnp.asarray(V))
    got = port_mesh.make_prolongation(tm, fine_tm.node_times,
                                      **F64)(torch.as_tensor(V))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    density = rng.uniform(0.1, 2.0, 10)
    want = jax_mesh.refined_mesh(0.0, TF, 17, 3, density)
    got = port_mesh.refined_mesh(0.0, TF, 17, 3, density)
    np.testing.assert_allclose(got.breakpoints, want.breakpoints, rtol=1e-14)
    assert (tm.t0, tm.tf) == (jm.t0, jm.tf) == (0.0, TF)
    with pytest.raises(ValueError, match="positive"):
        port_mesh.refined_mesh(0.0, TF, 5, 3, -density)


def test_defect_error_indicator_matches_jax(vdp_data):
    """The indicator at a perturbed trajectory on a degree-2 mesh: within
    1e-10 relative (float64)."""
    t_meas, y = vdp_data
    jm, tm = _mesh_pair(32, 2)
    jprob = JaxProblem.build(JaxVanDerPol(), jm, t_meas, defect_weight=300.0)
    tprob = EstimationProblem.build(VanDerPol(), tm, t_meas,
                                    defect_weight=300.0, **F64)
    V = np.stack([np.interp(jm.node_times, t_meas, y[:, 0]),
                  np.cos(jm.node_times)], axis=1)
    p = np.array([1.7, 0.1])
    want = jax_refine.defect_error_indicator(
        jprob, JaxDecision(V=jnp.asarray(V), p=jnp.asarray(p)))
    got = refine.defect_error_indicator(
        tprob, decision_from_numpy(V, p, "cpu", torch.float64))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_estimate_multilevel_matches_jax(vdp_data):
    """tests/test_refine.py's fast nested iteration (128 elements, degree
    2, two levels, maxiter 60): the same level sizes, and p at every level
    within 1e-7 relative of JAX's."""
    t_meas, y = vdp_data
    kw = dict(t0=0.0, tf=TF, num_elements=128, coarsen=4, levels=2,
              degree=2, defect_weight=300.0)
    fixed = dict(maxiter=60, gtol=1e-8, xtol=1e-10)
    *_, jhist = jax_refine.estimate_multilevel(
        JaxVanDerPol(), t_meas, y, [1.0, 0.0],
        options=JaxSolverOptions(**fixed), **kw)
    *_, thist = refine.estimate_multilevel(
        VanDerPol(), t_meas, y, [1.0, 0.0], options=SolverOptions(**fixed),
        **kw, **F64)
    assert [h[0].num_elements for h in thist] == [32, 128]
    for (tm, tp, _), (jm, jp, _) in zip(thist, jhist):
        np.testing.assert_array_equal(tm.breakpoints, jm.breakpoints)
        np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-7)


def test_estimate_adaptive_matches_jax(vdp_data):
    """tests/test_refine.py's fast adaptive run (32 degree-2 elements, two
    rounds, growth 1.6): the refined breakpoints within 1e-8, p within
    1e-7 relative and the max indicator within 1e-6 relative per round."""
    t_meas, y = vdp_data
    kw = dict(rounds=2, growth=1.6, defect_weight=300.0)
    fixed = dict(maxiter=80, gtol=1e-8, xtol=1e-10)
    jm, tm = _mesh_pair(32, 2)
    *_, jhist = jax_refine.estimate_adaptive(
        JaxVanDerPol(), jm, t_meas, y, [1.0, 0.0],
        options=JaxSolverOptions(**fixed), **kw)
    *_, thist = refine.estimate_adaptive(
        VanDerPol(), tm, t_meas, y, [1.0, 0.0],
        options=SolverOptions(**fixed), **kw, **F64)
    for (tmesh, tp, tind), (jmesh, jp, jind) in zip(thist, jhist):
        np.testing.assert_allclose(tmesh.breakpoints, jmesh.breakpoints,
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-7)
        np.testing.assert_allclose(tind, jind, rtol=1e-6)
    assert thist[-1][2] < 0.5 * thist[0][2]


def test_level_schedule_refuses_float32_past_the_chain_limit(monkeypatch,
                                                             vdp_data):
    """A float32 ladder whose fine level exceeds CR_DW_CHAIN raises before
    any level is built or solved (the JAX package's schedule would run the
    coarse levels first); in float64 the options are kept."""
    t_meas, y = vdp_data
    built = []
    monkeypatch.setattr(refine, "make_gn_solver",
                        lambda *a, **k: built.append(a))
    monkeypatch.setattr(refine.EstimationProblem, "build",
                        lambda *a, **k: built.append(a))
    with pytest.raises(ValueError, match="float64"):
        refine.estimate_multilevel(
            VanDerPol(), t_meas, y, [1.0, 0.0], t0=0.0, tf=TF,
            num_elements=refine.CR_DW_CHAIN, device="cpu",
            dtype=torch.float32)
    assert built == []
    opts = SolverOptions(maxiter=7)
    ns = [100, refine.CR_DW_CHAIN]
    assert refine.level_schedule(opts, ns, torch.float64) == [opts, opts]
    assert refine.level_schedule(opts, ns[:1], torch.float32) == [opts]
    with pytest.raises(ValueError, match="entries"):
        refine.level_schedule([opts], ns, torch.float64)


# ---- bench.py's converged ladder past CR_DW_CHAIN ---------------------------

def test_converged_schedule_is_bench_pys(monkeypatch):
    """Past CR_DW_CHAIN the schedule is bench.py:145-156's level by level,
    with float64 where the JAX package sets state_dw and cr_dw; below it the
    three uniform levels; the limit is read at each call."""
    from collocfem_tpu_torch.headline import converged_schedule

    def rows(levels):
        return [(lv.elements, lv.dtype, lv.options.maxiter, lv.options.lam0,
                 lv.options.gtol, lv.options.method, lv.options.state_dw)
                for lv in levels]

    f32, f64 = torch.float32, torch.float64
    assert rows(converged_schedule(100_000, f32)) == [
        (6250, f32, 60, 3e-6, 0.0, "auto", False),
        (6250, f64, 80, 1e-9, 0.0, "auto", False),
        (100_000, f64, 40, 1e-9, 0.0, "cr", False)]
    assert [r[1] for r in rows(converged_schedule(100_000, f64))] == [f64] * 3
    # Below the chain: refine.level_sizes, 'cr' past the TPU's fused kernel.
    for dtype in (f32, f64):
        assert rows(converged_schedule(20_000, dtype)) == [
            (1250, dtype, 60, 3e-6, 0.0, "auto", False),
            (5000, dtype, 30, 1e-9, 0.0, "auto", False),
            (20_000, dtype, 30, 1e-9, 0.0, "cr", False)]
    assert rows(converged_schedule(10_000, f32)) == [
        (625, f32, 60, 3e-6, 0.0, "auto", False),
        (2500, f32, 30, 1e-9, 0.0, "auto", False),
        (10_000, f32, 30, 1e-9, 0.0, "auto", False)]
    assert [r[0] for r in rows(converged_schedule(39_999, f32))] == [
        2500, 10_000, 39_999]
    assert [r[0] for r in rows(converged_schedule(40_000, f32))] == [
        2500, 2500, 40_000]
    monkeypatch.setattr(refine, "CR_DW_CHAIN", 100)
    assert rows(converged_schedule(160, f32)) == [
        (10, f32, 60, 3e-6, 0.0, "auto", False),
        (10, f64, 80, 1e-9, 0.0, "auto", False),
        (160, f64, 40, 1e-9, 0.0, "cr", False)]


# A ladder past a chain limit lowered to 8 blocks: 2 -> 2 -> 15 elements, the
# fine chain of 16 blocks one CR level deep (the JAX package's trace and
# compile of its cyclic reduction grow by ~15 s a level on the CPU).
DW_ELEMENTS, DW_CHAIN = 15, 8


def _jax_ladder_past_the_chain(dtype, dw):
    """The JAX package's bench.py:145-156 schedule at DW_ELEMENTS in
    ``dtype``: a cold level at max(2, DW_ELEMENTS // 16), a polish on the same mesh
    (warm-started from the cold solution as it is) and the fine level
    (through make_prolongation); with ``dw`` the polish carries state_dw
    and the fine level state_dw and method='cr_dw', as bench.py runs them.
    Returns (p, the fine level's V) in float64."""
    from baseline_cpu.run_baseline import TF as HTF, build_headline_problem
    from collocfem_tpu.solve.newton import make_gn_solver as jax_gn_solver

    _, t_meas, y, _ = build_headline_problem(DW_ELEMENTS)
    nc = max(2, DW_ELEMENTS // 16)
    tier = dict(state_dw=True) if dw else {}
    schedule = [
        (nc, dict(maxiter=60, lam0=3e-6)),
        (nc, dict(maxiter=80, lam0=1e-9, **tier)),
        (DW_ELEMENTS, dict(maxiter=40, lam0=1e-9,
                           **(dict(tier, method="cr_dw") if dw else {}))),
    ]
    z = prev = None
    for n, opts in schedule:
        mesh = jax_mesh.uniform_mesh(0.0, HTF, n, 4)
        prob = JaxProblem.build(JaxVanDerPol(), mesh, t_meas,
                                defect_weight=100.0, dtype=dtype)
        data = prob.pack_data(y, t_meas,
                              u_nodes=np.sin(0.9 * mesh.elem_times)[..., None])
        if z is None:
            z0 = prob.initial_guess_from_data(t_meas, y, p0=[0.5, 0.5])
        elif prev.num_elements == n:
            z0 = z
        else:
            z0 = JaxDecision(V=jax_mesh.make_prolongation(
                prev, mesh.node_times)(z.V).astype(prob.dtype), p=z.p)
        z, _ = jax_gn_solver(prob, JaxSolverOptions(gtol=0.0, **opts))(z0,
                                                                      data)
        prev = mesh
    return np.asarray(z.p, np.float64), np.asarray(z.V, np.float64)


def _port_ladder_past_the_chain(monkeypatch, dtype):
    from collocfem_tpu_torch.headline import ConvergedLadder

    monkeypatch.setattr(refine, "CR_DW_CHAIN", DW_CHAIN)
    ladder = ConvergedLadder(DW_ELEMENTS, device="cpu", dtype=dtype)
    assert [(lv.elements, lv.problem.dtype, lv.prolong is None)
            for lv in ladder.levels] == [
        (2, dtype, True), (2, torch.float64, True),
        (DW_ELEMENTS, torch.float64, False)]
    z, _ = ladder()
    assert z.p.dtype == torch.float64
    return z.p.numpy(), z.V.numpy()


def test_ladder_past_the_chain_matches_jax_in_float64(monkeypatch):
    """The port's float64 ladder through the branch past CR_DW_CHAIN
    (lowered to DW_CHAIN blocks in the port's refine, so N = 15 takes it: 2
    -> 2 -> 15 elements) against the JAX package's float64 run of the same
    three levels, which needs no double-word option: p within 1e-7
    relative, the fine level's V within 1e-7 of max |V|."""
    p, V = _port_ladder_past_the_chain(monkeypatch, torch.float64)
    jp, jV = _jax_ladder_past_the_chain(np.float64, dw=False)
    np.testing.assert_allclose(p, jp, rtol=1e-7)
    np.testing.assert_allclose(V, jV, rtol=0, atol=1e-7 * np.abs(jV).max())


def check_float64_levels_replace_the_double_word_tiers(monkeypatch):
    """The port's ladder past CR_DW_CHAIN as the main path runs it (float32
    cold level, float64 polish and fine level) against the JAX package's
    own schedule there: a float32 cold level, the polish with state_dw and
    the fine level with state_dw and method='cr_dw'.  The float64 levels
    take the double-word tiers' place: p within 1e-6 relative (3.2e-7
    measured at DW_ELEMENTS).  Not a Tier-1 test: the JAX package's trace
    and compile of its double-word solvers alone take ~34 s on 8 CPU cores;
    run it with ``PYTHONPATH=. python tests/test_torch_refine.py``.  Returns
    the relative deviation of p."""
    p, _ = _port_ladder_past_the_chain(monkeypatch, torch.float32)
    jp, _ = _jax_ladder_past_the_chain(np.float32, dw=True)
    np.testing.assert_allclose(p, jp, rtol=1e-6)
    return np.abs(p - jp) / np.abs(jp)


if __name__ == "__main__":
    import time

    import conftest  # noqa: F401  (the JAX package on the CPU, float64)

    with pytest.MonkeyPatch.context() as mp:
        start = time.perf_counter()
        dev = check_float64_levels_replace_the_double_word_tiers(mp)
    print(f"float64 levels against the double-word tiers at N = "
          f"{DW_ELEMENTS}: |p - p_jax| / |p_jax| = {dev.tolist()} (<= 1e-6), "
          f"{time.perf_counter() - start:.1f} s")
