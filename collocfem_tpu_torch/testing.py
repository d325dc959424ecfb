"""Seeded inputs, set-ups and residual checks shared by the port's tests and
``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA


def random_kkt_system(k: int, b: int, nq: int, seed: int, *,
                      dtype=torch.float64, device="cpu") -> BlockTriSystemSoA:
    """A seeded SPD bordered system in SoA layout.

    The chain blocks are diagonally dominant and the parameter corner
    dominates the Schur term B^T A^-1 B, so every damped system is positive
    definite.  Drawn in float64 with numpy, then cast.
    """
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, b, b))
    D = np.moveaxis(m @ m.transpose(0, 2, 1) + 2 * b * np.eye(b), 0, -1)
    m2 = rng.standard_normal((nq, nq))
    arrays = dict(D=D, E=0.3 * rng.standard_normal((b, b, k)),
                  B=rng.standard_normal((b, nq, k)),
                  C=m2 @ m2.T + 2 * b * k * np.eye(nq),
                  gx=rng.standard_normal((b, k)),
                  gp=rng.standard_normal(nq))
    return BlockTriSystemSoA(**{
        name: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                              device=device)
        for name, a in arrays.items()})


def random_chain(k: int, b: int, r: int, seed: int, *, boundary=None,
                 dtype=torch.float64, device="cpu"):
    """A seeded SPD block-tridiagonal chain in SoA layout: (D, E (b, b, K),
    G (b, r, K)).  With ``boundary`` every boundary-th coupling is exactly
    zero, as at the experiment boundaries of a concatenated chain."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, b, b))
    D = m @ m.transpose(0, 2, 1) + 2 * b * np.eye(b)
    E = 0.3 * rng.standard_normal((k, b, b))
    if boundary:
        E[boundary - 1::boundary] = 0.0
    G = rng.standard_normal((k, b, r))
    return tuple(torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)),
                                 dtype=dtype, device=device) for a in (D, E, G))


def random_chain_batch(n_exp: int, k: int, b: int, r: int, seed: int, *,
                       dtype=torch.float64, device="cpu"):
    """A seeded batch of SPD chains in block-major layout: (D, E
    (n_exp, K, b, b), G (n_exp, K, b, r))."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n_exp, k, b, b))
    D = m @ m.transpose(0, 1, 3, 2) + 4 * b * np.eye(b)
    E = 0.3 * rng.standard_normal((n_exp, k, b, b))
    G = rng.standard_normal((n_exp, k, b, r))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (D, E, G))


def chain_residual(D, E, G, X) -> float:
    """||A X - G||_inf / ||G||_inf in float64 for an SoA chain (E[..., K-1]
    ignored)."""
    D, E, G, X = (a.double() for a in (D, E, G, X))
    e = E[..., :-1]
    AX = torch.einsum("ijk,jrk->irk", D, X)
    AX[..., :-1] += torch.einsum("ijk,jrk->irk", e, X[..., 1:])
    AX[..., 1:] += torch.einsum("jik,jrk->irk", e, X[..., :-1])
    return float((AX - G).abs().max() / G.abs().max())


def kkt_residual(sys_, dx, dp, lam, dmax) -> float:
    """Relative x-block residual ||(A + lam_abs I) dx + B dp + gx||_inf /
    ||gx||_inf of the damped system (lam_abs = lam dmax), in float64."""
    D, E, B, _, gx, _ = (a.double() for a in sys_)
    dx, dp = dx.double(), dp.double()
    lam_abs = float(lam) * float(dmax)
    E = E[..., :-1]                            # E[..., K-1] is unused
    y = torch.einsum("ijk,jk->ik", D, dx) + lam_abs * dx
    y[:, :-1] += torch.einsum("ijk,jk->ik", E, dx[:, 1:])
    y[:, 1:] += torch.einsum("jik,jk->ik", E, dx[:, :-1])
    y += torch.einsum("iqk,q->ik", B, dp) + gx
    return float(y.abs().max() / gx.abs().max())


def rel_err(x, want) -> float:
    """max|x - want| / max|want|, in float64."""
    x, want = x.double(), want.double()
    return float((x - want).abs().max() / want.abs().max())


def cr_level_comparison(Ds, Es, Gs, Gs_level=None):
    """Every CR kernel, its plain version and the plain version in float64
    on one level's inputs (Ds, Es (b, b, m), Gs (b, r, m)).

    Returns {kernel name: (kernel outputs, plain outputs, float64 plain
    outputs)}, each a list of tensors.  The apply kernel reduces Gs through
    the factor kernel's own output, its plain version through the plain
    factor; the back-substitution takes g_new as x_even; the fused level
    takes ``Gs_level`` (default Gs).
    """
    from collocfem_tpu_torch.ops import cr

    out = {}
    (dn, en), fac = cr.cr_level_factor(Ds, Es)
    (dn_p, en_p), fac_p = cr.cr_level_factor_ref(Ds, Es)
    (dn_x, en_x), fac_x = cr.level_factor_plain(Ds.double(), Es.double())
    out["cr_level_factor"] = tuple(
        [d, e, f.L, f.s_up, f.s_lo] for d, e, f in
        ((dn, en, fac), (dn_p, en_p, fac_p), (dn_x, en_x, fac_x)))
    applied = (cr.cr_level_apply(fac, Gs), cr.cr_level_apply_ref(fac_p, Gs),
               cr.level_apply_plain(fac_x, Gs.double()))
    out["cr_level_apply"] = tuple(list(a) for a in applied)
    Gl = Gs if Gs_level is None else Gs_level
    levels = (cr.cr_level(Ds, Es, Gl), cr.cr_level_ref(Ds, Es, Gl),
              cr.level_plain(Ds.double(), Es.double(), Gl.double()))
    out["cr_level"] = tuple(list(a) + list(s) for a, s in levels)
    x_even = applied[1][0].contiguous()
    out["cr_backsub"] = (
        [cr.cr_backsub(x_even, fac.s_up, fac.s_lo, applied[0][1])],
        [cr.cr_backsub_ref(x_even, fac_p.s_up, fac_p.s_lo, applied[1][1])],
        [cr.backsub_plain(x_even.double(), fac_x.s_up, fac_x.s_lo,
                          applied[2][1])])
    return out


def level_bar(got, want, exact) -> tuple[bool, float]:
    """The bar a CR kernel's outputs must meet on one level.  float64: every
    output within 1e-9 (relative) of the plain version's.  float32: every
    output's error against the float64 plain level at most 10x the plain
    version's (taken as at least one float32 epsilon).  Returns (ok, the
    worst ratio of error to allowance)."""
    worst = 0.0
    for g, w, x in zip(got, want, exact):
        if g.dtype == torch.float64:
            ratio = rel_err(g, w) / 1e-9
        else:
            allowed = 10.0 * max(rel_err(w, x), torch.finfo(g.dtype).eps)
            ratio = rel_err(g, x) / allowed
        worst = max(worst, ratio)
    return worst <= 1.0, worst


def batch_residual(D, E, G, X) -> float:
    """||A X - G||_inf / ||G||_inf in float64 over a block-major batch of
    chains (E[:, K-1] ignored)."""
    D, E, G, X = (a.double() for a in (D, E, G, X))
    AX = D @ X
    AX[:, :-1] += E[:, :-1] @ X[:, 1:]
    AX[:, 1:] += E[:, :-1].mT @ X[:, :-1]
    return float((AX - G).abs().max() / G.abs().max())


def bits(x):
    """A tensor's bit pattern: a float tensor viewed as integers of its
    width, so that ``torch.equal`` on it is bit-for-bit equality in which a
    NaN matches the same NaN (``torch.equal`` on floats says NaN != NaN)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def bit_equal(a, b) -> bool:
    """Whether two pytrees of tensors have the same structure and every
    leaf the same dtype, shape and bits (:func:`bits`)."""
    from torch.utils._pytree import tree_flatten

    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


# examples/mhe_online.py's stream: Van der Pol with p = [1, 1] from x0 = [2,
# 0], sampled every MHE_DT, position measured with noise MHE_SIG_V.
MHE_DT, MHE_HORIZON, MHE_SIG_V, MHE_SIG_W, MHE_SAMPLES = 0.05, 12, 0.02, 0.5, 240


def mhe_online_stream(dtype, device, samples: int = MHE_SAMPLES):
    """examples/mhe_online.py's estimator and stream: Van der Pol with p
    fixed at [1, 1], horizon 12, dt 0.05, degree 3 (b = 6), sig_w 0.5,
    sig_v 0.02, maxiter 20, gtol 1e-9, 'auto'.  The RK4 truth from [2, 0]
    and the noise of default_rng(0) are made on the host in float64.
    Returns (mhe, truth (samples, 2), ys (samples, 1))."""
    from collocfem_tpu_torch.mhe import MovingHorizonEstimator
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.solve.newton import SolverOptions
    from collocfem_tpu_torch.utils.simulate import rk4_trajectory

    rng = np.random.default_rng(0)
    ts = np.arange(samples) * MHE_DT
    model = VanDerPol()
    f64 = torch.float64
    xs = rk4_trajectory(model.f, torch.tensor([2.0, 0.0], dtype=f64), ts,
                        u_fn=lambda t: torch.zeros(1, dtype=f64),
                        p=[1.0, 1.0], device="cpu").numpy()
    ys = xs[:, :1] + MHE_SIG_V * rng.standard_normal((samples, 1))
    mhe = MovingHorizonEstimator(
        model, horizon=MHE_HORIZON, dt=MHE_DT, sig_w=MHE_SIG_W,
        sig_v=MHE_SIG_V, degree=3, p_fixed=np.array([1.0, 1.0]),
        options=SolverOptions(maxiter=20, gtol=1e-9), device=device,
        dtype=dtype)
    return mhe, xs, ys


# ---- worlds of ranks: the sharded solvers' runs -------------------------------
#
# A gloo world of spawned processes runs a list of cases, each a (name,
# function, kwargs) with a module-level function below; each rank saves its
# results, which run_world returns in rank order.  The children import this
# module and torch only.  Specs are plain dicts of numpy arrays and numbers.


def shard_interior_chain(Ds, Es, G, sp: int, j: int):
    """The interior chain that rank ``j`` of ``sp`` solves in
    ``parallel.spike.blocktri_solve_spike``, taken from a global SoA chain
    (Ds, Es (b, b, K), G (b, r, K)): blocks j m + 1 .. (j + 1) m - 2 against
    [G | U | V] (r + 2 b columns, U = E[j m]^T at the first block, V =
    E[(j + 1) m - 2] at the last).  Returns SoA (D, E, rhs), contiguous."""
    b, _, K = Ds.shape
    m = K // sp
    lo, hi = j * m + 1, (j + 1) * m - 1
    U = Ds.new_zeros((b, b, hi - lo))
    V = torch.zeros_like(U)
    U[..., 0] = Es[..., lo - 1].T
    V[..., -1] = Es[..., hi - 1]
    return (Ds[..., lo:hi].contiguous(), Es[..., lo:hi].contiguous(),
            torch.cat([G[..., lo:hi], U, V], dim=1).contiguous())


def estimation_inputs(spec: dict, *, dtype, device):
    """(prob, z0, data) of one Van der Pol estimation: ``{"kind":
    "headline", "elements": N}`` (``headline.headline_problem``) or
    ``{"kind": "vdp", "breakpoints", "degree", "t_meas", "y", "u_nodes",
    "defect_weight", "p0"}``."""
    from collocfem_tpu_torch.headline import headline_problem
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.ops.basis import make_basis
    from collocfem_tpu_torch.ops.mesh import Mesh
    from collocfem_tpu_torch.problem import EstimationProblem

    if spec["kind"] == "headline":
        prob, data, z0 = headline_problem(spec["elements"], dtype=dtype,
                                          device=device)
        return prob, z0, data
    mesh = Mesh(basis=make_basis(spec["degree"]),
                breakpoints=np.asarray(spec["breakpoints"]))
    prob = EstimationProblem.build(VanDerPol(), mesh, spec["t_meas"],
                                   defect_weight=spec["defect_weight"],
                                   device=device, dtype=dtype)
    data = prob.pack_data(spec["y"], spec["t_meas"], u_nodes=spec["u_nodes"])
    return prob, prob.initial_guess_from_data(spec["t_meas"], spec["y"],
                                              p0=spec["p0"]), data


GN_REFERENCE_LEAVES = ("D", "E", "B", "C", "gx", "gp", "cost")


def stored_assembly_case(arrays, case: str, *, dtype, device):
    """One case of a stored reference of the one-experiment assembly
    (``arrays``: a mapping with keys ``<case>.<name>``, as
    ``tests/data/gn_assembly_jax.npz`` holds them): Van der Pol on a uniform
    mesh (``tf``, ``elements``, ``degree``; ``full``: the 'full' defect
    rule), its samples ``t_meas``, ``y``, ``u_nodes``, the weights
    ``defect_weight``, ``meas_w`` (shared (ny,) or per-sample (N, S, ny)),
    the priors ``p_prior``, ``p_w``, ``x0_prior``, ``x0_w`` (per-state or a
    full matrix) and the iterate ``V``, ``p``.  Returns ((prob, z, data)
    built by the port, {leaf: the stored float64 value} for
    GN_REFERENCE_LEAVES)."""
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.ops.mesh import uniform_mesh
    from collocfem_tpu_torch.problem import Decision, EstimationProblem

    a = {k.split(".", 1)[1]: np.asarray(v) for k, v in arrays.items()
         if k.startswith(case + ".")}
    mesh = uniform_mesh(0.0, float(a["tf"]), int(a["elements"]),
                        int(a["degree"]))
    prob = EstimationProblem.build(
        VanDerPol(), mesh, a["t_meas"],
        defect_weight=float(a["defect_weight"]), device=device, dtype=dtype,
        defect_rule="full" if int(a["full"]) else "interior")
    data = prob.pack_data(a["y"], a["t_meas"], u_nodes=a["u_nodes"],
                          p_prior=a["p_prior"], p_weight=a["p_w"],
                          x0_prior=a["x0_prior"], x0_weight=a["x0_w"])
    data = data._replace(meas_w=torch.as_tensor(a["meas_w"], dtype=dtype,
                                                device=device))
    z = Decision(V=torch.as_tensor(a["V"], dtype=dtype, device=device),
                 p=torch.as_tensor(a["p"], dtype=dtype, device=device))
    return (prob, z, data), {k: a[k] for k in GN_REFERENCE_LEAVES}


def batch_inputs(spec: dict, *, dtype, device):
    """(prob, z0, data_batch, p_prior, p_w) of a Van der Pol batch:
    ``{"kind": "config5", "n_exp", "elements"}``
    (``batched.build_config5_problem``) or ``{"kind": "vdp_batch",
    "breakpoints", "degree", "t_meas", "y" (E, S, 1), "u_nodes" (E, N, d+1,
    1), "defect_weight", "p0", "p_prior", "p_w"}`` (each experiment's
    initial guess from its data with p0 = 0, no per-experiment prior)."""
    from collocfem_tpu_torch.batched import build_config5_problem, stack_data
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.ops.basis import make_basis
    from collocfem_tpu_torch.ops.mesh import Mesh
    from collocfem_tpu_torch.parallel.batch import BatchDecision
    from collocfem_tpu_torch.problem import EstimationProblem

    if spec["kind"] == "config5":
        return build_config5_problem(spec["n_exp"], spec["elements"],
                                     dtype=dtype, device=device)
    mesh = Mesh(basis=make_basis(spec["degree"]),
                breakpoints=np.asarray(spec["breakpoints"]))
    t, y = spec["t_meas"], spec["y"]
    prob = EstimationProblem.build(VanDerPol(), mesh, t,
                                   defect_weight=spec["defect_weight"],
                                   device=device, dtype=dtype)
    data = stack_data([prob.pack_data(y[e], t, u_nodes=spec["u_nodes"][e],
                                      p_weight=0.0) for e in range(len(y))])
    V0 = torch.stack([prob.initial_guess_from_data(t, y[e], p0=[0, 0]).V
                      for e in range(len(y))])
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return (prob, BatchDecision(V=V0, p=as_t(spec["p0"])), data,
            as_t(spec["p_prior"]), as_t(spec["p_w"]))


def _host(tree):
    """A result pytree with every tensor on the host; NamedTuples become
    dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if hasattr(tree, "_asdict"):
        return {k: _host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (tuple, list)):
        return [_host(v) for v in tree]
    return tree


def _traffic(device):
    """``solve.graph.HostReads`` that also counts the all-reduces
    (``c10d.allreduce_``) of the block in ``all_reduces``: on the CPU it
    counts every read (what would be a read on the card), on a CUDA device
    the reads of CUDA tensors."""
    from collocfem_tpu_torch.solve.graph import HostReads

    class Traffic(HostReads):
        all_reduces = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.c10d.allreduce_.default:
                self.all_reduces += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Traffic(None if torch.device(device).type == "cpu" else "cuda")


def _counted(run, device, traffic=False):
    """Run ``run()`` with the kernel counts read just before and just after.
    Returns {"out": its result on the host, "wall": seconds, "counts":
    {function name: (calls, {shape: n})}} (kernel wrappers and plain
    versions that ran); with ``traffic`` also "host_reads" and
    "all_reduces", the run's reads to the host and all-reduces
    (:func:`_traffic`)."""
    import contextlib

    from collocfem_tpu_torch.ops import _build
    from collocfem_tpu_torch.utils.profiling import timed

    mode = _traffic(device) if traffic else contextlib.nullcontext()
    before = _build.snapshot()
    with mode:
        wall, out = timed(run, device=device, reps=1, warmup=0)
    made = _build.difference(before, _build.snapshot())
    res = {"out": _host(out), "wall": wall,
           "counts": {fn.__name__: c for fn, c in made.items()}}
    if traffic:
        res.update(host_reads=mode.count, all_reduces=mode.all_reduces)
    return res


def spike_case(*, mesh, D, E, G, dtype, device):
    """``parallel.spike_sharded_solver`` on a global block-major chain."""
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.spike import spike_sharded_solver

    solve = spike_sharded_solver(make_device_mesh(*mesh, device=device))
    args = [torch.as_tensor(a, dtype=dtype, device=device) for a in (D, E, G)]
    return _counted(lambda: solve(*args), device)


def _sp_solver(mesh, spec, options, dtype, device, irls_rounds=None):
    """(``parallel.make_sp_gn_solver`` on ``estimation_inputs(spec)``, or
    with ``irls_rounds`` the IRLS solver with it as the inner solver; its
    arguments)."""
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.sharded import make_sp_gn_solver
    from collocfem_tpu_torch.solve.newton import (SolverOptions,
                                                  make_irls_solver)

    prob, z0, data = estimation_inputs(spec, dtype=dtype, device=device)
    opts = SolverOptions(**options)
    solve = make_sp_gn_solver(prob, make_device_mesh(*mesh, device=device),
                              opts)
    if irls_rounds is not None:
        solve = make_irls_solver(prob, opts, irls_rounds, inner_solver=solve)
    return solve, (z0, data)


def sp_gn_case(*, mesh, spec, options, dtype, device, irls_rounds=None,
               mode="call", traffic=False):
    """``parallel.make_sp_gn_solver`` on ``estimation_inputs(spec)``, or
    with ``irls_rounds`` the IRLS solver with it as the inner solver;
    ``mode`` "call" runs the solver itself (captured on a CUDA device,
    eager on the CPU), "eager" or "stepwise" that form of it; counted
    (:func:`_counted`)."""
    solve, args = _sp_solver(mesh, spec, options, dtype, device, irls_rounds)
    run = solve if mode == "call" else getattr(solve, mode)
    return _counted(lambda: run(*args), device, traffic)


def _dp_solver(mesh, spec, options, layout, dtype, device, sp_chain=False):
    """(``make_multi_experiment_solver(dp_axis=...)`` on ``batch_inputs(
    spec)``, this rank's dp share of the experiments as its arguments, a
    function that gathers a result's V over dp: the whole batch)."""
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.batch import (
        BatchDecision, make_multi_experiment_solver)
    from collocfem_tpu_torch.parallel.meshes import gather
    from collocfem_tpu_torch.parallel.spike import spike_chain_solver
    from collocfem_tpu_torch.problem import ProblemData
    from collocfem_tpu_torch.solve.newton import SolverOptions

    dm = make_device_mesh(*mesh, device=device)
    prob, z0, data, p_prior, p_w = batch_inputs(spec, dtype=dtype,
                                                device=device)
    n = z0.V.shape[0] // dm.dp
    mine = lambda a: a[dm.dp_rank * n:(dm.dp_rank + 1) * n]
    chain = spike_chain_solver(prob.mesh.num_blocks, dm.sp,
                               group=dm.sp_group) if sp_chain else None
    solve = make_multi_experiment_solver(
        prob, SolverOptions(**options), dp_axis=dm.dp_group,
        chain_solver=chain, layout=layout)
    args = (BatchDecision(V=mine(z0.V), p=z0.p),
            ProblemData(*(mine(x) for x in data)), p_prior, p_w)

    def whole(res):
        z, stats = res["out"]
        V = gather(z["V"].to(device), dm.dp_group)
        res["out"] = [{"V": V.reshape(-1, *V.shape[2:]).cpu(), "p": z["p"]},
                      stats]
        return res

    return solve, args, whole


def dp_case(*, mesh, spec, options, layout, dtype, device, sp_chain=False,
            mode="call", traffic=False):
    """``make_multi_experiment_solver(dp_axis=...)`` on ``batch_inputs(
    spec)``, this rank's dp share of the experiments; with ``sp_chain`` the
    block layout's chains go through ``spike_chain_solver`` over the sp
    ranks.  ``mode`` as :func:`sp_gn_case`'s; counted (:func:`_counted`).
    The result's V is gathered over dp: the whole batch."""
    solve, args, whole = _dp_solver(mesh, spec, options, layout, dtype,
                                    device, sp_chain)
    run = solve if mode == "call" else getattr(solve, mode)
    return whole(_counted(lambda: run(*args), device, traffic))


def _profiled(run, device):
    """Device time (ms) and kernel count of one run() under torch.profiler,
    device activity only."""
    from torch.profiler import ProfilerActivity, profile

    from collocfem_tpu_torch.tools.spike_tiles import _device_us

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e)]
    return dict(device_ms=sum(_device_us(e) for e in events) / 1e3,
                kernels=sum(e.count for e in events))


def captured_case(*, kind, mesh, spec, options, dtype, device, layout=None,
                  profile=False):
    """One sharded solver (``kind`` "sp": :func:`_sp_solver`; "dp":
    :func:`_dp_solver` in ``layout``) run as ``.eager``, its first call
    (warm-up, capture, replay), a replay and ``.eager`` again, in that
    order on the same groups (so the collectives' epochs run on through
    eager and captured calls), each counted with its reads to the host
    (:func:`_counted`).  Returns {"runs": {run: result}} and, with
    ``profile``, "profile": one more ``.eager`` run's device time on the
    world's rank 0 (:func:`_profiled`; torch.profiler does not trace a loop
    graph's body), None on the others."""
    if kind == "sp":
        solve, args = _sp_solver(mesh, spec, options, dtype, device)
        whole = lambda res: res
    else:
        solve, args, whole = _dp_solver(mesh, spec, options, layout, dtype,
                                        device)
    runs = {}
    for name, run in (("eager", solve.eager), ("first call", solve),
                      ("captured", solve), ("eager again", solve.eager)):
        runs[name] = whole(_counted(lambda: run(*args), device, True))
    out = {"runs": runs}
    if profile:   # every rank runs it; rank 0 of the world profiles it
        import torch.distributed as dist

        run = lambda: solve.eager(*args)
        out["profile"] = None
        if dist.get_rank() == 0:
            out["profile"] = _profiled(run, device)
        else:
            run()
    return out


def collective_case(*, mesh, seed, sizes, device):
    """The collectives of ``parallel.meshes`` on both groups of a (dp, sp)
    grid: ``all_sum`` and ``all_max`` of a float64 and of a float32
    payload of each length in ``sizes`` and ``gather`` of the float64 one,
    each rank's payload drawn by ``numpy.random.default_rng(seed + its
    rank in the group)``.  Returns {group: {"rank": r, "size": P, (op,
    dtype name, n): result on the host}}."""
    from collocfem_tpu_torch.parallel import make_device_mesh
    from collocfem_tpu_torch.parallel.meshes import (all_max, all_sum,
                                                      gather)

    dm = make_device_mesh(*mesh, device=device)
    out = {}
    for name, group, rank, size in (("sp", dm.sp_group, dm.sp_rank, dm.sp),
                                    ("dp", dm.dp_group, dm.dp_rank, dm.dp)):
        res = {"rank": rank, "size": size}
        for n in sizes:
            x = np.random.default_rng(seed + rank).standard_normal(n)
            for dtype in (torch.float64, torch.float32):
                xt = torch.as_tensor(x, dtype=dtype, device=device)
                key = str(dtype).split(".")[1]
                res[("sum", key, n)] = all_sum(group, xt)[0].cpu()
                res[("max", key, n)] = all_max(group, xt)[0].cpu()
            res[("gather", "float64", n)] = gather(
                torch.as_tensor(x, device=device), group).cpu()
        out[name] = res
    return out


def _per_call_ms(fn, reps):
    """ms a call of fn() over ``reps`` calls after one, by the host clock
    bracketed by torch.cuda.synchronize() (a gloo all-reduce of a CUDA
    tensor runs partly on the host, which CUDA events would not see)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def peer_case(*, mesh, seed, sizes, reps, device):
    """The peer all-reduce's kernel against its plain version on the sp
    group of a (dp, sp) grid on a card: for SUM and MAX at each length in
    ``sizes``, each rank's float64 payload drawn by
    ``numpy.random.default_rng(seed + its rank)``; whether the two agree
    bit for bit, and the ms a call of the kernel, of the plain version and
    of ``dist.all_reduce`` (the group's backend) on the same payload, each
    the mean of ``reps`` calls (:func:`_per_call_ms`).  Returns {(op, n):
    {"same", "kernel_ms", "plain_ms", "library_ms"}} and "launches", the
    kernel's count over the comparisons (not the timing)."""
    import torch.distributed as dist

    from collocfem_tpu_torch.parallel import make_device_mesh, peer

    dm = make_device_mesh(*mesh, device=device)
    group, out = dm.sp_group, {}
    ops = (("sum", peer.SUM, dist.ReduceOp.SUM),
           ("max", peer.MAX, dist.ReduceOp.MAX))
    payloads = {n: torch.as_tensor(np.random.default_rng(seed + dm.sp_rank)
                                   .standard_normal(n), device=device)
                for n in sizes}
    before = peer.peer_reduce.launches
    for n, x in payloads.items():
        for name, op, _ in ops:
            out[(name, n)] = {"same": bit_equal(
                peer.peer_reduce(x, group, op),
                peer.peer_reduce_ref(x, group, op))}
    launches = peer.peer_reduce.launches - before
    for n, x in payloads.items():
        for name, op, red in ops:
            lib_x = x.clone()
            out[(name, n)].update(
                kernel_ms=_per_call_ms(
                    lambda: peer.peer_reduce(x, group, op), reps),
                plain_ms=_per_call_ms(
                    lambda: peer.peer_reduce_ref(x, group, op), reps),
                library_ms=_per_call_ms(
                    lambda: dist.all_reduce(lib_x, op=red, group=group),
                    reps))
    peer.check(group)
    out["launches"] = launches
    return out


def release_case(*, mesh, device):
    """A (dp, sp) grid's peer buffers freed (``parallel.peer.release``) and
    set up anew at the next collective: {"same": whether an ``all_sum``
    over sp before and after the release gives the same bits, "gone":
    whether the release left no entry of the two groups}."""
    from collocfem_tpu_torch.parallel import make_device_mesh, peer
    from collocfem_tpu_torch.parallel.meshes import all_sum

    dm = make_device_mesh(*mesh, device=device)
    groups = (dm.sp_group, dm.dp_group)
    x = torch.arange(5, dtype=torch.float64, device=device) + dm.sp_rank
    before, = all_sum(dm.sp_group, x)
    peer.release(*groups)
    gone = not any(key[0] is g for key in peer._GROUPS for g in groups)
    after, = all_sum(dm.sp_group, x)
    peer.check(dm.sp_group)
    return {"same": bit_equal(before, after), "gone": gone}


def stalled_rank_case(*, mesh, timeout_s, device):
    """A rank that never makes its call: the last rank of the sp group
    skips an ``all_sum`` that the others make with every wait bounded by
    ``timeout_s``.  Returns, on the others, {"raised": the message of
    ``parallel.peer.check``'s error or None, "wall": seconds to it, "nan":
    whether the sum came back NaN, "other group raised": whether the check
    of the mesh's other group (which made no call) raised first}; on the
    last rank {"skipped": True}.
    Every rank then meets at a barrier of the (gloo) group, so that no
    rank frees its buffer while another's kernel may still write to it."""
    import time

    import torch.distributed as dist

    from collocfem_tpu_torch.parallel import make_device_mesh, peer
    from collocfem_tpu_torch.parallel.meshes import all_sum

    dm = make_device_mesh(*mesh, device=device)
    if dm.sp_rank == dm.sp - 1:
        dist.barrier(group=dm.sp_group)
        return {"skipped": True}
    default, peer.SPIN_TIMEOUT_S = peer.SPIN_TIMEOUT_S, timeout_s
    t0, got = time.perf_counter(), None
    try:
        got, = all_sum(dm.sp_group, torch.ones(3, dtype=torch.float64,
                                               device=device))
        other = False
        try:
            peer.check(dm.dp_group)
        except RuntimeError:
            other = True
        peer.check(dm.sp_group)
        raised = None
    except RuntimeError as exc:
        raised = str(exc)
    finally:
        peer.SPIN_TIMEOUT_S = default
    out = {"raised": raised, "wall": time.perf_counter() - t0,
           "nan": got is not None and bool(torch.isnan(got).all()),
           "other group raised": other}
    dist.barrier(group=dm.sp_group)
    return out


def _rank_main(rank, n_ranks, workdir, cases, device):
    import datetime

    import torch.distributed as dist

    from collocfem_tpu_torch.parallel import peer

    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/init",
                            world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = {name: fn(**kwargs, device=device) for name, fn, kwargs in cases}
        torch.save(out, f"{workdir}/rank{rank}.pt")
        peer.release()
    finally:
        dist.destroy_process_group()


def run_world(n_ranks: int, cases, workdir, *, device="cpu"):
    """Spawn a gloo world of ``n_ranks`` processes in which every rank runs
    every case of ``cases`` ((name, function, kwargs), a function of this
    module called with ``device=``), in order; returns each rank's
    {name: result} in rank order.  ``workdir`` is a fresh directory for the
    world's rendezvous file and the results.  On a CUDA device every rank
    uses the current card (gloo reduces CUDA tensors)."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(n_ranks, str(workdir), cases, device),
             nprocs=n_ranks, join=True)
    return [torch.load(f"{workdir}/rank{r}.pt", weights_only=False)
            for r in range(n_ranks)]
