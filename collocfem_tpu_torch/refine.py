"""Mesh refinement and nested iteration for collocation estimation.

Counterpart of ``collocfem_tpu/refine.py``.  A defect-based error indicator
drives :func:`collocfem_tpu_torch.ops.mesh.refined_mesh`, and the previous
collocation polynomial is interpolated onto the new node set as the warm
start.  Refinement is an outer host loop; each solve runs on the problem's
device.

Unlike the JAX package, :func:`estimate_multilevel` builds every level's
problem and solver before it solves the first one, and
:func:`level_schedule` refuses a float32 level past :data:`CR_DW_CHAIN`
outright: a schedule that cannot run fails before any level has run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from collocfem_tpu_torch.ops.mesh import (
    Mesh,
    interpolate_trajectory,
    refined_mesh,
    uniform_mesh,
)
from collocfem_tpu_torch.problem import Decision, EstimationProblem
from collocfem_tpu_torch.solve.newton import SolverOptions, make_gn_solver

# Chain length past which a float32 factorisation floors out: the
# equilibrated collocation chain has cond ~ K^2 (1-D-Poisson-like), and at
# K ~ 4e4 the K^2 eps_f32 step error reaches ~1e-4 relative (the JAX
# package's measurement, refine.py:122-127).  The JAX package switches such
# levels to its double-word tier; the port runs them in float64.
CR_DW_CHAIN = 40_000


def defect_error_indicator(problem: EstimationProblem, z: Decision,
                           n_samples: int = 4) -> np.ndarray:
    """Per-element ODE-residual indicator, sampled off the collocation nodes.

    Samples ||x'(t) - f(x(t), 0, p, t)|| at ``n_samples`` midpoints between
    adjacent LGL nodes of every element and returns the per-element mean
    times the element width (numpy, (N,)): the indicator of h-refinement.
    """
    mesh, model = problem.mesh, problem.model
    n = mesh.num_elements
    tau = mesh.basis.nodes
    mids = 0.5 * (tau[:-1] + tau[1:])
    taus = mids[np.linspace(0, mids.size - 1, n_samples).round().astype(int)]
    times = (mesh.breakpoints[:-1][:, None]
             + 0.5 * mesh.widths[:, None] * (taus[None, :] + 1.0)).ravel()
    vals, derivs = interpolate_trajectory(mesh, z.V, times, derivative=True)
    x, dx = vals[:, :model.nx], derivs[:, :model.nx]
    # The indicator needs only relative sizes: the input is taken as zero.
    u = x.new_zeros((times.size, model.nu))
    t = torch.as_tensor(times, dtype=x.dtype, device=x.device)
    f = vmap(model.f, in_dims=(0, 0, None, 0))(x, u, z.p, t)
    err = torch.linalg.vector_norm(dx - f, dim=1).reshape(n, n_samples)
    # h-weighted: an element's share of the global error scales with its
    # width, so the indicator falls under refinement.
    return err.mean(dim=1).cpu().numpy() * mesh.widths


def level_sizes(num_elements: int, coarsen: int = 4,
                levels: int = 3) -> list[int]:
    """Element counts of nested iteration, coarsest first: ``num_elements``
    divided by ``coarsen`` per level (at least 2), the last level exact."""
    ns = [max(2, int(np.ceil(num_elements / coarsen ** (levels - 1 - i))))
          for i in range(levels)]
    ns[-1] = num_elements
    return ns


def level_schedule(options, ns, dtype) -> list[SolverOptions]:
    """Per-level solver options of nested iteration over element counts
    ``ns``.

    ``options`` may be a sequence (one per level, used verbatim) or one
    :class:`SolverOptions` used at every level.  In float32 a level whose
    chain K = n + 1 exceeds :data:`CR_DW_CHAIN` raises here, before any
    level runs: the JAX package promotes it to its double-word tier, which
    the port replaces by float64.
    """
    if isinstance(options, (list, tuple)):
        if len(options) != len(ns):
            raise ValueError(f"options sequence has {len(options)} entries "
                             f"for {len(ns)} levels")
        return list(options)
    if dtype != torch.float64:
        too_long = [n for n in ns if n + 1 > CR_DW_CHAIN]
        if too_long:
            raise ValueError(
                f"levels of {too_long} elements exceed the float32 chain "
                f"limit ({CR_DW_CHAIN} blocks); run the ladder in float64")
    return [options for _ in ns]


def _initial_or_warm(prob, meas_times, y_values, p0, z, prev_mesh):
    if z is None:
        return prob.initial_guess_from_data(meas_times, y_values, p0=p0)
    V0 = interpolate_trajectory(prev_mesh, z.V, prob.mesh.node_times)
    return Decision(V=V0.to(prob.dtype), p=z.p)


def estimate_multilevel(model, meas_times, y_values, p0, *, t0, tf,
                        num_elements, degree: int = 4, coarsen: int = 4,
                        levels: int = 3, defect_weight=100.0,
                        pack_kwargs: dict | None = None,
                        options=SolverOptions(), u_nodes_fn=None, device,
                        dtype):
    """Nested iteration: solve on a coarse mesh, prolong, re-solve.

    A float32 solve on a very fine mesh is conditioning-limited (cond ~
    K^2); converging coarse levels first starts the fine level in the
    quadratic basin.  Every level's problem, data and solver are built
    before the first solve.  Returns (problem, z, stats, history) with
    history a list of (mesh, p (numpy), final cost) per level.
    """
    pack_kwargs = dict(pack_kwargs or {})
    ns = level_sizes(num_elements, coarsen, levels)
    built = []
    for n, opts in zip(ns, level_schedule(options, ns, dtype)):
        mesh = uniform_mesh(t0, tf, n, degree)
        prob = EstimationProblem.build(model, mesh, meas_times,
                                       defect_weight=defect_weight,
                                       device=device, dtype=dtype)
        u_nodes = u_nodes_fn(mesh) if u_nodes_fn is not None else None
        data = prob.pack_data(y_values, meas_times, u_nodes=u_nodes,
                              **pack_kwargs)
        built.append((prob, data, make_gn_solver(prob, opts)))
    z, prev_mesh, history = None, None, []
    for prob, data, solve in built:
        z0 = _initial_or_warm(prob, meas_times, y_values, p0, z, prev_mesh)
        z, stats = solve(z0, data)
        history.append((prob.mesh, z.p.cpu().numpy(), float(stats.cost)))
        prev_mesh = prob.mesh
    return prob, z, stats, history


def estimate_adaptive(model, mesh0: Mesh, meas_times, y_values, p0, *,
                      rounds: int = 3, growth: float = 1.5,
                      floor_frac: float = 0.1, defect_weight=100.0,
                      pack_kwargs: dict | None = None,
                      options: SolverOptions = SolverOptions(),
                      u_nodes_fn=None, device, dtype):
    """Estimate with ``rounds`` of defect-driven h-refinement and warm
    starts.

    ``u_nodes_fn(mesh) -> (N, d+1, nu)`` rebuilds the input table on each
    refined mesh.  Returns (problem, z, stats, history) with history a list
    of (mesh, p (numpy), max indicator) per round.
    """
    pack_kwargs = dict(pack_kwargs or {})
    mesh, z, history = mesh0, None, []
    for rnd in range(rounds):
        prob = EstimationProblem.build(model, mesh, meas_times,
                                       defect_weight=defect_weight,
                                       device=device, dtype=dtype)
        u_nodes = u_nodes_fn(mesh) if u_nodes_fn is not None else None
        data = prob.pack_data(y_values, meas_times, u_nodes=u_nodes,
                              **pack_kwargs)
        z0 = _initial_or_warm(prob, meas_times, y_values, p0, z,
                              history[-1][0] if history else None)
        z, stats = make_gn_solver(prob, options)(z0, data)
        ind = defect_error_indicator(prob, z)
        history.append((mesh, z.p.cpu().numpy(), float(ind.max())))
        if rnd < rounds - 1:
            # Floor the density at a fraction of its max: without it the
            # equidistribution puts nearly every element on the sharpest
            # feature and lets the background elements grow.
            density = np.maximum(ind, floor_frac * ind.max() + 1e-300)
            mesh = refined_mesh(mesh.t0, mesh.tf,
                                int(np.ceil(mesh.num_elements * growth)),
                                mesh.degree, density)
    return prob, z, stats, history
