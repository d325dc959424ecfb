"""The system under test: the port's entry that a cell's traffic names,
built on the cell's data sets through the port's own API.

``entry`` in the traffic file picks one of

  * ``gn_solver``: ``solve.newton.make_gn_solver`` on one
    ``EstimationProblem`` (the headline estimation);
  * ``multi_experiment``: ``parallel.batch.make_multi_experiment_solver``
    over a batch of experiments sharing p, in ``traffic["layout"]``;
  * ``converged_ladder``: ``headline.ConvergedLadder``, handed each data set
    through its fields ``t_meas``, ``y`` and each level's ``data`` (packed
    by that level's own problem).

Each is called with the index of a data set and returns an :class:`Output`
of device tensors; ``.eager(k)`` runs the same solve on the port's eager
loop.  ``.steps()`` lists, for the last call, each level's (elements, LM
steps run): a converging loop runs as many steps as its iterations, a
fixed-work loop (every tolerance 0) its maxiter.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Output(NamedTuple):
    V: torch.Tensor            # (E, M, 2)
    p: torch.Tensor            # (2,)
    cost: torch.Tensor         # ()
    iterations: torch.Tensor   # () summed over the levels
    converged: torch.Tensor    # () of the last level


def _options(opts: dict):
    from collocfem_tpu_torch.solve.newton import SolverOptions

    return SolverOptions(**opts)


def _steps(options, stats) -> int:
    fixed = not (options.gtol > 0 or options.ftol > 0 or options.xtol > 0)
    return options.maxiter if fixed else int(stats.iterations)


def _u_nodes(freq, mesh):
    return np.sin(freq * mesh.elem_times)[..., None]


class GNSolver:
    def __init__(self, cfg, traffic, sets, device):
        from collocfem_tpu_torch.models import VanDerPol
        from collocfem_tpu_torch.ops.mesh import uniform_mesh
        from collocfem_tpu_torch.problem import EstimationProblem
        from collocfem_tpu_torch.solve.newton import make_gn_solver

        dtype = getattr(torch, traffic["dtype"])
        n = sets[0].elements
        mesh = uniform_mesh(cfg["t0"], cfg["tf"], n, cfg["degree"])
        prob = EstimationProblem.build(VanDerPol(), mesh, sets[0].t_meas,
                                       defect_weight=cfg["defect_weight"],
                                       device=device, dtype=dtype)
        self.inputs = [(
            prob.initial_guess_from_data(ds.t_meas, ds.y[0][:, None],
                                         p0=cfg["p0"]),
            prob.pack_data(ds.y[0][:, None], ds.t_meas,
                           u_nodes=_u_nodes(ds.freqs[0], mesh),
                           meas_weight=cfg["meas_weight"],
                           p_prior=cfg["p_prior"],
                           p_weight=cfg["p_weight"])) for ds in sets]
        self.options = _options(traffic["options"])
        self.elements = n
        self.solve = make_gn_solver(prob, self.options)
        self.last = None

    def _out(self, z, st):
        self.last = st
        return Output(z.V[None], z.p, st.cost, st.iterations, st.converged)

    def __call__(self, k):
        return self._out(*self.solve(*self.inputs[k]))

    def eager(self, k):
        return self._out(*self.solve.eager(*self.inputs[k]))

    def steps(self):
        return [(self.elements, _steps(self.options, self.last))]


class MultiExperiment:
    def __init__(self, cfg, traffic, sets, device):
        from collocfem_tpu_torch.batched import stack_data
        from collocfem_tpu_torch.models import VanDerPol
        from collocfem_tpu_torch.ops.mesh import uniform_mesh
        from collocfem_tpu_torch.parallel.batch import (
            BatchDecision, make_multi_experiment_solver)
        from collocfem_tpu_torch.problem import EstimationProblem, ProblemData

        dtype = getattr(torch, traffic["dtype"])
        n = sets[0].elements
        mesh = uniform_mesh(cfg["t0"], cfg["tf"], n, cfg["degree"])
        # Packed on the host, then moved once per field, as
        # batched.build_config5_problem does.
        prob = EstimationProblem.build(VanDerPol(), mesh, sets[0].t_meas,
                                       defect_weight=cfg["defect_weight"],
                                       device="cpu", dtype=dtype)
        packed = []
        for ds in sets:
            datas = [prob.pack_data(ds.y[e][:, None], ds.t_meas,
                                    u_nodes=_u_nodes(ds.freqs[e], mesh),
                                    meas_weight=cfg["meas_weight"])
                     for e in range(ds.y.shape[0])]
            v0s = [prob.initial_guess_from_data(ds.t_meas, ds.y[e][:, None],
                                                p0=[0.0, 0.0]).V
                   for e in range(ds.y.shape[0])]
            packed.append((torch.stack(v0s), stack_data(datas)))
        prob = prob.to(device)
        p_prior = torch.tensor(cfg["p_prior"], dtype=dtype, device=device)
        p_w = torch.full((2,), float(cfg["p_weight"]), dtype=dtype,
                         device=device)
        self.inputs = [(
            BatchDecision(V=v0.to(device),
                          p=torch.tensor(cfg["p0"], dtype=dtype,
                                         device=device)),
            ProblemData(*(x.to(device) for x in data)), p_prior, p_w)
            for v0, data in packed]
        self.options = _options(traffic["options"])
        self.elements = n
        self.solve = make_multi_experiment_solver(prob, self.options,
                                                  layout=traffic["layout"])
        self.last = None

    def _out(self, z, st):
        self.last = st
        return Output(z.V, z.p, st.cost, st.iterations, st.converged)

    def __call__(self, k):
        return self._out(*self.solve(*self.inputs[k]))

    def eager(self, k):
        return self._out(*self.solve.eager(*self.inputs[k]))

    def steps(self):
        return [(self.elements, _steps(self.options, self.last))]


class Ladder:
    def __init__(self, cfg, traffic, sets, device):
        from collocfem_tpu_torch.headline import ConvergedLadder

        self.ladder = ConvergedLadder(sets[0].elements, device=device,
                                      dtype=getattr(torch,
                                                    traffic["cold_dtype"]))
        self.sets = [(ds.t_meas, ds.y[0][:, None], [
            lvl.problem.pack_data(ds.y[0][:, None], ds.t_meas,
                                  u_nodes=_u_nodes(ds.freqs[0],
                                                   lvl.problem.mesh))
            for lvl in self.ladder.levels]) for ds in sets]
        self.level_stats = []

    def _run(self, k, run):
        lad = self.ladder
        lad.t_meas, lad.y, datas = self.sets[k]
        lad.levels = [lvl._replace(data=d)
                      for lvl, d in zip(lad.levels, datas)]
        stats = []
        z, st = run(on_level=lambda i, z, s: stats.append(s))
        self.level_stats = stats
        its = torch.stack([s.iterations for s in stats]).sum()
        return Output(z.V[None], z.p, st.cost, its, st.converged)

    def __call__(self, k):
        return self._run(k, self.ladder)

    def eager(self, k):
        return self._run(k, self.ladder.eager)

    def steps(self):
        return [(lvl.elements, _steps(lvl.options, st))
                for lvl, st in zip(self.ladder.levels, self.level_stats)]


ENTRIES = {"gn_solver": GNSolver, "multi_experiment": MultiExperiment,
           "converged_ladder": Ladder}


def build(cfg: dict, traffic: dict, sets, device):
    return ENTRIES[traffic["entry"]](cfg, traffic, sets, device)
