"""The benchmark's plain reference, in numpy and scipy: it imports nothing
of the port and takes nothing the port made.  :func:`solve` answers one
data set of a cell the way the cell's traffic says: one LM solve from the
cold initial guess, or a ladder of LM solves over coarser meshes, each
warm-started from the last through the collocation polynomial."""

from __future__ import annotations

import numpy as np

from portbench.reference.estimation import (Answer, Estimation,
                                            initial_guess, lm, prolong)

__all__ = ["Answer", "Estimation", "solve"]


def _estimation(config, elements, ds, dtype):
    return Estimation(elements, config["degree"], config["t0"], config["tf"],
                      ds.t_meas, ds.y, ds.freqs,
                      defect_weight=config["defect_weight"],
                      meas_weight=config["meas_weight"],
                      p_prior=config["p_prior"], p_weight=config["p_weight"],
                      dtype=dtype)


def solve(config: dict, traffic: dict, ds, dtype=np.float64) -> Answer:
    """The reference's answer on data set ``ds`` (``portbench.data``) in
    working precision ``dtype``."""
    elements = ds.elements
    levels = traffic.get("reference_levels")
    if levels is None:
        opts = traffic["options"]
        est = _estimation(config, elements, ds, dtype)
        V0, p0 = initial_guess(est, ds.t_meas, ds.y, config["p0"])
        return lm(est, V0, p0, maxiter=opts["maxiter"], lam0=opts["lam0"],
                  gtol=opts.get("gtol", 0.0), xtol=opts.get("xtol", 0.0),
                  ftol=opts.get("ftol", 0.0),
                  lam_max=opts.get("lam_max", 1e12))
    prev = ans = None
    for lv in levels:
        est = _estimation(config, max(2, elements // lv["divide"]), ds, dtype)
        if ans is None:
            V0, p0 = initial_guess(est, ds.t_meas, ds.y, config["p0"])
        elif est.n == prev.n:
            V0, p0 = ans.V, ans.p
        else:
            V0, p0 = prolong(prev, ans.V, est), ans.p
        ans = lm(est, V0, p0, maxiter=lv["maxiter"], lam0=lv["lam0"],
                 gtol=lv.get("gtol", 0.0))
        prev = est
    return ans
