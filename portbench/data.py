"""The cells' data, made from the seed: the one generator every
configuration and traffic file feeds.

A configuration (``configs/<name>.json``) fixes the model's true
parameters, the horizon, how each experiment starts and is driven, where
it is sampled and the noise on the samples; the traffic
(``workloads/<name>.json``) fixes the mesh size where the configuration
leaves it open, how many data sets a run cycles through, and whether they
are a fixed pool.  Data set k of seed s draws from
``numpy.random.default_rng([s, k])``: first the random
initial states and input frequencies where the configuration asks for
them, then the noise.  The true path is ``scipy.integrate.solve_ivp`` with
dense output, or classical RK4 on a fixed grid, as the configuration says;
both are frozen copies of the port's data builders
(``headline.build_headline_problem``, ``batched.make_config5_data``), which
the benchmark does not call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.integrate import solve_ivp


class DataSet(NamedTuple):
    elements: int
    t_meas: np.ndarray    # (S,) sample times, shared by the experiments
    y: np.ndarray         # (E, S) noisy samples of the first state
    freqs: np.ndarray     # (E,) input frequency: u = sin(freq t)


def _vdp(p_true):
    mu, b = p_true

    def f(x, t, freq):
        return np.stack([x[1], mu * (1.0 - x[0] ** 2) * x[1] - x[0]
                         + b * np.sin(freq * t)])
    return f


def _truth_ivp(cfg, x0, freq, t_meas):
    f = _vdp(cfg["p_true"])
    sim = cfg["simulate"]
    sol = solve_ivp(lambda t, x: f(x, t, freq), (cfg["t0"], cfg["tf"]),
                    list(x0), rtol=sim["rtol"], atol=sim["atol"],
                    dense_output=True)
    return sol.sol(t_meas)[0]


def _truth_rk4(cfg, x0s, freqs, t_meas):
    f = _vdp(cfg["p_true"])
    tt = np.linspace(cfg["t0"], cfg["tf"], cfg["simulate"]["points"])
    dt = tt[1] - tt[0]
    x = x0s.T.copy()                                   # (2, E)
    first = np.empty((tt.size, x0s.shape[0]))
    first[0] = x[0]
    for i in range(tt.size - 1):
        t = tt[i]
        k1 = f(x, t, freqs)
        k2 = f(x + 0.5 * dt * k1, t + 0.5 * dt, freqs)
        k3 = f(x + 0.5 * dt * k2, t + 0.5 * dt, freqs)
        k4 = f(x + dt * k3, t + dt, freqs)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        first[i + 1] = x[0]
    return np.stack([np.interp(t_meas, tt, first[:, e])
                     for e in range(x0s.shape[0])])


def draw(cfg: dict, n: int, rng, cache=None) -> DataSet:
    """One data set on a mesh of n elements from the generator ``rng``."""
    e = int(cfg["experiments"])
    smp = cfg["samples"]
    t_meas = np.linspace(smp["first"], smp["last"], smp["per_element"] * n)
    if "x0_uniform" in cfg:
        x0s = rng.uniform(*cfg["x0_uniform"], size=(e, 2))
    else:
        x0s = np.tile(np.asarray(cfg["x0"], dtype=np.float64), (e, 1))
    if "input_freq_uniform" in cfg:
        freqs = rng.uniform(*cfg["input_freq_uniform"], size=e)
    else:
        freqs = np.full(e, float(cfg["input_freq"]))
    cache = {} if cache is None else cache
    key = (x0s.tobytes(), freqs.tobytes())
    if key not in cache:
        if cfg["simulate"]["method"] == "solve_ivp":
            cache[key] = np.stack([_truth_ivp(cfg, x0s[i], freqs[i], t_meas)
                                   for i in range(e)])
        else:
            cache[key] = _truth_rk4(cfg, x0s, freqs, t_meas)
    y = cache[key] + cfg["noise_sigma"] * rng.standard_normal((e, t_meas.size))
    return DataSet(n, t_meas, y, freqs)


def datasets(cfg: dict, traffic: dict, seed: int) -> list[DataSet]:
    """The run's data sets: ``traffic["datasets"]`` of them, drawn from
    ``traffic["pool_seed"]`` where the traffic fixes its pool (so every run
    solves the same set, in an order the harness draws from the run's
    seed), else from ``seed``."""
    seed = traffic.get("pool_seed", seed)
    n = int(traffic.get("elements", cfg.get("elements", 0)))
    if n < 1:
        raise ValueError("neither the configuration nor the traffic sets "
                         "the mesh size 'elements'")
    cache = {}
    return [draw(cfg, n, np.random.default_rng([int(seed) % 2 ** 63, k]),
                 cache) for k in range(int(traffic.get("datasets", 1)))]
