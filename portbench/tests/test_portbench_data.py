"""The benchmark's data generator is a frozen copy of the port's data
builders: the same draws give the same samples, bit for bit; and a seed
gives the same data sets again."""

import json

import numpy as np
from portbench_testkit import REPO

from portbench import data

CONFIGS = REPO / "portbench" / "configs"


def _cfg(name, **over):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


def test_the_batch_is_make_config5_data():
    from collocfem_tpu_torch.batched import make_config5_data

    ds = data.draw(_cfg("vdp_batch_1024x10", experiments=16), 10,
                   np.random.default_rng(1))
    _, t, y, u = make_config5_data(16, 10, seed=1)
    assert np.array_equal(ds.t_meas, t) and np.array_equal(ds.y, y[..., 0])


def test_the_headline_without_noise_is_build_headline_problem():
    from collocfem_tpu_torch.headline import build_headline_problem

    ds = data.draw(_cfg("vdp_deg4", noise_sigma=0.0), 50,
                   np.random.default_rng(1))
    _, t, y, _ = build_headline_problem(50)
    assert np.array_equal(ds.t_meas, t) and np.array_equal(ds.y[0], y[:, 0])


def test_a_pool_ignores_the_seed_and_a_seed_repeats():
    cfg = _cfg("vdp_deg4")
    pool = {"elements": 20, "datasets": 2, "pool_seed": 5}
    a, b = data.datasets(cfg, pool, 1), data.datasets(cfg, pool, 2 ** 31 + 7)
    assert all(np.array_equal(x.y, z.y) for x, z in zip(a, b))
    free = {"elements": 20, "datasets": 2}
    c, d = data.datasets(cfg, free, 2 ** 31 + 7), data.datasets(cfg, free,
                                                               2 ** 31 + 7)
    assert all(np.array_equal(x.y, z.y) for x, z in zip(c, d))
    assert not np.array_equal(c[0].y, c[1].y)
