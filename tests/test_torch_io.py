"""Port parity, measurement IO: ``collocfem_tpu_torch.utils.io`` against
``collocfem_tpu.utils.io`` on the committed flight record and on .npz round
trips, bit for bit, and the cases both refuse."""

import os

import numpy as np
import pytest

from collocfem_tpu.utils.io import load_measurements as jax_load
from collocfem_tpu.utils.io import save_measurements as jax_save
from collocfem_tpu_torch.utils.io import load_measurements, save_measurements

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "examples", "data", "aircraft_doublet.csv")


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_flight_record_loads_as_in_jax():
    """The CSV of config 4: 400 samples of t, alpha, q, az, elevator."""
    t, y = load_measurements(RECORD)
    assert t.shape == (400,) and y.shape == (400, 4)
    _equal((t, y), jax_load(RECORD))


@pytest.mark.parametrize("with_u", [False, True])
@pytest.mark.parametrize("saver", ["port", "jax"])
def test_npz_round_trip_matches_jax(tmp_path, saver, with_u):
    """Shuffled times come back sorted, the same arrays from either
    loader, whichever package saved them."""
    rng = np.random.default_rng(4)
    t = rng.permutation(np.linspace(0.0, 1.0, 23))
    y = rng.standard_normal((23, 3))
    path = os.path.join(tmp_path, "m.npz")
    (save_measurements if saver == "port" else jax_save)(
        path, t, y, u=rng.standard_normal(23) if with_u else None)
    got = load_measurements(path)
    _equal(got, jax_load(path))
    np.testing.assert_array_equal(got[0], np.sort(t))


def test_npz_one_channel_row_is_promoted(tmp_path):
    path = os.path.join(tmp_path, "row.npz")
    np.savez(path, t=np.arange(5.0), y=np.arange(5.0) ** 2)
    got = load_measurements(path)
    assert got[1].shape == (5, 1)
    _equal(got, jax_load(path))


@pytest.mark.parametrize("arrays", [dict(a=np.zeros(3)),
                                    dict(t=np.zeros(5), y=np.zeros((4, 3)))],
                         ids=["no t or y", "length mismatch"])
def test_npz_refusals_match_jax(tmp_path, arrays):
    path = os.path.join(tmp_path, "bad.npz")
    np.savez(path, **arrays)
    for load in (load_measurements, jax_load):
        with pytest.raises(ValueError):
            load(path)
