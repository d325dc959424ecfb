"""Each cell's control, the nearest precision below the configuration's
float64 (the port's float32 path, or the plain reference in float32 where
the entry has no float32 path), comes out not correct at a size a test run
holds."""

import time

import pytest
from portbench_testkit import TINY, tiny_root

from portbench import control, harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("control"))


@pytest.fixture(autouse=True)
def low_chain(monkeypatch):
    from collocfem_tpu_torch import refine

    monkeypatch.setattr(refine, "CR_DW_CHAIN", 8)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(root, cell):
    c = harness.load_cell(root, cell)
    if cell == "tiny.conv":
        # float32 still converges at N = 40; by N = 500 it stalls short of
        # the estimate, as at the cell's N = 10,000.
        c.traffic.update(elements=500, datasets=1, reference_sample=1)
    res = harness.run(c, 20261018, 0.2, False, "cpu", time.perf_counter(),
                      build=control.builder("control", c.traffic["control"]))
    assert not res["correct"], res["checks"]
