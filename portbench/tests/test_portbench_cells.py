"""The harness drives each tiny cell on the CPU through the port's eager
path, and the plain reference agrees with it; the traced run reads the
per-layer metrics that need no device."""

import pytest
from portbench_testkit import TINY, run, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


@pytest.fixture(autouse=True)
def low_chain(monkeypatch):
    from collocfem_tpu_torch import refine

    monkeypatch.setattr(refine, "CR_DW_CHAIN", 8)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct_and_close_to_the_reference(root, cell):
    res = run(root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    for name in ("p_rel", "V_rel", "cost_rel"):
        assert res["checks"][name]["value"] < 1e-9
    assert set(res["metrics"]) >= {"solve_s", "setup_s"}
    assert list(res)[-1] == "checks"


def test_a_traced_run_reports_per_layer_metrics_and_the_window(root):
    res = run(root, "tiny.conv", trace=True)
    assert res["correct"]
    assert res["metrics"]["lm_iters"]["value"] > 0
    assert "solve_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
