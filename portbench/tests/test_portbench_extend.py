"""A configuration, a cell, a per-layer metric and a kernel family are
added as new files and new entries of BENCHMARK.json only: the harness
lists and loads them, and no file the benchmark had changes."""

import hashlib
import json

from portbench_testkit import run, tiny_root

from portbench import harness, trace


def _digests(folder):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()}


def test_new_files_only(tmp_path):
    root = tiny_root(tmp_path)
    bench = root / "portbench"
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "vdp_deg4.json").read_text())
    cfg.update(name="vdp_deg4_quiet", noise_sigma=0.001)
    (bench / "configs" / "vdp_deg4_quiet.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "workloads" / "tiny.conv.json").read_text())
    tr.update(elements=24, datasets=2)
    (bench / "workloads" / "n24_quiet.json").write_text(json.dumps(tr))
    (bench / "metrics" / "solves_in_window.py").write_text(
        "def read(r):\n    return len(r.iterations)\n")
    (bench / "kernels" / "extra.json").write_text(json.dumps(
        {"layer": "KKT / chain kernels", "kernels": ["extra_kernel"]}))

    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "vdp_deg4_quiet", "source": "test",
                            "file": "portbench/configs/vdp_deg4_quiet.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "quiet.n24", "config": "vdp_deg4_quiet",
                              "traffic": "n24_quiet", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "solves_in_window", "unit": "solves",
                              "better": "higher", "source": "host_clock",
                              "layer": "LM loop", "moves": "solve_s",
                              "workloads": ["quiet.n24"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(bench)
    assert {p: after[p] for p in before} == before

    cell = harness.load_cell(root, "quiet.n24")
    assert cell.config["noise_sigma"] == 0.001
    assert cell.traffic["elements"] == 24
    assert [m["name"] for m in cell.per_layer] == ["solves_in_window"]
    assert trace.families(bench)["extra_kernel"] == "extra"
    res = run(root, "quiet.n24", trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["solves_in_window"]["value"] >= 1


def test_a_metric_without_workloads_follows_the_metric_it_moves(tmp_path):
    root = tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "lm_iters_all", "unit": "iterations",
                              "better": "lower", "source": "program_counter",
                              "layer": "LM loop", "moves": "solve_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for w in spec["workloads"]:
        names = [m["name"] for m in harness.load_cell(root, w["name"]).per_layer]
        assert "lm_iters_all" in names
