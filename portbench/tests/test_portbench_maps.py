"""The kernel-family maps name kernels the port defines."""

import json
import re

from portbench_testkit import REPO

from portbench import trace

CSRC = REPO / "collocfem_tpu_torch" / "csrc"


def _strip_launch_bounds(text: str) -> str:
    out, i = [], 0
    while True:
        j = text.find("__launch_bounds__(", i)
        if j < 0:
            return "".join(out) + text[i:]
        out.append(text[i:j])
        depth, k = 0, j + len("__launch_bounds__")
        while True:
            depth += {"(": 1, ")": -1}.get(text[k], 0)
            k += 1
            if depth == 0:
                break
        i = k


def global_kernels() -> set[str]:
    names = set()
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        text = _strip_launch_bounds(src.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return names


def test_every_mapped_name_is_a_global_kernel_of_the_port():
    kernels = global_kernels()
    maps = sorted((REPO / "portbench" / "kernels").glob("*.json"))
    assert maps
    for path in maps:
        names = json.loads(path.read_text())["kernels"]
        assert names and set(names) <= kernels, (path.name, set(names) - kernels)


def test_no_kernel_is_in_two_families():
    seen = {}
    for path in (REPO / "portbench" / "kernels").glob("*.json"):
        for name in json.loads(path.read_text())["kernels"]:
            assert name not in seen, (name, seen.get(name), path.stem)
            seen[name] = path.stem


def test_base_names_of_profiler_kernel_names():
    assert trace.base_name("void kkt::tile_sweep<double, 8, 3, true>"
                           "(kkt::Args<double>)") == "tile_sweep"
    assert trace.base_name("void thomas::batched_thomas<double, 8, 3>"
                           "(double const*)") == "batched_thomas"
    assert trace.base_name("factor_pairs") == "factor_pairs"
    assert trace.families(REPO / "portbench")["interface_solve"] == "spike"
