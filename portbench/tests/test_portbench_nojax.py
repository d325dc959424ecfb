"""The no-JAX check compares whole top-level module names."""

import subprocess
import sys

import pytest
from portbench_testkit import REPO

from portbench.nojax import forbidden_modules


def test_the_port_passes():
    assert forbidden_modules(["collocfem_tpu_torch",
                              "collocfem_tpu_torch.ops.spike", "torch",
                              "jaxtyping", "collocfem_tpu_tools"]) == []


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "jaxlib.xla_client", "flax",
                                  "collocfem_tpu", "collocfem_tpu.x"])
def test_jax_and_the_jax_package_fail(name):
    assert forbidden_modules([name, "collocfem_tpu_torch", "numpy"]) == [name]


def test_a_process_that_loads_the_harness_and_the_port_loads_no_jax():
    code = ("import portbench.harness, portbench.port, portbench.control, "
            "collocfem_tpu_torch.headline, collocfem_tpu_torch.parallel.batch"
            "; from portbench.nojax import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]"
