"""One short run of each cell on the card, from the command the driver
runs; skips where there is no CUDA device."""

import json
import subprocess
import sys

import pytest
from portbench_testkit import REPO

CELLS = ["vdp.n10k_conv_f64", "batch.soa_conv_f64", "batch.blocks_conv_f64",
         "vdp.n100k_ladder"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483647", "--seconds", "2", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=1200, check=False)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


def test_without_a_card_the_command_exits_non_zero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300, check=False)
    assert out.returncode != 0 and out.stdout == ""
