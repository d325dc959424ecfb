"""Run one cell of BENCHMARK.json once on the card and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  It exits with a non-zero code and prints
no result where there is no CUDA device, or fewer than the cell asks for,
where the checkout lacks the port, or where JAX or the JAX package was
loaded by the end of the run.  The port's kernels build into the fixed
``collocfem_tpu_torch/build/`` of the checkout, so only the first run of a
cell there compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    harness.card_notes()
    return harness.finish(result)


if __name__ == "__main__":
    sys.exit(main())
