"""Benchmark of the PyTorch and CUDA port ``collocfem_tpu_torch``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is data found by name: the
configuration (``configs/<config>.json``), the traffic (``workloads/
<traffic>.json``), the kernel families (``kernels/*.json``) and one reader
per per-layer metric (``metrics/<metric>.py``).  Nothing here imports JAX
or the JAX package; the plain reference (``reference/``) imports nothing of
the port.
"""
