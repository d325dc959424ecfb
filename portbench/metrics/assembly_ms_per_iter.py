"""Device milliseconds per LM step in every kernel of no kernel family:
the assembly, the LM step's own arithmetic, cuBLAS and elementwise
kernels."""


def read(r):
    if r.summary is None or r.summary.launches == 0 or not r.total_steps:
        return None
    return 1e3 * r.summary.unmapped_s / r.total_steps
