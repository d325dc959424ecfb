"""Kernels the profiled solve launched per LM step (copies and memsets not
counted), over every level."""


def read(r):
    if r.summary is None or r.summary.launches == 0 or not r.total_steps:
        return None
    return r.summary.launches / r.total_steps
