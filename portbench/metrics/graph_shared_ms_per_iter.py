"""Device milliseconds per LM step in the ``shared`` spans (the
shared-parameter Schur step and the reductions feeding it) of the span
pass's captured batch solves."""

from portbench import spans


def read(r):
    sp = spans.of(r)
    return None if sp is None else spans.per_step_ms(sp.spans, "shared")
