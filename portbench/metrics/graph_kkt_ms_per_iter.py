"""Device milliseconds per LM step in the ``kkt`` spans (the damped linear
solve) of the captured solves of the span pass; the ladder's finest level."""

from portbench import spans


def read(r):
    sp = spans.of(r)
    return None if sp is None else spans.per_step_ms(sp.spans, "kkt")
