"""Device milliseconds per LM step outside its ``kkt`` and ``assemble`` spans:
the step's period (the start of ``lm.step`` i to that of i + 1, or to its
end for the last) less the two, so the accept / damping update, the batch's
shared-parameter step and the WHILE node's condition; with the two above it
adds up to the period.  The ladder's finest level."""

from portbench import spans


def read(r):
    sp = spans.of(r)
    return None if sp is None else spans.per_step_ms(sp.spans, "update")
