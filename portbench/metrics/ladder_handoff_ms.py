"""Device milliseconds a ladder between its levels: from the last device span
of level i to the first of level i + 1 (the casts and prolongation's
start), summed over the hand-offs, the mean over the span pass's ladders."""

from portbench import spans


def read(r):
    sp = spans.of(r)
    return None if sp is None else spans.handoff_ms(sp.spans, sp.calls)
