"""Percent of the span pass's call walls (call to ``synchronize()``) in which
no device span was open: the captured solve's idle device."""

from portbench import spans


def read(r):
    sp = spans.of(r)
    return None if sp is None else spans.idle_share(sp.spans, sp.calls)
