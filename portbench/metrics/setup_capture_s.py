"""Host seconds of set-up in CUDA-graph warm-ups, captures and
instantiations (the spans ``graph.warmup``, ``graph.capture`` and
``graph.instantiate``, which the port's counter ``graph_setup_ns`` sums with
recording off), read before the span pass captures its marked plans."""

from portbench import spans


def read(r):
    sp = spans.of(r)
    return None if sp is None else sp.counters["graph_setup_ns"] * 1e-9
