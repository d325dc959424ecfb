"""The metrics that read the port's spans: their arithmetic on a synthetic
span list, and the span pass on the CPU through a tiny cell's system under
test, found in its caller's frame as the harness calls the readers."""

import dataclasses

import pytest
from portbench_testkit import REPO, tiny_root  # noqa: F401  (sys.path)

from collocfem_tpu_torch.utils.profiling import Span
from portbench import spans

MS = 1_000_000


def _dev(name, start, end, sid, parent, solve):
    return Span(name, start * MS, end * MS, sid, parent, solve, True)


def _host(name, start, end, sid, parent, solve=0):
    return Span(name, start * MS, end * MS, sid, parent, solve, False)


def _two_step_solve(base, solve, parent, first_id):
    """A solve of two LM steps on [base, base + 10] ms: load 0-1, prelude
    1-2, step 2-5 (kkt 2-3, assemble 3-4.5), step 5.5-8.5 (kkt 5.5-6.5,
    shared 6.5-7, assemble 7-8), outputs 9-9.5."""
    i = first_id
    b = base
    return [
        _host("solve", b, b + 10, solve, parent, solve),
        _dev("solve.load", b, b + 1, i, solve, solve),
        _dev("lm.prelude", b + 1, b + 2, i + 1, solve, solve),
        _dev("lm.step", b + 2, b + 5, i + 2, solve, solve),
        _dev("kkt", b + 2, b + 3, i + 3, i + 2, solve),
        _dev("assemble", b + 3, b + 4.5, i + 4, i + 2, solve),
        _dev("lm.step", b + 5.5, b + 8.5, i + 5, solve, solve),
        _dev("kkt", b + 5.5, b + 6.5, i + 6, i + 5, solve),
        _dev("shared", b + 6.5, b + 7, i + 7, i + 5, solve),
        _dev("assemble", b + 7, b + 8, i + 8, i + 5, solve),
        _dev("solve.outputs", b + 9, b + 9.5, i + 9, solve, solve),
    ]


def test_per_step_parts_add_up_to_the_step_period():
    """Periods 3.5 and 3 ms: kkt 1 + 1, assemble 1.5 + 1, the rest 1 + 1
    (the second's shared 0.5 in it)."""
    sp = _two_step_solve(0, 1, 0, 100)
    assert spans.per_step_ms(sp, "kkt") == pytest.approx(1.0)
    assert spans.per_step_ms(sp, "assemble") == pytest.approx(1.25)
    assert spans.per_step_ms(sp, "update") == pytest.approx(1.0)
    assert spans.per_step_ms(sp, "shared") == pytest.approx(0.25)
    total = sum(spans.per_step_ms(sp, p) for p in ("kkt", "assemble",
                                                  "update"))
    assert total == pytest.approx((3.5 + 3.0) / 2)
    assert spans.per_step_ms([], "kkt") is None
    assert spans.per_step_ms(_two_step_solve(0, 1, 0, 100)[:6], "shared") \
        is None


def test_idle_share_counts_the_wall_outside_every_device_span():
    """A call of 12 ms around the solve: device spans cover 0-5, 5.5-8.5
    and 9-9.5 of it; idle 0.5 inside the solve's captured region ("graph"),
    0.5 in the solve's host span and the call's last 2.5 ms in none."""
    sp = _two_step_solve(0, 1, 0, 100)
    call = spans.Call(0, 0, 12 * MS, [(40, 2)], 2)
    assert spans.idle_share(sp, [call]) == pytest.approx(100 * 3.5 / 12)
    gaps = spans.idle_gaps(sp, [call])
    assert gaps["graph"] == pytest.approx(0.5 * MS)
    assert gaps["solve"] == pytest.approx(0.5 * MS)
    assert gaps["host"] == pytest.approx(2.5 * MS)


def test_the_ladder_reads_its_finest_level_and_its_hand_offs():
    """Two levels: the per-step metrics read the last one's solve only; the
    hand-off runs from level 0's last device span (its outputs at 9.5 ms)
    to level 1's first (the prolongation at 10.5 ms)."""
    sp = [_host("ladder.level[0]", 0, 10, 1, 0),
          _host("ladder.level[1]", 10, 30, 2, 0)]
    sp += _two_step_solve(0, 3, 1, 100)
    sp += [_dev("ladder.prolong", 10.5, 11, 150, 2, 0)]
    fine = _two_step_solve(12, 4, 2, 200)
    fine[4] = dataclasses.replace(fine[4], end=fine[4].start + 2 * MS)
    sp += fine
    call = spans.Call(0, 0, 30 * MS, [(40, 2), (160, 2)], 4)
    assert spans.finest_solves(sp) == {4}
    assert spans.per_step_ms(sp, "kkt") == pytest.approx(1.5)
    assert spans.handoff_ms(sp, [call]) == pytest.approx(1.0)
    assert spans.handoff_ms(_two_step_solve(0, 1, 0, 100), [call]) is None


def test_the_readers_return_none_without_a_card(tmp_path):
    """A traced tiny run on the CPU reports none of the span metrics: the
    pass runs only on a CUDA device."""
    from portbench_testkit import run

    root = tiny_root(tmp_path)
    res = run(root, "tiny.conv", trace=True)
    assert res["correct"]
    assert not {"graph_kkt_ms_per_iter", "graph_idle_share",
                "setup_capture_s"} & set(res["metrics"])


def test_the_pass_runs_on_the_sut_found_in_the_callers_frame(tmp_path):
    """The pass on the CPU, reached as the harness reaches the readers:
    each data set solved once unrecorded and once recorded after the marked
    plan's first call (here the eager loop), one ``lm.step`` an iteration,
    the per-step parts adding up to the period."""
    from collocfem_tpu_torch.utils import profiling
    from portbench import data, harness, port

    root = tiny_root(tmp_path)
    cell = harness.load_cell(root, "tiny.soa")
    sets = data.datasets(cell.config, cell.traffic, 1)
    sut = port.build(cell.config, cell.traffic, sets, "cpu")
    reading = harness.Reading(cell, None, [], 0.0)

    def harness_like(reading, sut, device, records):
        return spans.of(reading)

    assert harness_like(reading, sut, "cpu", []) is None     # not a card
    del reading.span_pass
    sp = harness_like(reading, sut, "cuda", [])
    assert reading.spans is sp.spans and spans.of(reading) is sp
    assert [c.dataset for c in sp.calls] == list(range(len(sets)))
    assert [k for k, _ in sp.off] == list(range(len(sets)))
    assert sp.counters.keys() == profiling.counters().keys()
    for c in sp.calls:
        ids = spans.solves_of(sp.spans, c)
        n = sum(s.name == "lm.step" and s.solve in ids for s in sp.spans)
        assert n == c.iterations == sum(k for _, k in c.steps)
    rows = spans.step_table(sp.spans, spans.finest_solves(sp.spans))
    period = sum(p for p, _ in rows) / len(rows) * 1e-6
    parts = sum(spans.per_step_ms(sp.spans, p)
                for p in ("kkt", "assemble", "update"))
    assert parts == pytest.approx(period, rel=1e-9)
