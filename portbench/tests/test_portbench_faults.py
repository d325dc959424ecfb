"""The check fails a run whose timed path is broken underneath, once for
each fault a cell can have: a step that returns its state unchanged, half
of the batch left out (the shared p then fits the rest), and an answer
altered where it is produced.  One card holds each cell whole, so no cell
has an exchange between chips to leave out."""

import pytest
import torch
from portbench_testkit import TINY, run, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


@pytest.fixture(autouse=True)
def low_chain(monkeypatch):
    from collocfem_tpu_torch import refine

    monkeypatch.setattr(refine, "CR_DW_CHAIN", 8)


def unchanged_step(monkeypatch):
    from collocfem_tpu_torch.solve import lm_core

    monkeypatch.setattr(lm_core, "lm_step", lambda st, *a, **k: st)


def half_batch(monkeypatch):
    from collocfem_tpu_torch.ops import assemble

    jacobians = assemble._batched_jacobians

    def left_out(problem, Vb, p, data_batch):
        r, jx, jp = jacobians(problem, Vb, p, data_batch)
        half = Vb.shape[0] // 2
        keep = (torch.arange(Vb.shape[0]) < half).to(r.dtype)
        # The leading axis of r, jx and jp is the experiment's.
        mask = lambda t: t * keep.reshape(-1, *([1] * (t.dim() - 1)))
        return mask(r), mask(jx), mask(jp)

    monkeypatch.setattr(assemble, "_batched_jacobians", left_out)


def altered_answer(monkeypatch):
    from collocfem_tpu_torch.solve import newton

    loop = newton.lm_loop       # every solver's loop on the CPU

    def altered(*args, **kwargs):
        st = loop(*args, **kwargs)
        return st._replace(z=st.z._replace(p=st.z.p * (1.0 + 1e-3)))

    monkeypatch.setattr(newton, "lm_loop", altered)


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "altered_answer": altered_answer}
CASES = [(f, c) for f in FAULTS for c in sorted(TINY)
         if f != "half_batch" or c in ("tiny.soa", "tiny.blocks")]


@pytest.mark.parametrize("fault,cell", CASES)
def test_the_check_fails_a_broken_timed_path(root, monkeypatch, fault, cell):
    FAULTS[fault](monkeypatch)
    res = run(root, cell)
    assert not res["correct"], res["checks"]
