"""The per-shape kernel builds (``collocfem_tpu_torch/ops/_build.py``) and
the kernels' ranges, on the CPU: no nvcc and no card is needed.

Every library is compiled once per (block size b, right-hand sides r) at
the shape's first use.  These tests hold the pure-Python range checks of
kernels #1-#7 at every 1 <= b <= 16 and at the edges of r and nq, the
instances' names, paths and defines, the digest, the concurrent prebuild,
and the method policy on a CUDA device (``torch.device("cuda")`` needs no
card)."""

import threading
import types

import pytest
import torch

from collocfem_tpu_torch.ops import _build, cr, spike, thomas
from collocfem_tpu_torch.solve.kkt import (require_cr_shapes,
                                           resolve_auto_method,
                                           resolve_method)

BLOCKS = range(1, 17)


@pytest.mark.parametrize("b", BLOCKS)
def test_every_block_size_is_in_range(b):
    """Inside the range every kernel takes the shape: #1 at nq = 1 and 16,
    #2 at r = 1 and 1 + 16 + 2 b, #7 at r = 1 and 17, the CR kernels at r =
    0 (the factor kernel), 1 and 17; one past each edge of r or nq it does
    not."""
    assert spike.kernel_supports(b, 1) and spike.kernel_supports(b, 16)
    assert not spike.kernel_supports(b, 0)
    assert not spike.kernel_supports(b, 17)
    top = 1 + 16 + 2 * b
    assert spike.chain_kernel_supports(b, 1)
    assert spike.chain_kernel_supports(b, top)
    assert not spike.chain_kernel_supports(b, 0)
    assert not spike.chain_kernel_supports(b, top + 1)
    assert thomas.kernel_supports(b, 1) and thomas.kernel_supports(b, 17)
    assert not thomas.kernel_supports(b, 0)
    assert not thomas.kernel_supports(b, 18)
    for r in (0, 1, 17):
        assert cr.kernel_supports(b, r)
    assert not cr.kernel_supports(b, 18)
    assert not cr.kernel_supports(b, -1)
    assert spike.kkt_instance(b, 16) == _build.Instance("kkt_spike", b, 17)
    assert spike.chain_instance(b, top) == _build.Instance("spike_chain", b,
                                                           top)
    assert thomas.instance(b, 17) == _build.Instance("thomas", b, 17)
    assert cr.instance(b, 0) == _build.Instance("cr", b, 0)


# Each instance maker with a shape past its range, and the range its
# message must name.
OUTSIDE = {
    "kkt b=0": (spike.kkt_instance, 0, 2, r"1 <= b <= 16 and 1 <= nq <= 16"),
    "kkt b=17": (spike.kkt_instance, 17, 2, r"1 <= b <= 16 and 1 <= nq <= 16"),
    "kkt nq=17": (spike.kkt_instance, 8, 17,
                  r"1 <= b <= 16 and 1 <= nq <= 16"),
    "kkt nq=0": (spike.kkt_instance, 8, 0, r"1 <= b <= 16 and 1 <= nq <= 16"),
    "chain b=0": (spike.chain_instance, 0, 1, r"1 <= r <= 1 \+ 16 \+ 2 b"),
    "chain b=17": (spike.chain_instance, 17, 1, r"1 <= b <= 16"),
    "chain r past": (spike.chain_instance, 8, 34, r"1 <= r <= 1 \+ 16 \+ 2 b"),
    "thomas b=0": (thomas.instance, 0, 3, r"1 <= b <= 16 and 1 <= r <= 17"),
    "thomas b=17": (thomas.instance, 17, 3, r"1 <= b <= 16 and 1 <= r <= 17"),
    "thomas r=18": (thomas.instance, 8, 18, r"1 <= b <= 16 and 1 <= r <= 17"),
    "cr b=0": (cr.instance, 0, 1, r"1 <= b <= 16 and 1 <= r <= 17"),
    "cr b=17": (cr.instance, 17, 0, r"1 <= b <= 16 and 1 <= r <= 17"),
    "cr r=18": (cr.instance, 8, 18, r"1 <= b <= 16 and 1 <= r <= 17"),
}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_shapes_outside_the_range_raise(case):
    """A shape outside a kernel's range raises ValueError naming the range,
    and its range check says no."""
    make, b, r, message = OUTSIDE[case]
    with pytest.raises(ValueError, match=message):
        make(b, r)


def test_range_checks_raise_with_the_range():
    """The checks the wrappers run on a CUDA tensor before any launch name
    the kernel and the range."""
    with pytest.raises(ValueError, match=r"kernel #1 takes 1 <= b <= 16"):
        spike.kkt_instance(17, 1)
    with pytest.raises(ValueError, match=r"kernel #2 takes 1 <= b <= 16"):
        spike.chain_instance(4, 1 + 16 + 8 + 1)
    with pytest.raises(ValueError, match=r"kernel #7 takes 1 <= b <= 16"):
        thomas.instance(4, 18)
    assert spike.kkt_instance(16, 16).r == 17
    assert spike.chain_instance(16, 49).r == 49


@pytest.mark.parametrize("lib,b,r,defines", [
    ("kkt_spike", 4, 3, ("-DCF_B=4", "-DCF_R=3", "-DCF_KKT=1")),
    ("spike_chain", 16, 1, ("-DCF_B=16", "-DCF_R=1", "-DCF_KKT=0")),
    ("thomas", 4, 3, ("-DCF_B=4", "-DCF_R=3")),
    ("cr", 12, 0, ("-DCF_B=12", "-DCF_R=0")),
])
def test_instance_name_path_and_defines(lib, b, r, defines):
    """An instance is named <lib>-b<b>-r<r>, built from its library's source
    into BUILD_DIR under that name and the digest, with the shape as
    defines."""
    inst = _build.Instance(lib, b, r)
    assert inst.name == f"{lib}-b{b}-r{r}"
    assert inst.defines == defines
    so, log = inst.paths()
    assert so == _build.BUILD_DIR / f"{lib}-b{b}-r{r}-{_build.digest()}.so"
    assert log == so.with_suffix(".log")
    assert inst.source.parent == _build.CSRC and inst.source.exists()
    assert inst.source.name == ("kkt_spike.cu" if "spike" in lib
                                else f"{lib}.cu")
    with pytest.raises(ValueError, match="unknown library"):
        _build.Instance("nope", b, r)


def test_digest_changes_with_the_flags_and_the_sources(monkeypatch,
                                                       tmp_path):
    """The digest, and with it every instance's path, changes with the
    compiler flags and with any file in csrc/."""
    inst = _build.Instance("cr", 8, 3)
    base, path = _build.digest(), inst.paths()[0]
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.digest() != base
    assert inst.paths()[0] != path
    monkeypatch.undo()
    copy = tmp_path / "csrc"
    copy.mkdir()
    for src in _build.CSRC.iterdir():
        (copy / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.digest() == base
    (copy / "cr.cu").write_bytes((copy / "cr.cu").read_bytes() + b"\n")
    assert _build.digest() != base


def test_prebuild_compiles_only_the_missing_instances_at_once(monkeypatch,
                                                              tmp_path):
    """prebuild runs one compile per missing instance, several at once,
    skips those already built, and returns each compiled one's wall."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.os, "cpu_count", lambda: 4)
    done, threads, barrier = [], set(), threading.Barrier(2, timeout=30)

    def fake_compile(inst):
        threads.add(threading.get_ident())
        barrier.wait()          # two compiles run at the same time
        inst.paths()[0].write_bytes(b"")
        done.append(inst)
        return 1.5

    monkeypatch.setattr(_build, "_compile_one", fake_compile)
    have = _build.Instance("thomas", 8, 3)
    have.paths()[0].write_bytes(b"")
    want = [_build.Instance("cr", 4, 2), _build.Instance("kkt_spike", 9, 2),
            have, _build.Instance("cr", 4, 2)]
    walls = _build.prebuild(want)
    assert walls == {want[0]: 1.5, want[1]: 1.5}
    assert sorted(i.name for i in done) == ["cr-b4-r2", "kkt_spike-b9-r2"]
    assert len(threads) == 2
    assert _build.prebuild(want) == {}


CUDA = torch.device("cuda")


@pytest.mark.parametrize("b", [1, 4, 6, 9, 12, 16])
def test_auto_method_on_a_cuda_device_without_a_card(b, monkeypatch):
    """On a CUDA device 'auto' is SPIKE and the CR kernels take every count
    the KKT solve gives them, for b in {1, 4, 6, 9, 12, 16}, with and
    without refinement and at nq = 0; neither builds anything."""
    monkeypatch.setattr(_build, "prebuild", pytest.fail)
    for nq, refine in ((0, 0), (1, 0), (2, 0), (5, 2), (16, 0)):
        assert resolve_auto_method(b, nq, CUDA, refine) == "spike"
        require_cr_shapes(b, nq, CUDA, refine)
        require_cr_shapes(b, nq, "cuda", refine)
    assert resolve_auto_method(b, 2, "cpu") == "cr"
    with pytest.raises(ValueError, match=r"1 <= b <= 16 and 1 <= nq <= 16"):
        resolve_auto_method(b, 17, CUDA)
    with pytest.raises(ValueError, match=r"1 <= b <= 16 and 1 <= r <= 17"):
        require_cr_shapes(b, 17, CUDA)
    with pytest.raises(ValueError, match=r"1 <= b <= 16"):
        resolve_auto_method(b + 16, 1, CUDA)


def _problem(degree, nv, nq, device):
    return types.SimpleNamespace(
        mesh=types.SimpleNamespace(degree=degree), nv=nv,
        model=types.SimpleNamespace(nq=nq), device=torch.device(device))


@pytest.mark.parametrize("method,degree,nv,nq,refine,want", [
    ("auto", 2, 2, 2, 0, [("kkt_spike", 4, 3)]),
    ("auto", 3, 3, 1, 0, [("kkt_spike", 9, 2)]),
    ("auto", 4, 2, 3, 2, [("spike_chain", 8, 1), ("spike_chain", 8, 4)]),
    ("auto", 4, 4, 0, 0, [("spike_chain", 16, 1)]),
    ("cr", 4, 3, 0, 0, [("cr", 12, 0), ("cr", 12, 1)]),
    ("cr", 2, 2, 2, 0, [("cr", 4, 0), ("cr", 4, 3)]),
    ("cr", 4, 2, 5, 1, [("cr", 8, 0), ("cr", 8, 1), ("cr", 8, 6)]),
])
def test_resolve_method_builds_what_the_solve_runs(method, degree, nv, nq,
                                                   refine, want,
                                                   monkeypatch):
    """On a CUDA device resolve_method, which every solver runs when it is
    made, builds and loads every instance the solve will launch (b =
    degree x nv); on the CPU it builds nothing."""
    loaded = []
    monkeypatch.setattr(_build, "load_all", loaded.extend)
    expected = "spike" if method == "auto" else "cr"
    assert resolve_method(_problem(degree, nv, nq, "cuda"), method,
                          refine) == expected
    assert [(i.lib, i.b, i.r) for i in loaded] == want
    loaded.clear()
    assert resolve_method(_problem(degree, nv, nq, "cpu"), method,
                          refine) == "cr"
    assert loaded == []


@pytest.mark.parametrize("layout,want", [("soa", ("spike_chain", 4, 3)),
                                         ("blocks", ("thomas", 4, 3))])
def test_multi_experiment_solver_builds_its_kernel_when_made(layout, want,
                                                             monkeypatch):
    """make_multi_experiment_solver on a CUDA device builds its layout's
    chain kernel at (b, 1 + nq) when it is made (here Van der Pol at degree
    2: b = 4, nq = 2), before any call."""
    from collocfem_tpu_torch.parallel import batch

    loaded = []
    monkeypatch.setattr(_build, "load", loaded.append)
    monkeypatch.setattr(batch, "captured_lm_solve", lambda *a, **k: "solve")
    assert batch.make_multi_experiment_solver(
        _problem(2, 2, 2, "cuda"), layout=layout) == "solve"
    assert [(i.lib, i.b, i.r) for i in loaded] == [want]
    loaded.clear()
    batch.make_multi_experiment_solver(_problem(2, 2, 2, "cpu"),
                                       layout=layout)
    assert loaded == []
