"""The GN element kernel's plain version (``ops/gn_elements.py``: the model's
values at the nodes, then each element's Jacobian built from the structure
of ``elem_residual``) against the element-level ``assemble_gn_soa``
(``vmap(jacfwd(elem_residual))``), every leaf and the cost; and the dispatch
that decides between them.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import itertools

import numpy as np
import pytest
import torch

from collocfem_tpu_torch.models import LinearSystem, Pendulum, VanDerPol
from collocfem_tpu_torch.ops import gn_elements
from collocfem_tpu_torch.ops.assemble import assemble_gn_soa
from collocfem_tpu_torch.ops.mesh import uniform_mesh
from collocfem_tpu_torch.problem import Decision, EstimationProblem
from collocfem_tpu_torch.utils import profiling

F64, F32 = torch.float64, torch.float32
LEAVES = ("D", "E", "B", "C", "gx", "gp")


def _lti():
    """3 states, 2 inputs, the 9 entries of A estimated, 2 outputs."""
    a = [[-0.5, 1.0, 0.0], [-1.0, -0.2, 0.3], [0.1, 0.0, -0.8]]
    b = [[1.0, 0.0], [0.0, 0.5], [0.2, 0.1]]
    c = [[1.0, 0.0, 0.5], [0.0, 1.0, -0.3]]
    return LinearSystem(a, b, c, estimate_params=True), np.ravel(a) + 0.05


MODELS = {"vdp": lambda: (VanDerPol(), np.array([1.1, 0.9])), "lti": _lti}
# Samples per element on average: the LTI model's 25 Jacobian columns keep
# a tile of its elements in shared memory only for a few samples each.
SAMPLES = {"vdp": 3, "lti": 1}


def _case(model_name, n, rule, weights, dtype, pad=1):
    """A seeded problem, data and iterate: SAMPLES x N random sample times
    grouped with ``pad`` padded slots past the fullest element, priors
    on p and x(t0) on; ``weights`` 'shared' gives a shared meas_w and
    per-state x0 weights, 'sample' a per-sample meas_w and a full x0
    sqrt-information matrix."""
    model, p = MODELS[model_name]()
    rng = np.random.default_rng(1000 * n + len(rule) + len(weights))
    nx, nu, nq, ny = model.nx, model.nu, model.nq, model.ny
    tf, d = 4.0, 4
    mesh = uniform_mesh(0.0, tf, n, d)
    t_meas = np.sort(rng.uniform(0.0, tf, SAMPLES[model_name] * n))
    counts = np.bincount(mesh.interp_rows(t_meas)[0], minlength=n)
    prob = EstimationProblem.build(model, mesh, t_meas, defect_weight=20.0,
                                   pad_to=int(counts.max()) + pad,
                                   device="cpu", dtype=dtype,
                                   defect_rule=rule)
    y = rng.standard_normal((t_meas.size, ny))
    x0w = (np.tril(rng.uniform(0.2, 1.0, (nx, nx))) if weights == "sample"
           else rng.uniform(0.2, 1.0, nx))
    data = prob.pack_data(
        y, t_meas, u_nodes=rng.standard_normal((n, d + 1, nu)),
        meas_weight=rng.uniform(0.5, 2.0, ny), p_prior=p + 0.1,
        p_weight=rng.uniform(0.1, 0.5, nq), x0_prior=rng.standard_normal(nx),
        x0_weight=x0w)
    if weights == "sample":
        data = data._replace(meas_w=torch.as_tensor(
            rng.uniform(0.5, 2.0, tuple(prob.mmask.shape) + (ny,)),
            dtype=dtype))
    z = Decision(V=torch.as_tensor(rng.standard_normal((mesh.num_nodes, nx)),
                                   dtype=dtype),
                 p=torch.as_tensor(p, dtype=dtype))
    return prob, z, data


@pytest.mark.parametrize("dtype,n,model,rule,weights", list(itertools.product(
    [F64, F32], [1, 2, 40, 101], ["vdp", "lti"], ["interior", "full"],
    ["shared", "sample"])))
def test_plain_version_matches_the_element_level_path(dtype, n, model, rule,
                                                      weights):
    """Every leaf and the float64 cost: float64 within rtol 1e-12 (an
    absolute floor of 1e-12 x the leaf's largest entry, for entries that
    cancel), float32 within 2e-5 x the leaf's largest entry."""
    prob, z, data = _case(model, n, rule, weights, dtype)
    assert bool((prob.mmask == 0).any())          # padded samples
    assert gn_elements.in_range(prob, data)
    want, want_cost = assemble_gn_soa(prob, z, data, with_cost=True)
    vals = gn_elements.node_values(prob, z, data)
    got, got_cost = gn_elements.gn_system_ref(prob, z, data, vals)
    tol = 1e-12 if dtype == F64 else 2e-5
    for name in LEAVES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype == dtype, name
        scale = float(w.abs().max())
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=tol if dtype == F64 else 0.0,
            atol=tol * scale, err_msg=name)
    assert got_cost.dtype == want_cost.dtype == F64
    assert abs(float(got_cost) - float(want_cost)) <= \
        (1e-12 if dtype == F64 else 1e-6) * float(want_cost)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_node_values_come_in_the_working_dtype(dtype):
    """Config 4's aircraft model, whose h under jacfwd gives float64
    derivatives of float32 inputs: the node values come in the iterate's
    dtype, and the plain version matches the element-level path as above
    (float32: 2e-5 x each leaf's largest entry)."""
    from collocfem_tpu_torch import configs

    prob, z, data = configs.build_config4_problem(dtype=dtype, device="cpu")
    assert gn_elements.in_range(prob, data)
    vals = gn_elements.node_values(prob, z, data)
    assert all(v.dtype == dtype for v in vals)
    got, got_cost = gn_elements.gn_system_ref(prob, z, data, vals)
    want, want_cost = assemble_gn_soa(prob, z, data, with_cost=True)
    tol = 1e-12 if dtype == F64 else 2e-5
    for name in LEAVES:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == dtype, name
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=tol if dtype == F64 else 0.0,
            atol=tol * float(w.abs().max()), err_msg=name)
    assert abs(float(got_cost) - float(want_cost)) <= \
        (1e-12 if dtype == F64 else 1e-6) * float(want_cost)


def _counted(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before[k]
                 for k in ("assembly_fused", "assembly_generic")}


class _OwnResidual(EstimationProblem):
    """An estimation problem whose elem_residual is its own."""

    def elem_residual(self, xe_flat, p, ed):
        return super().elem_residual(xe_flat, p, ed)


def test_dispatch_takes_the_generic_path_outside_the_range():
    """On the CPU every assembly takes the element-level path and counts
    it; the range check refuses a shape outside the kernel's range (nq = 0,
    a chain block above 16, a tile of Jacobians past the shared memory) and
    an overridden elem_residual, and takes the headline's shape."""
    prob, z, data = _case("vdp", 6, "interior", "shared", F64)
    assert gn_elements.in_range(prob, data)
    assert not gn_elements.engages(prob, z, data)      # CPU tensors
    _, moved = _counted(lambda: assemble_gn_soa(prob, z, data))
    assert moved == {"assembly_fused": 0, "assembly_generic": 1}

    mesh = uniform_mesh(0.0, 2.0, 6, 4)
    t = np.linspace(0.05, 1.95, 12)
    pend = EstimationProblem.build(Pendulum(), mesh, t, device="cpu",
                                   dtype=F64)
    pdata = pend.pack_data(np.zeros((12, pend.model.ny)), t)
    assert pend.model.nq == 0 and not gn_elements.in_range(pend, pdata)
    pz = Decision(V=torch.zeros(mesh.num_nodes, 2, dtype=F64),
                  p=torch.zeros(0, dtype=F64))
    _, moved = _counted(lambda: assemble_gn_soa(pend, pz, pdata))
    assert moved == {"assembly_fused": 0, "assembly_generic": 1}

    own = _OwnResidual(prob.model, prob.mesh,
                       dict(prob.named_buffers()), prob.defect_rule)
    assert not gn_elements.in_range(own, data)
    assert gn_elements.kernel_supports(4, 2, 2, 2, 1, False)
    assert not gn_elements.kernel_supports(5, 4, 2, 2, 1, False)   # b = 20
    assert not gn_elements.kernel_supports(4, 2, 17, 2, 1, False)
    assert not gn_elements.kernel_supports(4, 2, 2, 100, 4, False)
    with pytest.raises(ValueError, match="GN element kernel takes"):
        gn_elements.instance(4, 2, 2, 100, 4, False)
