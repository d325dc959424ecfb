"""Port parity, the Kalman tier as scans: ``collocfem_tpu_torch.kalman.scan``
(the counterpart of ``lax.scan``, captured on a CUDA device, its step bodies
in a loop on the CPU) and every filter, smoother and likelihood that runs
through it, against ``collocfem_tpu.kalman`` (``jax.jit`` on the CPU) on the
same seeded numpy inputs, float64, T = 20-40 samples, 2 RK4 substeps.

Tolerances: every output field within 1e-10 relative (max |diff| / max
|JAX|) of the JAX package's; the likelihoods' values and the gradients of
the scan's replayed backward within 1e-10 relative of ``jax.value_and_grad``
and within 1e-12 of the tape-recording loop (``ScanNLL.plain``).  The scan
itself is held against ``Scan.plain`` and ``torch.autograd.gradcheck``,
forward and reverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collocfem_tpu import kalman as jk
from collocfem_tpu.models import Duffing as JaxDuffing
from collocfem_tpu.models import VanDerPol as JaxVanDerPol
from collocfem_tpu.models.lti import LinearSystem as JaxLinearSystem
from collocfem_tpu_torch import kalman as tk
from collocfem_tpu_torch.kalman.scan import Scan
from collocfem_tpu_torch.kalman.sqrt import _qr_r
from collocfem_tpu_torch.models import Duffing, LinearSystem, VanDerPol
from test_torch_kalman import (A, H, M0, P0, QC, R, _lti_build, _problem,
                               _vdp_series)

F64 = torch.float64
T = 30
SUB = 2


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _hold_fields(got, want, tol=1e-10):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol, (_rel(g, w), tol)


def _mask(masked, n=T):
    return (np.arange(n) % 4 != 1).astype(float) if masked else None


# ---- the scan primitive ------------------------------------------------------


def _toy_step(carry, x, consts):
    (c,) = carry
    a, b = x
    (w,) = consts
    new = torch.tanh(a @ c) * w + b
    return (new,), {"sum": new.sum(), "c": new}


def _toy_inputs(n=6, seed=0, grad=False):
    rng = np.random.default_rng(seed)
    leaves = (_t(rng.standard_normal(3)), _t(rng.standard_normal((n, 3, 3))),
              _t(rng.standard_normal((n, 3))), _t(rng.standard_normal(3)))
    if grad:
        leaves = tuple(x.requires_grad_(True) for x in leaves)
    c0, a, b, w = leaves
    return (c0,), (a, b), (w,)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_equals_the_plain_loop(reverse):
    """The step bodies on static buffers (what the card replays) against the
    tape-recording loop: the same values bit for bit, gradients within
    1e-12, and ys[k] belongs to xs[k] in both directions."""
    args = _toy_inputs(grad=True)
    s = Scan(_toy_step)
    (c, ), ys = s(*args, reverse=reverse)
    (pc, ), pys = s.plain(*args, reverse=reverse)
    assert torch.equal(c, pc) and torch.equal(ys["c"], pys["c"])
    assert torch.equal(ys["sum"], pys["sum"])
    # The last step visited is k = 0 in reverse, k = T - 1 forwards.
    assert torch.equal(c, ys["c"][0 if reverse else -1])
    leaves = [args[0][0], *args[1], args[2][0]]
    g = torch.autograd.grad((c ** 2).sum() + ys["sum"].sum() * 0.3, leaves)
    pg = torch.autograd.grad((pc ** 2).sum() + pys["sum"].sum() * 0.3,
                             leaves)
    for a, b in zip(g, pg):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_backward_passes_gradcheck(reverse):
    """The replayed backward (recompute and VJP per step, the transpose of
    the scan) against finite differences, in every input."""
    s = Scan(_toy_step)

    def fn(c0, a, b, w):
        (c,), ys = s((c0,), (a, b), (w,), reverse=reverse)
        return c, ys["sum"], ys["c"]

    c0, (a, b), (w,) = _toy_inputs(n=4, seed=3, grad=True)
    assert torch.autograd.gradcheck(fn, (c0[0], a, b, w))


def test_scan_keeps_one_plan_per_key():
    """New data of the same key reuses its plan; a new shape, the other
    direction, or a call that wants no gradient makes another."""
    s = Scan(_toy_step)
    s(*_toy_inputs(seed=1, grad=True))
    (c2,), ys2 = s(*_toy_inputs(seed=2, grad=True))
    assert len(s._plans) == 1
    (pc,), pys = s.plain(*_toy_inputs(seed=2))
    assert torch.equal(c2, pc) and torch.equal(ys2["c"], pys["c"])
    s(*_toy_inputs(n=7, grad=True))
    s(*_toy_inputs(grad=True), reverse=True)
    s(*_toy_inputs())
    assert len(s._plans) == 4
    assert torch.equal(s.eager(*_toy_inputs(seed=2))[0][0], pc)
    assert len(s._plans) == 4


def test_scan_rejects_what_it_cannot_run():
    c0, xs, consts = _toy_inputs()
    s = Scan(_toy_step)
    with pytest.raises(ValueError, match="leading length"):
        s(c0, (xs[0], xs[1][:3]), consts)
    with pytest.raises(TypeError, match="tensors"):
        s(c0, xs, (1.5,))
    with pytest.raises(ValueError, match="carry"):
        Scan(lambda c, x, k: ((c[0][:2],), x[1]))(c0, xs, consts)
    with pytest.raises(ValueError, match="no scan"):
        s((c0[0].to("meta"),), tuple(x.to("meta") for x in xs),
          (consts[0].to("meta"),))


def test_householder_qr_matches_lapack():
    """The capturable Householder R against ``torch.linalg.qr``'s (signs
    made nonnegative) on tall and square pre-arrays; with a zero column it
    is still a finite triangular factor (R^T R = M^T M) with a zero on the
    diagonal, and R has a derivative."""
    rng = np.random.default_rng(4)
    for m, n in [(4, 2), (6, 3), (3, 3), (7, 4)]:
        M = _t(rng.standard_normal((m, n)))
        want = torch.linalg.qr(M, mode="r").R
        want = torch.sign(torch.diagonal(want))[:, None] * want
        assert _rel(_qr_r(M), want) <= 1e-13
    Z = _t(rng.standard_normal((5, 3)))
    Z[:, 1] = 0.0
    Rz = _qr_r(Z)
    assert torch.isfinite(Rz).all() and float(Rz[1, 1]) == 0.0
    assert torch.equal(Rz, Rz.triu()) and bool((Rz.diagonal() >= 0).all())
    assert _rel(Rz.T @ Rz, Z.T @ Z) <= 1e-13
    M = _t(rng.standard_normal((6, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(_qr_r, (M,))


# ---- the filters and smoothers against the JAX package -----------------------


@pytest.mark.parametrize("masked", [False, True])
def test_linear_filters_and_smoothers_match_jax(masked):
    """kalman_filter, cd_smoother (a reverse scan), sqrt_kalman_filter and
    sqrt_rts_smoother: every field within 1e-10 relative."""
    ts, y, Ad, Qd = _problem(np.random.default_rng(12), T=T)
    mask = _mask(masked)
    run = jax.jit(lambda y: jk.kalman_filter(Ad, Qd, H, R, y, M0, P0,
                                             mask=mask))
    res = tk.kalman_filter(Ad, Qd, H, R, _t(y), M0, P0, mask=mask,
                           device="cpu")
    jres = run(y)
    _hold_fields(res, jres)
    _hold_fields(tk.cd_smoother(res), jax.jit(jk.cd_smoother)(jres))
    sq = tk.sqrt_kalman_filter(Ad, Qd, H, R, _t(y), M0, P0, mask=mask,
                               device="cpu")
    jsq = jax.jit(lambda y: jk.sqrt_kalman_filter(Ad, Qd, H, R, y, M0, P0,
                                                  mask=mask))(y)
    _hold_fields(sq, jsq)
    _hold_fields(tk.sqrt_rts_smoother(sq, Ad, Qd),
                 jax.jit(lambda r: jk.sqrt_rts_smoother(r, Ad, Qd))(jsq))


def _nonlinear(case):
    """(model, JAX model, p, ts, y, R, Qc, m0, P0) at T samples."""
    if case == "linear":
        ts, y, _, _ = _problem(np.random.default_rng(13), T=T)
        return (LinearSystem(A, C=H), JaxLinearSystem(A, C=H), np.zeros(0),
                ts, y, R, QC, M0, P0)
    if case == "vdp":
        ts, y = _vdp_series(T=T, seed=14)
        return (VanDerPol(), JaxVanDerPol(), np.array([0.8, 0.9]), ts, y,
                np.array([[0.02**2]]), np.diag([1e-6, 1e-2]),
                np.array([2.0, 0.0]), np.eye(2) * 0.1)
    ts, y = _duffing_series()
    return (Duffing(gamma=8.0, omega=0.5), JaxDuffing(gamma=8.0, omega=0.5),
            np.array([0.5, 1.0, 0.5]), ts, y, np.array([[1e-4]]),
            np.diag([1e-8, 0.05**2]), np.array([y[0, 0], 0.0]),
            np.diag([0.1, 4.0]))


def _duffing_series():
    rng = np.random.default_rng(15)
    ts = np.linspace(0.05, 2.0, T)
    return ts, np.cos(1.3 * ts)[:, None] + 0.01 * rng.standard_normal((T, 1))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["linear", "vdp", "duffing"])
@pytest.mark.parametrize("kind", ["ekf", "ukf"])
def test_nonlinear_filters_and_smoother_match_jax(kind, case, masked):
    """ekf_filter / ukf_filter and cd_smoother on their results: every field
    within 1e-10 relative of the JAX package's."""
    model, jmodel, p, ts, y, Rm, Qc, m0, P0_ = _nonlinear(case)
    mask = _mask(masked)
    filt, jfilt = getattr(tk, f"{kind}_filter"), getattr(jk, f"{kind}_filter")
    res = filt(model, p, ts, _t(y), Rm, Qc, m0, P0_, substeps=SUB, mask=mask,
               device="cpu")
    jres = jax.jit(lambda p: jfilt(jmodel, p, ts, y, Rm, Qc, m0, P0_,
                                   substeps=SUB, mask=mask))(jnp.asarray(p))
    _hold_fields(res, jres)
    _hold_fields(tk.cd_smoother(res), jax.jit(jk.cd_smoother)(jres))


# ---- the likelihoods: the replayed backward --------------------------------


def _nlls(kind, masked):
    """(the port's ScanNLL, the JAX NLL, p) of one likelihood."""
    mask = _mask(masked)
    if kind == "lti":
        ts, y, _, _ = _problem(np.random.default_rng(16), T=T,
                               irregular=False)
        return (tk.make_lti_nll(_lti_build(torch), ts, y, mask=mask,
                                device="cpu"),
                jk.make_lti_nll(_lti_build(jnp), ts, y, mask=mask),
                [3.0, 1.0])
    model, jmodel, p, ts, y, Rm, Qc, m0, P0_ = _nonlinear("duffing")
    make, jmake = getattr(tk, f"make_{kind}_nll"), getattr(jk,
                                                            f"make_{kind}_nll")
    args = (ts, y, Rm, Qc, m0, P0_)
    return (make(model, *args, substeps=SUB, mask=mask, device="cpu"),
            jmake(jmodel, *args, substeps=SUB, mask=mask), p)


def _value_and_grad(fn, p):
    x = _t(p).requires_grad_(True)
    v = fn(x)
    (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["lti", "ekf", "ukf"])
def test_nll_gradients_match_jax_and_the_plain_loop(kind, masked):
    """make_lti_nll, make_ekf_nll, make_ukf_nll: the value and the gradient
    of the scan's replayed backward within 1e-10 relative of JAX's and
    within 1e-12 of the tape-recording loop; ``eager`` is the same scan, so
    it equals the call bit for bit; one plan serves every evaluation."""
    nll, jnll, p = _nlls(kind, masked)
    v, g = _value_and_grad(nll, p)
    jv, jg = jax.jit(jax.value_and_grad(jnll))(jnp.asarray(p, jnp.float64))
    assert abs(float(v) - float(jv)) <= 1e-10 * abs(float(jv))
    assert _rel(g, jg) <= 1e-10
    pv, pg = _value_and_grad(nll.plain, p)
    assert abs(float(v) - float(pv)) <= 1e-12 * abs(float(pv))
    assert _rel(g, pg) <= 1e-12
    ev, eg = _value_and_grad(nll.eager, p)
    assert torch.equal(v, ev) and torch.equal(g, eg)
    _value_and_grad(nll, np.asarray(p) * 1.01)
    assert len(nll.scan._plans) == 1


def test_sqrt_filter_gradient_matches_jax():
    """The square-root filter differentiates through the scan (its QR is
    the Householder one): d loglik / d(dt-scaled A) within 1e-10 of
    jax.grad of the JAX package's filter."""
    ts, y, _, _ = _problem(np.random.default_rng(17), T=T)
    # dts[0] > 0: a zero Qd[0] has a repeated eigenvalue, where the
    # derivative of psd_sqrt's eigh is NaN in both packages.
    dts = np.diff(ts, prepend=0.0)

    def loglik(xp, sqrt_filter, discretize):
        def f(p):
            Ap, Qc = _lti_build(xp)(p)[:2]
            Ad, Qd = discretize(Ap, Qc, dts)
            return sqrt_filter(Ad, Qd, H, R, y, M0, P0).loglik
        return f

    x = _t([3.0, 1.0]).requires_grad_(True)
    f = loglik(torch, lambda *a: tk.sqrt_kalman_filter(*a, device="cpu"),
               tk.discretize_lti)
    (g,) = torch.autograd.grad(f(x), x)
    jg = jax.jit(jax.grad(loglik(jnp, jk.sqrt_kalman_filter,
                                 jk.discretize_lti)))(jnp.array([3.0, 1.0]))
    assert _rel(g, jg) <= 1e-10
