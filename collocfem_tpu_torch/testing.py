"""Seeded inputs, set-ups and residual checks shared by the port's tests and
``chip_smoke.py``."""

from __future__ import annotations

import numpy as np
import torch

from collocfem_tpu_torch.ops.assemble import BlockTriSystemSoA


def random_kkt_system(k: int, b: int, nq: int, seed: int, *,
                      dtype=torch.float64, device="cpu") -> BlockTriSystemSoA:
    """A seeded SPD bordered system in SoA layout.

    The chain blocks are diagonally dominant and the parameter corner
    dominates the Schur term B^T A^-1 B, so every damped system is positive
    definite.  Drawn in float64 with numpy, then cast.
    """
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, b, b))
    D = np.moveaxis(m @ m.transpose(0, 2, 1) + 2 * b * np.eye(b), 0, -1)
    m2 = rng.standard_normal((nq, nq))
    arrays = dict(D=D, E=0.3 * rng.standard_normal((b, b, k)),
                  B=rng.standard_normal((b, nq, k)),
                  C=m2 @ m2.T + 2 * b * k * np.eye(nq),
                  gx=rng.standard_normal((b, k)),
                  gp=rng.standard_normal(nq))
    return BlockTriSystemSoA(**{
        name: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                              device=device)
        for name, a in arrays.items()})


def random_chain(k: int, b: int, r: int, seed: int, *, boundary=None,
                 dtype=torch.float64, device="cpu"):
    """A seeded SPD block-tridiagonal chain in SoA layout: (D, E (b, b, K),
    G (b, r, K)).  With ``boundary`` every boundary-th coupling is exactly
    zero, as at the experiment boundaries of a concatenated chain."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, b, b))
    D = m @ m.transpose(0, 2, 1) + 2 * b * np.eye(b)
    E = 0.3 * rng.standard_normal((k, b, b))
    if boundary:
        E[boundary - 1::boundary] = 0.0
    G = rng.standard_normal((k, b, r))
    return tuple(torch.as_tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)),
                                 dtype=dtype, device=device) for a in (D, E, G))


def random_chain_batch(n_exp: int, k: int, b: int, r: int, seed: int, *,
                       dtype=torch.float64, device="cpu"):
    """A seeded batch of SPD chains in block-major layout: (D, E
    (n_exp, K, b, b), G (n_exp, K, b, r))."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n_exp, k, b, b))
    D = m @ m.transpose(0, 1, 3, 2) + 4 * b * np.eye(b)
    E = 0.3 * rng.standard_normal((n_exp, k, b, b))
    G = rng.standard_normal((n_exp, k, b, r))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (D, E, G))


def chain_residual(D, E, G, X) -> float:
    """||A X - G||_inf / ||G||_inf in float64 for an SoA chain (E[..., K-1]
    ignored)."""
    D, E, G, X = (a.double() for a in (D, E, G, X))
    e = E[..., :-1]
    AX = torch.einsum("ijk,jrk->irk", D, X)
    AX[..., :-1] += torch.einsum("ijk,jrk->irk", e, X[..., 1:])
    AX[..., 1:] += torch.einsum("jik,jrk->irk", e, X[..., :-1])
    return float((AX - G).abs().max() / G.abs().max())


def kkt_residual(sys_, dx, dp, lam, dmax) -> float:
    """Relative x-block residual ||(A + lam_abs I) dx + B dp + gx||_inf /
    ||gx||_inf of the damped system (lam_abs = lam dmax), in float64."""
    D, E, B, _, gx, _ = (a.double() for a in sys_)
    dx, dp = dx.double(), dp.double()
    lam_abs = float(lam) * float(dmax)
    E = E[..., :-1]                            # E[..., K-1] is unused
    y = torch.einsum("ijk,jk->ik", D, dx) + lam_abs * dx
    y[:, :-1] += torch.einsum("ijk,jk->ik", E, dx[:, 1:])
    y[:, 1:] += torch.einsum("jik,jk->ik", E, dx[:, :-1])
    y += torch.einsum("iqk,q->ik", B, dp) + gx
    return float(y.abs().max() / gx.abs().max())


def rel_err(x, want) -> float:
    """max|x - want| / max|want|, in float64."""
    x, want = x.double(), want.double()
    return float((x - want).abs().max() / want.abs().max())


def cr_level_comparison(Ds, Es, Gs, Gs_level=None):
    """Every CR kernel, its plain version and the plain version in float64
    on one level's inputs (Ds, Es (b, b, m), Gs (b, r, m)).

    Returns {kernel name: (kernel outputs, plain outputs, float64 plain
    outputs)}, each a list of tensors.  The apply kernel reduces Gs through
    the factor kernel's own output, its plain version through the plain
    factor; the back-substitution takes g_new as x_even; the fused level
    takes ``Gs_level`` (default Gs).
    """
    from collocfem_tpu_torch.ops import cr

    out = {}
    (dn, en), fac = cr.cr_level_factor(Ds, Es)
    (dn_p, en_p), fac_p = cr.cr_level_factor_ref(Ds, Es)
    (dn_x, en_x), fac_x = cr.level_factor_plain(Ds.double(), Es.double())
    out["cr_level_factor"] = tuple(
        [d, e, f.L, f.s_up, f.s_lo] for d, e, f in
        ((dn, en, fac), (dn_p, en_p, fac_p), (dn_x, en_x, fac_x)))
    applied = (cr.cr_level_apply(fac, Gs), cr.cr_level_apply_ref(fac_p, Gs),
               cr.level_apply_plain(fac_x, Gs.double()))
    out["cr_level_apply"] = tuple(list(a) for a in applied)
    Gl = Gs if Gs_level is None else Gs_level
    levels = (cr.cr_level(Ds, Es, Gl), cr.cr_level_ref(Ds, Es, Gl),
              cr.level_plain(Ds.double(), Es.double(), Gl.double()))
    out["cr_level"] = tuple(list(a) + list(s) for a, s in levels)
    x_even = applied[1][0].contiguous()
    out["cr_backsub"] = (
        [cr.cr_backsub(x_even, fac.s_up, fac.s_lo, applied[0][1])],
        [cr.cr_backsub_ref(x_even, fac_p.s_up, fac_p.s_lo, applied[1][1])],
        [cr.backsub_plain(x_even.double(), fac_x.s_up, fac_x.s_lo,
                          applied[2][1])])
    return out


def level_bar(got, want, exact) -> tuple[bool, float]:
    """The bar a CR kernel's outputs must meet on one level.  float64: every
    output within 1e-9 (relative) of the plain version's.  float32: every
    output's error against the float64 plain level at most 10x the plain
    version's (taken as at least one float32 epsilon).  Returns (ok, the
    worst ratio of error to allowance)."""
    worst = 0.0
    for g, w, x in zip(got, want, exact):
        if g.dtype == torch.float64:
            ratio = rel_err(g, w) / 1e-9
        else:
            allowed = 10.0 * max(rel_err(w, x), torch.finfo(g.dtype).eps)
            ratio = rel_err(g, x) / allowed
        worst = max(worst, ratio)
    return worst <= 1.0, worst


def batch_residual(D, E, G, X) -> float:
    """||A X - G||_inf / ||G||_inf in float64 over a block-major batch of
    chains (E[:, K-1] ignored)."""
    D, E, G, X = (a.double() for a in (D, E, G, X))
    AX = D @ X
    AX[:, :-1] += E[:, :-1] @ X[:, 1:]
    AX[:, 1:] += E[:, :-1].mT @ X[:, :-1]
    return float((AX - G).abs().max() / G.abs().max())


def bits(x):
    """A tensor's bit pattern: a float tensor viewed as integers of its
    width, so that ``torch.equal`` on it is bit-for-bit equality in which a
    NaN matches the same NaN (``torch.equal`` on floats says NaN != NaN)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def bit_equal(a, b) -> bool:
    """Whether two pytrees of tensors have the same structure and every
    leaf the same dtype, shape and bits (:func:`bits`)."""
    from torch.utils._pytree import tree_flatten

    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


# examples/mhe_online.py's stream: Van der Pol with p = [1, 1] from x0 = [2,
# 0], sampled every MHE_DT, position measured with noise MHE_SIG_V.
MHE_DT, MHE_HORIZON, MHE_SIG_V, MHE_SIG_W, MHE_SAMPLES = 0.05, 12, 0.02, 0.5, 240


def mhe_online_stream(dtype, device, samples: int = MHE_SAMPLES):
    """examples/mhe_online.py's estimator and stream: Van der Pol with p
    fixed at [1, 1], horizon 12, dt 0.05, degree 3 (b = 6), sig_w 0.5,
    sig_v 0.02, maxiter 20, gtol 1e-9, 'auto'.  The RK4 truth from [2, 0]
    and the noise of default_rng(0) are made on the host in float64.
    Returns (mhe, truth (samples, 2), ys (samples, 1))."""
    from collocfem_tpu_torch.mhe import MovingHorizonEstimator
    from collocfem_tpu_torch.models import VanDerPol
    from collocfem_tpu_torch.solve.newton import SolverOptions
    from collocfem_tpu_torch.utils.simulate import rk4_trajectory

    rng = np.random.default_rng(0)
    ts = np.arange(samples) * MHE_DT
    model = VanDerPol()
    f64 = torch.float64
    xs = rk4_trajectory(model.f, torch.tensor([2.0, 0.0], dtype=f64), ts,
                        u_fn=lambda t: torch.zeros(1, dtype=f64),
                        p=[1.0, 1.0], device="cpu").numpy()
    ys = xs[:, :1] + MHE_SIG_V * rng.standard_normal((samples, 1))
    mhe = MovingHorizonEstimator(
        model, horizon=MHE_HORIZON, dt=MHE_DT, sig_w=MHE_SIG_W,
        sig_v=MHE_SIG_V, degree=3, p_fixed=np.array([1.0, 1.0]),
        options=SolverOptions(maxiter=20, gtol=1e-9), device=device,
        dtype=dtype)
    return mhe, xs, ys
