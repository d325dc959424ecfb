"""Plain reference of the estimation cells: Van der Pol parameter estimation
by LGL collocation and a Levenberg-Marquardt Gauss-Newton loop, in numpy.

It imports nothing of the port.  E experiments share the parameters p =
(mu, b) and each has its own state path V (M, 2) on one uniform mesh of N
degree-d elements (the headline is E = 1).  The residuals are

  * defects at local nodes 1..d: sqrt(w_k h / 2) * defect_weight *
    ((2 / h) D X - f(X, u, p)), f = (x2, mu (1 - x1^2) x2 - x1 + b u),
    u = sin(freq t);
  * measurements: meas_weight * (x1(t_i) - y_i), x1 interpolated in the
    sample's element;
  * a prior p_weight * (p - p_prior) on the shared parameters.

The Jacobian is written out by hand per element, the Gauss-Newton matrix is
assembled into LAPACK's lower band storage (the state variables in node
order: element e of experiment k spans the ten consecutive variables from
2 (k M + e d)), and each damped step is solved by a banded Cholesky of the
state block and the parameters' Schur complement.  The LM loop is Nielsen's
gain-ratio schedule on the damping lam * max(diag) * I, with the stop rules
gtol (gradient inf-norm), xtol (step norm) and the lambda rail.  ``dtype``
is the working precision; the cost is summed in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.linalg import LinAlgError, cho_solve_banded, cholesky_banded

from portbench.reference import lgl


class Answer(NamedTuple):
    V: np.ndarray          # (E, M, 2)
    p: np.ndarray          # (2,)
    cost: float
    iterations: int
    converged: bool


class Estimation:
    """The least-squares problem of E experiments on one mesh."""

    def __init__(self, elements: int, degree: int, t0: float, tf: float,
                 t_meas, y, freqs, *, defect_weight: float,
                 meas_weight: float, p_prior, p_weight, dtype):
        self.dtype = np.dtype(dtype)
        n, d = elements, degree
        self.n, self.d = n, d
        self.bp = np.linspace(t0, tf, n + 1)
        h = np.diff(self.bp)
        x = lgl.nodes(d)
        self.xi = x
        self.elem_t = self.bp[:-1, None] + 0.5 * h[:, None] * (x + 1.0)
        self.node_t = np.concatenate([self.elem_t[:, :-1].reshape(-1),
                                      [self.bp[-1]]])
        self.M = n * d + 1
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        self.E = y.shape[0]
        freqs = np.asarray(freqs, dtype=np.float64).reshape(self.E)
        c = lambda a: np.asarray(a, dtype=np.float64).astype(self.dtype)
        self.h = c(h)
        self.D = c(lgl.diff_matrix(x))
        self.u = c(np.sin(freqs[:, None, None] * self.elem_t[None]))
        self.s = c(np.sqrt(lgl.weights(x)[1:][None, :] * h[:, None] * 0.5)
                   * defect_weight)                               # (N, d)
        # Samples grouped by element, padded to the most in one element.
        t = np.asarray(t_meas, dtype=np.float64)
        el = np.clip(np.searchsorted(self.bp, t, side="right") - 1, 0, n - 1)
        tau = np.clip(2.0 * (t - self.bp[el]) / h[el] - 1.0, -1.0, 1.0)
        order = np.argsort(el, kind="stable")
        counts = np.bincount(el, minlength=n)
        slot = np.arange(t.size) - np.concatenate([[0], np.cumsum(counts)])[
            el[order]]
        smax = max(int(counts.max()), 1)
        self.gidx = np.zeros((n, smax), dtype=np.int64)
        self.gmask = np.zeros((n, smax))
        self.gidx[el[order], slot] = order
        self.gmask[el[order], slot] = 1.0
        rows = lgl.interp_rows(x, tau)
        self.Lg = c(rows[self.gidx] * self.gmask[..., None])      # (N, S, d+1)
        self.mw = self.dtype.type(meas_weight)
        self.yg = c(y[:, self.gidx] * self.gmask)                  # (E, N, S)
        self.mask = c(self.gmask)
        self.p_prior = c(p_prior)
        self.p_w = c(np.broadcast_to(np.asarray(p_weight, np.float64), (2,)))
        # The measurement rows' Gauss-Newton block is constant.
        self.Hm = self.mw * self.mw * np.einsum("nsj,nsk->njk", self.Lg,
                                                self.Lg)
        # Element e of experiment k: its first variable in x = V.reshape(-1).
        self.off = (2 * self.M * np.arange(self.E)[:, None]
                    + 2 * d * np.arange(n)[None, :]).reshape(-1)

    # ---- residuals, cost, Gauss-Newton system --------------------------------

    def _windows(self, V):
        d, n = self.d, self.n
        idx = np.arange(n)[:, None] * d + np.arange(d + 1)[None, :]
        return V[:, idx, :]                                    # (E, N, d+1, 2)

    def _residuals(self, V, p):
        X = self._windows(V)
        mu, b = p[0], p[1]
        deriv = (2.0 / self.h)[None, :, None, None] * np.einsum(
            "kj,enjc->enkc", self.D, X)
        x1, x2 = X[..., 0], X[..., 1]
        f = np.stack([x2, mu * (1.0 - x1 * x1) * x2 - x1 + b * self.u], -1)
        rd = (deriv - f)[:, :, 1:, :] * self.s[None, :, :, None]
        pred = np.einsum("nsj,enj->ens", self.Lg, x1)
        rm = self.mw * (pred - self.yg) * self.mask[None]
        rp = self.p_w * (p - self.p_prior)
        return X, rd, rm, rp

    @staticmethod
    def _cost(rd, rm, rp):
        sq = lambda r: float(np.sum(np.square(r.astype(np.float64))))
        return 0.5 * (sq(rd) + sq(rm) + sq(rp))

    def cost(self, V, p) -> float:
        return self._cost(*self._residuals(V, p)[1:])

    def system(self, V, p):
        """(cost, band (10, nvar) lower storage of the state block, Hxp
        (nvar, 2), Hpp (2, 2), gx (nvar,), gp (2,))."""
        E, n, d = self.E, self.n, self.d
        dt = self.dtype
        X, rd, rm, rp = self._residuals(V, p)
        cost = self._cost(rd, rm, rp)
        mu, b = p[0], p[1]
        x1, x2 = X[:, :, 1:, 0], X[:, :, 1:, 1]                  # nodes 1..d
        s = self.s[None, :, :]
        # dr_defect[k, i] / dX[j, m]: (E, N, d, 2, d+1, 2)
        J = np.zeros((E, n, d, 2, d + 1, 2), dtype=dt)
        coef = (2.0 / self.h)[None, :, None, None] * self.D[None, None, 1:, :]
        coef = coef * s[..., None]                                # (1,N,d,d+1)
        J[:, :, :, 0, :, 0] = coef
        J[:, :, :, 1, :, 1] = coef
        k = np.arange(d)
        J[:, :, k, 1, k + 1, 0] -= s * (-2.0 * mu * x1 * x2 - 1.0)
        J[:, :, k, 1, k + 1, 1] -= s * (mu * (1.0 - x1 * x1))
        J[:, :, k, 0, k + 1, 1] -= s
        Jp = np.zeros((E, n, d, 2, 2), dtype=dt)
        Jp[:, :, :, 1, 0] = -s * (1.0 - x1 * x1) * x2
        Jp[:, :, :, 1, 1] = -s * self.u[:, :, 1:]
        Je = np.concatenate([J.reshape(E * n, 2 * d, 2 * (d + 1)),
                             Jp.reshape(E * n, 2 * d, 2)], axis=2)
        re = rd.reshape(E * n, 2 * d)
        He = np.matmul(Je.transpose(0, 2, 1), Je)                 # (T, 12, 12)
        ge = np.einsum("tri,tr->ti", Je, re)
        # The measurement rows touch the first component of each node.
        nl = 2 * (d + 1)
        pos = 2 * np.arange(d + 1)
        Hm = np.broadcast_to(self.Hm[None], (E, n, d + 1, d + 1)).reshape(
            E * n, d + 1, d + 1)
        He[:, pos[:, None], pos[None, :]] += Hm
        ge[:, pos] += self.mw * np.einsum("nsj,ens->enj", self.Lg,
                                          rm).reshape(E * n, d + 1)
        nvar = 2 * self.M * E
        band = np.zeros((nl, nvar), dtype=dt)
        hxp = np.zeros((nvar, 2), dtype=dt)
        gx = np.zeros(nvar, dtype=dt)
        off = self.off
        for i in range(nl):
            for j in range(i + 1):
                band[i - j, off + j] += He[:, i, j]
            hxp[off + i] += He[:, i, nl:]
            gx[off + i] += ge[:, i]
        pw2 = self.p_w * self.p_w
        hpp = He[:, nl:, nl:].sum(axis=0) + np.diag(pw2)
        gp = ge[:, nl:].sum(axis=0) + pw2 * (p - self.p_prior)
        return cost, (band, hxp, hpp, gx, gp)

    # ---- one damped step -----------------------------------------------------

    def step(self, sysm, lam):
        """(dx, dp, dmax) of the damped system (H + lam dmax I) s = -g, or
        None where the damped state block is not positive definite."""
        band, hxp, hpp, gx, gp = sysm
        dt = self.dtype
        dmax = max(band[0].max(), np.diag(hpp).max())
        lam_abs = dt.type(lam * max(dmax, np.finfo(dt).tiny))
        a = band.copy()
        a[0] += lam_abs
        try:
            cb = cholesky_banded(a, lower=True)
        except LinAlgError:
            return None
        Y = cho_solve_banded((cb, True), np.column_stack([gx, hxp]))
        schur = hpp + lam_abs * np.eye(2, dtype=dt) - hxp.T @ Y[:, 1:]
        dp = -np.linalg.solve(schur, gp - hxp.T @ Y[:, 0])
        dx = -(Y[:, 0] + Y[:, 1:] @ dp)
        return dx.astype(dt), dp.astype(dt), dt.type(dmax)


def lm(est: Estimation, V0, p0, *, maxiter: int, lam0: float, gtol=0.0,
       xtol=0.0, ftol=0.0, lam_min=1e-14, lam_max=1e12) -> Answer:
    """The LM loop from (V0, p0); an accepted step is taken in the
    iteration that sets the stop flag too."""
    dt = est.dtype
    V = np.asarray(V0, dtype=dt)
    p = np.asarray(p0, dtype=dt)
    cost, sysm = est.system(V, p)
    lam = max(dt.type(lam0), np.finfo(dt).eps)
    nu = 2.0
    it, done = 0, False
    tiny = np.finfo(dt).tiny
    while it < maxiter and not done:
        gx, gp = sysm[3], sysm[4]
        gnorm = max(np.abs(gx).max(), np.abs(gp).max())
        sol = est.step(sysm, lam)
        if sol is None:
            ct, accept, snorm = np.inf, False, np.inf
            new = None
        else:
            dx, dp, dmax = sol
            V_try = V + dx.reshape(V.shape)
            p_try = p + dp
            with np.errstate(all="ignore"):
                ct = est.cost(V_try, p_try)
            gdot = float(gx @ dx + gp @ dp)
            snorm2 = float(dx @ dx + dp @ dp)
            snorm = np.sqrt(snorm2)
            pred = -0.5 * gdot + 0.5 * lam * dmax * snorm2
            actual = cost - ct
            rho = actual / max(pred, tiny)
            accept = bool(np.isfinite(ct) and ct < cost and pred > 0.0
                          and rho > 1e-4)
            new = (V_try, p_try)
        if accept:
            lam = max(lam * max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0),
                      lam_min)
            nu = 2.0
        else:
            lam = min(lam * nu, lam_max)
            nu = min(nu * 2.0, 64.0)
        rel = (cost - ct) / max(cost, 1e-300) if accept else np.inf
        done = bool(gnorm < gtol
                    or (accept and ftol > 0.0 and rel < ftol)
                    or (accept and xtol > 0.0 and snorm < xtol)
                    or (not accept and lam >= lam_max))
        it += 1
        if accept:
            # The trial's system is assembled only once the step is taken.
            V, p = new
            cost, sysm = est.system(V, p)
    return Answer(V=V, p=p, cost=float(cost), iterations=it, converged=done)


def initial_guess(est: Estimation, t_meas, y, p0):
    """V0: the first state is the samples interpolated at the nodes, the
    second zero; p0 as given."""
    y = np.atleast_2d(np.asarray(y, dtype=np.float64))
    V0 = np.zeros((est.E, est.M, 2))
    for k in range(est.E):
        V0[k, :, 0] = np.interp(est.node_t, np.asarray(t_meas), y[k])
    return V0, np.asarray(p0, dtype=np.float64)


def prolong(coarse: Estimation, V, fine: Estimation):
    """The coarse collocation polynomial of V (E, Mc, 2) at the fine
    mesh's nodes."""
    t = fine.node_t
    el = np.clip(np.searchsorted(coarse.bp, t, side="right") - 1, 0,
                 coarse.n - 1)
    h = np.diff(coarse.bp)[el]
    tau = np.clip(2.0 * (t - coarse.bp[el]) / h - 1.0, -1.0, 1.0)
    rows = lgl.interp_rows(coarse.xi, tau)                     # (T, d+1)
    idx = el[:, None] * coarse.d + np.arange(coarse.d + 1)[None, :]
    return np.einsum("tj,etjc->etc", rows, V[:, idx, :])
