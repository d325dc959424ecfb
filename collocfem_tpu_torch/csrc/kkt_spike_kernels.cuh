// Device code of the SPIKE chain solves (see kkt_spike.cu).
//
// One core serves two entry points, chosen by the template flag KKT:
//
//   KKT = true   the fused damped-KKT solve (kernel #1).  Solves
//                [[A + lam_abs I, B], [B^T, C + lam_abs I]] [dx, dp] = -[gx, gp]
//                for an SPD block-tridiagonal A with b x b blocks and nq
//                parameters.  The wrapper (collocfem_tpu_torch/ops/spike.py)
//                passes the raw chain D, E, the right-hand-side group
//                G = [gx | B inv_sp] (b, r = 1 + nq, K), the Jacobi scales
//                inv = diag(A + lam_abs)^-1/2 (b, K) and cg = [C_s | gp_s]
//                (nq, nq + 1).  Every load applies the scaling: the scaled
//                diagonal is set to exactly 1.
//   KKT = false  the plain chain solve A X = G (kernel #2): raw loads, no
//                Schur step; X (b, r, K) is written by the back-substitution.
//
// In both, blocks past the chain end read as identity, couplings from block
// K-1 on read as zero, and right-hand sides past the end read as zero.
//
// The chain is cut into T tiles of L >= 3 blocks (Kp = T L >= K).  Launches
// on one stream (4 and 5 only for KKT):
//   1. tile_sweep       one thread per tile: block-Thomas forward sweep over
//                       the L-2 interior blocks (factors and reduced RHS to
//                       scratch), a backward sweep for the spike end values,
//                       and the tile's 2x2-block interface system.
//   2. interface_solve  one thread: block Thomas on the 2T-block chain of
//                       tile boundary blocks.
//   3. back_substitute  one thread per tile: interior back-substitution from
//                       the boundary values; for KKT also the tile's partial
//                       sums of B_s^T X for the arrowhead Schur complement.
//   4. schur_solve      one thread: reduce the T partial sums in tile order
//                       (deterministic, no atomics) and solve the nq x nq
//                       Schur system by Cholesky.
//   5. compose          one thread per chain block: dx = (-x_g + x_b t) inv.
//
// Scratch layouts are block-major (each thread walks its own contiguous
// blocks); every chain index is 64-bit.

#pragma once

namespace kkt {

template <typename F> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  static constexpr float tiny = 1.17549435082228750797e-38f;
};
template <> struct Num<double> {
  static __device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
  static constexpr double tiny = 2.22507385850720138309e-308;
};

template <typename F>
struct Args {
  // Inputs (structure-of-arrays, chain index last).
  const F* D;    // (b, b, K)
  const F* E;    // (b, b, K), E[..., k] couples block k to k+1
  const F* G;    // (b, r, K)
  const F* inv;  // (b, K)
  const F* cg;   // (nq, nq + 1)
  // Outputs.
  F* dx;         // (b, K)      KKT: the step
  F* t;          // (nq,)       KKT: Schur solution; dp = -t inv_sp
  F* x;          // (b, r, K)   plain: the solution X
  // Scratch (block-major).
  F* lf;         // (Kp, b, b)   interior Cholesky factors
  F* y;          // (Kp, b, r+b) forward-reduced [g | u-spike]
  F* iface;      // (T, 4 b b + 2 b r) s_ll, s_lr, s_rr, e_cp, gh_l, gh_r
  F* ilf;        // (2T, b, b)   interface Cholesky factors
  F* iy;         // (2T, b, r)   interface forward-reduced RHS
  F* ix;         // (2T, b, r)   interface solution [x_l, x_r per tile]
  F* xs;         // (Kp, b, r)   scaled solution A_s^-1 [gx_s | B_s]
  F* acc;        // (T, r-1, r)  per-tile partial sums of B_s^T X (KKT)
  long long K;
  int T, L;
};

template <int B, int R_>
struct Shape {
  static constexpr int R = R_;       // right-hand sides (KKT: [gx | B])
  static constexpr int NQ = R - 1;   // KKT: parameters
  static constexpr int C = R + B;    // forward-reduced columns [g | u]
  static constexpr int CV = C + B;   // backward-sweep columns [g | u | v]
  static constexpr long long iface_stride = 4LL * B * B + 2LL * B * R;
};

// Scratch size in elements, and its carving into Args.
template <int B, int R>
inline long long scratch_elems(int T, int L) {
  using S = Shape<B, R>;
  const long long kp = (long long)T * L, t = T;
  return kp * B * B + kp * B * S::C + t * S::iface_stride
       + 2 * t * B * B + 4 * t * B * S::R + kp * B * S::R + t * S::NQ * S::R;
}

template <typename F, int B, int R>
inline Args<F> carve(const F* D, const F* E, const F* G, const F* inv,
                     const F* cg, F* dx, F* t, F* x, F* scratch, long long K,
                     int T, int L) {
  using S = Shape<B, R>;
  const long long kp = (long long)T * L;
  Args<F> a;
  a.D = D; a.E = E; a.G = G; a.inv = inv; a.cg = cg; a.dx = dx; a.t = t;
  a.x = x;
  F* p = scratch;
  a.lf = p;    p += kp * B * B;
  a.y = p;     p += kp * B * S::C;
  a.iface = p; p += (long long)T * S::iface_stride;
  a.ilf = p;   p += 2LL * T * B * B;
  a.iy = p;    p += 2LL * T * B * S::R;
  a.ix = p;    p += 2LL * T * B * S::R;
  a.xs = p;    p += kp * B * S::R;
  a.acc = p;
  a.K = K; a.T = T; a.L = L;
  return a;
}

// ---- loads of the raw chain (scaled for KKT) --------------------------------

template <typename F, int B, bool KKT>
__device__ __forceinline__ void load_d(const Args<F>& a, long long k,
                                       F out[B][B]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) out[i][j] = (i == j) ? F(1) : F(0);
  if (k >= a.K) return;
  if constexpr (!KKT) {
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j) out[i][j] = a.D[(i * B + j) * a.K + k];
    return;
  }
  F s[B];
#pragma unroll
  for (int i = 0; i < B; ++i) s[i] = a.inv[i * a.K + k];
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (i != j) out[i][j] = a.D[(i * B + j) * a.K + k] * s[i] * s[j];
}

// Coupling block k -> k+1, scaled by inv[k] (rows) and inv[k+1] (columns):
// across a tile boundary that is the next tile's first scale.
template <typename F, int B, bool KKT>
__device__ __forceinline__ void load_e(const Args<F>& a, long long k,
                                       F out[B][B]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) out[i][j] = F(0);
  if (k >= a.K - 1) return;
  if constexpr (!KKT) {
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j) out[i][j] = a.E[(i * B + j) * a.K + k];
    return;
  }
  F s[B], s1[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    s[i] = a.inv[i * a.K + k];
    s1[i] = a.inv[i * a.K + k + 1];
  }
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
      out[i][j] = a.E[(i * B + j) * a.K + k] * s[i] * s1[j];
}

template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void load_g(const Args<F>& a, long long k,
                                       F out[B][R]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) out[i][c] = F(0);
  if (k >= a.K) return;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const F s = KKT ? a.inv[i * a.K + k] : F(1);
#pragma unroll
    for (int c = 0; c < R; ++c) out[i][c] = a.G[(i * R + c) * a.K + k] * s;
  }
}

// ---- small dense algebra (compile-time sizes, fully unrolled) ----------------

template <typename F, int M, int N>
__device__ __forceinline__ void ld(const F* p, F out[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i][j] = p[i * N + j];
}

template <typename F, int M, int N>
__device__ __forceinline__ void st(F* p, const F in[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) p[i * N + j] = in[i][j];
}

// Columns [c0, c0 + N) of a B x NS array.
template <typename F, int B, int NS, int N>
__device__ __forceinline__ void cols(const F src[B][NS], int c0,
                                     F out[B][N]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c) out[i][c] = src[i][c0 + c];
}

// In-place lower Cholesky; each pivot is clamped at tiny (a NaN stays NaN),
// so a noise-indefinite block gives a finite junk factor and the LM loop
// rejects the step.
template <typename F, int B>
__device__ __forceinline__ void chol(F a[B][B]) {
#pragma unroll
  for (int j = 0; j < B; ++j) {
    F s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= a[j][k] * a[j][k];
    const F d = Num<F>::sqrt_(s < Num<F>::tiny ? Num<F>::tiny : s);
    a[j][j] = d;
    const F inv = F(1) / d;
#pragma unroll
    for (int i = j + 1; i < B; ++i) {
      F s2 = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 -= a[i][k] * a[j][k];
      a[i][j] = s2 * inv;
    }
  }
}

// x <- (L L^T)^-1 x for the lower factor held in l.
template <typename F, int B, int N>
__device__ __forceinline__ void chol_solve(const F l[B][B], F x[B][N]) {
  F inv[B];
#pragma unroll
  for (int i = 0; i < B; ++i) inv[i] = F(1) / l[i][i];
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F s = x[i][c];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= l[i][k] * x[k][c];
      x[i][c] = s * inv[i];
    }
#pragma unroll
  for (int i = B - 1; i >= 0; --i)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F s = x[i][c];
#pragma unroll
      for (int k = i + 1; k < B; ++k) s -= l[k][i] * x[k][c];
      x[i][c] = s * inv[i];
    }
}

// out <- out - op(e) v, op(e) = e or e^T (e is B x B, v and out B x N).
template <typename F, int B, int N, bool TRANS>
__device__ __forceinline__ void sub_mm(const F e[B][B], const F v[B][N],
                                       F out[B][N]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F s = out[i][c];
#pragma unroll
      for (int k = 0; k < B; ++k) s -= (TRANS ? e[k][i] : e[i][k]) * v[k][c];
      out[i][c] = s;
    }
}

// x <- [r0 | 0] - op(e) x in place (op(e) = e or e^T); columns of the
// right-hand side at or past NR are zero.
template <typename F, int B, int N, int NR, bool TRANS>
__device__ __forceinline__ void rhs_minus(const F e[B][B], const F r0[B][NR],
                                          F x[B][N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    F col[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      F s = (c < NR) ? r0[i][c < NR ? c : 0] : F(0);
#pragma unroll
      for (int k = 0; k < B; ++k) s -= (TRANS ? e[k][i] : e[i][k]) * x[k][c];
      col[i] = s;
    }
#pragma unroll
    for (int i = 0; i < B; ++i) x[i][c] = col[i];
  }
}

// acc[q][s] += sum_i g[i][1 + q] x[i][s]: the tile's share of B_s^T X.
template <typename F, int B, int NQ>
__device__ __forceinline__ void accumulate(const Args<F>& a, long long k,
                                           const F x[B][NQ + 1],
                                           F acc[NQ][NQ + 1]) {
  constexpr int R = NQ + 1;
  F g[B][R];
  load_g<F, B, R, true>(a, k, g);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      F v = acc[q][s];
#pragma unroll
      for (int i = 0; i < B; ++i) v += g[i][1 + q] * x[i][s];
      acc[q][s] = v;
    }
}

// ---- 1. tile sweep -----------------------------------------------------------

template <typename F, int B, int R_, bool KKT>
__global__ void tile_sweep(Args<F> a) {
  using S = Shape<B, R_>;
  constexpr int R = S::R, C = S::C, CV = S::CV;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= a.T) return;
  const int M = a.L - 2;                    // interior blocks per tile
  const long long k0 = (long long)tile * a.L;

  // Forward elimination over interior blocks m = 0..M-1 (chain k0 + m + 1).
  // The u-spike right-hand side enters at m = 0 as E[k0]^T; the v-spike's
  // is zero until the last interior block, so it is never reduced.
  F lfac[B][B];
  F y[B][C];
  {
    F g[B][R], e[B][B];
    load_d<F, B, KKT>(a, k0 + 1, lfac);
    chol<F, B>(lfac);
    load_g<F, B, R, KKT>(a, k0 + 1, g);
    load_e<F, B, KKT>(a, k0, e);
#pragma unroll
    for (int i = 0; i < B; ++i) {
#pragma unroll
      for (int c = 0; c < R; ++c) y[i][c] = g[i][c];
#pragma unroll
      for (int c = 0; c < B; ++c) y[i][R + c] = e[c][i];
    }
    st<F, B, B>(a.lf + (k0 + 1) * B * B, lfac);
    st<F, B, C>(a.y + (k0 + 1) * B * C, y);
  }
  for (int m = 1; m < M; ++m) {
    const long long k = k0 + m + 1;
    F e[B][B], w[B][B], g[B][R];
    load_e<F, B, KKT>(a, k - 1, e);          // couples interior m-1 -> m
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j) w[i][j] = e[i][j];
    chol_solve<F, B, B>(lfac, w);            // W = S_{m-1}^-1 E
    load_d<F, B, KKT>(a, k, lfac);
    sub_mm<F, B, B, true>(e, w, lfac);       // S_m = D - E^T W
    chol<F, B>(lfac);
    load_g<F, B, R, KKT>(a, k, g);
    rhs_minus<F, B, C, R, true>(w, g, y);    // y_m = [g | 0] - W^T y_{m-1}
    st<F, B, B>(a.lf + k * B * B, lfac);
    st<F, B, C>(a.y + k * B * C, y);
  }

  // Backward sweep with [g | u | v] columns, carried, not stored: only the
  // values at the first (m = 0) and last (m = M-1) interior blocks feed the
  // interface system.  The v-spike right-hand side at m = M-1 is E[k0+L-2].
  F x[B][CV];
  F wg_last[B][R], wv_last[B][B];
  {
    F ev[B][B];
    load_e<F, B, KKT>(a, k0 + M, ev);
#pragma unroll
    for (int i = 0; i < B; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) x[i][c] = y[i][c];
#pragma unroll
      for (int c = 0; c < B; ++c) x[i][C + c] = ev[i][c];
    }
    chol_solve<F, B, CV>(lfac, x);
    cols<F, B, CV, R>(x, 0, wg_last);
    cols<F, B, CV, B>(x, C, wv_last);
  }
  for (int m = M - 2; m >= 0; --m) {
    const long long k = k0 + m + 1;
    F e[B][B], ym[B][C];
    ld<F, B, B>(a.lf + k * B * B, lfac);
    ld<F, B, C>(a.y + k * B * C, ym);
    load_e<F, B, KKT>(a, k, e);              // couples interior m -> m+1
    rhs_minus<F, B, CV, C, false>(e, ym, x); // x_m = [y_m | 0] - E x_{m+1}
    chol_solve<F, B, CV>(lfac, x);
  }

  // The tile's interface blocks (the SPIKE reduced system):
  //   s_ll = D0 - E0 w_u0      s_lr = -E0 w_v0      s_rr = DL - E_{L-2}^T w_v
  //   gh_l = G0 - E0 w_g0      gh_r = GL - E_{L-2}^T w_g
  // plus the coupling e_cp from this tile's last block to the next tile's
  // first.
  F* out = a.iface + (long long)tile * S::iface_stride;
  {
    F e0[B][B], blk[B][B], v[B][B];
    load_e<F, B, KKT>(a, k0, e0);
    load_d<F, B, KKT>(a, k0, blk);
    cols<F, B, CV, B>(x, R, v);
    sub_mm<F, B, B, false>(e0, v, blk);
    st<F, B, B>(out, blk);                                  // s_ll
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j) blk[i][j] = F(0);
    cols<F, B, CV, B>(x, C, v);
    sub_mm<F, B, B, false>(e0, v, blk);
    st<F, B, B>(out + B * B, blk);                          // s_lr
    F g[B][R], wg[B][R];
    load_g<F, B, R, KKT>(a, k0, g);
    cols<F, B, CV, R>(x, 0, wg);
    sub_mm<F, B, R, false>(e0, wg, g);
    st<F, B, R>(out + 4 * B * B, g);                        // gh_l
  }
  {
    F el[B][B], blk[B][B], g[B][R];
    load_e<F, B, KKT>(a, k0 + M, el);
    load_d<F, B, KKT>(a, k0 + a.L - 1, blk);
    sub_mm<F, B, B, true>(el, wv_last, blk);
    st<F, B, B>(out + 2 * B * B, blk);                      // s_rr
    load_g<F, B, R, KKT>(a, k0 + a.L - 1, g);
    sub_mm<F, B, R, true>(el, wg_last, g);
    st<F, B, R>(out + 4 * B * B + B * R, g);                // gh_r
    load_e<F, B, KKT>(a, k0 + a.L - 1, blk);
    st<F, B, B>(out + 3 * B * B, blk);                      // e_cp
  }
}

// ---- 2. interface chain ------------------------------------------------------
//
// Block 2t is tile t's left boundary, 2t+1 its right one.  Diagonal blocks
// s_ll(t), s_rr(t); couplings 2t -> 2t+1: s_lr(t), 2t+1 -> 2t+2: e_cp(t).

template <typename F, int B, int R_>
__device__ __forceinline__ const F* iface_d(const Args<F>& a, int i) {
  using S = Shape<B, R_>;
  return a.iface + (long long)(i >> 1) * S::iface_stride + (i & 1) * 2 * B * B;
}
template <typename F, int B, int R_>
__device__ __forceinline__ const F* iface_e(const Args<F>& a, int i) {
  using S = Shape<B, R_>;
  return a.iface + (long long)(i >> 1) * S::iface_stride + (1 + 2 * (i & 1)) * B * B;
}
template <typename F, int B, int R_>
__device__ __forceinline__ const F* iface_g(const Args<F>& a, int i) {
  using S = Shape<B, R_>;
  return a.iface + (long long)(i >> 1) * S::iface_stride + 4 * B * B
       + (i & 1) * B * S::R;
}

template <typename F, int B, int R_>
__global__ void interface_solve(Args<F> a) {
  constexpr int R = R_;
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int n = 2 * a.T;
  F lfac[B][B], y[B][R];
  ld<F, B, B>(iface_d<F, B, R_>(a, 0), lfac);
  ld<F, B, R>(iface_g<F, B, R_>(a, 0), y);
  chol<F, B>(lfac);
  st<F, B, B>(a.ilf, lfac);
  st<F, B, R>(a.iy, y);
  for (int i = 1; i < n; ++i) {
    F e[B][B], w[B][B], g[B][R];
    ld<F, B, B>(iface_e<F, B, R_>(a, i - 1), e);
    ld<F, B, B>(iface_e<F, B, R_>(a, i - 1), w);
    chol_solve<F, B, B>(lfac, w);
    ld<F, B, B>(iface_d<F, B, R_>(a, i), lfac);
    sub_mm<F, B, B, true>(e, w, lfac);
    chol<F, B>(lfac);
    ld<F, B, R>(iface_g<F, B, R_>(a, i), g);
    rhs_minus<F, B, R, R, true>(w, g, y);
    st<F, B, B>(a.ilf + (long long)i * B * B, lfac);
    st<F, B, R>(a.iy + (long long)i * B * R, y);
  }
  chol_solve<F, B, R>(lfac, y);
  st<F, B, R>(a.ix + (long long)(n - 1) * B * R, y);
  for (int i = n - 2; i >= 0; --i) {
    F e[B][B], yi[B][R];
    ld<F, B, B>(a.ilf + (long long)i * B * B, lfac);
    ld<F, B, R>(a.iy + (long long)i * B * R, yi);
    ld<F, B, B>(iface_e<F, B, R_>(a, i), e);
    rhs_minus<F, B, R, R, false>(e, yi, y);
    chol_solve<F, B, R>(lfac, y);
    st<F, B, R>(a.ix + (long long)i * B * R, y);
  }
}

// ---- 3. interior back-substitution (+ partial Schur sums for KKT) -----------
//
// By linearity the interior solution is A_II^-1 (g - U x_l - V x_r); its
// forward reduction is y_g - y_u x_l, minus E[k0+L-2] x_r at the last block.

// Block k of the solution: for KKT to the block-major scratch xs (compose
// reads it); for the plain solve straight into X (b, r, K), dropping the
// padding blocks past the chain end.
template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void store_x(const Args<F>& a, long long k,
                                       const F x[B][R]) {
  if constexpr (KKT) {
    st<F, B, R>(a.xs + k * B * R, x);
  } else {
    if (k >= a.K) return;
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) a.x[(i * R + c) * a.K + k] = x[i][c];
  }
}

template <typename F, int B, int R_, bool KKT>
__global__ void back_substitute(Args<F> a) {
  using S = Shape<B, R_>;
  constexpr int R = S::R, C = S::C, NQ = S::NQ;
  constexpr int NA = (KKT && NQ > 0) ? NQ : 1;   // rows of the Schur sums
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= a.T) return;
  const int M = a.L - 2;
  const long long k0 = (long long)tile * a.L;

  F xl[B][R], xr[B][R], acc[NA][R];
#pragma unroll
  for (int q = 0; q < NA; ++q)
#pragma unroll
    for (int s = 0; s < R; ++s) acc[q][s] = F(0);
  ld<F, B, R>(a.ix + 2LL * tile * B * R, xl);
  ld<F, B, R>(a.ix + (2LL * tile + 1) * B * R, xr);
  store_x<F, B, R, KKT>(a, k0, xl);
  store_x<F, B, R, KKT>(a, k0 + a.L - 1, xr);
  if constexpr (KKT) {
    accumulate<F, B, NQ>(a, k0, xl, acc);
    accumulate<F, B, NQ>(a, k0 + a.L - 1, xr, acc);
  }

  F x[B][R];
  for (int m = M - 1; m >= 0; --m) {
    const long long k = k0 + m + 1;
    F lfac[B][B], ym[B][C], e[B][B], yc[B][R], yu[B][B];
    ld<F, B, B>(a.lf + k * B * B, lfac);
    ld<F, B, C>(a.y + k * B * C, ym);
    cols<F, B, C, R>(ym, 0, yc);
    cols<F, B, C, B>(ym, R, yu);
    sub_mm<F, B, R, false>(yu, xl, yc);      // y_g - y_u x_l
    load_e<F, B, KKT>(a, k, e);              // couples interior m -> m+1
    if (m == M - 1) {
      // Coupling to the right boundary block: the right-hand side takes
      // -E x_r, with x_r as the "next" solution.
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c) x[i][c] = xr[i][c];
    }
    rhs_minus<F, B, R, R, false>(e, yc, x);  // x_m = yc - E x_{m+1}
    chol_solve<F, B, R>(lfac, x);
    store_x<F, B, R, KKT>(a, k, x);
    if constexpr (KKT) accumulate<F, B, NQ>(a, k, x, acc);
  }
  if constexpr (KKT) st<F, NQ, R>(a.acc + (long long)tile * NQ * R, acc);
}

// ---- 4. arrowhead Schur solve ------------------------------------------------
//
// schur = C_s - B_s^T A_s^-1 B_s,  rp = gp_s - B_s^T A_s^-1 gx_s,  t = schur^-1 rp.

template <typename F, int B, int NQ>
__global__ void schur_solve(Args<F> a) {
  constexpr int R = NQ + 1;
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  F tot[NQ][R];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int s = 0; s < R; ++s) tot[q][s] = F(0);
  for (int tile = 0; tile < a.T; ++tile) {
    const F* p = a.acc + (long long)tile * NQ * R;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int s = 0; s < R; ++s) tot[q][s] += p[q * R + s];
  }
  F schur[NQ][NQ], rp[NQ][1];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      schur[q][qq] = a.cg[q * (NQ + 1) + qq] - tot[q][1 + qq];
    rp[q][0] = a.cg[q * (NQ + 1) + NQ] - tot[q][0];
  }
  chol<F, NQ>(schur);
  chol_solve<F, NQ, 1>(schur, rp);
#pragma unroll
  for (int q = 0; q < NQ; ++q) a.t[q] = rp[q][0];
}

// ---- 5. compose and unscale --------------------------------------------------

template <typename F, int B, int NQ>
__global__ void compose(Args<F> a) {
  constexpr int R = NQ + 1;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.K) return;
  F t[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) t[q] = a.t[q];
  const F* x = a.xs + k * B * R;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F v = -x[i * R];
#pragma unroll
    for (int q = 0; q < NQ; ++q) v += x[i * R + 1 + q] * t[q];
    a.dx[i * a.K + k] = v * a.inv[i * a.K + k];
  }
}

}  // namespace kkt
