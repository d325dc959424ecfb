// Device code of the per-level cyclic-reduction kernels (see cr.cu).
//
// One level of block cyclic reduction on an SPD block-tridiagonal chain of m
// blocks of b x b in SoA layout: D, E (b, b, m) with E[..., k] coupling block
// k to k+1, right-hand sides G (b, r, m); entry (i, j) of block k is at
// (i * cols + j) * m + k.  Pair p (h = m / 2 pairs) is the even block 2p and
// the odd block 2p + 1, with e_up = E[..., 2p] (even -> odd) and
// e_lo = E[..., 2p + 1] (odd -> next even).  Eliminating the odd blocks:
//
//   L L^T = D_odd,  s_up = D_odd^-1 e_up^T,  s_lo = D_odd^-1 e_lo,
//   s_g = D_odd^-1 g_odd,
//   d_new[p] = d_even - e_up s_up - cross_d[p - 1],  cross_d = e_lo^T s_lo,
//   e_new[p] = -e_up s_lo,
//   g_new[p] = g_even - e_up s_g - cross_g[p - 1],  cross_g = e_lo^T s_g,
//
// and the back-substitution x_odd = s_g - s_up x_even[p] - s_lo x_even[p + 1]
// (x_even[h] = 0) interleaves x_even and x_odd into the (b, r, 2h) solution.
//
// One thread per pair.  Every load and store is SoA with the pair index
// fastest, so neighbouring threads touch neighbouring addresses (stride 2 on
// the level's input, stride 1 on its outputs).  Pair p's cross term belongs
// to pair p + 1, which another thread owns: the pair kernels write it to
// scratch and shift_sub subtracts it in a second, elementwise launch.
//
// Registers: a thread holds the Cholesky factor (b (b + 1) / 2 values and b
// inverse pivots) and one b x b solve at a time; e_up and e_lo are re-read
// row by row (or column by column) from the level's input instead of being
// held, so a b = 8 thread keeps about 120 values live.

#pragma once

#include "kkt_spike_kernels.cuh"

namespace cr {

// Block of M x N at slot k of an SoA array with chain length n.
template <typename F, int M, int N>
__device__ __forceinline__ void ld(const F* a, long long n, long long k,
                                   F out[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i][j] = a[(long long)(i * N + j) * n + k];
}

template <typename F, int M, int N>
__device__ __forceinline__ void st(F* a, long long n, long long k,
                                   const F in[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[(long long)(i * N + j) * n + k] = in[i][j];
}

// The transposed B x B block: out[i][j] = A[j][i].
template <typename F, int B>
__device__ __forceinline__ void ld_t(const F* a, long long n, long long k,
                                     F out[B][B]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) out[i][j] = a[(long long)(j * B + i) * n + k];
}

// x <- (L L^T)^-1 x with the lower factor in l and its inverse pivots.
template <typename F, int B, int N>
__device__ __forceinline__ void chol_solve(const F l[B][B], const F inv[B],
                                           F x[B][N]) {
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

// Writes out[..., p] = base[..., kb] - (e_up s) (or 0 - (e_up s) without a
// base) for the N-column s, reading e_up = E[..., ke] row by row.
template <typename F, int B, int N, bool BASE>
__device__ __forceinline__ void minus_eup_times(const F* E, long long m,
                                                long long ke, const F s[B][N],
                                                const F* base, F* out,
                                                long long h, long long p) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F er[B];
#pragma unroll
    for (int k = 0; k < B; ++k) er[k] = E[(long long)(i * B + k) * m + ke];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F v = BASE ? base[(long long)(i * N + c) * m + ke] : F(0);
      F t = F(0);
#pragma unroll
      for (int k = 0; k < B; ++k) t += er[k] * s[k][c];
      out[(long long)(i * N + c) * h + p] = v - t;
    }
  }
}

// out[..., p] = e_lo^T s with e_lo = E[..., ko], read column by column.
template <typename F, int B, int N>
__device__ __forceinline__ void elo_t_times(const F* E, long long m,
                                            long long ko, const F s[B][N],
                                            F* out, long long h, long long p) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F ec[B];
#pragma unroll
    for (int k = 0; k < B; ++k) ec[k] = E[(long long)(k * B + i) * m + ko];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F t = F(0);
#pragma unroll
      for (int k = 0; k < B; ++k) t += ec[k] * s[k][c];
      out[(long long)(i * N + c) * h + p] = t;
    }
  }
}

// The G-independent half of pair p: factor D_odd into l / inv (and, with
// STORE_L, the lower factor with zeros above to lo), then s_lo, cross_d,
// e_new, s_up and d_new (before its cross term).
template <typename F, int B, bool STORE_L>
__device__ __forceinline__ void factor_pair(const F* D, const F* E,
                                            long long h, long long p, F* dn,
                                            F* en, F* su, F* sl, F* lo,
                                            F* cd, F l[B][B], F inv[B]) {
  const long long m = 2 * h, ke = 2 * p, ko = 2 * p + 1;
  ld<F, B, B>(D, m, ko, l);
  kkt::chol<F, B>(l);
#pragma unroll
  for (int i = 0; i < B; ++i) inv[i] = F(1) / l[i][i];
  if constexpr (STORE_L) {
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int j = 0; j < B; ++j)
        lo[(long long)(i * B + j) * h + p] = j <= i ? l[i][j] : F(0);
  }
  {
    F s[B][B];
    ld<F, B, B>(E, m, ko, s);
    chol_solve<F, B, B>(l, inv, s);                      // s_lo
    st<F, B, B>(sl, h, p, s);
    elo_t_times<F, B, B>(E, m, ko, s, cd, h, p);         // cross_d
    minus_eup_times<F, B, B, false>(E, m, ke, s, nullptr, en, h, p);
  }
  {
    F s[B][B];
    ld_t<F, B>(E, m, ke, s);
    chol_solve<F, B, B>(l, inv, s);                      // s_up
    st<F, B, B>(su, h, p, s);
    minus_eup_times<F, B, B, true>(E, m, ke, s, D, dn, h, p);
  }
}

// The right-hand-side half of pair p through the factor in l / inv: s_g,
// g_new (before its cross term) and cross_g.
template <typename F, int B, int R>
__device__ __forceinline__ void apply_pair(const F l[B][B], const F inv[B],
                                           const F* E, const F* G,
                                           long long h, long long p, F* gn,
                                           F* sg, F* cg) {
  const long long m = 2 * h, ke = 2 * p, ko = 2 * p + 1;
  F s[B][R];
  ld<F, B, R>(G, m, ko, s);
  chol_solve<F, B, R>(l, inv, s);
  st<F, B, R>(sg, h, p, s);
  minus_eup_times<F, B, R, true>(E, m, ke, s, G, gn, h, p);
  elo_t_times<F, B, R>(E, m, ko, s, cg, h, p);
}

// ---- kernels ---------------------------------------------------------------

// Kernel #4's pair pass: the G-independent half of a level.
template <typename F, int B>
__global__ void factor_pairs(const F* D, const F* E, F* dn, F* en, F* su,
                             F* sl, F* lo, F* cd, long long h) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  F l[B][B], inv[B];
  factor_pair<F, B, true>(D, E, h, p, dn, en, su, sl, lo, cd, l, inv);
}

// Kernel #5's pair pass: reduce G through the stored factor lo.
template <typename F, int B, int R>
__global__ void apply_pairs(const F* lo, const F* E, const F* G, F* gn, F* sg,
                            F* cg, long long h) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  F l[B][B], inv[B];
  ld<F, B, B>(lo, h, p, l);
#pragma unroll
  for (int i = 0; i < B; ++i) inv[i] = F(1) / l[i][i];
  apply_pair<F, B, R>(l, inv, E, G, h, p, gn, sg, cg);
}

// Kernel #3's pair pass: both halves with the factor kept in registers.
template <typename F, int B, int R>
__global__ void level_pairs(const F* D, const F* E, const F* G, F* dn, F* en,
                            F* gn, F* su, F* sl, F* sg, F* cd, F* cg,
                            long long h) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  F l[B][B], inv[B];
  factor_pair<F, B, false>(D, E, h, p, dn, en, su, sl, nullptr, cd, l, inv);
  apply_pair<F, B, R>(l, inv, E, G, h, p, gn, sg, cg);
}

// out[row, p] -= cross[row, p - 1] for p >= 1: pair p - 1's cross term
// lands on pair p.  One thread per element of the (rows, h) array.
template <typename F>
__global__ void shift_sub(F* out, const F* cross, long long rows,
                          long long h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * h || i % h == 0) return;
  out[i] -= cross[i - 1];
}

// Kernel #6: x_odd = s_g - s_up x_even[p] - s_lo x_even[p + 1], written
// interleaved with x_even into X (b, r, 2h).
template <typename F, int B, int R>
__global__ void backsub(const F* xe, const F* su, const F* sl, const F* sg,
                        F* X, long long h) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  F x[B][R], xr[B][R];
  ld<F, B, R>(xe, h, p, x);
  if (p + 1 < h) {
    ld<F, B, R>(xe, h, p + 1, xr);
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) xr[i][c] = F(0);
  }
  const long long m = 2 * h;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F a[B], b[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      a[k] = su[(long long)(i * B + k) * h + p];
      b[k] = sl[(long long)(i * B + k) * h + p];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      F t1 = F(0), t2 = F(0);
#pragma unroll
      for (int k = 0; k < B; ++k) {
        t1 += a[k] * x[k][c];
        t2 += b[k] * xr[k][c];
      }
      const long long row = (long long)(i * R + c) * m;
      X[row + 2 * p] = x[i][c];
      X[row + 2 * p + 1] = sg[(long long)(i * R + c) * h + p] - t1 - t2;
    }
  }
}

}  // namespace cr
