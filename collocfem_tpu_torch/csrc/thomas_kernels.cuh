// Device code of the batched block-Thomas solve (see thomas.cu).
//
// n_exp independent SPD block-tridiagonal chains of K blocks of b x b, each
// with r right-hand sides, block-major: D, E (n_exp, K, b, b) with E[:, k]
// coupling block k to k+1 (E[:, K-1] ignored), G and X (n_exp, K, b, r).
// Each chain runs the pivot-free block-Cholesky forward sweep
//   L_0 L_0^T = D_0,  y_0 = G_0,
//   W = (L_{k-1} L_{k-1}^T)^-1 E_{k-1},  L_k L_k^T = D_k - E_{k-1}^T W,
//   y_k = G_k - W^T y_{k-1},
// storing each factor in the scratch lf and each reduced right-hand side in
// X, then the back-substitution
//   x_{K-1} = (L L^T)^-1 y_{K-1},  x_k = (L_k L_k^T)^-1 (y_k - E_k x_{k+1}),
// which overwrites X block by block.  K is a runtime argument.
//
// Lane layout: the SPIKE core's (kkt_spike_kernels.cuh).  A group of W =
// group_width(b) neighbouring lanes (1, 2, 4, 8 or 16) carries one chain,
// lane i < b owning row i of every block, and the b x b algebra is its
// row-per-lane functions (chol_rows, chol_solve_rows, sub_mm_rows,
// rhs_minus_rows), with rows exchanged by __shfl_sync under the whole
// warp's constant mask: every group of a warp runs every step, and a group
// past the last chain works on the last chain again and stores nothing.
// Lanes b..W-1 of a group load row b - 1's entries, join every shuffle and
// store nothing, as in the SPIKE core.  A lane reads its rows of D, G and E
// and its column of E (the row of E^T) from the block-major arrays, those
// of the next step before the algebra of this one.  A factor is stored as
// in the SPIKE core, the lane's row of L and then its column below the
// diagonal: lf is (n_exp, K, b, 2b), and the backward sweep reads both
// without a transpose.  Pivots are clamped at tiny, as in the plain
// version.

#pragma once

#include "kkt_spike_kernels.cuh"

namespace thomas {

// Threads of a block: eight chains, and at least two warps (64 threads, as
// at b = 8, up to b = 8; 128 at b = 9..16).
template <int B>
constexpr int kThreads =
    kkt::group_width(B) <= 8 ? 64 : 8 * kkt::group_width(B);

template <typename F, int B, int R>
__global__ void __launch_bounds__(kThreads<B>)
batched_thomas(const F* D, const F* E, const F* G, F* X, F* lf,
               long long n_exp, int K) {
  using namespace kkt;
  constexpr int W = group_width(B);
  const long long thread = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((thread - threadIdx.x % 32) / W >= n_exp) return;   // the whole warp
  const GroupOf<B> g(0xffffffffu);
  const int i = row_of<B>(g.lane);
  const bool live = thread / W < n_exp && g.lane < B;
  const long long e = thread / W < n_exp ? thread / W : n_exp - 1;
  const F* d = D + e * K * B * B;
  const F* c = E + e * K * B * B;
  const F* gr = G + e * K * B * R;
  F* x = X + e * K * B * R;
  F* l = lf + e * K * B * 2 * B;

  // Forward step k reads E[k-1] (row and column), D[k] and G[k]; those of
  // step k + 1 are fetched before step k's algebra.
  F lfac[B], lt[B], y[R];
  F e_c[B], ec_c[B], d_c[B], g_c[R], e_n[B], ec_n[B], d_n[B], g_n[R];
  copy<F, B>(d + i * B, lfac);
  copy<F, R>(gr + i * R, y);
  const int k1 = K > 1 ? 1 : 0;
  copy<F, B>(c + i * B, e_c);
  copy_col<F, B>(c, i, ec_c);
  copy<F, B>(d + k1 * B * B + i * B, d_c);
  copy<F, R>(gr + k1 * B * R + i * R, g_c);
  chol_rows<F, B>(g, lfac);
  lower_cols<F, B>(g, lfac, lt);
  store_factor<F, B>(l + i * 2 * B, lfac, lt, live);
  store<F, R>(x + i * R, y, live);
  for (int k = 1; k < K; ++k) {
    const long long kn = k + 1 < K ? k + 1 : k;
    copy<F, B>(c + (kn - 1) * B * B + i * B, e_n);
    copy_col<F, B>(c + (kn - 1) * B * B, i, ec_n);
    copy<F, B>(d + kn * B * B + i * B, d_n);
    copy<F, R>(gr + kn * B * R + i * R, g_n);
    F w[B], tr[B];
#pragma unroll
    for (int j = 0; j < B; ++j) w[j] = e_c[j];
    chol_solve_rows<F, B, B>(g, lfac, lt, w);    // W = S_{k-1}^-1 E_{k-1}
#pragma unroll
    for (int j = 0; j < B; ++j) lfac[j] = d_c[j];
    sub_mm_rows<F, B, B>(g, ec_c, w, lfac);      // S_k = D_k - E^T W
    chol_rows<F, B>(g, lfac);
    lower_cols<F, B>(g, lfac, lt);
    transpose<F, B>(g, w, tr);
    rhs_minus_rows<F, B, R, R>(g, tr, g_c, y);   // y_k = G_k - W^T y_{k-1}
    store_factor<F, B>(l + ((long long)k * B + i) * 2 * B, lfac, lt, live);
    store<F, R>(x + ((long long)k * B + i) * R, y, live);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      e_c[j] = e_n[j];
      ec_c[j] = ec_n[j];
      d_c[j] = d_n[j];
    }
#pragma unroll
    for (int q = 0; q < R; ++q) g_c[q] = g_n[q];
  }
  chol_solve_rows<F, B, R>(g, lfac, lt, y);
  store<F, R>(x + ((long long)(K - 1) * B + i) * R, y, live);

  // Backward step k reads the factor and reduced right-hand side of block k
  // and E[k]; those of step k - 1 are fetched first.
  if (K < 2) return;
  F l_c[B], y_c[R], l_n[B], lt_n[B], y_n[R];
  load_factor<F, B>(l + ((long long)(K - 2) * B + i) * 2 * B, l_c, lt);
  copy<F, R>(x + ((long long)(K - 2) * B + i) * R, y_c);
  copy<F, B>(c + (long long)(K - 2) * B * B + i * B, e_c);
  for (int k = K - 2; k >= 0; --k) {
    const long long kn = k > 0 ? k - 1 : 0;
    load_factor<F, B>(l + (kn * B + i) * 2 * B, l_n, lt_n);
    copy<F, R>(x + (kn * B + i) * R, y_n);
    copy<F, B>(c + kn * B * B + i * B, e_n);
    rhs_minus_rows<F, B, R, R>(g, e_c, y_c, y);  // y_k - E_k x_{k+1}
    chol_solve_rows<F, B, R>(g, l_c, lt, y);
    store<F, R>(x + ((long long)k * B + i) * R, y, live);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      l_c[j] = l_n[j];
      lt[j] = lt_n[j];
      e_c[j] = e_n[j];
    }
#pragma unroll
    for (int q = 0; q < R; ++q) y_c[q] = y_n[q];
  }
}

}  // namespace thomas
