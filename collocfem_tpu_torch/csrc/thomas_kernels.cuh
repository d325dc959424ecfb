// Device code of the batched block-Thomas solve (see thomas.cu).
//
// n_exp independent SPD block-tridiagonal chains of K blocks of b x b, each
// with r right-hand sides, block-major: D, E (n_exp, K, b, b) with E[:, k]
// coupling block k to k+1 (E[:, K-1] ignored), G and X (n_exp, K, b, r).
// One thread per chain runs the pivot-free block-Cholesky forward sweep
//   L_0 L_0^T = D_0,  y_0 = G_0,
//   W = (L_{k-1} L_{k-1}^T)^-1 E_{k-1},  L_k L_k^T = D_k - E_{k-1}^T W,
//   y_k = G_k - W^T y_{k-1},
// storing each factor in the scratch lf (n_exp, K, b, b) and each reduced
// right-hand side in X, then the back-substitution
//   x_{K-1} = (L L^T)^-1 y_{K-1},  x_k = (L_k L_k^T)^-1 (y_k - E_k x_{k+1}),
// which overwrites X block by block.  K is a runtime argument; threads past
// n_exp return at once.  The small dense algebra (Cholesky with pivots
// clamped at tiny, triangular solves) is the SPIKE core's.

#pragma once

#include "kkt_spike_kernels.cuh"

namespace thomas {

template <typename F, int B, int R>
__global__ void batched_thomas(const F* D, const F* E, const F* G, F* X,
                               F* lf, long long n_exp, int K) {
  using kkt::chol;
  using kkt::chol_solve;
  using kkt::ld;
  using kkt::rhs_minus;
  using kkt::st;
  using kkt::sub_mm;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_exp) return;
  const F* d = D + e * K * B * B;
  const F* c = E + e * K * B * B;
  const F* g = G + e * K * B * R;
  F* x = X + e * K * B * R;
  F* l = lf + e * K * B * B;

  F lfac[B][B], y[B][R];
  ld<F, B, B>(d, lfac);
  chol<F, B>(lfac);
  st<F, B, B>(l, lfac);
  ld<F, B, R>(g, y);
  st<F, B, R>(x, y);
  for (int k = 1; k < K; ++k) {
    F ek[B][B], w[B][B], gk[B][R];
    ld<F, B, B>(c + (long long)(k - 1) * B * B, ek);
    ld<F, B, B>(c + (long long)(k - 1) * B * B, w);
    chol_solve<F, B, B>(lfac, w);            // W = S_{k-1}^-1 E_{k-1}
    ld<F, B, B>(d + (long long)k * B * B, lfac);
    sub_mm<F, B, B, true>(ek, w, lfac);      // S_k = D_k - E^T W
    chol<F, B>(lfac);
    st<F, B, B>(l + (long long)k * B * B, lfac);
    ld<F, B, R>(g + (long long)k * B * R, gk);
    rhs_minus<F, B, R, R, true>(w, gk, y);   // y_k = G_k - W^T y_{k-1}
    st<F, B, R>(x + (long long)k * B * R, y);
  }
  chol_solve<F, B, R>(lfac, y);
  st<F, B, R>(x + (long long)(K - 1) * B * R, y);
  for (int k = K - 2; k >= 0; --k) {
    F ek[B][B], yk[B][R];
    ld<F, B, B>(l + (long long)k * B * B, lfac);
    ld<F, B, R>(x + (long long)k * B * R, yk);
    ld<F, B, B>(c + (long long)k * B * B, ek);
    rhs_minus<F, B, R, R, false>(ek, yk, y); // y_k - E_k x_{k+1}
    chol_solve<F, B, R>(lfac, y);
    st<F, B, R>(x + (long long)k * B * R, y);
  }
}

}  // namespace thomas
