// Batched block-Thomas solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel collocfem_tpu/ops/blocktri_pallas.py
// batched_thomas_solve (body _thomas_kernel): many independent short SPD
// block-tridiagonal chains, block-Cholesky forward sweep and
// back-substitution per chain.  Config 5's block-major layout solves 1024
// chains of K = 11 blocks of b = 8 with r = 3 right-hand sides per LM
// iteration.
//
// What bounds it on the card: in float32 the batch reads about 7 MB (D, E,
// G) and writes 1 MB of X, 2.4 us of HBM traffic, and does about 40 MFLOP.
// The time is the length of one chain's dependent 8x8 steps (2 K - 1
// factor or solve steps), each a few hundred warp shuffles.  The TPU kernel
// carried the batch on its vector lanes; here a group of b = 8 lanes
// carries one chain on the SPIKE core's row-per-lane algebra
// (thomas_kernels.cuh), four chains a warp, in blocks of two warps: config
// 5's 1024 chains are 256 warps over 128 of the 132 SMs.  Other block sizes
// take a group of group_width(b) lanes a chain, the lanes past b idle.  K is
// a runtime argument; the factors go to a global scratch (5.8 MB float32 at
// config 5, held in L2).
//
// Measured (chip_smoke.py phase 2, config 5's 1024 chains of K = 11, NVIDIA
// H100 80GB HBM3, 700.00 W): 36.5 us on the device in float32, 59.4 us in
// float64 (torch.profiler); 0.040 / 0.065 ms a call by CUDA events.  The
// one-thread-per-chain kernel before took 0.155 / 0.183 ms by events, on 32
// SMs, loading its blocks without coalescing and spilling 1,356 bytes in
// float64; ptxas now: 122 / 194 registers, no spill.
//
// The device code is in thomas_kernels.cuh.  Build (one instance per shape;
// collocfem_tpu_torch/ops/_build.py does this at first use of the shape):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DCF_B=8 -DCF_R=3 -o thomas-b8-r3.so thomas.cu
// CF_B is the block size b (1..16), CF_R the right-hand sides r.

#include <cuda_runtime.h>

#include "thomas_kernels.cuh"

#if !defined(CF_B) || !defined(CF_R)
#error "build with -DCF_B=<b> -DCF_R=<r> (ops/_build.py)"
#endif
static_assert(CF_B >= 1 && CF_B <= 16 && CF_R >= 1, "b in 1..16, r >= 1");

namespace {

template <typename F>
int dispatch(const F* D, const F* E, const F* G, F* X, F* lf, int b, int r,
             long long n_exp, int K, void* stream) {
  if (b != CF_B || r != CF_R || n_exp < 1 || K < 1)
    return cudaErrorInvalidValue;
  constexpr int W = kkt::group_width(CF_B), kThreads = thomas::kThreads<CF_B>;
  const long long blocks = (n_exp * W + kThreads - 1) / kThreads;
  thomas::batched_thomas<F, CF_B, CF_R><<<(unsigned)blocks, kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(D, E, G, X, lf, n_exp, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int thomas_supported(int b, int r) { return b == CF_B && r == CF_R; }

// X (n_exp, K, b, r) with A_e X_e = G_e; lf is scratch of n_exp K b 2b
// elements.  Returns 0 or the launch's cudaError_t.
int thomas_f32(const float* D, const float* E, const float* G, float* X,
               float* lf, int b, int r, long long n_exp, int K,
               void* stream) {
  return dispatch<float>(D, E, G, X, lf, b, r, n_exp, K, stream);
}

int thomas_f64(const double* D, const double* E, const double* G, double* X,
               double* lf, int b, int r, long long n_exp, int K,
               void* stream) {
  return dispatch<double>(D, E, G, X, lf, b, r, n_exp, K, stream);
}

const char* thomas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
