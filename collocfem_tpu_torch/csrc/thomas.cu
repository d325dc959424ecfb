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
// G) and moves about 8 MB more through the factor scratch and X, a few
// microseconds of HBM traffic, and does about 40 MFLOP.  The time is the
// length of one chain's dependent 8x8 steps (2 K - 1 factor or solve
// steps).  The TPU kernel carried the batch
// on its vector lanes; here one thread carries one chain, with K a runtime
// argument and the factors in global scratch, and small blocks of threads
// spread the chains over as many SMs as possible.  A first version: one
// thread per chain keeps the whole 8x8 state in registers (spilling at
// float64) and loads its blocks without coalescing across the warp; a warp
// per chain, or chains interleaved in memory, are the ways to make it fast.
//
// The device code is in thomas_kernels.cuh.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libthomas.so thomas.cu
// (collocfem_tpu_torch/ops/_build.py does this at first use).

#include <cuda_runtime.h>

#include "thomas_kernels.cuh"

// The (block size, right-hand sides) the library is compiled for: config 5
// (Van der Pol, degree 4: b = 8; r = 1 + nq = 3).
#define THOMAS_SHAPES(X) X(8, 3)

namespace {

constexpr int kThreads = 32;

template <typename F>
int dispatch(const F* D, const F* E, const F* G, F* X, F* lf, int b, int r,
             long long n_exp, int K, void* stream) {
  if (n_exp < 1 || K < 1) return cudaErrorInvalidValue;
  const long long blocks = (n_exp + kThreads - 1) / kThreads;
#define THOMAS_RUN(Bv, Rv)                                                \
  if (b == Bv && r == Rv) {                                               \
    thomas::batched_thomas<F, Bv, Rv><<<(unsigned)blocks, kThreads, 0,    \
        static_cast<cudaStream_t>(stream)>>>(D, E, G, X, lf, n_exp, K);   \
    return cudaGetLastError();                                            \
  }
  THOMAS_SHAPES(THOMAS_RUN)
#undef THOMAS_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int thomas_supported(int b, int r) {
#define THOMAS_MATCH(Bv, Rv) if (b == Bv && r == Rv) return 1;
  THOMAS_SHAPES(THOMAS_MATCH)
#undef THOMAS_MATCH
  return 0;
}

// X (n_exp, K, b, r) with A_e X_e = G_e; lf is scratch of n_exp K b b
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
