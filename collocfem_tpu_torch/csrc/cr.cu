// Per-level cyclic-reduction kernels for NVIDIA Hopper (sm_90a), plain C
// interface.  Replaces the four Pallas TPU kernels of
// collocfem_tpu/ops/cr_pallas.py:
//
//   cr_level_*    cr_level (body _fwd_kernel): one fused CR level, both the
//                 elimination of the odd blocks and the right-hand-side sweep;
//   cr_factor_*   cr_level_factor (body _factor_kernel): the G-independent
//                 half, which also stores the Cholesky factor of the odd
//                 blocks for the later sweeps;
//   cr_apply_*    cr_level_apply (body _apply_kernel): reduces G through the
//                 stored factor;
//   cr_backsub_*  cr_backsub (body _bwd_kernel): recovers the odd blocks and
//                 writes the interleaved solution.
//
// The Pallas kernels emit each pair's cross term for the next pair and let
// XLA shift-subtract it outside; here the same shift-subtract is a second,
// elementwise launch on the caller's stream (cr_level: two, for D and G).
// The factor kernel stores no copy of e_up / e_lo: the apply kernel reads
// them from the level's input E, which the caller keeps.
//
// What bounds them on the card: at the first level of the headline chain
// at N = 20,000 (K padded to 32,768, b = 8, 16,384 pairs) the factor pass
// reads about 1 KB and writes about 1.5 KB per pair in float32 (the cross
// pass moves 0.75 KB more), ~55 MB in all, some 20 us of HBM traffic, and
// does ~7,500 flops per pair (~120 MFLOP, a few us at the card's float32
// rate); the apply and back-substitution passes move a few MB.  So the big
// levels are memory bound and the small ones (a chain halves per level, 12
// levels down to 8 blocks) are launch and latency bound.  One thread per
// pair, SoA loads coalesced across the warp.  A first version: the levels
// could fuse (several levels per launch in shared memory once a chain fits
// a block) and the cross-term pass could fold into the next level's loads.
//
// The device code is in cr_kernels.cuh.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libcr.so cr.cu
// (collocfem_tpu_torch/ops/_build.py does this at first use).

#include <cuda_runtime.h>

#include "cr_kernels.cuh"

// The (block size, right-hand sides) the library is compiled for: Van der
// Pol at degree 4 (b = 8) with r = 3 (the KKT right-hand side [gx | B]),
// r = 2 (covariance's B) and r = 1 (refinement passes, nq = 0).  The factor
// kernel needs only b.
#define CR_SHAPES(X) X(8, 1) X(8, 2) X(8, 3)
#define CR_BLOCKS(X) X(8)

namespace {

constexpr int kPairThreads = 64;
constexpr int kElemThreads = 256;

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <typename F>
cudaError_t shift_subtract(F* out, const F* cross, long long rows,
                           long long h, cudaStream_t stream) {
  cr::shift_sub<F><<<blocks_for(rows * h, kElemThreads), kElemThreads, 0,
                     stream>>>(out, cross, rows, h);
  return cudaGetLastError();
}

template <typename F>
int factor(const F* D, const F* E, F* dn, F* en, F* su, F* sl, F* lo, F* cd,
           int b, long long h, void* stream) {
  if (h < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CR_FACTOR(Bv)                                                       \
  if (b == Bv) {                                                            \
    cr::factor_pairs<F, Bv><<<blocks_for(h, kPairThreads), kPairThreads, 0, \
                              s>>>(D, E, dn, en, su, sl, lo, cd, h);        \
    cudaError_t err = cudaGetLastError();                                   \
    if (err != cudaSuccess) return err;                                     \
    return shift_subtract<F>(dn, cd, (long long)Bv * Bv, h, s);             \
  }
  CR_BLOCKS(CR_FACTOR)
#undef CR_FACTOR
  return cudaErrorInvalidValue;
}

template <typename F>
int apply(const F* lo, const F* E, const F* G, F* gn, F* sg, F* cg, int b,
          int r, long long h, void* stream) {
  if (h < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CR_APPLY(Bv, Rv)                                                    \
  if (b == Bv && r == Rv) {                                                 \
    cr::apply_pairs<F, Bv, Rv><<<blocks_for(h, kPairThreads), kPairThreads, \
                                 0, s>>>(lo, E, G, gn, sg, cg, h);          \
    cudaError_t err = cudaGetLastError();                                   \
    if (err != cudaSuccess) return err;                                     \
    return shift_subtract<F>(gn, cg, (long long)Bv * Rv, h, s);             \
  }
  CR_SHAPES(CR_APPLY)
#undef CR_APPLY
  return cudaErrorInvalidValue;
}

template <typename F>
int level(const F* D, const F* E, const F* G, F* dn, F* en, F* gn, F* su,
          F* sl, F* sg, F* cd, F* cg, int b, int r, long long h,
          void* stream) {
  if (h < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CR_LEVEL(Bv, Rv)                                                    \
  if (b == Bv && r == Rv) {                                                 \
    cr::level_pairs<F, Bv, Rv><<<blocks_for(h, kPairThreads), kPairThreads, \
                                 0, s>>>(D, E, G, dn, en, gn, su, sl, sg,   \
                                         cd, cg, h);                        \
    cudaError_t err = cudaGetLastError();                                   \
    if (err != cudaSuccess) return err;                                     \
    err = shift_subtract<F>(dn, cd, (long long)Bv * Bv, h, s);              \
    if (err != cudaSuccess) return err;                                     \
    return shift_subtract<F>(gn, cg, (long long)Bv * Rv, h, s);             \
  }
  CR_SHAPES(CR_LEVEL)
#undef CR_LEVEL
  return cudaErrorInvalidValue;
}

template <typename F>
int backsub(const F* xe, const F* su, const F* sl, const F* sg, F* X, int b,
            int r, long long h, void* stream) {
  if (h < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CR_BACKSUB(Bv, Rv)                                                  \
  if (b == Bv && r == Rv) {                                                 \
    cr::backsub<F, Bv, Rv><<<blocks_for(h, kPairThreads), kPairThreads, 0,  \
                             s>>>(xe, su, sl, sg, X, h);                    \
    return cudaGetLastError();                                              \
  }
  CR_SHAPES(CR_BACKSUB)
#undef CR_BACKSUB
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// 1 if the library is compiled for (b, r); r = 0 asks for the factor
// kernel, which needs only b.
int cr_supported(int b, int r) {
  if (r == 0) {
#define CR_MATCH_B(Bv) if (b == Bv) return 1;
    CR_BLOCKS(CR_MATCH_B)
#undef CR_MATCH_B
    return 0;
  }
#define CR_MATCH(Bv, Rv) if (b == Bv && r == Rv) return 1;
  CR_SHAPES(CR_MATCH)
#undef CR_MATCH
  return 0;
}

// All arrays SoA with the chain last: inputs of chain length 2h, outputs
// and scratch (cd, cg: the cross terms) of length h, X of length 2h.  Each
// returns 0 or the cudaError_t of its first failed launch.
int cr_factor_f32(const float* D, const float* E, float* dn, float* en,
                  float* su, float* sl, float* lo, float* cd, int b,
                  long long h, void* stream) {
  return factor<float>(D, E, dn, en, su, sl, lo, cd, b, h, stream);
}

int cr_factor_f64(const double* D, const double* E, double* dn, double* en,
                  double* su, double* sl, double* lo, double* cd, int b,
                  long long h, void* stream) {
  return factor<double>(D, E, dn, en, su, sl, lo, cd, b, h, stream);
}

int cr_apply_f32(const float* lo, const float* E, const float* G, float* gn,
                 float* sg, float* cg, int b, int r, long long h,
                 void* stream) {
  return apply<float>(lo, E, G, gn, sg, cg, b, r, h, stream);
}

int cr_apply_f64(const double* lo, const double* E, const double* G,
                 double* gn, double* sg, double* cg, int b, int r,
                 long long h, void* stream) {
  return apply<double>(lo, E, G, gn, sg, cg, b, r, h, stream);
}

int cr_level_f32(const float* D, const float* E, const float* G, float* dn,
                 float* en, float* gn, float* su, float* sl, float* sg,
                 float* cd, float* cg, int b, int r, long long h,
                 void* stream) {
  return level<float>(D, E, G, dn, en, gn, su, sl, sg, cd, cg, b, r, h,
                      stream);
}

int cr_level_f64(const double* D, const double* E, const double* G,
                 double* dn, double* en, double* gn, double* su, double* sl,
                 double* sg, double* cd, double* cg, int b, int r,
                 long long h, void* stream) {
  return level<double>(D, E, G, dn, en, gn, su, sl, sg, cd, cg, b, r, h,
                       stream);
}

int cr_backsub_f32(const float* xe, const float* su, const float* sl,
                   const float* sg, float* X, int b, int r, long long h,
                   void* stream) {
  return backsub<float>(xe, su, sl, sg, X, b, r, h, stream);
}

int cr_backsub_f64(const double* xe, const double* su, const double* sl,
                   const double* sg, double* X, int b, int r, long long h,
                   void* stream) {
  return backsub<double>(xe, su, sl, sg, X, b, r, h, stream);
}

const char* cr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
