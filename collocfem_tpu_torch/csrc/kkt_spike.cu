// Fused damped-KKT SPIKE solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel collocfem_tpu/ops/spike_pallas.py
// kkt_solve_spike_fused (body _kkt_spike_kernel): equilibration at load,
// SPIKE over tiles of the block-tridiagonal chain, the interface chain, the
// arrowhead Schur complement, compose and unscale.
//
// What bounds it on the card: at the headline shape (K = 10,001 blocks of
// b = 8, nq = 2) the whole solve reads and writes about 10 MB, a few
// microseconds at 3.35 TB/s, and does about 50 MFLOP.  The time is latency:
// each tile is a sequential chain of dependent 8x8 block factorisations, the
// interface chain is sequential, and the solve takes five launches.  The
// design keeps the sequential depth to about 3 L + 2 T block steps by cutting
// the chain into T ~ 2 sqrt(K) tiles of L blocks (one thread each; the
// wrapper picks the split from the measured cost of the two phases), and it
// launches everything on the caller's stream with no host synchronisation.
// It is a correct first version: one thread per tile leaves most of the card
// idle, the per-thread block state spills registers (at float64 in
// particular), and the interface chain runs on one thread.  Warp-per-tile
// algebra, a parallel interface reduction and a single cooperative launch
// are the ways to make it fast.
//
// The device code is in kkt_spike_kernels.cuh.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libkkt_spike.so kkt_spike.cu
// (collocfem_tpu_torch/ops/_build.py does this at first use).

#include <cuda_runtime.h>

#include "kkt_spike_kernels.cuh"

// The (block size, nq) shapes the library is compiled for.  The headline Van
// der Pol estimation (nx = 2, degree 4, two parameters) is b = 8, nq = 2.
#define KKT_SHAPES(X) X(8, 2)

namespace {

constexpr int kTileThreads = 64;
constexpr int kComposeThreads = 256;

template <typename F, int B, int NQ>
int run(const F* D, const F* E, const F* G, const F* inv, const F* cg, F* dx,
        F* t, F* scratch, long long K, int T, int L, cudaStream_t stream) {
  kkt::Args<F> a = kkt::carve<F, B, NQ>(D, E, G, inv, cg, dx, t, scratch, K,
                                        T, L);
  const int tile_blocks = (T + kTileThreads - 1) / kTileThreads;
  cudaError_t err;
  kkt::tile_sweep<F, B, NQ><<<tile_blocks, kTileThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkt::interface_solve<F, B, NQ><<<1, 1, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkt::back_substitute<F, B, NQ><<<tile_blocks, kTileThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkt::schur_solve<F, B, NQ><<<1, 1, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long compose_blocks = (K + kComposeThreads - 1) / kComposeThreads;
  kkt::compose<F, B, NQ><<<(unsigned)compose_blocks, kComposeThreads, 0,
                           stream>>>(a);
  return cudaGetLastError();
}

template <typename F>
int dispatch(const F* D, const F* E, const F* G, const F* inv, const F* cg,
             F* dx, F* t, F* scratch, int b, int nq, long long K, int T, int L,
             void* stream) {
  if (T < 1 || L < 3 || (long long)T * L < K) return cudaErrorInvalidValue;
#define KKT_RUN(Bv, NQv)                                                  \
  if (b == Bv && nq == NQv)                                               \
    return run<F, Bv, NQv>(D, E, G, inv, cg, dx, t, scratch, K, T, L,     \
                           static_cast<cudaStream_t>(stream));
  KKT_SHAPES(KKT_RUN)
#undef KKT_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int kkt_spike_supported(int b, int nq) {
#define KKT_MATCH(Bv, NQv) if (b == Bv && nq == NQv) return 1;
  KKT_SHAPES(KKT_MATCH)
#undef KKT_MATCH
  return 0;
}

long long kkt_spike_scratch_elems(int b, int nq, int T, int L) {
#define KKT_SIZE(Bv, NQv) \
  if (b == Bv && nq == NQv) return kkt::scratch_elems<Bv, NQv>(T, L);
  KKT_SHAPES(KKT_SIZE)
#undef KKT_SIZE
  return -1;
}

// Returns 0 on success or the cudaError_t of the first failed launch.
int kkt_spike_f32(const float* D, const float* E, const float* G,
                  const float* inv, const float* cg, float* dx, float* t,
                  float* scratch, int b, int nq, long long K, int T, int L,
                  void* stream) {
  return dispatch<float>(D, E, G, inv, cg, dx, t, scratch, b, nq, K, T, L,
                         stream);
}

int kkt_spike_f64(const double* D, const double* E, const double* G,
                  const double* inv, const double* cg, double* dx, double* t,
                  double* scratch, int b, int nq, long long K, int T, int L,
                  void* stream) {
  return dispatch<double>(D, E, G, inv, cg, dx, t, scratch, b, nq, K, T, L,
                          stream);
}

const char* kkt_spike_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
