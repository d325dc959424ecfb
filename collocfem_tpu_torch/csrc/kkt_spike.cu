// SPIKE solves of an SPD block-tridiagonal chain for NVIDIA Hopper (sm_90a),
// plain C interface.  Two entry points share one device core
// (kkt_spike_kernels.cuh):
//
//   kkt_spike_*    replaces the Pallas TPU kernel
//                  collocfem_tpu/ops/spike_pallas.py kkt_solve_spike_fused
//                  (body _kkt_spike_kernel): equilibration at load, SPIKE
//                  over tiles of the chain, the interface chain, the
//                  arrowhead Schur complement, compose and unscale.
//   spike_chain_*  replaces blocktri_solve_spike_fused (body _spike_kernel)
//                  in the same file: the same SPIKE solve of A X = G with
//                  raw loads and no Schur step.
//
// What bounds them on the card: at the headline shape (K = 10,001 blocks of
// b = 8, nq = 2) the KKT solve reads and writes 6.7 MB, 2.0 microseconds at
// 3.35 TB/s, and does ~35 MFLOP; the batched chain of config 5 (K = 11,264,
// r = 3) moves 7.9 MB.  The time is latency: each tile is a chain of
// dependent 8x8 block steps, the interface chain is sequential, and a
// solve takes three or five launches.  The design cuts the chain into T ~
// 1.1 sqrt(K) tiles of L blocks (the wrapper picks the split from the
// measured cost of the tile and interface steps), so the sequential depth
// is about 3 L + 4 T block steps, and runs each block step on a group of b
// lanes, one row of every block per lane: a step's dot products run in
// parallel across the rows, and the rows a lane needs from the others come
// by warp shuffles, which set most of the cost of a step (~7 cycles of
// issue a shuffle for one warp: ~335 shuffles in a forward tile step, ~420
// in a backward one with its 19 right-hand-side columns).  Each step loads the next step's
// rows into registers before its own algebra, so no step waits on memory.
// Everything launches on the caller's stream with no host
// synchronisation.  What is left: the interface chain is still sequential
// over 2T blocks (a log-depth reduction is the next step), and the loads
// are per lane, not coalesced.
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libkkt_spike.so kkt_spike.cu
// (collocfem_tpu_torch/ops/_build.py does this at first use).

#include <cuda_runtime.h>

#include "kkt_spike_kernels.cuh"

// The shapes the library is compiled for.  The headline Van der Pol
// estimation (nx = 2, degree 4, two parameters) is b = 8, nq = 2; Duffing
// (config 2, three parameters) b = 8, nq = 3; the aircraft model (config 4,
// five parameters) b = 8, nq = 5.  The chain solves (config 5's concatenated
// chain, KKT refinement, nq = 0) take r = 1 + nq = 3 or a single
// right-hand side.  The optimal-control problems carry [x; u] at a node: the
// pendulum swing-up (config 3, nx = 2, nu = 1, degree 4) is b = 12 with no
// parameter (the chain solve at r = 1), its free-time form b = 12 with the
// horizon as the one parameter (nq = 1).  The moving-horizon estimator's
// window (Van der Pol, nx = 2, degree 3, no parameter) is b = 6 at r = 1,
// on an 8-lane group with lanes 6 and 7 idle.  The element-chain sharded
// solve (parallel/spike.py) solves each shard's interior against [G | U |
// V]: r = (1 + nq) + 2 b = 19 at the headline's b = 8, nq = 2.
#define KKT_SHAPES(X) X(8, 2) X(8, 3) X(8, 5) X(12, 1) /* (b, nq), KKT */
#define CHAIN_SHAPES(X) \
  X(6, 1) X(8, 1) X(8, 3) X(8, 19) X(12, 1) /* (b, r), chain */

namespace {

constexpr int kTileThreads = 32;   // one warp: four tiles of b = 6 or 8
                                   // (8-lane groups), two of b = 12 (16)
constexpr int kComposeThreads = 256;

template <typename F, int B, int R, bool KKT>
int run(const kkt::Args<F>& a, cudaStream_t stream) {
  constexpr int W = kkt::group_width(B);   // lanes a tile
  const long long lanes = (long long)a.T * W;
  const unsigned tile_blocks =
      (unsigned)((lanes + kTileThreads - 1) / kTileThreads);
  cudaError_t err;
  kkt::tile_sweep<F, B, R, KKT><<<tile_blocks, kTileThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkt::interface_solve<F, B, R><<<1, W, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkt::back_substitute<F, B, R, KKT><<<tile_blocks, kTileThreads, 0,
                                       stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (KKT) {
    kkt::schur_solve<F, B, R - 1><<<1, 1, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long compose_blocks =
        (a.K + kComposeThreads - 1) / kComposeThreads;
    kkt::compose<F, B, R - 1><<<(unsigned)compose_blocks, kComposeThreads, 0,
                                stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

bool bad_plan(long long K, int T, int L) {
  return K < 1 || T < 1 || L < 3 || (long long)T * L < K;
}

template <typename F>
int dispatch_kkt(const F* D, const F* E, const F* G, const F* inv,
                 const F* cg, F* dx, F* t, F* scratch, int b, int nq,
                 long long K, int T, int L, void* stream) {
  if (bad_plan(K, T, L)) return cudaErrorInvalidValue;
#define KKT_RUN(Bv, NQv)                                                  \
  if (b == Bv && nq == NQv)                                               \
    return run<F, Bv, NQv + 1, true>(                                     \
        kkt::carve<F, Bv, NQv + 1>(D, E, G, inv, cg, dx, t, nullptr,      \
                                   scratch, K, T, L),                     \
        static_cast<cudaStream_t>(stream));
  KKT_SHAPES(KKT_RUN)
#undef KKT_RUN
  return cudaErrorInvalidValue;
}

template <typename F>
int dispatch_chain(const F* D, const F* E, const F* G, F* X, F* scratch,
                   int b, int r, long long K, int T, int L, void* stream) {
  if (bad_plan(K, T, L)) return cudaErrorInvalidValue;
#define CHAIN_RUN(Bv, Rv)                                                 \
  if (b == Bv && r == Rv)                                                 \
    return run<F, Bv, Rv, false>(                                         \
        kkt::carve<F, Bv, Rv>(D, E, G, nullptr, nullptr, nullptr, nullptr, \
                              X, scratch, K, T, L),                       \
        static_cast<cudaStream_t>(stream));
  CHAIN_SHAPES(CHAIN_RUN)
#undef CHAIN_RUN
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
  if (b == Bv && nq == NQv) return kkt::scratch_elems<Bv, NQv + 1>(T, L);
  KKT_SHAPES(KKT_SIZE)
#undef KKT_SIZE
  return -1;
}

// Returns 0 on success or the cudaError_t of the first failed launch.
int kkt_spike_f32(const float* D, const float* E, const float* G,
                  const float* inv, const float* cg, float* dx, float* t,
                  float* scratch, int b, int nq, long long K, int T, int L,
                  void* stream) {
  return dispatch_kkt<float>(D, E, G, inv, cg, dx, t, scratch, b, nq, K, T,
                             L, stream);
}

int kkt_spike_f64(const double* D, const double* E, const double* G,
                  const double* inv, const double* cg, double* dx, double* t,
                  double* scratch, int b, int nq, long long K, int T, int L,
                  void* stream) {
  return dispatch_kkt<double>(D, E, G, inv, cg, dx, t, scratch, b, nq, K, T,
                              L, stream);
}

int spike_chain_supported(int b, int r) {
#define CHAIN_MATCH(Bv, Rv) if (b == Bv && r == Rv) return 1;
  CHAIN_SHAPES(CHAIN_MATCH)
#undef CHAIN_MATCH
  return 0;
}

long long spike_chain_scratch_elems(int b, int r, int T, int L) {
#define CHAIN_SIZE(Bv, Rv) \
  if (b == Bv && r == Rv) return kkt::scratch_elems<Bv, Rv>(T, L);
  CHAIN_SHAPES(CHAIN_SIZE)
#undef CHAIN_SIZE
  return -1;
}

// X (b, r, K) with A X = G; returns 0 or the first failed launch's error.
int spike_chain_f32(const float* D, const float* E, const float* G, float* X,
                    float* scratch, int b, int r, long long K, int T, int L,
                    void* stream) {
  return dispatch_chain<float>(D, E, G, X, scratch, b, r, K, T, L, stream);
}

int spike_chain_f64(const double* D, const double* E, const double* G,
                    double* X, double* scratch, int b, int r, long long K,
                    int T, int L, void* stream) {
  return dispatch_chain<double>(D, E, G, X, scratch, b, r, K, T, L, stream);
}

const char* kkt_spike_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
