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
// Build (one instance per shape; collocfem_tpu_torch/ops/_build.py does this
// at first use of the shape):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DCF_B=8 -DCF_R=3 -DCF_KKT=1 \
//        -o kkt_spike-b8-r3.so kkt_spike.cu
// CF_B is the block size b (1..16), CF_R the right-hand-side count r (for
// the KKT solve r = 1 + nq, the group [gx | B]), CF_KKT selects kernel #1
// (1) or kernel #2 (0).  The lane group is group_width(b) lanes: 1, 2, 4, 8
// or 16, the lanes b..W-1 idle (kkt_spike_kernels.cuh).

#include <cuda_runtime.h>

#include "kkt_spike_kernels.cuh"

#if !defined(CF_B) || !defined(CF_R) || !defined(CF_KKT)
#error "build with -DCF_B=<b> -DCF_R=<r> -DCF_KKT=<0|1> (ops/_build.py)"
#endif
static_assert(CF_B >= 1 && CF_B <= 16, "block sizes 1..16");
static_assert(CF_R >= (CF_KKT ? 2 : 1), "kernel #1 needs nq >= 1");

namespace {

constexpr int kTileThreads = 32;   // one warp: 32 / W tiles (W = 1 .. 16)
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

// Whether this instance is the one asked for: (b, r) its shape.
bool is_shape(int b, int r) { return b == CF_B && r == CF_R; }

}  // namespace

extern "C" {

#if CF_KKT

int kkt_spike_supported(int b, int nq) { return is_shape(b, nq + 1); }

long long kkt_spike_scratch_elems(int b, int nq, int T, int L) {
  return is_shape(b, nq + 1) ? kkt::scratch_elems<CF_B, CF_R>(T, L) : -1;
}

// Returns 0 on success or the cudaError_t of the first failed launch.
#define KKT_ENTRY(NAME, F)                                                  \
  int NAME(const F* D, const F* E, const F* G, const F* inv, const F* cg,  \
           F* dx, F* t, F* scratch, int b, int nq, long long K, int T,      \
           int L, void* stream) {                                           \
    if (!is_shape(b, nq + 1) || bad_plan(K, T, L))                          \
      return cudaErrorInvalidValue;                                         \
    return run<F, CF_B, CF_R, true>(                                        \
        kkt::carve<F, CF_B, CF_R>(D, E, G, inv, cg, dx, t, nullptr,         \
                                  scratch, K, T, L),                        \
        static_cast<cudaStream_t>(stream));                                 \
  }
KKT_ENTRY(kkt_spike_f32, float)
KKT_ENTRY(kkt_spike_f64, double)
#undef KKT_ENTRY

#else

int spike_chain_supported(int b, int r) { return is_shape(b, r); }

long long spike_chain_scratch_elems(int b, int r, int T, int L) {
  return is_shape(b, r) ? kkt::scratch_elems<CF_B, CF_R>(T, L) : -1;
}

// X (b, r, K) with A X = G; returns 0 or the first failed launch's error.
#define CHAIN_ENTRY(NAME, F)                                                \
  int NAME(const F* D, const F* E, const F* G, F* X, F* scratch, int b,    \
           int r, long long K, int T, int L, void* stream) {                \
    if (!is_shape(b, r) || bad_plan(K, T, L)) return cudaErrorInvalidValue; \
    return run<F, CF_B, CF_R, false>(                                       \
        kkt::carve<F, CF_B, CF_R>(D, E, G, nullptr, nullptr, nullptr,       \
                                  nullptr, X, scratch, K, T, L),            \
        static_cast<cudaStream_t>(stream));                                 \
  }
CHAIN_ENTRY(spike_chain_f32, float)
CHAIN_ENTRY(spike_chain_f64, double)
#undef CHAIN_ENTRY

#endif

const char* kkt_spike_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
