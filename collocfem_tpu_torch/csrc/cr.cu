// Per-level cyclic-reduction kernels for NVIDIA Hopper (sm_90a), plain C
// interface.  Replaces the four Pallas TPU kernels of
// collocfem_tpu/ops/cr_pallas.py:
//
//   cr_level_*         cr_level (body _fwd_kernel): one fused CR level, both
//                      the elimination of the odd blocks and the
//                      right-hand-side sweep;
//   cr_factor_sweep_*  cr_level_factor (body _factor_kernel), level after
//                      level: the G-independent half, which also stores the
//                      Cholesky factor of the odd blocks for later sweeps;
//   cr_apply_sweep_*   cr_level_apply (body _apply_kernel), level after
//                      level: reduces G through the stored factors;
//   cr_backsub_sweep_* cr_backsub (body _bwd_kernel), level after level from
//                      the tail up: recovers the odd blocks and writes the
//                      interleaved solution.
//
// The Pallas kernels emit each pair's cross term for the next pair and let
// XLA shift-subtract it outside, because a TPU kernel could not store to a
// neighbour's lane.  Here the cross term travels one lane up inside the pair
// pass (cr_kernels.cuh), so a level is one launch and writes d_new / g_new
// complete.  The factor kernel stores no copy of e_up / e_lo: the apply
// kernel reads them from the level's input E, which the caller keeps.
//
// A sweep is one call of this library: it launches every level from here, on
// the caller's stream, each level reading the one before from the sweep's
// workspace (layout: cr::sweep_offset).  The caller allocates the workspace
// and nothing here synchronises.
//
// What bounds them on the card: at the first level of the headline chain at
// N = 20,000 (K padded to 32,768, b = 8, 16,384 pairs) the factor pass reads
// 1 KB and writes 1.25 KB per pair in float32, 37.7 MB, some 11 us of HBM
// traffic, against ~7,500 flops per pair (~120 MFLOP, 2 us at the card's
// float32 rate): the big levels are bound by bytes.  A chain halves per level
// (12 levels down to 8 blocks), and eight of the twelve have at most 1,024
// pairs: they are bound by the latency of one thread's dependent work and by
// the launch.  The warp-per-column layout cuts that work from a whole pair
// to one column of it, and the staging in shared memory cuts a thread's
// rounds of loads to one.  The back-substitution moves 29.4 MB a float32
// sweep (8.8 us), half of it at the top level; it spreads a pair over b
// threads, one a row, and runs its levels of at most 64 pairs
// (ops/cr.py BACKSUB_SMALL_PAIRS) in one launch of one block.
//
// Measured (collocfem_tpu_torch/tools/cr_sweeps.py, NVIDIA H100 80GB HBM3,
// 700.00 W, device time by torch.profiler): the 12 levels of the factor
// pass take 19.6, 8.4, 5.7 and then 4.3 to 3.9 us each in float32, 71 us a
// sweep (float64: 33.3, 15.5, 8.9, then 6.5 to 5.2; 111 us); the apply pass
// with r = 3, 6.5, 5.2 and then ~4 us each, 51 us a sweep (float64 82 us).
// The back-substitution's top level takes 4.8 us in float32 (its bytes: 4.4
// us; float64 12.6), each bigger level 2.3 to 3.3 us, mostly the launch,
// and the four levels of at most 64 pairs 5.6 us in their one launch
// (float64 7.5) against 8.8 (11.1) in four: 29.2 / 48.0 us a sweep (the
// one-thread-per-pair kernel before: ~105 / ~123).  Fusing 16, 32, 64, 128
// or 256 pairs gave 31.6, 30.2, 29.2, 29.4, 32.0 us (float64 50.8, 49.3,
// 48.0, 48.4, 52.8): a fused level costs ~1.2 us, the latency of its rows'
// loads, which the block prefetches only one step ahead.  By CUDA events a
// whole sweep takes ~0.1-0.25 ms, because the host cannot launch it faster
// (PERF.md).

// The device code is in cr_kernels.cuh.  Build (one instance per shape;
// collocfem_tpu_torch/ops/_build.py does this at first use of the shape):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DCF_B=8 -DCF_R=3 -o cr-b8-r3.so cr.cu
// CF_B is the block size b (1..16).  CF_R = 0 builds the factor kernel
// (#4), which needs only b; CF_R = r >= 1 builds the kernels that take r
// right-hand sides (#3, #5, #6).

#include <cuda_runtime.h>

#include "cr_kernels.cuh"

#if !defined(CF_B) || !defined(CF_R)
#error "build with -DCF_B=<b> -DCF_R=<r> (ops/_build.py)"
#endif
static_assert(CF_B >= 1 && CF_B <= 16 && CF_R >= 0, "b in 1..16, r >= 0");

namespace {

constexpr int B = CF_B, R = CF_R;

// Kernel launches made by this library since it was loaded.
unsigned long long device_launches = 0;

// Launch Kernel with `bytes` of dynamic shared memory (above the 48 KB a
// block may use by default, the kernel is first given leave to) and count it.
template <auto Kernel, typename... Args>
cudaError_t launch(unsigned grid, int threads, size_t bytes, cudaStream_t s,
                   Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  Kernel<<<grid, threads, bytes, s>>>(args...);
  ++device_launches;
  return cudaGetLastError();
}

unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

// Whether `levels` levels can run from a chain of 2 h0 blocks: every level's
// chain must be even.
bool sweep_ok(long long h0, int levels) {
  return levels >= 1 && levels < 62 && h0 >= 1 &&
         (2 * h0) % (1LL << levels) == 0;
}

#if CF_R == 0

template <typename F>
int factor_sweep(const F* D, const F* E, F* ws, int b, long long h0,
                 int levels, void* stream) {
  if (b != B || !sweep_ok(h0, levels)) return cudaErrorInvalidValue;
  constexpr int P = cr::kFactorPairs<F, B>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int lv = 0; lv < levels; ++lv) {
    const long long h = h0 >> lv, n = (long long)B * B * h;
    F* out = ws + cr::sweep_offset(5, B * B, h0, h);
    const cudaError_t err = launch<cr::factor_pairs<F, B, P>>(
        blocks_for(h, P - 1), cr::whole_warps(B * P),
        cr::factor_tile(B, P) * sizeof(F), s, D, E, out, out + n,
        out + 2 * n, out + 3 * n, out + 4 * n, h);
    if (err != cudaSuccess) return err;
    D = out;
    E = out + n;
  }
  return cudaSuccess;
}

#else

template <typename F>
int apply_sweep(const F* const* lo, const F* const* E, const F* G, F* ws,
                int b, int r, long long h0, int levels, void* stream) {
  if (b != B || r != R || !sweep_ok(h0, levels)) return cudaErrorInvalidValue;
  constexpr int P = cr::kApplyPairs<F, B, R>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int lv = 0; lv < levels; ++lv) {
    const long long h = h0 >> lv, n = (long long)B * R * h;
    F* out = ws + cr::sweep_offset(2, B * R, h0, h);
    const cudaError_t err = launch<cr::apply_pairs<F, B, R, P>>(
        blocks_for(h, P - 1), cr::kApplyWarps<R> * 32,
        cr::apply_tile(B, R, P) * sizeof(F), s, lo[lv], E[lv], G, out,
        out + n, h);
    if (err != cudaSuccess) return err;
    G = out;
  }
  return cudaSuccess;
}

template <typename F>
int level(const F* D, const F* E, const F* G, F* dn, F* en, F* gn, F* su,
          F* sl, F* sg, int b, int r, long long h, void* stream) {
  if (b != B || r != R || h < 1) return cudaErrorInvalidValue;
  constexpr int P = cr::kLevelPairs<F, B, R>;
  return launch<cr::level_pairs<F, B, R, P>>(
      blocks_for(h, P - 1), cr::whole_warps(B * P),
      cr::level_tile(B, R, P) * sizeof(F), static_cast<cudaStream_t>(stream),
      D, E, G, dn, en, gn, su, sl, sg, h);
}

// Level lv of a back-substitution sweep reads the X of level lv + 1 (the
// tail's, xt, for the last level) and writes its own to X (lv = 0) or to the
// workspace.  The levels of at most h_small pairs run first, in one launch
// that keeps their X in shared memory but for the last one's.
template <typename F>
int backsub_sweep(const F* xt, const F* const* su, const F* const* sl,
                  const F* const* sg, F* X, F* ws, int b, int r, long long h0,
                  int levels, long long h_small, void* stream) {
  if (b != B || r != R || !sweep_ok(h0, levels) || h_small < 0 ||
      h_small > cr::kMaxSmallPairs ||
      cr::small_bytes<F, B, R>(h_small) > cr::kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto out = [&](int lv) {
    return lv == 0 ? X : ws + cr::backsub_offset(B * R, h0, h0 >> lv);
  };
  const auto in = [&](int lv) -> const F* {
    return lv + 1 == levels ? xt : out(lv + 1);
  };
  int lv = levels - 1;
  cr::SmallLevels<F> small{};
  small.xt = xt;
  for (; lv >= 0 && (h0 >> lv) <= h_small; --lv, ++small.n) {
    small.su[small.n] = su[lv];
    small.sl[small.n] = sl[lv];
    small.sg[small.n] = sg[lv];
    small.h[small.n] = h0 >> lv;
  }
  if (small.n) {
    small.X = out(lv + 1);
    const cudaError_t err = launch<cr::backsub_small<F, B, R>>(
        1, cr::kSmallThreads<B>,
        cr::small_bytes<F, B, R>(small.h[small.n - 1]), s, small);
    if (err != cudaSuccess) return err;
  }
  for (; lv >= 0; --lv) {
    const long long h = h0 >> lv;
    const cudaError_t err = launch<cr::backsub_pairs<F, B, R>>(
        blocks_for(h, cr::kLanes), B * cr::kLanes,
        cr::backsub_tile(B, R) * sizeof(F), s, in(lv), su[lv], sl[lv],
        sg[lv], out(lv), h);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

#endif

}  // namespace

extern "C" {

// 1 if this instance is (b, r); r = 0 is the factor kernel's instance.
int cr_supported(int b, int r) { return b == B && r == R; }

// Kernel launches made by this library since it was loaded (every entry
// below adds one per kernel it launches).
unsigned long long cr_device_launches() { return device_launches; }

// All arrays SoA with the chain last.  Each entry returns 0 or the
// cudaError_t of its first failed launch.

#if CF_R == 0

// cr_factor_sweep: `levels` factor levels from the chain D, E of 2 h0 blocks
// (2 h0 a multiple of 2^levels).  Level lv (h = h0 >> lv pairs) writes dn,
// en, su, sl, lo, each (b, b, h), one after the other from
// ws + cr::sweep_offset(5, b b, h0, h); the next level reads its dn, en.
int cr_factor_sweep_f32(const float* D, const float* E, float* ws, int b,
                        long long h0, int levels, void* stream) {
  return factor_sweep<float>(D, E, ws, b, h0, levels, stream);
}

int cr_factor_sweep_f64(const double* D, const double* E, double* ws, int b,
                        long long h0, int levels, void* stream) {
  return factor_sweep<double>(D, E, ws, b, h0, levels, stream);
}

#else

// cr_apply_sweep: `levels` apply levels from G (b, r, 2 h0) through the
// factors lo[lv] (b, b, h) and the levels' input couplings E[lv] (b, b, 2h)
// (host arrays of device pointers).  Level lv writes gn, sg, each (b, r, h),
// from ws + cr::sweep_offset(2, b r, h0, h); the next level reads its gn.
int cr_apply_sweep_f32(const float* const* lo, const float* const* E,
                       const float* G, float* ws, int b, int r, long long h0,
                       int levels, void* stream) {
  return apply_sweep<float>(lo, E, G, ws, b, r, h0, levels, stream);
}

int cr_apply_sweep_f64(const double* const* lo, const double* const* E,
                       const double* G, double* ws, int b, int r,
                       long long h0, int levels, void* stream) {
  return apply_sweep<double>(lo, E, G, ws, b, r, h0, levels, stream);
}

// cr_backsub_sweep: `levels` back-substitution levels from the tail's X xt
// (b, r, h0 >> (levels - 1)) up to X (b, r, 2 h0), through level lv's s_up
// su[lv], s_lo sl[lv] (b, b, h) and s_g sg[lv] (b, r, h), h = h0 >> lv (host
// arrays of device pointers).  Level lv >= 1 writes its X (b, r, 2h) to
// ws + cr::backsub_offset(b r, h0, h).  Every level of at most h_small
// pairs (0 <= h_small <= cr::kMaxSmallPairs) runs in one launch, which
// writes the X of only its last level.
int cr_backsub_sweep_f32(const float* xt, const float* const* su,
                         const float* const* sl, const float* const* sg,
                         float* X, float* ws, int b, int r, long long h0,
                         int levels, long long h_small, void* stream) {
  return backsub_sweep<float>(xt, su, sl, sg, X, ws, b, r, h0, levels,
                              h_small, stream);
}

int cr_backsub_sweep_f64(const double* xt, const double* const* su,
                         const double* const* sl, const double* const* sg,
                         double* X, double* ws, int b, int r, long long h0,
                         int levels, long long h_small, void* stream) {
  return backsub_sweep<double>(xt, su, sl, sg, X, ws, b, r, h0, levels,
                               h_small, stream);
}

// cr_level: inputs of chain length 2h, outputs of length h.
int cr_level_f32(const float* D, const float* E, const float* G, float* dn,
                 float* en, float* gn, float* su, float* sl, float* sg, int b,
                 int r, long long h, void* stream) {
  return level<float>(D, E, G, dn, en, gn, su, sl, sg, b, r, h, stream);
}

int cr_level_f64(const double* D, const double* E, const double* G,
                 double* dn, double* en, double* gn, double* su, double* sl,
                 double* sg, int b, int r, long long h, void* stream) {
  return level<double>(D, E, G, dn, en, gn, su, sl, sg, b, r, h, stream);
}

#endif

const char* cr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
