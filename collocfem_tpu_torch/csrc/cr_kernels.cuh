// Device code of the cyclic-reduction kernels (see cr.cu).
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
// The pair passes (kernels #3, #4, #5): a warp per block column.  A block of
// b warps works on P = 32 consecutive pairs: warp c owns column c of every
// b x b (or b x r) result of those pairs, and lane l owns the pair p0 + l.
// Where the tiles of 32 pairs would not fit in a block's shared memory
// (pairs_for: in float64 only, the factor pass at b = 16 and the fused level
// and apply pass at b >= 12 with many right-hand sides), a block works on P
// = 16 pairs and a warp holds two columns, a half-warp each; a block of b
// odd then has a last half-warp with no column, which stages and leaves.  All a
// pair computes is column-parallel: column c of s_lo, s_up and s_g is one
// pair of triangular solves with the pair's factor, and column c of d_new,
// e_new, g_new and of the cross terms needs the whole of e_up / e_lo and only
// that column of s.  So the algebra needs no exchange between threads, and a
// level's latency is one column's work (a Cholesky, two solves, three
// matrix-vector products) instead of one thread's whole pair.  Every warp
// factors D_odd of its 32 pairs itself (8 square roots and reciprocals):
// b-fold redundant work, but no barrier inside the algebra.  (Factoring on
// one warp and handing L through shared memory was measured and was slower
// on the large levels and no faster on the small ones.)  The apply pass
// loads the stored factor instead; its first r warps take a column each.
//
// The inputs go through shared memory.  The 32 pairs of a block are 64
// neighbouring chain slots.  The block first copies those slots of every
// row of D, E (and G, and the stored factor's lower triangle) into a tile,
// all threads at once and neighbouring threads on neighbouring slots: one
// round of loads that uses whole cache lines, instead of each thread
// fetching its rows at stride 2 as its algebra reaches them, round trip
// after round trip.  (Reading the level's input directly took 1.6x the time
// on every level; prefetching it into L1 did not help.)  The tile keeps a
// row's even slots first and its odd ones after them, so a warp reads 32
// neighbouring words.  Outputs are written SoA with the pair index across
// the lanes.
//
// The cross term.  Pair p's cross_d / cross_g belongs to pair p + 1, the
// next lane of the same warp: one __shfl_up_sync per value with the whole
// warp's constant mask (the half-warp's at P = 16).  Lane 0 needs the pair
// before the block's first, so each block computes that pair again as a
// halo and stores nothing for it: a block stores P - 1 = 31 pairs.  A slot
// before or past the chain reads the nearest one, so the lanes there work on
// a harmless pair and store nothing; the pair before the chain passes a zero
// cross term on.  d_new and g_new
// are so written once, complete, as (d_even - e_up s_up) - cross, the order
// of the plain version.
//
// Arithmetic per pair: the Cholesky without pivoting, column-by-column
// solves and every dot product summed over k = 0 .. b - 1 from zero, as the
// plain versions (ops/cr.py) do them.
//
// Registers: a thread holds the factor (b (b + 1) / 2 values and b inverse
// pivots), its columns of s_lo and s_up, the cross column and one row of E.
// Shared memory per block, b = 8: 32 KB (float32) / 64 KB (float64) for the
// factor pass, up to 38 / 76 KB for the fused level, up to 30 / 60 KB for
// the apply pass; above 48 KB it is dynamic shared memory by leave, and at
// most the 227 KB a block may have (pairs_for).  The fused level and the
// apply pass take more right-hand-side columns than they have column
// groups by striding the columns over them.

#pragma once

#include "kkt_spike_kernels.cuh"

namespace cr {

constexpr int kLanes = 32;        // a warp; the pairs of the back-substitution
constexpr unsigned kWarp = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;   // shared memory a block may have: 227 KB

// Threads of a block of n column threads: whole warps.
__host__ __device__ constexpr int whole_warps(int n) {
  return (n + 31) / 32 * 32;
}

// The lanes of this thread's group of P pairs (P = 32: the whole warp), the
// mask of the group's shuffles.
template <int P>
__device__ __forceinline__ unsigned segment_mask() {
  if constexpr (P == 32) {
    return kWarp;
  } else {
    return ((1u << P) - 1u) << (threadIdx.x % 32 / P * P);
  }
}

// Start of level lv's arrays in a sweep's workspace, in elements.  A sweep
// runs levels lv = 0, 1, ... on chains of 2 h0 >> lv blocks, and level lv
// writes `arrays` outputs of `rows` rows and h = h0 >> lv columns each, one
// after the other; the levels follow each other, so level lv starts at
// arrays * rows * (h0 + h0 / 2 + ... + 2 h) = arrays * rows * 2 (h0 - h).
// The workspace of `levels` levels holds sweep_offset(..., h0 >> levels)
// elements.  ops/cr.py computes the same (sweep_layout).
inline long long sweep_offset(int arrays, int rows, long long h0,
                              long long h) {
  return (long long)arrays * rows * 2 * (h0 - h);
}

// The pair a lane works on, in a block of P pairs (the halo included) that
// stores P - 1.
template <int P>
struct Lane {
  long long p;   // the pair; in the chain where store is set
  bool store;    // this lane writes its pair's outputs
  bool before;   // the pair before the chain: its cross term is zero
  int lane;      // this thread's place among the P: its pair's in the block
  int col;       // the column this thread's group of P owns
  __device__ __forceinline__ explicit Lane(long long h) {
    lane = threadIdx.x % P;
    p = (long long)blockIdx.x * (P - 1) + lane - 1;
    store = lane > 0 && p < h;
    before = p < 0;
    col = threadIdx.x / P;
  }
};

// The pair's inputs as a lane reads them from the block's tiles: arrays of
// row stride n with the even block at slot ke and the odd block at ko.
template <typename F>
struct Inputs {
  const F *D, *E, *G;
  long long n, ke, ko;
};

// The block's dynamic shared memory.
template <typename F>
__device__ __forceinline__ F* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char raw[];
  return reinterpret_cast<F*>(raw);
}

// Copy rows 0 .. ROWS - 1 of the SLOTS chain slots from s0 on of an SoA array
// with chain length n into tile (ROWS, SLOTS), all THREADS threads of the
// block together, neighbouring threads on neighbouring slots; a slot before
// or past the chain reads the nearest one.  With SPLIT the even slots of a
// row come first and the odd ones after them, so that lane l finds its
// pair's even block at l and its odd block at SLOTS / 2 + l.  With LOWER > 0
// the rows are those of a LOWER x LOWER block and only its lower triangle
// is copied.
// Where THREADS is no whole number of rows of SLOTS, or ROWS no whole
// number of passes, the threads walk the tile's elements instead.
template <typename F, int ROWS, int SLOTS, int THREADS, bool SPLIT,
          int LOWER = 0>
__device__ __forceinline__ void stage(const F* a, long long n, long long s0,
                                      F* tile) {
  constexpr int kBlock = LOWER > 0 ? LOWER : 1;
  if constexpr (THREADS % SLOTS == 0 && ROWS % (THREADS / SLOTS) == 0) {
    constexpr int kRowsPerPass = THREADS / SLOTS;
    constexpr int kPasses = ROWS / kRowsPerPass;
    const int j = threadIdx.x % SLOTS, r0 = threadIdx.x / SLOTS;
    long long s = s0 + j;
    s = s < 0 ? 0 : (s < n ? s : n - 1);
    const int dst = SPLIT ? (j & 1) * (SLOTS / 2) + j / 2 : j;
#pragma unroll(kPasses <= 32 ? kPasses : 16)
    for (int k = 0; k < kPasses; ++k) {
      const int row = k * kRowsPerPass + r0;
      if (LOWER > 0 && row % kBlock > row / kBlock) continue;
      tile[row * SLOTS + dst] = a[(long long)row * n + s];
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * SLOTS; e += THREADS) {
      const int row = e / SLOTS, j = e % SLOTS;
      if (LOWER > 0 && row % kBlock > row / kBlock) continue;
      long long s = s0 + j;
      s = s < 0 ? 0 : (s < n ? s : n - 1);
      const int dst = SPLIT ? (j & 1) * (SLOTS / 2) + j / 2 : j;
      tile[row * SLOTS + dst] = a[(long long)row * n + s];
    }
  }
}

// The lower triangle of the B x B block at slot k (the rest is left alone).
template <typename F, int B>
__device__ __forceinline__ void ld_lower(const F* a, long long n, long long k,
                                         F out[B][B]) {
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) out[i][j] = a[(long long)(i * B + j) * n + k];
}

// In-place lower Cholesky of the lower triangle of a, with inv[j] = 1 /
// a[j][j] (correctly rounded, the value of the division).  Each pivot is
// clamped at tiny (a NaN stays NaN), so a noise-indefinite block gives a
// finite junk factor and the LM loop rejects the step.
template <typename F, int B>
__device__ __forceinline__ void chol_inv(F a[B][B], F inv[B]) {
  using N = kkt::Num<F>;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    F s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= a[j][k] * a[j][k];
    const F d = N::sqrt_(s < N::tiny ? N::tiny : s);
    a[j][j] = d;
    inv[j] = N::rcp(d);
#pragma unroll
    for (int i = j + 1; i < B; ++i) {
      F s2 = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 -= a[i][k] * a[j][k];
      a[i][j] = s2 * inv[j];
    }
  }
}

// x <- (L L^T)^-1 x for one column, with the lower factor in l and its
// inverse pivots.
template <typename F, int B>
__device__ __forceinline__ void solve_col(const F l[B][B], const F inv[B],
                                          F x[B]) {
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * x[k];
    x[i] = s * inv[i];
  }
#pragma unroll
  for (int i = B - 1; i >= 0; --i) {
    F s = x[i];
#pragma unroll
    for (int k = i + 1; k < B; ++k) s -= l[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// (e_lo^T s)[i] for the pair before this lane's: this pair's column of the
// cross term, zero for the pair before the chain, handed one lane up inside
// the group of P pairs.  Every lane of the group must call it.
template <typename F, int B, int P>
__device__ __forceinline__ void cross_from_below(const F* E, long long m,
                                                 long long ko, const F s[B],
                                                 bool before, F cross[B]) {
  const unsigned mask = segment_mask<P>();
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F t = F(0);
#pragma unroll
    for (int k = 0; k < B; ++k) t += E[(long long)(k * B + i) * m + ko] * s[k];
    cross[i] = __shfl_up_sync(mask, before ? F(0) : t, 1, P);
  }
}

// Column ln.col of the G-independent half of pair ln.p through the factor
// in l / inv: s_lo, s_up, e_new and d_new, complete with the cross term of
// the pair before.
template <typename F, int B, int P>
__device__ __forceinline__ void factor_column(const F l[B][B], const F inv[B],
                                              const Inputs<F>& in,
                                              long long h, const Lane<P>& ln,
                                              F* dn, F* en, F* su, F* sl) {
  const F *D = in.D, *E = in.E;
  const long long m = in.n, ke = in.ke, ko = in.ko, p = ln.p;
  const int c = ln.col;
  F x[B], y[B], cross[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    x[i] = E[(long long)(i * B + c) * m + ko];   // column c of e_lo
    y[i] = E[(long long)(c * B + i) * m + ke];   // column c of e_up^T
  }
  solve_col<F, B>(l, inv, x);                    // s_lo[:, c]
  solve_col<F, B>(l, inv, y);                    // s_up[:, c]
  cross_from_below<F, B, P>(E, m, ko, x, ln.before, cross);
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F er[B];
#pragma unroll
    for (int k = 0; k < B; ++k) er[k] = E[(long long)(i * B + k) * m + ke];
    const F d = D[(long long)(i * B + c) * m + ke];
    F t1 = F(0), t2 = F(0);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      t1 += er[k] * x[k];
      t2 += er[k] * y[k];
    }
    if (ln.store) {
      const long long o = (long long)(i * B + c) * h + p;
      en[o] = F(0) - t1;
      dn[o] = (d - t2) - cross[i];
      sl[o] = x[i];
      su[o] = y[i];
    }
  }
}

// Column c of the right-hand-side half of pair ln.p: s_g and g_new,
// complete with the cross term of the pair before.
template <typename F, int B, int R, int P>
__device__ __forceinline__ void apply_column(const F l[B][B], const F inv[B],
                                             const Inputs<F>& in,
                                             long long h, const Lane<P>& ln,
                                             int c, F* gn, F* sg) {
  const F *E = in.E, *G = in.G;
  const long long m = in.n, ke = in.ke, ko = in.ko, p = ln.p;
  F s[B], cross[B];
#pragma unroll
  for (int i = 0; i < B; ++i) s[i] = G[(long long)(i * R + c) * m + ko];
  solve_col<F, B>(l, inv, s);                    // s_g[:, c]
  cross_from_below<F, B, P>(E, m, ko, s, ln.before, cross);
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const F g = G[(long long)(i * R + c) * m + ke];
    F t = F(0);
#pragma unroll
    for (int k = 0; k < B; ++k) t += E[(long long)(i * B + k) * m + ke] * s[k];
    if (ln.store) {
      const long long o = (long long)(i * R + c) * h + p;
      gn[o] = (g - t) - cross[i];
      sg[o] = s[i];
    }
  }
}

// First chain slot of the block's P pairs (the halo pair's even block).
template <int P>
__device__ __forceinline__ long long first_slot() {
  return 2 * ((long long)blockIdx.x * (P - 1) - 1);
}

// Stage the block's 2 P chain slots of the b x b arrays D, E (either may be
// null) and of the b x R array G (R > 0) into tile, with a block of THREADS
// threads.  The caller synchronises the block before reading.
template <typename F, int B, int R, int THREADS, int P>
__device__ __forceinline__ Inputs<F> staged(const F* D, const F* E,
                                            const F* G, long long h,
                                            const Lane<P>& ln, F* tile) {
  constexpr int kSlots = 2 * P;
  const long long s0 = first_slot<P>();
  Inputs<F> in{nullptr, nullptr, nullptr, kSlots, ln.lane, P + ln.lane};
  if (D) {
    stage<F, B * B, kSlots, THREADS, true>(D, 2 * h, s0, tile);
    in.D = tile;
    tile += B * B * kSlots;
  }
  if (E) {
    stage<F, B * B, kSlots, THREADS, true>(E, 2 * h, s0, tile);
    in.E = tile;
    tile += B * B * kSlots;
  }
  if constexpr (R > 0) {
    stage<F, B * R, kSlots, THREADS, true>(G, 2 * h, s0, tile);
    in.G = tile;
  }
  return in;
}

// Column ln.col of the lower factor in l, with zeros above the diagonal, to
// lo.
template <typename F, int B, int P>
__device__ __forceinline__ void store_factor(const F l[B][B], long long h,
                                             const Lane<P>& ln, F* lo) {
  if (!ln.store) return;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F v = F(0);
#pragma unroll
    for (int j = 0; j <= i; ++j) v = (j == ln.col) ? l[i][j] : v;
    lo[(long long)(i * B + ln.col) * h + ln.p] = v;
  }
}

// ---- kernels ---------------------------------------------------------------

// Warps of an apply block: one per right-hand-side column up to eight,
// and at least four to stage the inputs; a power of two, so that a block
// stages whole rows of every tile in each pass where it can.
template <int R>
constexpr int kApplyWarps = R <= 4 ? 4 : 8;

// Elements of dynamic shared memory a block of each pair pass stages, for
// P pairs: the level's D and E (b b rows each) and G (b r rows) at 2 P
// slots, the stored factor at P.
__host__ __device__ constexpr int factor_tile(int b, int p) {
  return 2 * b * b * 2 * p;
}
__host__ __device__ constexpr int level_tile(int b, int r, int p) {
  return factor_tile(b, p) + b * r * 2 * p;
}
__host__ __device__ constexpr int apply_tile(int b, int r, int p) {
  return b * b * p + b * b * 2 * p + b * r * 2 * p;
}

// The pairs P of a block whose tiles take `elems32` elements at P = 32: 32
// where they fit in a block's shared memory, else 16.
template <typename F>
__host__ __device__ constexpr int pairs_for(int elems32) {
  return (size_t)elems32 * sizeof(F) <= kMaxSmem ? 32 : 16;
}
template <typename F, int B>
constexpr int kFactorPairs = pairs_for<F>(factor_tile(B, 32));
template <typename F, int B, int R>
constexpr int kLevelPairs = pairs_for<F>(level_tile(B, R, 32));
template <typename F, int B, int R>
constexpr int kApplyPairs = pairs_for<F>(apply_tile(B, R, 32));

// Kernel #4's pair pass: the G-independent half of a level, b column
// groups of P pairs a block.  Also stores the lower factor with zeros above
// the diagonal to lo.
template <typename F, int B, int P>
__global__ void __launch_bounds__(whole_warps(B * P))
factor_pairs(const F* D, const F* E, F* dn, F* en, F* su, F* sl, F* lo,
             long long h) {
  static_assert(factor_tile(B, P) * sizeof(F) <= kMaxSmem, "shared memory");
  const Lane<P> ln(h);
  const Inputs<F> in = staged<F, B, 0, whole_warps(B * P), P>(
      D, E, nullptr, h, ln, dynamic_smem<F>());
  __syncthreads();
  if (ln.col >= B) return;                   // the half-warp with no column
  F l[B][B], inv[B];
  ld_lower<F, B>(in.D, in.n, in.ko, l);
  chol_inv<F, B>(l, inv);
  store_factor<F, B>(l, h, ln, lo);
  factor_column<F, B>(l, inv, in, h, ln, dn, en, su, sl);
}

// Kernel #5's pair pass: reduce G through the stored factor lo; every
// thread of the block stages, and the column groups of P pairs take the
// right-hand-side columns in turn.
template <typename F, int B, int R, int P>
__global__ void __launch_bounds__(kApplyWarps<R> * 32)
apply_pairs(const F* lo, const F* E, const F* G, F* gn, F* sg, long long h) {
  constexpr int kThreads = kApplyWarps<R> * 32;
  static_assert(apply_tile(B, R, P) * sizeof(F) <= kMaxSmem, "shared memory");
  const Lane<P> ln(h);
  F* lt = dynamic_smem<F>();
  stage<F, B * B, P, kThreads, false, B>(lo, h, first_slot<P>() / 2, lt);
  const Inputs<F> in = staged<F, B, R, kThreads, P>(nullptr, E, G, h, ln,
                                                    lt + B * B * P);
  __syncthreads();
  if (ln.col >= R) return;
  F l[B][B], inv[B];
  ld_lower<F, B>(lt, P, ln.lane, l);
#pragma unroll
  for (int i = 0; i < B; ++i) inv[i] = kkt::Num<F>::rcp(l[i][i]);
  for (int c = ln.col; c < R; c += kThreads / P)
    apply_column<F, B, R>(l, inv, in, h, ln, c, gn, sg);
}

// Kernel #3's pair pass: both halves with the factor kept in registers, b
// column groups of P pairs a block; the column groups also take the
// right-hand-side columns in turn.
template <typename F, int B, int R, int P>
__global__ void __launch_bounds__(whole_warps(B * P))
level_pairs(const F* D, const F* E, const F* G, F* dn, F* en, F* gn, F* su,
            F* sl, F* sg, long long h) {
  static_assert(level_tile(B, R, P) * sizeof(F) <= kMaxSmem, "shared memory");
  const Lane<P> ln(h);
  const Inputs<F> in = staged<F, B, R, whole_warps(B * P), P>(
      D, E, G, h, ln, dynamic_smem<F>());
  __syncthreads();
  if (ln.col >= B) return;                   // the half-warp with no column
  F l[B][B], inv[B];
  ld_lower<F, B>(in.D, in.n, in.ko, l);
  chol_inv<F, B>(l, inv);
  factor_column<F, B>(l, inv, in, h, ln, dn, en, su, sl);
  for (int c = ln.col; c < R; c += B)
    apply_column<F, B, R>(l, inv, in, h, ln, c, gn, sg);
}

// ---- kernel #6: the back-substitution ----------------------------------------
//
// x_odd[p] = s_g - s_up x_even[p] - s_lo x_even[p + 1] (x_even[h] = 0),
// written interleaved with x_even into X (b, r, 2h).  A level's pairs do not
// depend on each other, only on the level below (its X is this level's
// x_even), so a sweep runs
//
//   backsub_small  every level of at most h_small pairs in one launch: one
//                  block of kSmallThreads walks them from the tail up, with a
//                  __syncthreads() between levels and their X in shared
//                  memory (the last one's to global memory);
//   backsub_pairs  each bigger level in a launch of its own: a block of b
//                  warps on kLanes neighbouring pairs stages x_even of those
//                  pairs and of the next one (x_right of its last pair) in
//                  dynamic shared memory (backsub_tile).
//
// In both, thread (row i, pair p) sits in warp i of its group of b warps and
// on lane p % kLanes: it loads its rows of s_up, s_lo and s_g (neighbouring
// lanes on neighbouring pairs) before it waits for x_even, then writes
// (x_even, x_odd) of each of its r columns as one two-element store at 2p,
// neighbouring lanes to neighbouring addresses.  Arithmetic: t1 = sum_k
// s_up[i][k] x_even[k][c] and t2 = sum_k s_lo[i][k] x_right[k][c], each
// summed over k = 0 .. b - 1 from zero, x_odd = s_g - t1 - t2: the order of
// the one-thread-per-pair kernel before, so the results are equal bit for
// bit.

// Start, in elements, of the X (rows, 2h) that level lv (h = h0 >> lv pairs,
// lv >= 1) of a back-substitution sweep writes for the level above, in the
// sweep's workspace.  Level 0 writes the sweep's output instead; levels 1,
// 2, ... follow each other, so level lv starts at rows * 2 (h0 / 2 + ... +
// 2h) = 2 rows (h0 - 2h).  ops/cr.py computes the same (backsub_layout).
inline long long backsub_offset(int rows, long long h0, long long h) {
  return 2LL * rows * (h0 - 2 * h);
}

// The block of backsub_small: whole groups of b warps, at most 512 threads
// (512 at b = 1, 2, 4, 8, 16).
template <int B>
constexpr int kSmallThreads = 512 / (kLanes * B) * (kLanes * B);
constexpr long long kMaxSmallPairs = 256;     // pairs of its largest level
constexpr int kMaxSmall = 9;                  // levels it can walk: 1 .. 256

template <typename F> struct Vec2;
template <> struct Vec2<float> { using T = float2; };
template <> struct Vec2<double> { using T = double2; };

// p[0] = a, p[1] = b in one store (p is 2-element aligned).
template <typename F>
__device__ __forceinline__ void store2(F* p, F a, F b) {
  typename Vec2<F>::T v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<typename Vec2<F>::T*>(p) = v;
}

// Thread (row i, pair p) of a level: its rows of s_up, s_lo (b, b, h) and of
// s_g (b, r, h), loaded before x_even is needed.
template <typename F, int B, int R>
struct BacksubRow {
  F up[B], lo[B], g[R];

  __device__ __forceinline__ void load(const F* su, const F* sl, const F* sg,
                                       long long h, long long p, int i) {
#pragma unroll
    for (int k = 0; k < B; ++k) {
      up[k] = su[(long long)(i * B + k) * h + p];
      lo[k] = sl[(long long)(i * B + k) * h + p];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) g[c] = sg[(long long)(i * R + c) * h + p];
  }

  // Row i of the pair's (x_even, x_odd) to X (b, r, 2h); xe(j) and xr(j)
  // are row j = k * R + c of x_even at the pair and at the next pair.
  template <typename XE, typename XR>
  __device__ __forceinline__ void solve(XE xe, XR xr, F* X, long long h,
                                        long long p, int i) const {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      F t1 = F(0), t2 = F(0);
#pragma unroll
      for (int k = 0; k < B; ++k) {
        t1 += up[k] * xe(k * R + c);
        t2 += lo[k] * xr(k * R + c);
      }
      store2<F>(X + (long long)(i * R + c) * 2 * h + 2 * p, xe(i * R + c),
                g[c] - t1 - t2);
    }
  }
};

// Elements of backsub_pairs' tile: x_even of the block's pairs and the next.
__host__ __device__ constexpr int backsub_tile(int b, int r) {
  return b * r * (kLanes + 1);
}

// One level of more than the sweep's h_small pairs: x_even (b, r, h), s_up,
// s_lo (b, b, h), s_g (b, r, h) -> X (b, r, 2h).
template <typename F, int B, int R>
__global__ void __launch_bounds__(B * kLanes)
backsub_pairs(const F* xe, const F* su, const F* sl, const F* sg, F* X,
              long long h) {
  constexpr int kSlots = kLanes + 1;          // the block's pairs and the next
  F* tile = dynamic_smem<F>();
  const int lane = threadIdx.x % kLanes, i = threadIdx.x / kLanes;
  const long long p0 = (long long)blockIdx.x * kLanes, p = p0 + lane;
  BacksubRow<F, B, R> row;
  if (p < h) row.load(su, sl, sg, h, p, i);
  for (int e = threadIdx.x; e < B * R * kSlots; e += B * kLanes) {
    const int j = e % kSlots;
    tile[e] = p0 + j < h ? xe[(long long)(e / kSlots) * h + p0 + j] : F(0);
  }
  __syncthreads();
  if (p >= h) return;
  row.solve([&](int j) { return tile[j * kSlots + lane]; },
            [&](int j) { return tile[j * kSlots + lane + 1]; }, X, h, p, i);
}

// The levels backsub_small walks, in the order it runs them: level l has
// h[l] pairs and reads s_up su[l], s_lo sl[l] (b, b, h[l]) and s_g sg[l]
// (b, r, h[l]); the first reads x_even xt (b, r, h[0]), the last writes X
// (b, r, 2 h[n - 1]).
template <typename F>
struct SmallLevels {
  const F* xt;
  F* X;
  const F* su[kMaxSmall];
  const F* sl[kMaxSmall];
  const F* sg[kMaxSmall];
  long long h[kMaxSmall];
  int n;
};

// Shared memory of backsub_small: two buffers of the largest x_even.
template <typename F, int B, int R>
inline size_t small_bytes(long long h_last) {
  return 2 * (size_t)B * R * h_last * sizeof(F);
}

// Every level of at most h_small pairs in one block: kSmallPairs pairs a
// step, a level after the one below it.  x_even and the X of every level but
// the last stay in shared memory, in two buffers that the levels take in
// turn; the __syncthreads() at a level's first step orders its reads after
// the writes of the level below and its writes after that level's reads.
// A thread loads its rows of the next step's s_up, s_lo and s_g before it
// waits, so the loads of one level overlap the algebra of the one before.
template <typename F, int B, int R>
__global__ void __launch_bounds__(kSmallThreads<B>)
backsub_small(SmallLevels<F> lv) {
  constexpr int kThreads = kSmallThreads<B>, kPairs = kThreads / B;
  static_assert(kPairs % kLanes == 0, "whole groups of b warps");
  F* buf[2] = {dynamic_smem<F>(),
               dynamic_smem<F>() + (long long)B * R * lv.h[lv.n - 1]};
  const int lane = threadIdx.x % kLanes, i = (threadIdx.x / kLanes) % B;
  const int q = (threadIdx.x / (kLanes * B)) * kLanes + lane;
  for (int e = threadIdx.x; e < B * R * lv.h[0]; e += kThreads)
    buf[0][e] = lv.xt[e];
  BacksubRow<F, B, R> row, next;
  if (q < lv.h[0]) row.load(lv.su[0], lv.sl[0], lv.sg[0], lv.h[0], q, i);
  for (int l = 0; l < lv.n; ++l) {
    const long long h = lv.h[l];
    const F* xe = buf[l & 1];
    F* X = l + 1 == lv.n ? lv.X : buf[(l + 1) & 1];
    for (long long p0 = 0; p0 < h; p0 += kPairs) {
      const long long p = p0 + q;
      // The next step: this level's next pairs, or the next level's first.
      const bool more = p0 + kPairs < h;
      const int ln = more ? l : l + 1;
      const long long pn = more ? p + kPairs : q;
      if (ln < lv.n && pn < lv.h[ln])
        next.load(lv.su[ln], lv.sl[ln], lv.sg[ln], lv.h[ln], pn, i);
      if (p0 == 0) __syncthreads();           // the level below is written
      if (p < h)
        row.solve([&](int j) { return xe[(long long)j * h + p]; },
                  [&](int j) {
                    return p + 1 < h ? xe[(long long)j * h + p + 1] : F(0);
                  },
                  X, h, p, i);
      row = next;
    }
  }
}

}  // namespace cr
