// Device code of the SPIKE chain solves (see kkt_spike.cu).
//
// One core serves two entry points, chosen by the template flag KKT:
//
//   KKT = true   the fused damped-KKT solve (kernel #1).  Solves
//                [[A + lam_abs I, B], [B^T, C + lam_abs I]] [dx, dp] = -[gx, gp]
//                for an SPD block-tridiagonal A with b x b blocks and nq
//                parameters.  The wrapper (collocfem_tpu_torch/ops/spike.py)
//                passes the raw chain D, E, the right-hand-side group
//                G = [gx | B inv_sp] (b, r = 1 + nq, K), the Jacobi scales
//                inv = diag(A + lam_abs)^-1/2 (b, K) and cg = [C_s | gp_s]
//                (nq, nq + 1).  Every load applies the scaling: the scaled
//                diagonal is set to exactly 1.
//   KKT = false  the plain chain solve A X = G (kernel #2): raw loads, no
//                Schur step; X (b, r, K) is written by the back-substitution.
//
// In both, blocks past the chain end read as identity, couplings from block
// K-1 on read as zero, and right-hand sides past the end read as zero.
//
// The chain is cut into T tiles of L >= 3 blocks (Kp = T L >= K).  Launches
// on one stream (4 and 5 only for KKT):
//   1. tile_sweep       one lane group per tile: block-Thomas forward
//                       sweep over the L-2 interior blocks (factors and
//                       reduced RHS to scratch), a backward sweep for the
//                       spike end values, and the tile's 2x2-block interface
//                       system.
//   2. interface_solve  one lane group: block Thomas on the 2T-block
//                       chain of tile boundary blocks.
//   3. back_substitute  one group per tile: interior back-substitution from
//                       the boundary values; for KKT also the tile's partial
//                       sums of B_s^T X for the arrowhead Schur complement.
//   4. schur_solve      one thread: reduce the T partial sums in tile order
//                       (deterministic, no atomics) and solve the nq x nq
//                       Schur system by Cholesky.
//   5. compose          one thread per chain block: dx = (-x_g + x_b t) inv.
//
// Lane layout of phases 1-3: a group is W neighbouring lanes of a warp, W
// the next power of two at or above b (group_width: W = b = 8, four tiles
// to a warp; b = 6 also takes W = 8; b = 9..16 take W = 16, two tiles to a
// warp; b = 1 is one lane, 32 tiles to a warp), and lane i < b owns
// row i of every b x b block and of every b x N right-hand side the group
// carries (the factor,
// the reduced RHS y with C = r + b columns, the backward-sweep state x with
// CV = r + 2b columns, W, E).  A row that another lane needs is broadcast
// with __shfl_sync inside the group (source lane relative to the group); a
// transpose is b - 1 xor exchanges.  Each dot product is summed by the lane
// that owns its row, in the same k order as a one-thread loop; the backward
// triangular solve subtracts the solved rows from the last one up.  A
// Cholesky factor is stored with each lane's column below the diagonal
// (what the backward solve reads), so later phases need no transpose of
// it.  Each step loads the chain rows of the next step into registers
// before it does its own algebra.  No shared memory.  In the tile phases
// every group of a warp runs every step (a group past the last tile
// repeats the last tile and stores nothing), so the shuffles name the whole
// warp; the interface chain is one group of W lanes.  When b < W, lanes
// b..W-1 join every shuffle, load the rows of row b - 1 (so every address
// is in bounds), never store, and no lane reads them: every broadcast
// names a source lane below b, and a transpose, whose xor partner may be
// one of them, drops what it gets from them.
//
// Scratch layouts are block-major, row-major inside a block (lane i writes
// and reads its own row); every chain index is 64-bit.

#pragma once

namespace kkt {

template <typename F> struct Num;
// sqrt_ and rcp are correctly rounded: the same values as sqrt(x) and
// 1 / x, without the general division's slow path.
template <> struct Num<float> {
  static __device__ __forceinline__ float sqrt_(float x) {
    return __fsqrt_rn(x);
  }
  static __device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
  static constexpr float tiny = 1.17549435082228750797e-38f;
};
template <> struct Num<double> {
  static __device__ __forceinline__ double sqrt_(double x) {
    return __dsqrt_rn(x);
  }
  static __device__ __forceinline__ double rcp(double x) {
    return __drcp_rn(x);
  }
  static constexpr double tiny = 2.22507385850720138309e-308;
};

template <typename F>
struct Args {
  // Inputs (structure-of-arrays, chain index last).
  const F* D;    // (b, b, K)
  const F* E;    // (b, b, K), E[..., k] couples block k to k+1
  const F* G;    // (b, r, K)
  const F* inv;  // (b, K)
  const F* cg;   // (nq, nq + 1)
  // Outputs.
  F* dx;         // (b, K)      KKT: the step
  F* t;          // (nq,)       KKT: Schur solution; dp = -t inv_sp
  F* x;          // (b, r, K)   plain: the solution X
  // Scratch (block-major).
  F* lf;         // (Kp, b, 2b)  interior Cholesky factors: row i of L,
                 //              then column i below the diagonal
  F* y;          // (Kp, b, r+b) forward-reduced [g | u-spike]
  F* iface;      // (T, 4 b b + 2 b r) s_ll, s_lr, s_rr, e_cp, gh_l, gh_r
  F* ilf;        // (2T, b, 2b)  interface Cholesky factors (as lf)
  F* iy;         // (2T, b, r)   interface forward-reduced RHS
  F* ix;         // (2T, b, r)   interface solution [x_l, x_r per tile]
  F* xs;         // (Kp, b, r)   scaled solution A_s^-1 [gx_s | B_s]
  F* acc;        // (T, r-1, r)  per-tile partial sums of B_s^T X (KKT)
  long long K;
  int T, L;
};

template <int B, int R_>
struct Shape {
  static constexpr int R = R_;       // right-hand sides (KKT: [gx | B])
  static constexpr int NQ = R - 1;   // KKT: parameters
  static constexpr int C = R + B;    // forward-reduced columns [g | u]
  static constexpr int CV = C + B;   // backward-sweep columns [g | u | v]
  static constexpr long long iface_stride = 4LL * B * B + 2LL * B * R;
};

// Scratch size in elements, and its carving into Args.
template <int B, int R>
inline long long scratch_elems(int T, int L) {
  using S = Shape<B, R>;
  const long long kp = (long long)T * L, t = T;
  return 2 * kp * B * B + kp * B * S::C + t * S::iface_stride
       + 4 * t * B * B + 4 * t * B * S::R + kp * B * S::R + t * S::NQ * S::R;
}

template <typename F, int B, int R>
inline Args<F> carve(const F* D, const F* E, const F* G, const F* inv,
                     const F* cg, F* dx, F* t, F* x, F* scratch, long long K,
                     int T, int L) {
  using S = Shape<B, R>;
  const long long kp = (long long)T * L;
  Args<F> a;
  a.D = D; a.E = E; a.G = G; a.inv = inv; a.cg = cg; a.dx = dx; a.t = t;
  a.x = x;
  F* p = scratch;
  a.lf = p;    p += 2 * kp * B * B;
  a.y = p;     p += kp * B * S::C;
  a.iface = p; p += (long long)T * S::iface_stride;
  a.ilf = p;   p += 4LL * T * B * B;
  a.iy = p;    p += 2LL * T * B * S::R;
  a.ix = p;    p += 2LL * T * B * S::R;
  a.xs = p;    p += kp * B * S::R;
  a.acc = p;
  a.K = K; a.T = T; a.L = L;
  return a;
}

// ---- one-thread dense algebra (the Schur solve) -----------------------------

// In-place lower Cholesky; each pivot is clamped at tiny (a NaN stays NaN),
// so a noise-indefinite block gives a finite junk factor and the LM loop
// rejects the step.
template <typename F, int B>
__device__ __forceinline__ void chol(F a[B][B]) {
#pragma unroll
  for (int j = 0; j < B; ++j) {
    F s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= a[j][k] * a[j][k];
    const F d = Num<F>::sqrt_(s < Num<F>::tiny ? Num<F>::tiny : s);
    a[j][j] = d;
    const F inv = F(1) / d;
#pragma unroll
    for (int i = j + 1; i < B; ++i) {
      F s2 = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 -= a[i][k] * a[j][k];
      a[i][j] = s2 * inv;
    }
  }
}

// x <- (L L^T)^-1 x for the lower factor held in l.
template <typename F, int B, int N>
__device__ __forceinline__ void chol_solve(const F l[B][B], F x[B][N]) {
  F inv[B];
#pragma unroll
  for (int i = 0; i < B; ++i) inv[i] = F(1) / l[i][i];
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F s = x[i][c];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= l[i][k] * x[k][c];
      x[i][c] = s * inv[i];
    }
#pragma unroll
  for (int i = B - 1; i >= 0; --i)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      F s = x[i][c];
#pragma unroll
      for (int k = i + 1; k < B; ++k) s -= l[k][i] * x[k][c];
      x[i][c] = s * inv[i];
    }
}

// ---- the lane group ----------------------------------------------------------

// W neighbouring lanes of a warp (W a power of two); lane = this thread's
// place in the group, its row when below the block size.  bc(v, j) is lane
// j's v, with j relative to the group.  The mask
// names every lane that runs the shuffle together: the whole warp in the
// tile phases and in kernel #7 (thomas_kernels.cuh), where every group of
// the warp runs every step, the one group of the interface chain.  A mask known at compile time lets the compiler
// emit a plain shuffle, with no convergence bookkeeping around it.
template <int W>
struct Group {
  static_assert(W >= 1 && W <= 32 && (W & (W - 1)) == 0,
                "a group is a power-of-two slice of a warp");
  unsigned mask;
  int lane;
  __device__ __forceinline__ explicit Group(unsigned m)
      : mask(m), lane(threadIdx.x & (W - 1)) {}
  template <typename F>
  __device__ __forceinline__ F bc(F v, int src) const {
    return __shfl_sync(mask, v, src, W);
  }
};

// The group width of block size b: the next power of two at or above b.
__host__ __device__ constexpr int group_width(int b) {
  return b <= 1 ? 1 : 2 * group_width((b + 1) / 2);
}

// The lane group that carries blocks of size B.
template <int B>
using GroupOf = Group<group_width(B)>;

// v[i] for a runtime i, by selects (no local memory).
template <typename F, int N>
__device__ __forceinline__ F pick(const F v[N], int i) {
  F out = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) out = (i == k) ? v[k] : out;
  return out;
}

template <typename F, int N>
__device__ __forceinline__ void copy(const F* src, F out[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = src[c];
}

template <typename F, int N>
__device__ __forceinline__ void store(F* dst, const F in[N], bool on = true) {
  if (!on) return;
#pragma unroll
  for (int c = 0; c < N; ++c) dst[c] = in[c];
}

// col[k] = row_k[lane]: column `lane` of the block whose rows the group
// holds.  W - 1 xor exchanges (a shuffle costs ~7 cycles of issue a warp
// on the H100, a select ~1): at step d lane i trades entry i ^ d with lane
// i ^ d.  A partner at or past B holds no row: what it sends lands in no
// entry (k == p never holds), and what it gets is never read.
template <typename F, int B>
__device__ __forceinline__ void transpose(const GroupOf<B>& g, const F row[B],
                                          F col[B]) {
  const int i = g.lane;
#pragma unroll
  for (int k = 0; k < B; ++k) col[k] = row[k];   // col[i] = row[i] is right
#pragma unroll
  for (int d = 1; d < group_width(B); ++d) {
    const int p = i ^ d;                            // the partner lane
    const F v = g.bc(pick<F, B>(row, p), p);
#pragma unroll
    for (int k = 0; k < B; ++k) col[k] = (k == p) ? v : col[k];
  }
}

// lt[k] = L[k][lane] for k > lane: the part of column `lane` below the
// diagonal of the lower factor whose rows the group holds (the backward
// triangular solve reads only that part).
template <typename F, int B>
__device__ __forceinline__ void lower_cols(const GroupOf<B>& g, const F l[B],
                                           F lt[B]) {
#pragma unroll
  for (int k = 0; k < B; ++k) lt[k] = l[k];
#pragma unroll
  for (int k = 1; k < B; ++k)
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const F v = g.bc(l[j], k);
      lt[k] = (g.lane == j) ? v : lt[k];
    }
}

// ---- group algebra on rows ---------------------------------------------------

// In-place lower Cholesky of the block whose rows the group holds (a =
// this lane's row; the part above the diagonal is left as it was).  Pivots
// are clamped at tiny as in chol(); lane i sums row i in the same k order.
template <typename F, int B>
__device__ __forceinline__ void chol_rows(const GroupOf<B>& g, F a[B]) {
  const int i = g.lane;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    // Every lane forms the pivot from row j's broadcast entries, in lane
    // j's order, so no lane waits for another's square root.
    F t = a[j], s = g.bc(a[j], j);
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const F v = g.bc(a[k], j);
      t -= a[k] * v;
      s -= v * v;
    }
    const F d = Num<F>::sqrt_(s < Num<F>::tiny ? Num<F>::tiny : s);
    const F inv = Num<F>::rcp(d);
    a[j] = (i == j) ? d : (i > j ? t * inv : a[j]);
  }
}

// x <- (L L^T)^-1 x: l is this lane's row of the lower factor, lt its
// column (lt[k] = L[k][lane], read for k > lane), x its row of the B x N
// right-hand side.  Forward: row r is scaled and broadcast, the rows below
// subtract it (lane i's sum runs k = 0..i-1, as in chol_solve).  Backward:
// the same from the last row up.
template <typename F, int B, int N>
__device__ __forceinline__ void chol_solve_rows(const GroupOf<B>& g,
                                                const F l[B], const F lt[B],
                                                F x[N]) {
  const int i = g.lane;
  const F dinv = Num<F>::rcp(pick<F, B>(l, i));
#pragma unroll
  for (int r = 0; r < B; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      x[c] = (i == r) ? x[c] * dinv : x[c];
      if (r + 1 < B) {
        const F v = g.bc(x[c], r);
        x[c] = (i > r) ? x[c] - l[r] * v : x[c];
      }
    }
#pragma unroll
  for (int r = B - 1; r >= 0; --r)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      x[c] = (i == r) ? x[c] * dinv : x[c];
      if (r > 0) {
        const F v = g.bc(x[c], r);
        x[c] = (i < r) ? x[c] - lt[r] * v : x[c];
      }
    }
}

// out <- out - e v: e is this lane's row of a B x B block (pass a column to
// subtract e^T v), v and out this lane's rows of B x N blocks.
template <typename F, int B, int N>
__device__ __forceinline__ void sub_mm_rows(const GroupOf<B>& g, const F e[B],
                                            const F v[N], F out[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    F s = out[c];
#pragma unroll
    for (int k = 0; k < B; ++k) s -= e[k] * g.bc(v[c], k);
    out[c] = s;
  }
}

// x <- [r0 | 0] - e x (e: this lane's row, or column for e^T); columns of
// the right-hand side at or past NR are zero.
template <typename F, int B, int N, int NR>
__device__ __forceinline__ void rhs_minus_rows(const GroupOf<B>& g,
                                               const F e[B], const F r0[NR],
                                               F x[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    F s = (c < NR) ? r0[c < NR ? c : 0] : F(0);
#pragma unroll
    for (int k = 0; k < B; ++k) s -= e[k] * g.bc(x[c], k);
    x[c] = s;
  }
}

// acc[q][s] += sum_i g[i][1 + q] x[i][s] (the tile's share of B_s^T X),
// summed over the rows in order i = 0..B-1; every lane holds the same acc.
template <typename F, int B, int NQ>
__device__ __forceinline__ void accumulate_rows(const GroupOf<B>& g,
                                                const F grow[NQ + 1],
                                                const F x[NQ + 1],
                                                F acc[NQ][NQ + 1]) {
  constexpr int R = NQ + 1;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F gb[NQ], xb[R];
#pragma unroll
    for (int q = 0; q < NQ; ++q) gb[q] = g.bc(grow[1 + q], i);
#pragma unroll
    for (int s = 0; s < R; ++s) xb[s] = g.bc(x[s], i);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int s = 0; s < R; ++s) acc[q][s] += gb[q] * xb[s];
  }
}

// ---- loads of the raw chain, one row per lane --------------------------------

// Chain block k as lane i reads it: its row of D[k], its row and column of
// E[k] (the coupling k -> k+1), its row of G[k], its Jacobi scale s =
// inv[i][k] and the block's scales sv[j] = inv[j][k] (1 for the plain
// solve).  Past the end: D = I, E = 0, G = 0, scales 1; E[K-1] reads as 0.
// A kernel issues fetch() one step ahead and scales at use; fields it never
// reads are not loaded.
template <typename F, int B, int R, bool KKT>
struct Rows {
  F d[B], e[B], ec[B], g[R], s, sv[B];
  __device__ __forceinline__ void fetch(const Args<F>& a, long long k,
                                        int i) {
    const bool in = k < a.K, e_in = k < a.K - 1;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const long long at = (long long)(i * B + j) * a.K + k;
      d[j] = in ? a.D[at] : F(i == j ? 1 : 0);
      e[j] = e_in ? a.E[at] : F(0);
      ec[j] = e_in ? a.E[(long long)(j * B + i) * a.K + k] : F(0);
      sv[j] = (KKT && in) ? a.inv[(long long)j * a.K + k] : F(1);
    }
#pragma unroll
    for (int c = 0; c < R; ++c)
      g[c] = in ? a.G[(long long)(i * R + c) * a.K + k] : F(0);
    s = (KKT && in) ? a.inv[(long long)i * a.K + k] : F(1);
  }
};

// The scaling at load (KKT only; the plain solve reads the raw chain).
// sn[j] is lane j's scale of block k + 1 (across a tile boundary, the next
// tile's first block).

// Row of D[k]: D_ij s_i s_j with the diagonal exactly 1.
template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void d_row(int i, const Rows<F, B, R, KKT>& b,
                                      F out[B]) {
#pragma unroll
  for (int j = 0; j < B; ++j)
    out[j] = !KKT ? b.d[j] : (i == j) ? F(1) : b.d[j] * b.s * b.sv[j];
}

// Row of E[k]: rows scaled by inv[k], columns by inv[k+1].
template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void e_row(const Rows<F, B, R, KKT>& b,
                                      const F sn[B], F out[B]) {
#pragma unroll
  for (int j = 0; j < B; ++j) out[j] = KKT ? b.e[j] * b.s * sn[j] : b.e[j];
}

// Column of E[k] (the row of E[k]^T): entry j is E_ji s_j(k) s_i(k+1),
// with s_next this lane's scale of block k + 1.
template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void e_col(const Rows<F, B, R, KKT>& b, F s_next,
                                      F out[B]) {
#pragma unroll
  for (int j = 0; j < B; ++j)
    out[j] = KKT ? b.ec[j] * b.sv[j] * s_next : b.ec[j];
}

template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void g_row(const Rows<F, B, R, KKT>& b, F out[R]) {
#pragma unroll
  for (int c = 0; c < R; ++c) out[c] = b.g[c] * b.s;
}

// A stored factor: this lane's row of L, then its column below the
// diagonal, 2 B values at p.
template <typename F, int B>
__device__ __forceinline__ void load_factor(const F* p, F l[B], F lt[B]) {
  copy<F, B>(p, l);
  copy<F, B>(p + B, lt);
}

template <typename F, int B>
__device__ __forceinline__ void store_factor(F* p, const F l[B],
                                             const F lt[B], bool on) {
  store<F, B>(p, l, on);
  store<F, B>(p + B, lt, on);
}

// The tile of this lane's group.  Every group of a warp runs every step
// (the shuffles name the whole warp): a group past the last tile runs the
// last tile again and stores nothing, and neither does a lane past the
// block's rows (live = false for both).
template <int B>
__device__ __forceinline__ long long tile_of(int T, bool& live) {
  constexpr int W = group_width(B);
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / W;
  live = t < T && (int)(threadIdx.x & (W - 1)) < B;
  return t < T ? t : T - 1;
}

// The row whose chain entries a lane loads: its own, or row B - 1 for a
// lane past the block's rows (its loads stay in bounds; it stores nothing).
template <int B>
__device__ __forceinline__ int row_of(int lane) {
  return lane < B ? lane : B - 1;
}

// ---- 1. tile sweep -----------------------------------------------------------

template <typename F, int B, int R_, bool KKT>
__global__ void tile_sweep(Args<F> a) {
  using S = Shape<B, R_>;
  using Blk = Rows<F, B, R_, KKT>;
  constexpr int R = S::R, C = S::C, CV = S::CV;
  const GroupOf<B> g(0xffffffffu);
  bool live;
  const long long tile = tile_of<B>(a.T, live);
  const int i = row_of<B>(g.lane);
  const int M = a.L - 2;                    // interior blocks per tile
  const long long k0 = tile * a.L;

  // Forward elimination over interior blocks m = 0..M-1 (chain k0 + m + 1).
  // The u-spike right-hand side enters at m = 0 as E[k0]^T; the v-spike's
  // is zero until the last interior block, so it is never reduced.
  // pb, cb: chain blocks k-1 and k of step m; nb: block k+1, fetched
  // before step m's algebra.
  Blk pb, cb, nb;
  pb.fetch(a, k0, i);
  cb.fetch(a, k0 + 1, i);
  F lfac[B], lt[B], y[C];
  {
    nb.fetch(a, k0 + 2, i);
    d_row<F, B, R, KKT>(i, cb, lfac);
    chol_rows<F, B>(g, lfac);
    lower_cols<F, B>(g, lfac, lt);
    g_row<F, B, R, KKT>(cb, y);
    F ec[B];
    e_col<F, B, R, KKT>(pb, cb.s, ec);      // E[k0]^T
#pragma unroll
    for (int c = 0; c < B; ++c) y[R + c] = ec[c];
    store_factor<F, B>(a.lf + ((k0 + 1) * B + i) * 2 * B, lfac, lt, live);
    store<F, C>(a.y + ((k0 + 1) * B + i) * C, y, live);
    pb = cb;
    cb = nb;
  }
  for (int m = 1; m < M; ++m) {
    const long long k = k0 + m + 1;
    // E[k-1] (row and column) is formed first, so pb is dead before the
    // prefetch of block k+1 takes its registers.
    F w[B], tr[B], gr[R];
    e_row<F, B, R, KKT>(pb, cb.sv, w);      // couples interior m-1 -> m
    e_col<F, B, R, KKT>(pb, cb.s, tr);
    nb.fetch(a, k + 1, i);
    chol_solve_rows<F, B, B>(g, lfac, lt, w);   // W = S_{m-1}^-1 E
    d_row<F, B, R, KKT>(i, cb, lfac);
    sub_mm_rows<F, B, B>(g, tr, w, lfac);       // S_m = D - E^T W
    chol_rows<F, B>(g, lfac);
    lower_cols<F, B>(g, lfac, lt);
    g_row<F, B, R, KKT>(cb, gr);
    transpose<F, B>(g, w, tr);
    rhs_minus_rows<F, B, C, R>(g, tr, gr, y);   // y_m = [g | 0] - W^T y_{m-1}
    store_factor<F, B>(a.lf + (k * B + i) * 2 * B, lfac, lt, live);
    store<F, C>(a.y + (k * B + i) * C, y, live);
    pb = cb;
    cb = nb;
  }

  // Backward sweep with [g | u | v] columns, carried, not stored: only the
  // values at the first (m = 0) and last (m = M-1) interior blocks feed the
  // interface system.  The v-spike right-hand side at m = M-1 is E[k0+L-2];
  // pb now holds block k0 + M = k0 + L - 2, cb block k0 + L - 1.
  F x[CV];
  F wg_last[R], wv_last[B];
  F su[B];                                  // scales of block k + 1
  {
    F ev[B];
    e_row<F, B, R, KKT>(pb, cb.sv, ev);
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = y[c];
#pragma unroll
    for (int c = 0; c < B; ++c) x[C + c] = ev[c];
    chol_solve_rows<F, B, CV>(g, lfac, lt, x);
#pragma unroll
    for (int c = 0; c < R; ++c) wg_last[c] = x[c];
#pragma unroll
    for (int c = 0; c < B; ++c) {
      wv_last[c] = x[C + c];
      su[c] = pb.sv[c];
    }
  }
  {
    // Step m reads the stored factor and reduced RHS of block k and E[k];
    // those of step m - 1 are fetched before step m's algebra.
    F l_c[B], lt_c[B], y_c[C], l_n[B], lt_n[B], y_n[C];
    Blk eb, en;
    long long k = k0 + M - 1;
    load_factor<F, B>(a.lf + (k * B + i) * 2 * B, l_c, lt_c);
    copy<F, C>(a.y + (k * B + i) * C, y_c);
    eb.fetch(a, k, i);
    for (int m = M - 2; m >= 0; --m, --k) {
      F e[B];
      e_row<F, B, R, KKT>(eb, su, e);        // couples interior m -> m+1
#pragma unroll
      for (int j = 0; j < B; ++j) su[j] = eb.sv[j];
      load_factor<F, B>(a.lf + ((k - 1) * B + i) * 2 * B, l_n, lt_n);
      copy<F, C>(a.y + ((k - 1) * B + i) * C, y_n);
      en.fetch(a, k - 1, i);
      rhs_minus_rows<F, B, CV, C>(g, e, y_c, x);  // x_m = [y_m | 0] - E x_{m+1}
      chol_solve_rows<F, B, CV>(g, l_c, lt_c, x);
#pragma unroll
      for (int j = 0; j < B; ++j) {
        l_c[j] = l_n[j];
        lt_c[j] = lt_n[j];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) y_c[c] = y_n[c];
      eb = en;
    }
  }

  // The tile's interface blocks (the SPIKE reduced system):
  //   s_ll = D0 - E0 w_u0      s_lr = -E0 w_v0      s_rr = DL - E_{L-2}^T w_v
  //   gh_l = G0 - E0 w_g0      gh_r = GL - E_{L-2}^T w_g
  // plus the coupling e_cp from this tile's last block to the next tile's
  // first.
  F* out = a.iface + tile * S::iface_stride;
  F blk[B], gr[R];
  {
    Blk lb, b1;
    lb.fetch(a, k0, i);
    b1.fetch(a, k0 + 1, i);                 // its scales
    F e0[B], v[B], wg[R];
    e_row<F, B, R, KKT>(lb, b1.sv, e0);
    d_row<F, B, R, KKT>(i, lb, blk);
#pragma unroll
    for (int c = 0; c < B; ++c) v[c] = x[R + c];
    sub_mm_rows<F, B, B>(g, e0, v, blk);
    store<F, B>(out + i * B, blk, live);                    // s_ll
#pragma unroll
    for (int c = 0; c < B; ++c) {
      blk[c] = F(0);
      v[c] = x[C + c];
    }
    sub_mm_rows<F, B, B>(g, e0, v, blk);
    store<F, B>(out + B * B + i * B, blk, live);            // s_lr
    g_row<F, B, R, KKT>(lb, gr);
#pragma unroll
    for (int c = 0; c < R; ++c) wg[c] = x[c];
    sub_mm_rows<F, B, R>(g, e0, wg, gr);
    store<F, R>(out + 4 * B * B + i * R, gr, live);         // gh_l
  }
  {
    Blk mb, rb, eb;
    mb.fetch(a, k0 + M, i);
    rb.fetch(a, k0 + a.L - 1, i);
    eb.fetch(a, k0 + a.L, i);               // its scales
    F elt[B];
    e_col<F, B, R, KKT>(mb, rb.s, elt);                     // E[k0+L-2]^T
    d_row<F, B, R, KKT>(i, rb, blk);
    sub_mm_rows<F, B, B>(g, elt, wv_last, blk);
    store<F, B>(out + 2 * B * B + i * B, blk, live);        // s_rr
    g_row<F, B, R, KKT>(rb, gr);
    sub_mm_rows<F, B, R>(g, elt, wg_last, gr);
    store<F, R>(out + 4 * B * B + B * R + i * R, gr, live); // gh_r
    e_row<F, B, R, KKT>(rb, eb.sv, blk);
    store<F, B>(out + 3 * B * B + i * B, blk, live);        // e_cp
  }
}

// ---- 2. interface chain ------------------------------------------------------
//
// Block 2t is tile t's left boundary, 2t+1 its right one.  Diagonal blocks
// s_ll(t), s_rr(t); couplings 2t -> 2t+1: s_lr(t), 2t+1 -> 2t+2: e_cp(t).
// Lane i's row of block q is iface_d/e/g(a, q) + i * B (or + i * R); its
// column of a coupling is the entries i, B + i, ...

template <typename F, int B, int R_>
__device__ __forceinline__ const F* iface_d(const Args<F>& a, int q) {
  using S = Shape<B, R_>;
  return a.iface + (long long)(q >> 1) * S::iface_stride + (q & 1) * 2 * B * B;
}
template <typename F, int B, int R_>
__device__ __forceinline__ const F* iface_e(const Args<F>& a, int q) {
  using S = Shape<B, R_>;
  return a.iface + (long long)(q >> 1) * S::iface_stride + (1 + 2 * (q & 1)) * B * B;
}
template <typename F, int B, int R_>
__device__ __forceinline__ const F* iface_g(const Args<F>& a, int q) {
  using S = Shape<B, R_>;
  return a.iface + (long long)(q >> 1) * S::iface_stride + 4 * B * B
       + (q & 1) * B * S::R;
}

// Column i of the B x B block at p.
template <typename F, int B>
__device__ __forceinline__ void copy_col(const F* p, int i, F out[B]) {
#pragma unroll
  for (int k = 0; k < B; ++k) out[k] = p[k * B + i];
}

template <typename F, int B, int R_>
__global__ void interface_solve(Args<F> a) {
  constexpr int R = R_;
  constexpr int W = group_width(B);
  if (blockIdx.x != 0 || threadIdx.x >= W) return;   // one group
  const GroupOf<B> g(W == 32 ? 0xffffffffu : (1u << W) - 1u);
  const bool live = g.lane < B;
  const int i = row_of<B>(g.lane);
  const int n = 2 * a.T;
  F lfac[B], lt[B], y[R];
  copy<F, B>(iface_d<F, B, R_>(a, 0) + i * B, lfac);
  copy<F, R>(iface_g<F, B, R_>(a, 0) + i * R, y);
  chol_rows<F, B>(g, lfac);
  lower_cols<F, B>(g, lfac, lt);
  store_factor<F, B>(a.ilf + i * 2 * B, lfac, lt, live);
  store<F, R>(a.iy + i * R, y, live);
  // Step q reads E(q-1) (row and column), D(q), G(q); those of step q + 1
  // are fetched first.
  F e_c[B], ec_c[B], d_c[B], g_c[R], e_n[B], ec_n[B], d_n[B], g_n[R];
  copy<F, B>(iface_e<F, B, R_>(a, 0) + i * B, e_c);
  copy_col<F, B>(iface_e<F, B, R_>(a, 0), i, ec_c);
  copy<F, B>(iface_d<F, B, R_>(a, 1) + i * B, d_c);
  copy<F, R>(iface_g<F, B, R_>(a, 1) + i * R, g_c);
  for (int q = 1; q < n; ++q) {
    const int qn = q + 1 < n ? q + 1 : q;
    copy<F, B>(iface_e<F, B, R_>(a, qn - 1) + i * B, e_n);
    copy_col<F, B>(iface_e<F, B, R_>(a, qn - 1), i, ec_n);
    copy<F, B>(iface_d<F, B, R_>(a, qn) + i * B, d_n);
    copy<F, R>(iface_g<F, B, R_>(a, qn) + i * R, g_n);
    F w[B], tr[B];
#pragma unroll
    for (int j = 0; j < B; ++j) w[j] = e_c[j];
    chol_solve_rows<F, B, B>(g, lfac, lt, w);
#pragma unroll
    for (int j = 0; j < B; ++j) lfac[j] = d_c[j];
    sub_mm_rows<F, B, B>(g, ec_c, w, lfac);
    chol_rows<F, B>(g, lfac);
    lower_cols<F, B>(g, lfac, lt);
    transpose<F, B>(g, w, tr);
    rhs_minus_rows<F, B, R, R>(g, tr, g_c, y);
    store_factor<F, B>(a.ilf + ((long long)q * B + i) * 2 * B, lfac, lt,
                       live);
    store<F, R>(a.iy + ((long long)q * B + i) * R, y, live);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      e_c[j] = e_n[j];
      ec_c[j] = ec_n[j];
      d_c[j] = d_n[j];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) g_c[c] = g_n[c];
  }
  chol_solve_rows<F, B, R>(g, lfac, lt, y);
  store<F, R>(a.ix + ((long long)(n - 1) * B + i) * R, y, live);
  // Step q reads the factor and reduced RHS of block q and E(q).
  F l_c[B], y_c[R], l_n[B], lt_n[B], y_n[R];
  load_factor<F, B>(a.ilf + ((long long)(n - 2) * B + i) * 2 * B, l_c, lt);
  copy<F, R>(a.iy + ((long long)(n - 2) * B + i) * R, y_c);
  copy<F, B>(iface_e<F, B, R_>(a, n - 2) + i * B, e_c);
  for (int q = n - 2; q >= 0; --q) {
    const int qn = q > 0 ? q - 1 : 0;
    load_factor<F, B>(a.ilf + ((long long)qn * B + i) * 2 * B, l_n, lt_n);
    copy<F, R>(a.iy + ((long long)qn * B + i) * R, y_n);
    copy<F, B>(iface_e<F, B, R_>(a, qn) + i * B, e_n);
    rhs_minus_rows<F, B, R, R>(g, e_c, y_c, y);
    chol_solve_rows<F, B, R>(g, l_c, lt, y);
    store<F, R>(a.ix + ((long long)q * B + i) * R, y, live);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      l_c[j] = l_n[j];
      lt[j] = lt_n[j];
      e_c[j] = e_n[j];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) y_c[c] = y_n[c];
  }
}

// ---- 3. interior back-substitution (+ partial Schur sums for KKT) -----------
//
// By linearity the interior solution is A_II^-1 (g - U x_l - V x_r); its
// forward reduction is y_g - y_u x_l, minus E[k0+L-2] x_r at the last block.

// Lane i's row of block k of the solution: for KKT to the block-major
// scratch xs (compose reads it); for the plain solve straight into X
// (b, r, K), dropping the padding blocks past the chain end.
template <typename F, int B, int R, bool KKT>
__device__ __forceinline__ void store_x(const Args<F>& a, long long k, int i,
                                       const F x[R], bool live) {
  if constexpr (KKT) {
    store<F, R>(a.xs + (k * B + i) * R, x, live);
  } else {
    if (!live || k >= a.K) return;
#pragma unroll
    for (int c = 0; c < R; ++c) a.x[(long long)(i * R + c) * a.K + k] = x[c];
  }
}

template <typename F, int B, int R_, bool KKT>
__global__ void back_substitute(Args<F> a) {
  using S = Shape<B, R_>;
  using Blk = Rows<F, B, R_, KKT>;
  constexpr int R = S::R, C = S::C, NQ = S::NQ;
  constexpr int NA = (KKT && NQ > 0) ? NQ : 1;   // rows of the Schur sums
  const GroupOf<B> g(0xffffffffu);
  bool live;
  const long long tile = tile_of<B>(a.T, live);
  const int i = row_of<B>(g.lane);
  const int M = a.L - 2;
  const long long k0 = tile * a.L;

  F xl[R], xr[R], acc[NA][R];
#pragma unroll
  for (int q = 0; q < NA; ++q)
#pragma unroll
    for (int s = 0; s < R; ++s) acc[q][s] = F(0);
  copy<F, R>(a.ix + (2 * tile * B + i) * R, xl);
  copy<F, R>(a.ix + ((2 * tile + 1) * B + i) * R, xr);
  store_x<F, B, R, KKT>(a, k0, i, xl, live);
  store_x<F, B, R, KKT>(a, k0 + a.L - 1, i, xr, live);
  if constexpr (KKT) {
    Blk lb, rb;
    lb.fetch(a, k0, i);
    rb.fetch(a, k0 + a.L - 1, i);
    F gr[R];
    g_row<F, B, R, KKT>(lb, gr);
    accumulate_rows<F, B, NQ>(g, gr, xl, acc);
    g_row<F, B, R, KKT>(rb, gr);
    accumulate_rows<F, B, NQ>(g, gr, xr, acc);
  }

  // Step m reads the factor and reduced RHS of block k, E[k] (and G[k]
  // for KKT); those of step m - 1 are fetched before step m's algebra.
  F x[R];
#pragma unroll
  for (int c = 0; c < R; ++c) x[c] = xr[c];      // the "next" solution
  F su[B];                                       // scales of block k + 1
  {
    Blk rb;
    rb.fetch(a, k0 + M + 1, i);
#pragma unroll
    for (int j = 0; j < B; ++j) su[j] = rb.sv[j];
  }
  long long k = k0 + M;
  F l_c[B], lt_c[B], y_c[C], l_n[B], lt_n[B], y_n[C];
  Blk eb, en;
  load_factor<F, B>(a.lf + (k * B + i) * 2 * B, l_c, lt_c);
  copy<F, C>(a.y + (k * B + i) * C, y_c);
  eb.fetch(a, k, i);
  for (int m = M - 1; m >= 0; --m, --k) {
    F yc[R], yu[B], e[B], gr[R];
    e_row<F, B, R, KKT>(eb, su, e);              // couples interior m -> m+1
    g_row<F, B, R, KKT>(eb, gr);
#pragma unroll
    for (int j = 0; j < B; ++j) su[j] = eb.sv[j];
    load_factor<F, B>(a.lf + ((k - 1) * B + i) * 2 * B, l_n, lt_n);
    copy<F, C>(a.y + ((k - 1) * B + i) * C, y_n);
    en.fetch(a, k - 1, i);
#pragma unroll
    for (int c = 0; c < R; ++c) yc[c] = y_c[c];
#pragma unroll
    for (int c = 0; c < B; ++c) yu[c] = y_c[R + c];
    sub_mm_rows<F, B, R>(g, yu, xl, yc);         // y_g - y_u x_l
    rhs_minus_rows<F, B, R, R>(g, e, yc, x);     // x_m = yc - E x_{m+1}
    chol_solve_rows<F, B, R>(g, l_c, lt_c, x);
    store_x<F, B, R, KKT>(a, k, i, x, live);
    if constexpr (KKT) accumulate_rows<F, B, NQ>(g, gr, x, acc);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      l_c[j] = l_n[j];
      lt_c[j] = lt_n[j];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) y_c[c] = y_n[c];
    eb = en;
  }
  if constexpr (KKT) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      store<F, R>(a.acc + (tile * NQ + q) * R, acc[q], live && i == 0);
  }
}

// ---- 4. arrowhead Schur solve ------------------------------------------------
//
// schur = C_s - B_s^T A_s^-1 B_s,  rp = gp_s - B_s^T A_s^-1 gx_s,  t = schur^-1 rp.

template <typename F, int B, int NQ>
__global__ void schur_solve(Args<F> a) {
  constexpr int R = NQ + 1;
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  F tot[NQ][R];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int s = 0; s < R; ++s) tot[q][s] = F(0);
  for (int tile = 0; tile < a.T; ++tile) {
    const F* p = a.acc + (long long)tile * NQ * R;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int s = 0; s < R; ++s) tot[q][s] += p[q * R + s];
  }
  F schur[NQ][NQ], rp[NQ][1];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      schur[q][qq] = a.cg[q * (NQ + 1) + qq] - tot[q][1 + qq];
    rp[q][0] = a.cg[q * (NQ + 1) + NQ] - tot[q][0];
  }
  chol<F, NQ>(schur);
  chol_solve<F, NQ, 1>(schur, rp);
#pragma unroll
  for (int q = 0; q < NQ; ++q) a.t[q] = rp[q][0];
}

// ---- 5. compose and unscale --------------------------------------------------

template <typename F, int B, int NQ>
__global__ void compose(Args<F> a) {
  constexpr int R = NQ + 1;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.K) return;
  F t[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) t[q] = a.t[q];
  const F* x = a.xs + k * B * R;
#pragma unroll
  for (int i = 0; i < B; ++i) {
    F v = -x[i * R];
#pragma unroll
    for (int q = 0; q < NQ; ++q) v += x[i * R + 1 + q] * t[q];
    a.dx[i * a.K + k] = v * a.inv[i * a.K + k];
  }
}

}  // namespace kkt
