// One experiment's damped Gauss-Newton system for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces no Pallas kernel.  It is the body of ops/assemble.py
// assemble_gn_soa on the card (ops/gn_elements.py dispatches to it): where
// the element-level path differentiates every element's residual with
// vmap(jacfwd(elem_residual)) (12 tangents of 10 rows at the headline's
// degree 4, nx 2, nq 2), forms the normal equations with batched GEMMs of
// (10 x 8) and (10 x 12) matrices and scatters them into the chain with
// ~150 elementwise kernels, this kernel goes from the model's values and
// first derivatives at the nodes and samples (f, df/dx, df/dp at the
// collocated nodes; h, dh/dx, dh/dp at the samples: ops/gn_elements.py
// node_values, plain PyTorch under vmap(jacfwd)) straight to the SoA chain.
//
// gn_elements: a block of T threads builds T consecutive elements, thread t
// element base - 1 + t (base = blockIdx.x (T - 1)), each its residual r and
// Jacobian J = [Jx | Jp] from the structure of EstimationProblem.
// elem_residual, into shared memory as [row][col][thread]:
//   defect row (k, i), k a collocated local node (1..d, or 0..d for the
//   'full' rule), scaled by dscale[k, i]:
//     r  = (2/h sum_j diff[k, j] (X_j,i - X_0,i) - f_k,i)      (X_0 first)
//     Jx = 2/h Deff[k, j] delta_il - delta_kj df_k/dx[i, l],
//          Deff = diff with column 0 replaced by -sum_{j>=1} diff[k, j]
//     Jp = -df_k/dp[i, q]
//   measurement row (s, o), scaled by g = meas_w[s, o] mask[s]:
//     r  = h_s,o - y_s,o,   Jx = dh_s/dx[o, l] rows[s, j],   Jp = dh_s/dp[o, q].
// Then thread t (t < T - 1) owns chain slot k = base + t and gathers, without
// atomics: element k's J^T J, J^T r (its own block and the coupling E), and
// element k - 1's overlap onto block k's leading nx states (a one-element
// halo, built by thread t), and stores D, E, B and gx; every store is
// coalesced over k.  The pad identity of slot K - 1 is added there.  Each
// element's parameter sums (J_p^T J_p, J_p^T r) and r.r (float64) are summed
// over the block in a fixed tree into one partial a block.
// gn_params: one block sums the partials over the blocks in a fixed order
// (every replay bit-identical), adds the priors on p and x(t0) (per-state
// weights or a full sqrt-information matrix) to C, gp, D[:, :, 0] and
// gx[:, 0], and writes the float64 cost 0.5 r.r with the priors' residuals.
//
// What bounds it: bytes.  At N = 100,000 (b = 8, nq = 2, S = 1) it reads
// ~45 MB (node values, data, tables) and writes D and E (2 x 64 x 100,001
// float64: 102 MB), B and gx: ~0.17 GB, 50 us at 3.35 TB/s; ~1,100 FMA an
// element in the products.
//
// Build (one instance per shape; ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DCF_B=8 -DCF_R=2 -DCF_D=4 -DCF_S=2 -DCF_NY=1 \
//        -DCF_FULL=0 -o gn_elements.so gn_elements.cu
// CF_B is the chain block d nx, CF_R the parameters nq, CF_D the degree d,
// CF_S the samples per element, CF_NY the outputs, CF_FULL the defect rule.

#include <cuda_runtime.h>

#if !defined(CF_B) || !defined(CF_R) || !defined(CF_D) || !defined(CF_S) || \
    !defined(CF_NY) || !defined(CF_FULL)
#error "build with -DCF_B -DCF_R -DCF_D -DCF_S -DCF_NY -DCF_FULL (ops/_build.py)"
#endif

// Pointers as the C interface takes them (ops/gn_elements.py _Call); at
// namespace scope, so the extern "C" entry points that take it keep their
// external linkage.
struct Call {
  // node values, element-major: fv (N, DD, nx), fx (N, DD, nx, nx), fp (N,
  // DD, nx, nq); hv (N, S, ny), hx (N, S, ny, nx), hp (N, S, ny, nq)
  const void *V, *fv, *fx, *fp, *hv, *hx, *hp;
  // data and tables: y (N, S, ny), meas_w by its strides, mask (N, S),
  // rows (N, S, d + 1), widths (N,), dscale (N, DD, nx), diff (d+1, d+1)
  const void *y, *w, *mask, *rows, *widths, *dscale, *diff;
  // priors: p, p_prior, p_w (nq,); x0_prior (nx,), x0_w (nx,) or (nx, nx)
  const void *p, *p_prior, *p_w, *x0_prior, *x0_w;
  // outputs: D, E (b, b, K), B (b, nq, K), gx (b, K), C (nq, nq), gp (nq,),
  // cost () float64; scratch: part (blocks, PP), rr_part (blocks,) float64
  void *D, *E, *B, *gx, *C, *gp, *cost, *part, *rr_part;
  long long w_e, w_s, w_o;  // meas_w's strides in elements (0: shared)
  long long n;              // elements N
  long long x0_full;        // x0_w is the (nx, nx) matrix L
};

namespace {

constexpr int kD = CF_D;                      // degree
constexpr int kNX = CF_B / CF_D;              // states (= decision vars a node)
constexpr int kNQ = CF_R;                     // parameters
constexpr int kS = CF_S;                      // samples per element
constexpr int kNY = CF_NY;                    // outputs
constexpr bool kFull = CF_FULL != 0;          // defects at all d + 1 nodes
constexpr int kNN = kD + 1;                   // local nodes
constexpr int kDD = kFull ? kNN : kD;         // collocated nodes
constexpr int kK0 = kFull ? 0 : 1;            // the first collocated node
constexpr int kBD = kD * kNX;                 // chain block
constexpr int kSX = kNN * kNX;                // local state variables
constexpr int kNC = kSX + kNQ + 1;            // columns of [Jx | Jp | r]
constexpr int kM = kDD * kNX + kS * kNY;      // residual rows
constexpr int kPP = kNQ * (kNQ + 1) / 2 + kNQ;  // hpp's upper triangle, gpe
constexpr int kFinishThreads = 256;
constexpr size_t kSmemLimit = 200 * 1024;     // ops/gn_elements.py SMEM_LIMIT

static_assert(CF_B % CF_D == 0 && kD >= 1 && kNX >= 1 && kBD <= 16,
              "the chain block d nx must be a multiple of d, at most 16");
static_assert(kNQ >= 1 && kNQ <= 16 && kS >= 1 && kNY >= 1,
              "1 <= nq <= 16, S >= 1, ny >= 1");

// Threads a block: 64 where 64 elements' J fit in 100 KB, else 32.
template <typename F>
constexpr int tile() {
  return 64 * (kM * kNC + kPP) * sizeof(F) + 64 * sizeof(double) <=
                 100 * 1024 ? 64 : 32;
}

// The tile's [J | r] of each thread, its parameter partials, and its r.r.
template <typename F>
constexpr size_t smem_bytes() {
  return tile<F>() * ((kM * kNC + kPP) * sizeof(F) + sizeof(double));
}

static_assert(smem_bytes<double>() <= kSmemLimit,
              "the elements' Jacobians of a tile exceed the shared memory");

template <typename F>
struct Ptrs {
  const F *V, *fv, *fx, *fp, *hv, *hx, *hp, *y, *w, *mask, *rows, *widths,
      *dscale, *diff, *p, *p_prior, *p_w, *x0_prior, *x0_w;
  F *D, *E, *B, *gx, *C, *gp, *part;
  double *cost, *rr_part;
  long long w_e, w_s, w_o, n;
  bool x0_full;

  explicit Ptrs(const Call& c)
      : V(static_cast<const F*>(c.V)), fv(static_cast<const F*>(c.fv)),
        fx(static_cast<const F*>(c.fx)), fp(static_cast<const F*>(c.fp)),
        hv(static_cast<const F*>(c.hv)), hx(static_cast<const F*>(c.hx)),
        hp(static_cast<const F*>(c.hp)), y(static_cast<const F*>(c.y)),
        w(static_cast<const F*>(c.w)), mask(static_cast<const F*>(c.mask)),
        rows(static_cast<const F*>(c.rows)),
        widths(static_cast<const F*>(c.widths)),
        dscale(static_cast<const F*>(c.dscale)),
        diff(static_cast<const F*>(c.diff)), p(static_cast<const F*>(c.p)),
        p_prior(static_cast<const F*>(c.p_prior)),
        p_w(static_cast<const F*>(c.p_w)),
        x0_prior(static_cast<const F*>(c.x0_prior)),
        x0_w(static_cast<const F*>(c.x0_w)), D(static_cast<F*>(c.D)),
        E(static_cast<F*>(c.E)), B(static_cast<F*>(c.B)),
        gx(static_cast<F*>(c.gx)), C(static_cast<F*>(c.C)),
        gp(static_cast<F*>(c.gp)), part(static_cast<F*>(c.part)),
        cost(static_cast<double*>(c.cost)),
        rr_part(static_cast<double*>(c.rr_part)), w_e(c.w_e), w_s(c.w_s),
        w_o(c.w_o), n(c.n), x0_full(c.x0_full != 0) {}
};

// Element e's [Jx | Jp | r] into this thread's column J of the tile: entry
// (row, col) at J[(row kNC + col) T].
template <typename F, int T>
__device__ void build(const Ptrs<F>& a, long long e, F* J) {
  auto put = [&](int row, int col, F v) { J[(row * kNC + col) * T] = v; };
  F x[kNN][kNX];
#pragma unroll
  for (int j = 0; j < kNN; ++j)
#pragma unroll
    for (int i = 0; i < kNX; ++i) x[j][i] = a.V[(e * kD + j) * kNX + i];
  const F alpha = F(2) / a.widths[e];
#pragma unroll 1
  for (int kk = 0; kk < kDD; ++kk) {
    const int k = kk + kK0;
    F dk[kNN];
#pragma unroll
    for (int j = 0; j < kNN; ++j) dk[j] = a.diff[k * kNN + j];
    F d0 = F(0);                      // d/dX_0 of diff (X - X_0), row k
#pragma unroll
    for (int j = 1; j < kNN; ++j) d0 += dk[j];
    d0 = -d0;
    const long long node = e * kDD + kk;
#pragma unroll
    for (int i = 0; i < kNX; ++i) {
      const int row = kk * kNX + i;
      const F sc = a.dscale[node * kNX + i];
      const F* fxi = a.fx + (node * kNX + i) * kNX;
      const F* fpi = a.fp + (node * kNX + i) * kNQ;
      F xd = F(0);
#pragma unroll
      for (int j = 1; j < kNN; ++j) xd += dk[j] * (x[j][i] - x[0][i]);
#pragma unroll
      for (int j = 0; j < kNN; ++j)
#pragma unroll
        for (int l = 0; l < kNX; ++l) {
          F v = l == i ? alpha * (j == 0 ? d0 : dk[j]) : F(0);
          if (j == k) v -= fxi[l];
          put(row, j * kNX + l, v * sc);
        }
#pragma unroll
      for (int q = 0; q < kNQ; ++q) put(row, kSX + q, -fpi[q] * sc);
      put(row, kNC - 1, (alpha * xd - a.fv[node * kNX + i]) * sc);
    }
  }
#pragma unroll 1
  for (int s = 0; s < kS; ++s) {
    const long long smp = e * kS + s;
    const F mk = a.mask[smp];
    const F* rw = a.rows + smp * kNN;
#pragma unroll
    for (int o = 0; o < kNY; ++o) {
      const int row = kDD * kNX + s * kNY + o;
      const long long idx = smp * kNY + o;
      const F g = a.w[e * a.w_e + s * a.w_s + o * a.w_o];
      const F* hxo = a.hx + idx * kNX;
      const F* hpo = a.hp + idx * kNQ;
#pragma unroll
      for (int j = 0; j < kNN; ++j)
#pragma unroll
        for (int l = 0; l < kNX; ++l)
          put(row, j * kNX + l, hxo[l] * rw[j] * g * mk);
#pragma unroll
      for (int q = 0; q < kNQ; ++q) put(row, kSX + q, hpo[q] * g * mk);
      put(row, kNC - 1, (a.hv[idx] - a.y[idx]) * g * mk);
    }
  }
}

// Column c1 . column c2 of one thread's [J | r].
template <typename F, int T>
__device__ __forceinline__ F dot(const F* J, int c1, int c2) {
  F s = F(0);
#pragma unroll
  for (int row = 0; row < kM; ++row)
    s += J[(row * kNC + c1) * T] * J[(row * kNC + c2) * T];
  return s;
}

template <typename F, int T>
__global__ void __launch_bounds__(T) gn_elements(Ptrs<F> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  F* sJ = reinterpret_cast<F*>(smem);                 // [kM kNC][T]
  F* red = sJ + kM * kNC * T;                         // [kPP][T]
  double* rr = reinterpret_cast<double*>(red + kPP * T);  // [T]
  const int t = threadIdx.x;
  const long long n = a.n, K = n + 1;
  const long long base = (long long)blockIdx.x * (T - 1);
  const long long mine = base - 1 + t;                // the element built
  if (mine >= 0 && mine < n) build<F, T>(a, mine, sJ + t);
  __syncthreads();

  const long long k = base + t;                       // the slot owned
  const bool slot = t < T - 1 && k < K;
  const bool hasA = slot && k < n, hasP = slot && k >= 1;
  const F* JA = sJ + t + 1;                           // element k
  const F* JP = sJ + t;                               // element k - 1
  if (slot) {
#pragma unroll 1
    for (int i = 0; i < kBD; ++i) {
      const bool ov = hasP && i < kNX;                // in k - 1's overlap
#pragma unroll 1
      for (int j = i; j < kBD; ++j) {
        F v = F(0);
        if (hasA) v += dot<F, T>(JA, i, j);
        if (ov && j < kNX) v += dot<F, T>(JP, kBD + i, kBD + j);
        if (!hasA && i == j && i >= kNX) v += F(1);   // the pad identity
        a.D[(i * kBD + j) * K + k] = v;
        if (j != i) a.D[(j * kBD + i) * K + k] = v;
      }
#pragma unroll 1
      for (int j = 0; j < kBD; ++j)
        a.E[(i * kBD + j) * K + k] =
            hasA && j < kNX ? dot<F, T>(JA, i, kBD + j) : F(0);
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        F v = F(0);
        if (hasA) v += dot<F, T>(JA, i, kSX + q);
        if (ov) v += dot<F, T>(JP, kBD + i, kSX + q);
        a.B[(i * kNQ + q) * K + k] = v;
      }
      F g = F(0);
      if (hasA) g += dot<F, T>(JA, i, kNC - 1);
      if (ov) g += dot<F, T>(JP, kBD + i, kNC - 1);
      a.gx[i * K + k] = g;
    }
  }
  // Element k's parameter sums, 0 where this thread has no element.
  int u = 0;
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
#pragma unroll
    for (int q2 = q; q2 < kNQ; ++q2)
      red[(u++) * T + t] = hasA ? dot<F, T>(JA, kSX + q, kSX + q2) : F(0);
  }
#pragma unroll
  for (int q = 0; q < kNQ; ++q)
    red[(u++) * T + t] = hasA ? dot<F, T>(JA, kSX + q, kNC - 1) : F(0);
  double r2 = 0.0;
  if (hasA) {
#pragma unroll
    for (int row = 0; row < kM; ++row) {
      const double r = static_cast<double>(JA[(row * kNC + kNC - 1) * T]);
      r2 += r * r;
    }
  }
  rr[t] = r2;
  __syncthreads();
#pragma unroll 1
  for (int stride = T / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      for (int i = 0; i < kPP; ++i) red[i * T + t] += red[i * T + t + stride];
      rr[t] += rr[t + stride];
    }
    __syncthreads();
  }
  for (int i = t; i < kPP; i += T) a.part[blockIdx.x * kPP + i] = red[i * T];
  if (t == 0) a.rr_part[blockIdx.x] = rr[0];
}

// The sum over the blocks of partial column i, in a fixed order: lane l
// sums blocks l, l + 32, ..., then a fixed shuffle tree; lane 0 holds it.
template <typename V>
__device__ V column_sum(const V* part, int stride, int i, long long nb,
                        int lane) {
  V s = V(0);
  for (long long b = lane; b < nb; b += 32) s += part[b * stride + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(~0u, s, off);
  return s;
}

template <typename F>
__global__ void __launch_bounds__(kFinishThreads)
gn_params(Ptrs<F> a, long long nb) {
  __shared__ F sum[kPP];
  __shared__ double rr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i <= kPP; i += kFinishThreads / 32) {
    if (i < kPP) {
      const F s = column_sum<F>(a.part, kPP, i, nb, lane);
      if (lane == 0) sum[i] = s;
    } else {
      const double s = column_sum<double>(a.rr_part, 1, 0, nb, lane);
      if (lane == 0) rr = s;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long K = a.n + 1;
  double c = rr;
  int u = 0;
  for (int q = 0; q < kNQ; ++q)
    for (int q2 = q; q2 < kNQ; ++q2) {
      a.C[q * kNQ + q2] = sum[u];
      a.C[q2 * kNQ + q] = sum[u++];
    }
  for (int q = 0; q < kNQ; ++q) {
    const F dp = a.p[q] - a.p_prior[q];
    const F w2 = a.p_w[q] * a.p_w[q];
    a.C[q * kNQ + q] += w2;
    a.gp[q] = sum[u++] + w2 * dp;
    const double r = static_cast<double>(a.p_w[q] * dp);
    c += r * r;
  }
  F dx[kNX];
  for (int i = 0; i < kNX; ++i) dx[i] = a.V[i] - a.x0_prior[i];
  for (int i = 0; i < kNX; ++i) {
    if (a.x0_full) {                  // L dx0; L^T L and L^T L dx0
      F r = F(0);
      for (int j = 0; j < kNX; ++j) r += a.x0_w[i * kNX + j] * dx[j];
      c += static_cast<double>(r) * static_cast<double>(r);
      F g = F(0);
      for (int j = 0; j < kNX; ++j) {
        F lam = F(0);
        for (int m = 0; m < kNX; ++m)
          lam += a.x0_w[m * kNX + i] * a.x0_w[m * kNX + j];
        a.D[(i * kBD + j) * K] += lam;
        g += lam * dx[j];
      }
      a.gx[i * K] += g;
    } else {                          // per-state weights w
      const F w = a.x0_w[i];
      const double r = static_cast<double>(w * dx[i]);
      c += r * r;
      a.D[(i * kBD + i) * K] += w * w;
      a.gx[i * K] += w * w * dx[i];
    }
  }
  *a.cost = 0.5 * c;
}

constexpr int kMaxDevices = 64;

template <typename F>
int dispatch(const Call* call, void* stream) {
  if (call->n < 1) return cudaErrorInvalidValue;
  constexpr int T = tile<F>();
  constexpr size_t smem = smem_bytes<F>();
  // Above 48 KB a block's shared memory is opted into, once a device.
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(gn_elements<F, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  const Ptrs<F> a(*call);
  const long long nb = (a.n + 1 + T - 2) / (T - 1);
  auto st = static_cast<cudaStream_t>(stream);
  gn_elements<F, T><<<static_cast<unsigned>(nb), T, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_params<F><<<1, kFinishThreads, 0, st>>>(a, nb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads a block (the tile of elements less its halo element gives the
// slots a block fills, so blocks = ceil((N + 1) / (T - 1))).
int gn_elements_tile(int f64) { return f64 ? tile<double>() : tile<float>(); }

// Returns 0 or the launch's cudaError_t.
int gn_elements_f32(const Call* call, void* stream) {
  return dispatch<float>(call, stream);
}

int gn_elements_f64(const Call* call, void* stream) {
  return dispatch<double>(call, stream);
}

const char* gn_elements_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
