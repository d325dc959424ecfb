// The multi-rank tier's all-reduce over peer-mapped memory: one kernel and
// its set-up, plain C interface.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the
// collectives the JAX package runs inside shard_map (jax.lax.psum / pmax
// and lm_core.psum_dw: collocfem_tpu/parallel/sharded.py, batch.py), which
// XLA keeps inside the device program, so the sharded LM loop
// (lax.while_loop) never returns to the host.  NCCL's kernels of several
// ranks cannot sit in a CUDA-graph WHILE body (on four H100s the loop
// graph failed to instantiate), and NCCL refuses two ranks on one card.
// This kernel is a plain kernel node, which a conditional body takes, and
// it runs between processes that share one card as between cards of one
// host (CUDA IPC).
//
// Set-up, once per process group (parallel/peer.py): each rank allocates
// one buffer with cudaMalloc (peer_alloc) and exports it
// (cudaIpcGetMemHandle); the ranks exchange the handles through the group
// itself, eagerly, and each opens its peers' buffers (peer_open); when the
// group goes away each unmaps them (peer_close) and, once no peer maps its
// own, frees that (peer_free).  A buffer holds
//
//   [0, 256)   one flag per sender rank: the last epoch that rank has
//              finished writing into its slot here;
//   [256, ..)  two parities x P slots x cap doubles.
//
// A call (peer_reduce) is one launch of one block.  With e the call's epoch
// (a device counter the kernel advances itself, so a graph replay needs
// nothing from the host) it
//
//   1. writes this rank's float64 payload into slot [e & 1][rank] of every
//      peer's buffer, as 16-byte stores (over NVLink between cards);
//   2. fences at system scope, then stores e into its flag in every peer
//      (st.release.sys);
//   3. spins with ld.acquire.sys until all P flags of its own buffer reach
//      e, each spin bounded by %globaltimer: past the timeout it sets the
//      group's error word (on the device and in mapped host memory, which
//      the host reads after the solve) and writes NaN; every later call of
//      the group then writes NaN at once;
//   4. reduces the P slots of its own buffer in rank order 0..P-1: a sum
//      (__dadd_rn, never contracted) or a max (NaN propagating, as
//      torch.maximum), or copies them out (a gather).  Each slot value is
//      first added to +0.0, which turns -0.0 into +0.0 as the plain
//      version's all-reduce of zero-filled slots does, so the result is
//      that plain version's bit for bit.
//
// A rank is at most one call ahead of any peer (it cannot pass a call
// before every peer has posted its flag of that call), so the two parities
// keep a rank one call ahead from overwriting a slot a peer still reads.
//
// What bounds it: latency, not bytes.  The sharded solves' payloads are
// 1 to ~1,200 doubles (the SPIKE interface gather at sp = 4, (8, 19): 4 x 2
// x 8 x 19); a call moves P x n doubles out and reads P x n, some ns of
// HBM or NVLink time, against the flag round trip (~us between cards) and,
// where ranks share one card, the time slices of the other ranks'
// processes.  One block keeps the round trip to one flag exchange.
//
// Build (ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o peer_reduce.so peer_reduce.cu

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxRanks = 32;
constexpr int kThreads = 512;
constexpr long long kFlagBytes = kMaxRanks * sizeof(unsigned long long);

enum Op { kSum = 0, kMax = 1, kGather = 2 };

struct Peers {
  char* base[kMaxRanks];   // every rank's buffer, mapped into this process
};

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ double slot_value(const double* p) {
  return __dadd_rn(__ldcg(p), 0.0);
}

__device__ __forceinline__ double combine(double acc, double v, int op) {
  if (op == kSum) return __dadd_rn(acc, v);
  if (isnan(acc) || isnan(v)) return __dadd_rn(acc, v);
  return v > acc ? v : acc;
}

__device__ void fill_nan(double* out, long long n, long long rows,
                         long long stride) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (long long r = 0; r < rows; ++r)
    for (long long i = threadIdx.x; i < n; i += kThreads)
      out[r * stride + i] = nan;
}

// state[0]: the group's epoch; state[1]: its error word (1 after a
// timeout).  host_error: the error word's mirror in mapped host memory.
__global__ void __launch_bounds__(kThreads)
    peer_reduce_kernel(Peers peers, int P, int rank,
                       const double* __restrict__ x, double* __restrict__ out,
                       long long n, long long out_stride, int op,
                       long long cap, long long* state,
                       volatile int* host_error, long long timeout_ns) {
  __shared__ long long s_epoch;
  __shared__ int s_failed;
  const int t = threadIdx.x;
  if (t == 0) {
    s_epoch = state[0] + 1;
    s_failed = state[1] != 0;
  }
  __syncthreads();
  const long long e = s_epoch;
  const long long rows = op == kGather ? P : 1;
  if (s_failed) {
    fill_nan(out, n, rows, out_stride);
    if (t == 0) state[0] = e;
    return;
  }
  const long long parity = e & 1;

  // 1. This rank's payload into its slot of every peer's buffer.
  const long long pairs = n / 2;
  for (int p = 0; p < P; ++p) {
    double* slot = reinterpret_cast<double*>(peers.base[p] + kFlagBytes) +
                   (parity * P + rank) * cap;
    double2* slot2 = reinterpret_cast<double2*>(slot);
    for (long long i = t; i < pairs; i += kThreads)
      slot2[i] = make_double2(x[2 * i], x[2 * i + 1]);
    if ((n & 1) && t == 0) slot[n - 1] = x[n - 1];
  }
  __threadfence_system();
  __syncthreads();

  // 2. This rank's flag in every peer, released after its payload.
  if (t < P)
    store_release(reinterpret_cast<unsigned long long*>(peers.base[t]) + rank,
                  static_cast<unsigned long long>(e));

  // 3. Every peer's flag in this rank's buffer, each wait bounded.
  if (t < P) {
    const unsigned long long* flag =
        reinterpret_cast<const unsigned long long*>(peers.base[rank]) + t;
    const unsigned long long start = now_ns();
    while (load_acquire(flag) < static_cast<unsigned long long>(e)) {
      if (now_ns() - start > static_cast<unsigned long long>(timeout_ns)) {
        s_failed = 1;
        break;
      }
    }
  }
  __syncthreads();
  if (s_failed) {
    if (t == 0) {
      state[1] = 1;
      *host_error = 1;
      __threadfence_system();
      state[0] = e;
    }
    fill_nan(out, n, rows, out_stride);
    return;
  }

  // 4. The P slots in rank order.
  const double* slots = reinterpret_cast<const double*>(peers.base[rank] +
                                                        kFlagBytes) +
                        parity * P * cap;
  for (long long i = t; i < n; i += kThreads) {
    if (op == kGather) {
      for (int s = 0; s < P; ++s)
        out[s * out_stride + i] = slot_value(slots + s * cap + i);
    } else {
      double acc = slot_value(slots + i);
      for (int s = 1; s < P; ++s)
        acc = combine(acc, slot_value(slots + s * cap + i), op);
      out[i] = acc;
    }
  }
  if (t == 0) state[0] = e;
}

}  // namespace

extern "C" {

int peer_max_ranks() { return kMaxRanks; }
int peer_flag_bytes() { return static_cast<int>(kFlagBytes); }
int peer_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// A zeroed buffer of ``bytes`` on the current device and its IPC handle
// (peer_handle_bytes() bytes into ``handle``).
int peer_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return err;
  }
  memcpy(handle, &h, sizeof h);
  return cudaSuccess;
}

// Map another process's buffer (its handle from peer_alloc) into this one.
int peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// A zeroed int in mapped, pinned host memory: its host and device pointers.
int peer_host_word(void** host, void** device) {
  cudaError_t err = cudaHostAlloc(host, sizeof(int), cudaHostAllocMapped);
  if (err != cudaSuccess) return err;
  *static_cast<int*>(*host) = 0;
  return cudaHostGetDevicePointer(device, *host, 0);
}

// Unmap a peer's buffer (peer_open's pointer).
int peer_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

// Free this rank's buffer (peer_alloc's) and its error word
// (peer_host_word's host pointer).
int peer_free(void* buffer, void* host) {
  cudaError_t err = cudaFree(buffer);
  cudaError_t host_err = cudaFreeHost(host);
  return err != cudaSuccess ? err : host_err;
}

// One call (module comment): ``bases`` is a host array of the P buffers as
// this process maps them (its own at ``rank``); ``x`` (n doubles) on the
// device; ``out`` n doubles, or P rows of n at ``out_stride`` for a gather.
int peer_reduce(void* const* bases, int P, int rank, const double* x,
                double* out, long long n, long long out_stride, int op,
                long long cap, long long* state, int* host_error,
                long long timeout_ns, void* stream) {
  if (P < 1 || P > kMaxRanks || rank < 0 || rank >= P || n < 1 || n > cap ||
      op < kSum || op > kGather)
    return cudaErrorInvalidValue;
  Peers peers = {};
  for (int p = 0; p < P; ++p) peers.base[p] = static_cast<char*>(bases[p]);
  peer_reduce_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      peers, P, rank, x, out, n, out_stride, op, cap, state, host_error,
      timeout_ns);
  return cudaGetLastError();
}

const char* peer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
