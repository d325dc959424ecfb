// Cost of the operations the SPIKE core's lane groups are built from, for
// one warp alone on the card (clock64 around unrolled loops): a warp
// shuffle (throughput with eight independent shuffles in flight, and the
// latency of a dependent chain), an independent fused multiply-add, and a
// dependent square root and reciprocal (a Cholesky pivot), in float32 and
// float64.  The tile and interface steps of kernels #1 and #2 are counted
// in these units in PERF.md.
//
// Build and run on a machine with the card (from the root of a checkout):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o shfl_probe \
//        collocfem_tpu_torch/tools/shfl_probe.cu && ./shfl_probe

#include <cstdio>

#include <cuda_runtime.h>

template <typename F>
__global__ void shfl_throughput(F* out, int iters, long long* cyc,
                                int width) {
  const int lane = threadIdx.x & 31;
  const unsigned mask = 0xffffffffu;
  F v[8];
  for (int j = 0; j < 8; ++j) v[j] = lane + j;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __shfl_sync(mask, v[j], (j + it) & (width - 1), width);
  }
  const long long t1 = clock64();
  F s = 0;
  for (int j = 0; j < 8; ++j) s += v[j];
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

template <typename F>
__global__ void shfl_latency(F* out, int iters, long long* cyc) {
  F v = threadIdx.x;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
    v = __shfl_sync(0xffffffffu, v, (it + 1) & 7, 8);
  const long long t1 = clock64();
  out[threadIdx.x] = v;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

template <typename F>
__global__ void fma_throughput(F* out, int iters, long long* cyc) {
  F v[8];
  const F a = threadIdx.x * F(1e-3);
  for (int j = 0; j < 8; ++j) v[j] = j;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = v[j] * a + F(0.5);
  const long long t1 = clock64();
  F s = 0;
  for (int j = 0; j < 8; ++j) s += v[j];
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

__device__ __forceinline__ float rcp_rn(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __drcp_rn(x); }

template <typename F>
__global__ void pivot_latency(F* out, int iters, long long* cyc) {
  F v = threadIdx.x + 2;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) v = rcp_rn(sqrt(v)) + F(2);
  const long long t1 = clock64();
  out[threadIdx.x] = v;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}

template <typename F>
void probe(const char* type) {
  constexpr int kIters = 4096;
  F* out;
  long long *cyc, h;
  cudaMalloc(&out, 32 * sizeof(F));
  cudaMalloc(&cyc, sizeof(long long));
  auto cycles = [&] {
    cudaMemcpy(&h, cyc, sizeof h, cudaMemcpyDeviceToHost);
    return (double)h;
  };
  for (int width : {8, 32}) {
    shfl_throughput<F><<<1, 32>>>(out, kIters, cyc, width);
    printf("%s shuffle, width %d, 8 independent: %.2f cycles per shuffle\n",
           type, width, cycles() / (8.0 * kIters));
  }
  shfl_latency<F><<<1, 32>>>(out, kIters, cyc);
  printf("%s shuffle, dependent chain: %.2f cycles\n", type,
         cycles() / kIters);
  fma_throughput<F><<<1, 32>>>(out, kIters, cyc);
  printf("%s fma, 8 independent: %.2f cycles per fma\n", type,
         cycles() / (8.0 * kIters));
  pivot_latency<F><<<1, 32>>>(out, kIters, cyc);
  printf("%s sqrt + correctly rounded reciprocal, dependent: %.2f cycles\n",
         type, cycles() / kIters);
  cudaFree(out);
  cudaFree(cyc);
}

int main() {
  probe<float>("float32");
  probe<double>("float64");
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
