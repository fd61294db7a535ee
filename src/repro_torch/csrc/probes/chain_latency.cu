// chain_latency: SM cycles of one step of the dependent chains that a walk
// of csrc/sojourn_cells.cu runs, for that kernel's chain bound.  Not a
// kernel of any path: chip_smoke.py builds it beside the kernels and reads
// it once.
//
// One warp runs each chain for `steps` steps and times it with clock64:
//   0. __reduce_min_sync on a value that depends on the last result (the
//      warp reductions that give the trees' roots);
//   1. lane 0 stores a word in shared memory, __syncwarp, then every lane
//      loads 16 bytes of it (a walk's update of a set, then its node's
//      float4 load).
// Each loop is unrolled, so the counter's add and branch hide behind the
// chain.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libchain_latency.so chain_latency.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32)
chain_latency_kernel(int steps, long long* cycles, unsigned* sink) {
  __shared__ __align__(16) unsigned buf[4 * 32];
  const unsigned lane = threadIdx.x & 31;
  for (int k = lane; k < 4 * 32; k += 32) buf[k] = k;
  __syncwarp();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf));

  unsigned v = lane;
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) v = __reduce_min_sync(FULL, v + lane);
  long long t1 = clock64();

  unsigned w = v;
  long long t2 = clock64();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) {
    if (lane == 0)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base), "r"(w) : "memory");
    __syncwarp();
    unsigned a, b, c, d;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                 : "r"(base + 16u * lane)
                 : "memory");
    w = a + (b ^ c ^ d);
  }
  long long t3 = clock64();

  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t3 - t2;
  }
  sink[lane] = v ^ w;
}

}  // namespace

extern "C" {

// Cycles per step of each chain, from the second of two launches of
// `steps` steps (the first warms the instruction cache).  Returns a CUDA
// error code, 0 on success.
int chain_latency_probe(int steps, double* per_step) {
  long long* cycles = nullptr;
  unsigned* sink = nullptr;
  cudaError_t err = cudaMalloc(&cycles, 2 * sizeof(long long));
  if (err == cudaSuccess) err = cudaMalloc(&sink, 32 * sizeof(unsigned));
  for (int run = 0; run < 2 && err == cudaSuccess; ++run) {
    chain_latency_kernel<<<1, 32>>>(steps, cycles, sink);
    err = cudaDeviceSynchronize();
  }
  long long host[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpy(host, cycles, sizeof(host), cudaMemcpyDeviceToHost);
  cudaFree(cycles);
  cudaFree(sink);
  for (int k = 0; k < 2; ++k) per_step[k] = (double)host[k] / steps;
  return (int)err;
}

}  // extern "C"
