// coded_cells: the k-th smallest of N worker times per trial, k per cell.
//
// Replaces: src/repro/kernels/sojourn_sweep/kernel.py:coded_cells_pallas
// (body _coded_kernel -> coded_cell: sort each row, take column k-1).
//
// What bounds it on this card: bytes.  Each of the C*T rows of N float32
// values is read and one value is written, and the selection itself is a
// handful of integer operations per element, far under the card's rate.
//
// Design: no sort.  For short rows (N <= 64, the planner's fleets of a few
// dozen workers) one thread owns one row and finds the value x_j with
// #{x < x_j} < k <= #{x <= x_j} by counting, O(N^2) compares in
// registers and L1.  For long rows one 256-thread block owns one row and
// runs a radix select on the float's order-preserving 32-bit key: four
// passes of an 8-bit digit histogram in shared memory, each pass keeping
// only the elements whose key matches the prefix found so far.  Both paths
// return one of the input floats unchanged, so the output is bit-equal to
// torch.sort + gather (up to the sign of a zero, which the service times
// never carry).  Duplicates are handled by the counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMALL_N = 64;
constexpr int RADIX_THREADS = 256;

__global__ void coded_small_kernel(const float* __restrict__ times,
                                   const int* __restrict__ ks,
                                   float* __restrict__ out, int n_cells,
                                   int n_trials, int n) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)n_cells * n_trials) return;
  const int c = (int)(row / n_trials);
  const int k = ks[c];
  const float* x = times + row * n;
  float v[SMALL_N];
#pragma unroll 4
  for (int j = 0; j < n; ++j) v[j] = x[j];
  float res = v[0];
  for (int j = 0; j < n; ++j) {
    const float xj = v[j];
    int less = 0, leq = 0;
    for (int i = 0; i < n; ++i) {
      less += v[i] < xj ? 1 : 0;
      leq += v[i] <= xj ? 1 : 0;
    }
    if (less < k && k <= leq) {
      res = xj;
      break;
    }
  }
  out[row] = res;
}

__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t key) {
  const uint32_t u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(u);
}

__global__ void __launch_bounds__(RADIX_THREADS)
coded_radix_kernel(const float* __restrict__ times, const int* __restrict__ ks,
                   float* __restrict__ out, int n_trials, int n) {
  __shared__ unsigned int hist[256];
  __shared__ uint32_t s_prefix;
  __shared__ int s_k;
  const long long row = blockIdx.x;
  const int c = (int)(row / n_trials);
  const float* x = times + row * n;
  uint32_t prefix = 0, mask = 0;
  int kk = ks[c];
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += RADIX_THREADS) hist[b] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += RADIX_THREADS) {
      const uint32_t key = key_of(__ldg(x + j));
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int below = 0;
      int digit = 255;
      for (int b = 0; b < 256; ++b) {
        const int cnt = (int)hist[b];
        if (below + cnt >= kk) {
          digit = b;
          break;
        }
        below += cnt;
      }
      s_prefix = prefix | ((uint32_t)digit << shift);
      s_k = kk - below;
    }
    __syncthreads();
    prefix = s_prefix;
    kk = s_k;
    mask |= 0xffu << shift;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[row] = float_of(prefix);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// force_radix != 0 runs the radix select on short rows too (to time the
// two paths against each other on the same input).
int coded_cells_launch(const float* times, const int* ks, float* out,
                       int n_cells, int n_trials, int n, int force_radix,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)n_cells * n_trials;
  if (rows == 0) return 0;
  if (n <= SMALL_N && !force_radix) {
    const int threads = 128;
    const long long blocks = (rows + threads - 1) / threads;
    coded_small_kernel<<<(unsigned)blocks, threads, 0, s>>>(times, ks, out,
                                                           n_cells, n_trials, n);
  } else {
    coded_radix_kernel<<<(unsigned)rows, RADIX_THREADS, 0, s>>>(times, ks, out,
                                                                n_trials, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
