// combine: (R, K) coefficients x (K, D) blocks -> (R, D), float32.
//
// Replaces: src/repro/kernels/coded/kernel.py:combine_pallas (body
// _combine_kernel: one output row per program, jnp.dot in float32).  The
// same product is the coded encode (generator x data blocks) and the decode
// (weights x surviving responses).
//
// What bounds it on this card: at the planner's shapes (R, K <= a few
// dozen, D = 2048) bytes and launch latency, far from the 67 TFLOP/s of
// float32 FFMA; at square shapes of a thousand or more, operations.  The
// reference product is full float32, so the tensor cores (TF32 at best)
// are not used.
//
// Design: a plain shared-memory tiled SGEMM.  Each 256-thread block owns a
// 64 x 64 output tile and walks K in steps of 16, staging a 64 x 16 tile of
// the coefficients and a 16 x 64 tile of the blocks in shared memory; each
// thread keeps a 4 x 4 accumulator in registers and updates it with FFMA.
// Ragged edges are zero-filled on load and masked on store.  Summation
// order differs from the reference, so the result is held to
// |kernel - plain| <= 1e-5 * (|coeffs| @ |blocks|) elementwise.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int r, int k, int d) {
  __shared__ float sa[BK][BM + 4];  // transposed: sa[kk][row]
  __shared__ float sb[BK][BN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int rr = e / BK, kk = e % BK;
      const int gr = row0 + rr, gk = k0 + kk;
      sa[kk][rr] = (gr < r && gk < k) ? a[(size_t)gr * k + gk] : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      sb[kk][cc] = (gk < k && gc < d) ? b[(size_t)gk * d + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = sa[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = sb[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= r) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < d) c[(size_t)gr * d + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int combine_launch(const float* a, const float* b, float* c, int r, int k,
                   int d, void* stream) {
  if (r == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((d + BN - 1) / BN, (r + BM - 1) / BM);
  combine_kernel<<<grid, THREADS, 0, s>>>(a, b, c, r, k, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
