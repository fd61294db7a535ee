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
// Design: two kernels, chosen by shape in combine_launch.
// - Small R (R <= 32 and R x K fits 48 KB): every block holds all R x K
//   coefficients in shared memory (transposed, so the rows of a warp read
//   neighbouring banks) and owns a strip of D; each thread owns one row and
//   four neighbouring columns, streams its columns of `blocks` with float4
//   loads and runs exactly K FFMA steps.  D = 2048 at R = 16 gives 128
//   blocks of 64 threads; no tile row or k-step is zero padding.
// - Otherwise a 128 x 128 block tile over k-steps of 16, 256 threads, each
//   with an 8 x 8 register tile (two 4 x 4 quadrants, 64 rows and columns
//   apart, so the float4 reads of shared memory are free of bank
//   conflicts).  Both
//   operand tiles are double-buffered in shared memory and filled by
//   cp.async while the previous tile's FFMAs run, in 16-byte copies (4-byte
//   ones where K or D is not a multiple of 4).  A thread reads four k-steps
//   of its eight coefficient rows as eight float4 and each k-step's eight
//   block columns as two float4.  Ragged edges are zero-filled by the
//   copies and masked on store.
// Each output is a sum over k in increasing order in float32 FFMA, as the
// plain version sums (without its roundings between multiply and add), so
// the result is held to |kernel - plain| <= 1e-5 * (|coeffs| @ |blocks|).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// small R
// ---------------------------------------------------------------------------

constexpr int SMALL_MAX_R = 32;
constexpr int SMALL_MAX_COEFFS = 12288;  // 48 KB of float32

template <bool VEC>
__global__ void __launch_bounds__(128)
combine_small_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int r, int k, int d, int cw) {
  extern __shared__ float s_at[];  // s_at[kk * r + row]
  const int tid = threadIdx.x;
  for (int e = tid; e < r * k; e += blockDim.x) {
    const int row = e / k, kk = e - row * k;
    s_at[kk * r + row] = a[e];
  }
  __syncthreads();
  const int row = tid / cw;
  const int col = (blockIdx.x * cw + tid % cw) * 4;
  if (row >= r || col >= d) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* bp = b + col;
  if (VEC) {
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(bp + (size_t)kk * d));
      const float w = s_at[kk * r + row];
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(c + (size_t)row * d + col) = acc;
  } else {
    const int n = d - col < 4 ? d - col : 4;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const float* q = bp + (size_t)kk * d;
      const float w = s_at[kk * r + row];
      acc.x = fmaf(w, __ldg(q), acc.x);
      if (n > 1) acc.y = fmaf(w, __ldg(q + 1), acc.y);
      if (n > 2) acc.z = fmaf(w, __ldg(q + 2), acc.z);
      if (n > 3) acc.w = fmaf(w, __ldg(q + 3), acc.w);
    }
    float* o = c + (size_t)row * d + col;
    o[0] = acc.x;
    if (n > 1) o[1] = acc.y;
    if (n > 2) o[2] = acc.z;
    if (n > 3) o[3] = acc.w;
  }
}

// ---------------------------------------------------------------------------
// large shapes
// ---------------------------------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int A_LD = BK + 4;  // a row of the coefficient tile, padded
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Tiles {
  float a[2][BM][A_LD];  // a[buf][row][kk]: 16 coefficients a row
  float b[2][BK][BN];    // b[buf][kk][col]
};

// Issue the copies of k-tile `k0` into buffer `buf`: 16-byte copies where
// rows are 16-byte aligned (VA: K % 4 == 0; VB: D % 4 == 0), else 4-byte.
template <bool VA, bool VB>
__device__ __forceinline__ void load_tile(Tiles& t, int buf, const float* a,
                                          const float* b, int r, int k, int d,
                                          int row0, int col0, int k0) {
  const int tid = threadIdx.x;
  if (VA) {
#pragma unroll
    for (int j = 0; j < BM * BK / 4 / THREADS; ++j) {  // 2 float4 a thread
      const int e = tid + j * THREADS;
      const int rr = e / (BK / 4), kk = (e % (BK / 4)) * 4;
      const int gr = row0 + rr, gk = k0 + kk;
      const bool ok = gr < r && gk < k;
      cp_async16(&t.a[buf][rr][kk], ok ? a + (size_t)gr * k + gk : a, ok);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BM * BK / THREADS; ++j) {  // 8 floats a thread
      const int e = tid + j * THREADS;
      const int rr = e / BK, kk = e % BK;
      const int gr = row0 + rr, gk = k0 + kk;
      const bool ok = gr < r && gk < k;
      cp_async4(&t.a[buf][rr][kk], ok ? a + (size_t)gr * k + gk : a, ok);
    }
  }
  if (VB) {
#pragma unroll
    for (int j = 0; j < BK * BN / 4 / THREADS; ++j) {  // 2 float4 a thread
      const int e = tid + j * THREADS;
      const int kk = e / (BN / 4), cc = (e % (BN / 4)) * 4;
      const int gk = k0 + kk, gc = col0 + cc;
      const bool ok = gk < k && gc < d;
      cp_async16(&t.b[buf][kk][cc], ok ? b + (size_t)gk * d + gc : b, ok);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {  // 8 floats a thread
      const int e = tid + j * THREADS;
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      const bool ok = gk < k && gc < d;
      cp_async4(&t.b[buf][kk][cc], ok ? b + (size_t)gk * d + gc : b, ok);
    }
  }
  cp_async_commit();
}

// Rows (and columns) of a thread: two groups of four, 64 apart.
__device__ __forceinline__ int quad(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
combine_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int r, int k, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles& t = *reinterpret_cast<Tiles*>(smem_raw);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int n_tiles = (k + BK - 1) / BK;
  if (n_tiles > 0) load_tile<VA, VB>(t, 0, a, b, r, k, d, row0, col0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<VA, VB>(t, buf ^ 1, a, b, r, k, d, row0, col0, (it + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(&t.a[buf][quad(ty, i)][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(&t.b[buf][k4 + q][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&t.b[buf][k4 + q][64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float w = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(w, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + quad(ty, i);
    if (gr >= r) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + h * 64 + tx * 4;
      float* o = c + (size_t)gr * d + gc;
      if (VB) {
        if (gc < d)
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < d) o[j] = acc[i][h * 4 + j];
      }
    }
  }
}

template <bool VA, bool VB>
void launch_tiled(const float* a, const float* b, float* c, int r, int k, int d,
                  cudaStream_t s) {
  const dim3 grid((d + BN - 1) / BN, (r + BM - 1) / BM);
  combine_tiled_kernel<VA, VB><<<grid, THREADS, sizeof(Tiles), s>>>(a, b, c, r, k, d);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Which kernel a shape takes: 0 small-R, 1 tiled.
int combine_path(int r, int k) {
  return (r <= SMALL_MAX_R && (long long)r * k <= SMALL_MAX_COEFFS) ? 0 : 1;
}

int combine_launch(const float* a, const float* b, float* c, int r, int k,
                   int d, void* stream) {
  if (r == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 access needs rows that start on 16-byte boundaries
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (combine_path(r, k) == 0) {
    int cw = (32 + r - 1) / r;  // float4 column groups a block
    if (cw < 4) cw = 4;
    const int cols = cw * 4;
    const dim3 grid((d + cols - 1) / cols);
    const size_t smem = sizeof(float) * (size_t)r * k;
    if (vec)
      combine_small_kernel<true><<<grid, cw * r, smem, s>>>(a, b, c, r, k, d, cw);
    else
      combine_small_kernel<false><<<grid, cw * r, smem, s>>>(a, b, c, r, k, d, cw);
  } else {
    const bool va = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    if (va && vec)
      launch_tiled<true, true>(a, b, c, r, k, d, s);
    else if (va)
      launch_tiled<true, false>(a, b, c, r, k, d, s);
    else if (vec)
      launch_tiled<false, true>(a, b, c, r, k, d, s);
    else
      launch_tiled<false, false>(a, b, c, r, k, d, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
