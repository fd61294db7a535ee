// decode_attention: split-KV attention of one query per head over a cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:
// decode_attention_kernel_call (body _decode_kernel) and its exact
// log-sum-exp merge combine_splits.  q (b, H, d) and caches
// (b, S_max, KV, d), float32 or bfloat16; positions >= cache_len are
// masked.  Each split writes a float32 partial (m, l, acc) per head; a
// second launch merges the splits exactly: with m* = max_s m_s and
// w_s = exp(m_s - m*), out = sum_s w_s acc_s / sum_s w_s l_s, in q's dtype.
//
// What bounds it on this card: bytes.  One decode step of the serving run
// (b = 8, KV = 2, d = 64, cache length about 1,056) reads about 4.3 MB of
// K and V per layer and does about 30 MFLOP on them: 1.3 us at 3.35 TB/s.
// At that size the two launches cost more than the reads.
//
// Design: one 128-thread block per (split, KV head, batch row).  A split
// is 4096 / d cache positions (64 at d = 64, 36 at d = 112).  The block serves all
// H / KV query heads of its KV group, so each K and V row is read from
// device memory once per group, not once per query head (the reference
// repeats the cache per head).  It stages its K rows (padded rows) and V
// rows in shared memory as float32, computes the group's scores, takes
// each head's max and sum with one warp per head, and accumulates
// P x V with one thread per (head, column).  A split that starts at or
// past cache_len reads nothing and writes m = -1e30, l = 0 and acc = 0:
// the merge gives it weight exp(-1e30 - m*) = 0, and with l = 0 and
// acc = 0 it would add nothing at any weight, so the result is the one the
// TPU kernel gets from its fully masked splits.  The merge launch reads
// acc only for splits of non-zero weight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int D>
__host__ __device__ constexpr int split_len() {
  return 4096 / D;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
int smem_bytes(int G) {
  constexpr int S = split_len<D>();
  return (G * D + S * D + S * (D + 1) + G * S) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, float* __restrict__ m_out,
             float* __restrict__ l_out, float* __restrict__ acc_out, int H,
             int KV, int smax, int cache_len, int n_splits, float scale) {
  constexpr int S = split_len<D>();
  constexpr int VN = Vec<T>::N;
  constexpr int GROUPS = D / VN;
  constexpr int KSTRIDE = D + 1;  // padded: threads of a warp read 32 rows

  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int G = H / KV;
  const int h0 = kvh * G;
  const int start = split * S;
  const int tid = threadIdx.x;
  // partial (bi, h0 + g, split) lives at part + g * n_splits
  const size_t part = ((size_t)bi * H + h0) * n_splits + split;

  if (start >= cache_len) {
    for (int e = tid; e < G * D; e += THREADS)
      acc_out[(part + (size_t)(e / D) * n_splits) * D + e % D] = 0.0f;
    for (int g = tid; g < G; g += THREADS) {
      m_out[part + (size_t)g * n_splits] = NEG_INF;
      l_out[part + (size_t)g * n_splits] = 0.0f;
    }
    return;
  }
  const int len = min(S, cache_len - start);

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [G][D], scaled
  float* Vs = Qs + G * D;                       // [S][D]
  float* Ks = Vs + S * D;                       // [S][KSTRIDE]
  float* Ps = Ks + S * KSTRIDE;                 // [G][S]

  for (int e = tid; e < G * GROUPS; e += THREADS) {
    const int g = e / GROUPS, c = (e % GROUPS) * VN;
    float buf[VN];
    Vec<T>::load(q + ((size_t)bi * H + h0 + g) * D + c, buf);
#pragma unroll
    for (int i = 0; i < VN; ++i) Qs[g * D + c + i] = buf[i] * scale;
  }
  for (int e = tid; e < len * GROUPS; e += THREADS) {
    const int r = e / GROUPS, c = (e % GROUPS) * VN;
    const size_t row = (((size_t)bi * smax + start + r) * KV + kvh) * D + c;
    float buf[VN];
    Vec<T>::load(kc + row, buf);
#pragma unroll
    for (int i = 0; i < VN; ++i) Ks[r * KSTRIDE + c + i] = buf[i];
    Vec<T>::load(vc + row, buf);
#pragma unroll
    for (int i = 0; i < VN; i += 4)
      *reinterpret_cast<float4*>(&Vs[r * D + c + i]) =
          make_float4(buf[i], buf[i + 1], buf[i + 2], buf[i + 3]);
  }
  __syncthreads();

  for (int e = tid; e < G * S; e += THREADS) {
    const int g = e / S, r = e % S;
    if (r >= len) continue;
    const float* qr = Qs + g * D;
    const float* kr = Ks + r * KSTRIDE;
    float acc = 0.0f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kr[c], acc);
    Ps[g * S + r] = acc;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += THREADS / 32) {
    float mx = NEG_INF;
    for (int r = lane; r < len; r += 32) mx = fmaxf(mx, Ps[g * S + r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int r = lane; r < len; r += 32) {
      const float p = expf(Ps[g * S + r] - mx);
      Ps[g * S + r] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_out[part + (size_t)g * n_splits] = mx;
      l_out[part + (size_t)g * n_splits] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, c = e % D;
    const float* pr = Ps + g * S;
    float acc = 0.0f;
    for (int r = 0; r < len; ++r) acc = fmaf(pr[r], Vs[r * D + c], acc);
    acc_out[(part + (size_t)g * n_splits) * D + c] = acc;
  }
}

template <typename T>
__global__ void merge_kernel(const float* __restrict__ m,
                             const float* __restrict__ l,
                             const float* __restrict__ acc,
                             T* __restrict__ out, int n_splits, int D) {
  const size_t bh = blockIdx.x;  // b * H + h
  const int c = threadIdx.x;     // blockDim.x == D
  const float* mr = m + bh * n_splits;
  const float* lr = l + bh * n_splits;
  float m_tot = NEG_INF;
  for (int s = 0; s < n_splits; ++s) m_tot = fmaxf(m_tot, mr[s]);
  float l_tot = 0.0f, num = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(mr[s] - m_tot);
    if (w == 0.0f) continue;
    l_tot = fmaf(lr[s], w, l_tot);
    num = fmaf(w, acc[(bh * n_splits + s) * D + c], num);
  }
  store(out + bh * D + c, num / fmaxf(l_tot, 1e-30f));
}

template <typename T, int D>
int launch_split(const void* q, const void* k, const void* v, float* m,
                 float* l, float* acc, int b, int H, int KV, int smax,
                 int cache_len, int n_splits, cudaStream_t s) {
  const int smem = smem_bytes<D>(H / KV);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_splits, KV, b);
  split_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, acc, H, KV, smax, cache_len, n_splits,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cache positions per split at head dimension d (0 for an unsupported d)
int decode_attention_split_len(int d) {
  if (d == 64) return split_len<64>();
  if (d == 112) return split_len<112>();
  if (d == 128) return split_len<128>();
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  m, l: (b, H, n_splits) and acc:
// (b, H, n_splits, d), float32 scratch that the wrapper allocates, with
// n_splits = ceil(smax / split_len(d)).  The wrapper checks shapes,
// contiguity, alignment and 1 <= cache_len <= smax.
int decode_attention_split_launch(const void* q, const void* k, const void* v,
                                  float* m, float* l, float* acc, int b, int H,
                                  int KV, int smax, int d, int cache_len,
                                  int n_splits, int dtype, void* stream) {
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_split<float, 64>(q, k, v, m, l, acc, b, H, KV, smax,
                                   cache_len, n_splits, s);
  if (dtype == 0 && d == 128)
    return launch_split<float, 128>(q, k, v, m, l, acc, b, H, KV, smax,
                                    cache_len, n_splits, s);
  if (dtype == 1 && d == 64)
    return launch_split<__nv_bfloat16, 64>(q, k, v, m, l, acc, b, H, KV, smax,
                                           cache_len, n_splits, s);
  if (dtype == 1 && d == 128)
    return launch_split<__nv_bfloat16, 128>(q, k, v, m, l, acc, b, H, KV,
                                            smax, cache_len, n_splits, s);
  if (dtype == 0 && d == 112)
    return launch_split<float, 112>(q, k, v, m, l, acc, b, H, KV, smax,
                                    cache_len, n_splits, s);
  if (dtype == 1 && d == 112)
    return launch_split<__nv_bfloat16, 112>(q, k, v, m, l, acc, b, H, KV,
                                            smax, cache_len, n_splits, s);
  return (int)cudaErrorInvalidValue;
}

int decode_attention_merge_launch(const float* m, const float* l,
                                  const float* acc, void* out, int b, int H,
                                  int d, int n_splits, int dtype,
                                  void* stream) {
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    merge_kernel<float><<<b * H, d, 0, s>>>(m, l, acc,
                                            static_cast<float*>(out),
                                            n_splits, d);
  else if (dtype == 1)
    merge_kernel<__nv_bfloat16><<<b * H, d, 0, s>>>(
        m, l, acc, static_cast<__nv_bfloat16*>(out), n_splits, d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
