// flash_attention: online-softmax attention, causal or not, GQA read natively.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:
// flash_attention_kernel_call (body _attn_kernel).  q (b, sq, H, d) and
// k, v (b, skv, KV, d), float32 or bfloat16; the scores, the softmax state
// (m, l) and the accumulator are float32 and the output is in q's dtype.
// Query head h reads KV head h / (H / KV), the group-major mapping of the
// reference's jnp.repeat; the repeat is never materialised.  With
// `causal`, key position j is visible to query row i when
// j <= i + q_offset, and key tiles wholly past a query tile's frontier are
// never visited (the causal early exit of the TPU kernel).
//
// What bounds it on this card: at the serving prefill (b = 8, s = 1024,
// H = 14, d = 64, causal) about 15 GFLOP against about 33 MB, so the
// bound is operations (15 us on the bf16 tensor cores, 989 TFLOP/s).
// This first version runs on the float32 FMA units (67 TFLOP/s), so its
// own ceiling is about 15 times that bound.
//
// Design: one 256-thread block per (64-row query tile, head, batch),
// heaviest causal tiles first.  The block keeps its scaled query tile in
// shared memory and walks 64-key tiles: K (transposed) and V are staged in
// shared memory as float32, each thread computes a 4 x 4 patch of the
// 64 x 64 score tile, the row max and sum are reduced over the 16 threads
// of a row group with shuffles, the probabilities go through shared memory
// and each thread updates a 4 x (4 per 64 columns) patch of the output in
// registers: columns tx * 4 + 64 * cb, for every cb whose group lies below
// d (d = 112: the second block's last four threads hold no columns).
// Ragged query and key edges are masked here, so the wrapper pads nothing.
// Tensor cores (mma / wgmma), TMA and a pipelined ring of tiles are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PSTRIDE = BK + 4;  // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

// 16-byte loads, converted to float32
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int H, int KV, int causal, int q_offset, float scale,
             int n_qtiles) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][BQ], scaled
  float* Ks = Qs + D * BQ;                      // [D][BK]
  float* Vs = Ks + D * BK;                      // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][PSTRIDE]

  constexpr int VN = Vec<T>::N;
  constexpr int GROUPS = D / VN;  // 16-byte groups per row
  constexpr int CB = (D + 63) / 64;  // 4-column blocks per thread, 64 apart

  const int qt = n_qtiles - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score columns tx*4 .., output columns too
  // D is a multiple of 16; with D % 64 == 0 every column block is whole,
  // else the last one holds columns for the threads with tx * 4 < D % 64
  const bool last_cb = D % 64 == 0 || tx * 4 < D % 64;

  for (int e = tid; e < BQ * GROUPS; e += THREADS) {
    const int r = e % BQ, g = e / BQ;
    float buf[VN];
    if (q0 + r < sq) {
      Vec<T>::load(q + (((size_t)bi * sq + q0 + r) * H + h) * D + g * VN, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) buf[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) Qs[(g * VN + i) * BQ + r] = buf[i] * scale;
  }

  int kv_end = skv;
  if (causal) {
    const int last = min(q0 + BQ, sq) - 1 + q_offset;  // absolute position
    kv_end = min(skv, last + 1);
  }
  const int n_ktiles = (kv_end + BK - 1) / BK;

  float m_i[4], l_i[4], acc[4][4 * CB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * CB; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * GROUPS; e += THREADS) {
      const int r = e % BK, g = e / BK;
      float buf[VN];
      if (k0 + r < skv) {
        Vec<T>::load(k + (((size_t)bi * skv + k0 + r) * KV + kvh) * D + g * VN,
                     buf);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) buf[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) Ks[(g * VN + i) * BK + r] = buf[i];
    }
    for (int e = tid; e < BK * GROUPS; e += THREADS) {
      const int r = e / GROUPS, g = e % GROUPS;
      float buf[VN];
      if (k0 + r < skv) {
        Vec<T>::load(v + (((size_t)bi * skv + k0 + r) * KV + kvh) * D + g * VN,
                     buf);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) buf[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < VN; i += 4)
        *reinterpret_cast<float4*>(&Vs[r * D + g * VN + i]) =
            make_float4(buf[i], buf[i + 1], buf[i + 2], buf[i + 3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[kk * BQ + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ks[kk * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        if (kpos >= skv || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of one row group are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CB; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * PSTRIDE + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PSTRIDE + kk]);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          if (cb == CB - 1 && !last_cb) continue;
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * D + cb * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][cb * 4 + 0] = fmaf(p[i][u], vv.x, acc[i][cb * 4 + 0]);
            acc[i][cb * 4 + 1] = fmaf(p[i][u], vv.y, acc[i][cb * 4 + 1]);
            acc[i][cb * 4 + 2] = fmaf(p[i][u], vv.z, acc[i][cb * 4 + 2]);
            acc[i][cb * 4 + 3] = fmaf(p[i][u], vv.w, acc[i][cb * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
    T* o = out + (((size_t)bi * sq + row) * H + h) * D;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (cb == CB - 1 && !last_cb) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(o + cb * 64 + tx * 4 + j, acc[i][cb * 4 + j] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int H, int KV, int causal, int q_offset,
           cudaStream_t s) {
  const int smem = (D * BQ + D * BK + BK * D + BQ * PSTRIDE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  dim3 grid(n_qtiles, H, b);
  flash_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, H, KV, causal,
      q_offset, 1.0f / sqrtf((float)D), n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16; d in {64, 112, 128}.  The wrapper checks
// shapes, strides (contiguous), alignment and q_offset >= 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int sq, int skv, int H, int KV,
                           int d, int causal, int q_offset, int dtype,
                           void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, b, sq, skv, H, KV, causal,
                             q_offset, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, b, sq, skv, H, KV, causal,
                              q_offset, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, b, sq, skv, H, KV, causal,
                                     q_offset, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, b, sq, skv, H, KV, causal,
                                      q_offset, s);
  if (dtype == 0 && d == 112)
    return launch<float, 112>(q, k, v, out, b, sq, skv, H, KV, causal,
                              q_offset, s);
  if (dtype == 1 && d == 112)
    return launch<__nv_bfloat16, 112>(q, k, v, out, b, sq, skv, H, KV, causal,
                                      q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
