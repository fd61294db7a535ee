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
// What bounds it on this card: at the serving prefill of qwen2-0.5b
// (b = 8, s = 1024, H = 14, KV = 2, d = 64, causal) 15.05 GFLOP against
// 33.6 MB: operations, 0.0152 ms on the bf16 tensor cores (989 TFLOP/s).
// At zamba2-7b's shared attention (H = KV = 32, d = 112) 60.2 GFLOP against
// 234.9 MB: bytes, 0.0701 ms at 3.35 TB/s.
//
// bfloat16: one block of two 128-thread warpgroups per (128-row query
// tile, head, batch row), heaviest causal tiles first (the query tile is
// the slowest grid axis, reversed).  Each warpgroup owns 64 query rows and
// both share every K and V tile the block loads, which halves the tile
// traffic from L2 against one warpgroup per block; a warpgroup skips the
// tiles past its own causal frontier.  Both products run on the tensor
// cores through wgmma.mma_async with float32 accumulators:
//   S = Q K^T   m64n64k16, A = the Q tile and B = the K tile, both in
//               shared memory, K-major (K is stored [key][d]);
//   O += P V    m64n{d}k16, A = P from registers, B = the V tile [key][d]
//               in shared memory read MN-major through the transpose bit,
//               so V is never transposed in memory.
// The float32 accumulator fragment of S, rounded to bf16 pairs, is already
// wgmma's register fragment of A, so P never goes through shared memory;
// rounding P to bf16 before P V is the reference's p.astype(v.dtype).  The
// scale multiplies the float32 scores (1/sqrt(112) is not a power of two;
// rounding q * scale to bf16 would lose bits the reference keeps).
// Q, K and V tiles come by TMA (cp.async.bulk.tensor, 4-D tensor maps over
// (b, s, heads, d), so the KV head is read in place) with 128-byte
// swizzle, the layout wgmma's descriptors read, into a ring of two
// 64-key stages completed on mbarriers: while one tile is in the tensor
// cores the next is in flight.  TMA zero-fills rows
// past skv and sq.  The causal and skv masks apply only to the tiles that
// cross the diagonal or skv; the tiles below take the unmasked path.
// Layout at d = 112: 224-byte rows are not whole 128-byte swizzle atoms,
// so each tile is two 64-column sub-tiles in shared memory and the tensor
// map's extent of 112 zero-fills columns 112..127 of the second.  Q K^T
// issues 7 k16 steps (columns 0..111; the padding is never multiplied) and
// P V is one m64n112k16 per 16 keys, whose two column blocks lie a
// sub-tile apart (the descriptor's leading offset).
//
// With a non-null `lse` (the trainable form, FlashAttentionFn) each row's
// log-sum-exp of the scaled logits goes out too, float32 (b, H, sq): the
// backward (flash_attention_bwd.cu) rebuilds P = exp(S - LSE) from it.
// In bfloat16 the trainable form also takes `out_lo`, the bf16 residual of
// each output element (the output's float32 value as bf16 hi + lo): the
// backward's Delta = rowsum(dO o out) from the rounded output alone put dQ
// past its 5e-2 hold against the float32 plain backward at `train`'s shape
// (tests/test_torch_flash_bwd_hopper.py).  Inference passes null for both
// and writes nothing more.
//
// float32 keeps the FMA kernel below (TF32 would break the 5e-5 float32
// tolerance): one 256-thread block per (64-row query tile, head, batch),
// the scaled query tile and K (transposed) and V staged in shared memory,
// 4 x 4 score patches per thread, probabilities through shared memory, a
// 4 x (4 per 64 columns) patch of the output in registers.  Nothing on the
// serving path runs float32 attention.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA (sm_90a)
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;  // query rows per consumer warpgroup
constexpr int WG_GROUPS = 2;  // consumer warpgroups per block
constexpr int WG_BQ = WG_ROWS * WG_GROUPS;  // query rows per block
constexpr int WG_BK = 64;    // keys per tile
constexpr int WG_THREADS = 128 * WG_GROUPS;

template <int D>
struct Tiles {
  static constexpr int NSUB = (D + 63) / 64;  // 64-column sub-tiles
  static constexpr int KSTEPS = D / 16;       // k16 steps of Q K^T
  static constexpr int WG_Q_BYTES = NSUB * WG_ROWS * ROW_BYTES;
  static constexpr int Q_BYTES = WG_GROUPS * WG_Q_BYTES;
  static constexpr int KV_BYTES = NSUB * WG_BK * ROW_BYTES;  // one K or V tile
  // two stages: a third (at d = 64, 65 KB of shared memory a block, not
  // 49) measured slower on the H100
  static constexpr int STAGES = 2;
  // 1024 bytes of slack to align the tiles to the 1024-byte swizzle period
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
};


template <int D>
__global__ void __launch_bounds__(WG_THREADS, D <= 112 ? 2 : 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
            __nv_bfloat16* __restrict__ out_lo, int sq, int skv, int H,
            int KV, int causal, int q_offset, float scale_log2) {
  using T = Tiles<D>;
  constexpr int STAGES = T::STAGES, BK = WG_BK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];  // Q, then each stage

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq_tiles = base;  // [GROUPS][NSUB][64 rows][64] bf16
  const uint32_t skv_tiles = base + T::Q_BYTES;  // per stage: K, then V
  const uint32_t bar_q = smem_u32(&bars[0]);

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_BQ;  // heaviest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // consumer warpgroup: rows qw .. qw + 63
  const int qw = q0 + wg * WG_ROWS;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const uint32_t sq_tile = sq_tiles + wg * T::WG_Q_BYTES;

  // the block loads key tiles [0, n_tiles), those some row of it reaches;
  // this warpgroup computes tiles [0, my_tiles), of which [0, n_full) lie
  // wholly inside skv and at or below its first row's causal frontier.
  // The warpgroup holding the block's last row has my_tiles == n_tiles,
  // so every stage's phases complete in order.
  int kv_end = skv, my_end = skv, n_full = skv / BK;
  if (causal) {
    kv_end = min(skv, min(q0 + WG_BQ, sq) + q_offset);
    my_end = min(skv, min(qw + WG_ROWS, sq) + q_offset);
    n_full = min(n_full, (qw + q_offset + 1) / BK);
  }
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int my_tiles = qw < sq ? (my_end + BK - 1) / BK : 0;

  auto load_kv = [&](int tile, int stage) {
    const uint32_t bar = smem_u32(&bars[1 + stage]);
    const uint32_t dst = skv_tiles + stage * 2 * T::KV_BYTES;
    mbar_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
    for (int s = 0; s < T::NSUB; ++s) {
      tma_load_4d(dst + s * BK * ROW_BYTES, &tk, bar, s * 64, kvh,
                  tile * BK, bi);
      tma_load_4d(dst + T::KV_BYTES + s * BK * ROW_BYTES, &tv, bar, s * 64,
                  kvh, tile * BK, bi);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
    for (int g = 0; g < WG_GROUPS; ++g)
#pragma unroll
      for (int s = 0; s < T::NSUB; ++s)
        tma_load_4d(sq_tiles + g * T::WG_Q_BYTES + s * WG_ROWS * ROW_BYTES,
                    &tq, bar_q, s * 64, h, q0 + g * WG_ROWS, bi);
    for (int t = 0; t < STAGES && t < n_tiles; ++t) load_kv(t, t);
  }

  // this thread's rows of the tile: r0 and r0 + 8; its columns in each
  // 8-column group: c0 and c0 + 1 (wgmma's accumulator fragment)
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    if (t < my_tiles) {  // tiles past this warpgroup's frontier: none
      const uint32_t sk = skv_tiles + stage * 2 * T::KV_BYTES;
      const uint32_t sv = sk + T::KV_BYTES;
      mbar_wait(smem_u32(&bars[1 + stage]), (t / STAGES) & 1);

      // S = Q K^T: k16 step kk reads 32 bytes into sub-tile kk / 4
      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint32_t qa = sq_tile + (kk / 4) * WG_ROWS * ROW_BYTES + off;
        const uint32_t ka = sk + (kk / 4) * BK * ROW_BYTES + off;
        wgmma_ss_n64(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // masks only where the tile needs them
      if (t >= n_full) {
        const int k0 = t * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + c0 + e;
              const int qpos = qw + r0 + 8 * i + q_offset;
              if (kpos >= skv || (causal && kpos > qpos))
                s[4 * j + 2 * i + e] = NEG_INF;
            }
      }

      // online softmax over the row, held by the four lanes of a quad; the
      // max is taken on the raw scores and the scale (in the log2 domain)
      // enters each exponent through one fma
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_r[i];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = exp2f((m_r[i] - mx) * scale_log2);
        m_r[i] = mx;
        const float bias = -mx * scale_log2;
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[4 * j + 2 * i + e], scale_log2, bias));
            s[4 * j + 2 * i + e] = p;
            rs += p;
          }
        l_r[i] = l_r[i] * alpha[i] + rs;  // this lane's part of the row sum
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }

      // P (bf16) as wgmma's A fragments, one per 16 keys
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V: 16 keys are 16 rows of 128 bytes in every V sub-tile; the
      // sub-tiles (64 columns each) lie KV sub-tile bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<D>(
            o, pa[kk],
            sw128_desc(sv + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
    }

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && t + STAGES < n_tiles) load_kv(t + STAGES, stage);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = qw + r0 + 8 * i;
    if (row >= sq) continue;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    // the row's log-sum-exp of the scaled logits, for the backward
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)bi * H + h) * sq + row] =
          (m_r[i] * scale_log2 + log2f(fmaxf(l, 1e-30f))) *
          0.6931471805599453f;
    const size_t off = (((size_t)bi * sq + row) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = o[4 * j + 2 * i] * inv, v1 = o[4 * j + 2 * i + 1] * inv;
      const uint32_t hi = pack_bf16(v0, v1);
      *reinterpret_cast<uint32_t*>(out + off + 8 * j) = hi;
      if (out_lo != nullptr) {  // what the bf16 output misses, for Delta
        const float2 hf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
        *reinterpret_cast<uint32_t*>(out_lo + off + 8 * j) =
            pack_bf16(v0 - hf.x, v1 - hf.y);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, void* out_lo, int b, int sq, int skv, int H,
                 int KV, int causal, int q_offset, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, b, sq, H, D, WG_ROWS) ||
      !tensor_map(&tk, k, b, skv, KV, D, WG_BK) ||
      !tensor_map(&tv, v, b, skv, KV, D, WG_BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Tiles<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, b, (sq + WG_BQ - 1) / WG_BQ);
  flash_wgmma<D><<<grid, WG_THREADS, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse,
      static_cast<__nv_bfloat16*>(out_lo), sq, skv, H, KV, causal, q_offset,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PSTRIDE = BK + 4;  // row stride of the probability tile

// 16-byte loads
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

__device__ inline void store(float* p, float v) { *p = v; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int sq, int skv, int H, int KV,
             int causal, int q_offset, float scale, int n_qtiles) {
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
    if (lse != nullptr && tx == 0)
      lse[((size_t)bi * H + h) * sq + row] =
          m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
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
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int sq, int skv, int H, int KV, int causal,
           int q_offset, cudaStream_t s) {
  const int smem = (D * BQ + D * BK + BK * D + BQ * PSTRIDE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  dim3 grid(n_qtiles, H, b);
  flash_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, skv, H, KV,
      causal, q_offset, 1.0f / sqrtf((float)D), n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); d in
// {64, 112, 128}.  lse may be null (inference); else it receives each
// row's log-sum-exp of the scaled logits, float32 (b, H, sq), which the
// backward (flash_attention_bwd.cu) reads.  out_lo (bfloat16 only, may be
// null) receives the bf16 rounding residual of each output element, so
// that out + out_lo carries the float32 output to the backward's Delta.
// The wrapper checks shapes, strides (contiguous), alignment and
// q_offset >= 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, float* lse, void* out_lo, int b, int sq,
                           int skv, int H, int KV, int d, int causal,
                           int q_offset, int dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64)
    return launch_wgmma<64>(q, k, v, out, lse, out_lo, b, sq, skv, H, KV,
                            causal, q_offset, s);
  if (dtype == 1 && d == 112)
    return launch_wgmma<112>(q, k, v, out, lse, out_lo, b, sq, skv, H, KV,
                             causal, q_offset, s);
  if (dtype == 1 && d == 128)
    return launch_wgmma<128>(q, k, v, out, lse, out_lo, b, sq, skv, H, KV,
                             causal, q_offset, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, lse, b, sq, skv, H, KV, causal,
                             q_offset, s);
  if (dtype == 0 && d == 112)
    return launch<float, 112>(q, k, v, out, lse, b, sq, skv, H, KV, causal,
                              q_offset, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, lse, b, sq, skv, H, KV, causal,
                              q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
