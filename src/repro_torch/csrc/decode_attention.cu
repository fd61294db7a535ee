// decode_attention: split-KV attention of one query per head over a cache,
// in one launch.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:
// decode_attention_kernel_call (body _decode_kernel) and its exact
// log-sum-exp merge combine_splits.  q (b, H, d) and caches
// (b, S_max, KV, d), float32 or bfloat16; only positions < cache_len are
// read.  Each split keeps a float32 partial (m, l, acc) per head; the
// splits merge exactly: with m* = max_s m_s and w_s = exp(m_s - m*),
// out = sum_s w_s acc_s / sum_s w_s l_s, in q's dtype.
//
// What bounds it on this card: bytes.  One decode step of qwen2-0.5b
// (b = 8, KV = 2, d = 64, cache length about 1,055) reads 4.3 MB of K and
// V per layer: 1.3 us at 3.35 TB/s; zamba2-7b's shared attention (b = 8,
// KV = 32, d = 112, about 1,039) reads 119 MB: 35.6 us.
//
// Design: one block per (split, KV head, batch row), and the splits of one
// (batch row, KV head) form a thread-block cluster (at most 8, the
// portable size).  The wrapper sizes the splits to cache_len
// (kernels/decode_attention/ops.py: split_plan): enough splits for about
// one wave of the 132 SMs, none of them empty.  A block serves all H / KV
// query heads of its KV group, so each K and V row is read from device
// memory once per group.  Rows come into shared memory in the cache's own
// dtype by 16-byte cp.async copies kept ahead of the compute, padded by 16
// bytes so the lanes of a warp reading different rows hit different banks.
// After a cluster barrier block rank 0 reads the other blocks' partials
// through distributed shared memory, merges and writes the output; a
// second barrier keeps the others resident until it has read them.  No
// scratch tensor, no second launch.
//
// bfloat16 with at most 16 query heads per KV head (both serving models):
// warp_kernel, 4 warps, each an independent flash-decoding lane over its
// own 16-row pieces of the split (piece j goes to warp j % 4) with its own
// ring of 3 pieces, so no block barrier stands in the loop.  Both
// products run on the tensor cores (mma.sync m16n8k16, float32
// accumulators; the group's heads, padded to 16, are the rows): S = Q K^T
// reads its B fragments straight from the staged K rows; the running max,
// the weights and l stay in registers; the accumulator fragment of S,
// rounded to bf16, is P V's A fragment, and V's B fragments come by
// ldmatrix.trans.  q * scale and P are rounded to bf16, the plain
// version's own roundings.  At the end the four warps' (m, l, O) merge
// exactly in shared memory.  A block-wide pass per chunk (scores, a warp
// per head's softmax, P V, each ending in a block barrier) spent most of
// its time waiting on those dependent phases.
//
// float32, and bfloat16 with more heads per KV head: chunk_kernel, 256
// threads, a block-wide pass per chunk of 32 rows on the FMA units:
// scores one thread per (head, row), each head's max and sum one warp,
// then P V per 16-byte column piece over row slices summed by warp
// shuffles into a float32 acc in shared memory.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of a staged row as float32
__device__ inline void load_piece(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ inline void load_piece(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// dot of a float32 row (shared memory) with a staged cache row
template <typename T, int D>
__device__ inline float dot_row(const float* q, const T* k) {
  constexpr int PIECE = 16 / (int)sizeof(T);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; c += PIECE) {
    float x[PIECE];
    load_piece(k + c, x);
#pragma unroll
    for (int i = 0; i < PIECE; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q + c + i);
      acc = fmaf(a.x, x[i], acc);
      acc = fmaf(a.y, x[i + 1], acc);
      acc = fmaf(a.z, x[i + 2], acc);
      acc = fmaf(a.w, x[i + 3], acc);
    }
  }
  return acc;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N groups of this thread's copies are in flight
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of a 16 x 8 tile of a row-major [k][n] bf16 matrix: lanes
// 0-15 give the addresses of its 16 rows
__device__ inline void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                         const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// The exact merge of the cluster's partials (acc [G][D], m, l [G] in each
// block's shared memory) by block rank 0, which writes out [G][D]: first
// each split's weight per head, W[s][g] = w_s / sum_s' w_s' l_s' (W:
// MAX_SPLITS x G floats of rank 0's shared memory), then out = sum_s
// W[s][g] acc_s.  The remote reads of all splits are issued together.
template <typename T, int D, int NT>
__device__ void cluster_merge(float* acc, float* m, float* l, float* W,
                              T* out, int G) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int g = tid; g < G; g += NT) {
      float mv[MAX_SPLITS], lv[MAX_SPLITS];
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s) {
        mv[s] = s < n_splits ? cluster.map_shared_rank(m, s)[g] : NEG_INF;
        lv[s] = s < n_splits ? cluster.map_shared_rank(l, s)[g] : 0.0f;
      }
      float m_tot = NEG_INF;
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s) m_tot = fmaxf(m_tot, mv[s]);
      float l_tot = 0.0f;
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s) {
        mv[s] = expf(mv[s] - m_tot);  // the split's weight; 0 past n_splits
        l_tot = fmaf(lv[s], mv[s], l_tot);
      }
      const float inv = 1.0f / fmaxf(l_tot, 1e-30f);
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        if (s < n_splits) W[s * G + g] = mv[s] * inv;
    }
    __syncthreads();
    for (int e = tid; e < G * D / 4; e += NT) {
      const int g = 4 * e / D;
      float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s) {
        if (s >= n_splits) break;
        const float4 a =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, s))[e];
        const float w = W[s * G + g];
        num.x = fmaf(w, a.x, num.x);
        num.y = fmaf(w, a.y, num.y);
        num.z = fmaf(w, a.z, num.z);
        num.w = fmaf(w, a.w, num.w);
      }
      store(out + 4 * e, num.x);
      store(out + 4 * e + 1, num.y);
      store(out + 4 * e + 2, num.z);
      store(out + 4 * e + 3, num.w);
    }
  }
  cluster.sync();  // keep every block's partial alive until rank 0 read it
}

// ---------------------------------------------------------------------------
// bfloat16, at most 16 heads per KV head: one flash-decoding lane per warp
// ---------------------------------------------------------------------------

constexpr int WK_WARPS = 4;
constexpr int WK_THREADS = 32 * WK_WARPS;
constexpr int WK_ROWS = 16;   // cache rows of one piece
constexpr int WK_STAGES = 3;  // pieces in a warp's ring

// shared memory in byte offsets: Qb bf16 [16][D + 8] (q * scale, heads
// padded to 16), the warps' rings of WK_STAGES pieces (K then V, rows of
// D + 8), which after the loop hold the warps' partials O [warp][16][D],
// then m and l [warp][16] (f32), then the block's partial acc [16][D], m,
// l [16] and the merge's weights W [MAX_SPLITS][16] (f32)
template <int D>
struct WarpSmem {
  static constexpr int RS = D + 8;  // staged row stride, elements
  static constexpr int PIECE = 2 * WK_ROWS * RS;  // elements of a K + V piece
  static constexpr int RING = WK_WARPS * WK_STAGES * PIECE * 2;
  static constexpr int PART = WK_WARPS * 16 * (D + 2) * 4;
  static constexpr int RING_OFF = align16(16 * RS * 2);
  static constexpr int ACC_OFF = RING_OFF + align16(RING > PART ? RING : PART);
  static constexpr int M_OFF = ACC_OFF + 16 * D * 4;
  static constexpr int L_OFF = M_OFF + 16 * 4;
  static constexpr int W_OFF = L_OFF + 16 * 4;
  static constexpr int TOTAL = W_OFF + MAX_SPLITS * 16 * 4;
};

template <int D>
__global__ void __launch_bounds__(WK_THREADS)
warp_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ kc,
            const __nv_bfloat16* __restrict__ vc,
            __nv_bfloat16* __restrict__ out, int H, int KV, int smax,
            int cache_len, int split_len, float scale) {
  using S = WarpSmem<D>;
  constexpr int RS = S::RS;
  constexpr int PIECES = D / 8;  // 16-byte copies per row

  const int split = (int)cg::this_cluster().block_rank();
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int G = H / KV;  // <= 16
  const int h0 = kvh * G;
  const int start = split * split_len;
  const int len = min(split_len, cache_len - start);  // >= 1 by the plan
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, qd = 2 * (lane % 4);  // mma fragment coordinates

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(base + S::RING_OFF) +
      warp * WK_STAGES * S::PIECE;
  float* part = reinterpret_cast<float*>(base + S::RING_OFF);
  float* Acc = reinterpret_cast<float*>(base + S::ACC_OFF);
  float* M = reinterpret_cast<float*>(base + S::M_OFF);
  float* L = reinterpret_cast<float*>(base + S::L_OFF);
  float* W = reinterpret_cast<float*>(base + S::W_OFF);

  // this warp's i-th piece (rows 16 j .. of the split, j = warp + 4 i)
  // into its stage i % WK_STAGES; an empty group past the end keeps the
  // count of groups in flight uniform
  auto issue = [&](int i) {
    const int r0 = WK_ROWS * (warp + WK_WARPS * i);
    if (r0 < len) {
      const int rows = min(WK_ROWS, len - r0);
      __nv_bfloat16* ks = ring + (i % WK_STAGES) * S::PIECE;
      __nv_bfloat16* vs = ks + WK_ROWS * RS;
      for (int e = lane; e < rows * PIECES; e += 32) {
        const int r = e / PIECES, p = (e % PIECES) * 8;
        const size_t g =
            (((size_t)bi * smax + start + r0 + r) * KV + kvh) * D + p;
        cp_async16(ks + r * RS + p, kc + g);
        cp_async16(vs + r * RS + p, vc + g);
      }
    }
    cp_async_commit();
  };

  for (int i = 0; i < WK_STAGES - 1; ++i) issue(i);
  for (int e = tid; e < 16 * D; e += WK_THREADS) {
    const int g = e / D;
    const float x =
        g < G ? __bfloat162float(q[((size_t)bi * H + h0) * D + e]) * scale
              : 0.0f;
    Qb[g * RS + e % D] = __float2bfloat16(x);
  }
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of q * scale
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* qrow = Qb + grp * RS + 16 * kk + qd;
    qa[kk][0] = ld32(qrow);
    qa[kk][1] = ld32(qrow + 8 * RS);
    qa[kk][2] = ld32(qrow + 8);
    qa[kk][3] = ld32(qrow + 8 * RS + 8);
  }

  // this thread's heads grp and grp + 8: running max, l (its lanes' part)
  // and O's columns 8 n + qd, + 1
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;

  for (int i = 0; WK_ROWS * (warp + WK_WARPS * i) < len; ++i) {
    issue(i + WK_STAGES - 1);  // into the stage piece i - 1 freed
    cp_async_wait<WK_STAGES - 1>();
    __syncwarp();  // every lane's copies of piece i are visible
    const int rows = min(WK_ROWS, len - WK_ROWS * (warp + WK_WARPS * i));
    const __nv_bfloat16* ks = ring + (i % WK_STAGES) * S::PIECE;
    __nv_bfloat16* vs = ring + (i % WK_STAGES) * S::PIECE + WK_ROWS * RS;
    if (rows < WK_ROWS) {
      // rows past the split enter P V with weight 0; zero them, since
      // 0 x (stale NaN) would be NaN
      for (int e = lane; e < (WK_ROWS - rows) * D; e += 32)
        vs[(rows + e / D) * RS + e % D] = __float2bfloat16(0.0f);
      __syncwarp();
    }

    // S = Q K^T over two 8-key tiles: s[t][2 h + e] is head grp + 8 h,
    // key 8 t + qd + e
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const __nv_bfloat16* krow = ks + (8 * t + grp) * RS + qd;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[t][j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[t], qa[kk], ld32(krow + 16 * kk), ld32(krow + 16 * kk + 8));
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * t + qd + e >= rows) s[t][e] = s[t][2 + e] = NEG_INF;
    }

    // online softmax of each head over the piece's keys, held by the four
    // lanes of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, m_r[h]);
      const float alpha = expf(m_r[h] - mx);
      m_r[h] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[t][2 * h + e] = expf(s[t][2 * h + e] - mx);
          rs += s[t][2 * h + e];
        }
      l_r[h] = l_r[h] * alpha + rs;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator fragment, rounded to bf16, is the A
    // fragment of one k16 step
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, vs + (lane % 16) * RS + 8 * n);
      mma_bf16(o[n], pa, b0, b1);
    }
    __syncwarp();  // the stage is free for the copy issued next
  }

  // the four warps' partials merge exactly into the block's (the rings
  // are free once every warp is past its loop)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  __syncthreads();
  float* ow = part + warp * 16 * D;
  float* ml = part + WK_WARPS * 16 * D;  // m [warp][16], then l [warp][16]
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ow[(grp + 8 * h) * D + 8 * n + qd] = o[n][2 * h];
      ow[(grp + 8 * h) * D + 8 * n + qd + 1] = o[n][2 * h + 1];
    }
  if (lane % 4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml[warp * 16 + grp + 8 * h] = m_r[h];
      ml[(WK_WARPS + warp) * 16 + grp + 8 * h] = l_r[h];
    }
  __syncthreads();
  for (int e = tid; e < G * D; e += WK_THREADS) {
    const int g = e / D;
    float mt = NEG_INF;
#pragma unroll
    for (int w = 0; w < WK_WARPS; ++w) mt = fmaxf(mt, ml[w * 16 + g]);
    float acc = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < WK_WARPS; ++w) {
      const float x = expf(ml[w * 16 + g] - mt);  // 0 for a warp with no rows
      acc = fmaf(x, part[(w * 16 + g) * D + e % D], acc);
      lsum = fmaf(x, ml[(WK_WARPS + w) * 16 + g], lsum);
    }
    Acc[e] = acc;
    if (e % D == 0) {
      M[g] = mt;
      L[g] = lsum;
    }
  }
  cluster_merge<__nv_bfloat16, D, WK_THREADS>(
      Acc, M, L, W, out + ((size_t)bi * H + h0) * D, G);
}

// ---------------------------------------------------------------------------
// float32, and bfloat16 with more heads per KV head: a block pass per chunk
// ---------------------------------------------------------------------------

constexpr int CK_THREADS = 256;
constexpr int CK_WARPS = CK_THREADS / 32;
constexpr int CK_ROWS = 32;   // cache rows of a chunk
constexpr int CK_STAGES = 3;  // chunks in the ring

// shared memory in byte offsets for G heads: Acc [G][D] f32, M, L, Alpha
// [G] f32, Ps [G][CK_ROWS] f32 (scores, then weights; the merge's W after
// the loop), Qs [G][D] f32 (q * scale), then the ring of CK_STAGES
// (K, V) chunks of rows of RS elements
template <typename T, int D>
struct ChunkSmem {
  static constexpr int RS = D + 16 / (int)sizeof(T);
  int m, l, alpha, ps, q, ring, total;
  __host__ __device__ explicit ChunkSmem(int G) {
    m = align16(G * D * 4);
    l = m + align16(G * 4);
    alpha = l + align16(G * 4);
    ps = alpha + align16(G * 4);
    q = ps + align16(G * CK_ROWS * 4);
    ring = q + align16(G * D * 4);
    total = ring + CK_STAGES * 2 * CK_ROWS * RS * (int)sizeof(T);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(CK_THREADS)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, T* __restrict__ out, int H, int KV,
             int smax, int cache_len, int split_len, float scale) {
  constexpr int CH = CK_ROWS, RS = ChunkSmem<T, D>::RS;
  constexpr int PIECE = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int PIECES = D / PIECE;           // copies per row

  const int split = (int)cg::this_cluster().block_rank();
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int G = H / KV;
  const int h0 = kvh * G;
  const int start = split * split_len;
  const int len = min(split_len, cache_len - start);  // >= 1 by the plan
  const int n_chunks = (len + CH - 1) / CH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const ChunkSmem<T, D> lay(G);
  float* Acc = reinterpret_cast<float*>(base);
  float* M = reinterpret_cast<float*>(base + lay.m);
  float* L = reinterpret_cast<float*>(base + lay.l);
  float* Alpha = reinterpret_cast<float*>(base + lay.alpha);
  float* Ps = reinterpret_cast<float*>(base + lay.ps);
  float* Qs = reinterpret_cast<float*>(base + lay.q);
  T* ring = reinterpret_cast<T*>(base + lay.ring);

  // chunk c of the split into its stage (an empty group past the end keeps
  // the count of groups in flight uniform)
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int r0 = c * CH, rows = min(CH, len - r0);
      T* ks = ring + (c % CK_STAGES) * 2 * CH * RS;
      T* vs = ks + CH * RS;
      for (int e = tid; e < rows * PIECES; e += CK_THREADS) {
        const int r = e / PIECES, p = (e % PIECES) * PIECE;
        const size_t g =
            (((size_t)bi * smax + start + r0 + r) * KV + kvh) * D + p;
        cp_async16(ks + r * RS + p, kc + g);
        cp_async16(vs + r * RS + p, vc + g);
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < CK_STAGES - 1; ++c) issue(c);
  for (int e = tid; e < G * D; e += CK_THREADS) {
    Qs[e] = to_float(q[((size_t)bi * H + h0) * D + e]) * scale;
    Acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += CK_THREADS) {
    M[g] = NEG_INF;
    L[g] = 0.0f;
  }
  // P x V work: items (head, 16-byte column piece), each over `sl` row
  // slices (a power of two: rows slice, slice + sl, ...).  A warp holds
  // 32 / sl items x sl slices, slice-major, so a slice's lanes read
  // neighbouring pieces of one row and the slices sum by shuffles.
  const int items = G * PIECES;
  int sl = 1;
  while (sl < 32 && items * sl * 2 <= CK_THREADS) sl *= 2;
  const int iw = 32 / sl;
  const int slot = warp * iw + lane % iw, slice = lane / iw;

  for (int c = 0; c < n_chunks; ++c) {
    issue(c + CK_STAGES - 1);  // into the stage the previous chunk freed
    cp_async_wait<CK_STAGES - 1>();  // this thread's copies of chunk c
    __syncthreads();                  // and everyone's
    const T* ks = ring + (c % CK_STAGES) * 2 * CH * RS;
    const T* vs = ks + CH * RS;
    const int rows = min(CH, len - c * CH);

    for (int e = tid; e < G * CH; e += CK_THREADS) {
      const int g = e / CH, r = e % CH;
      if (r < rows) Ps[e] = dot_row<T, D>(Qs + g * D, ks + r * RS);
    }
    __syncthreads();

    // each head's running max and sum, one warp per head; the weights
    // replace the scores
    for (int g = warp; g < G; g += CK_WARPS) {
      float mx = M[g];
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, Ps[g * CH + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(Ps[g * CH + r] - mx);
        Ps[g * CH + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(M[g] - mx);
        Alpha[g] = alpha;
        L[g] = L[g] * alpha + sum;
        M[g] = mx;
      }
    }
    __syncthreads();

    // Acc = Acc * alpha + P V
    for (int base_it = 0; base_it < items; base_it += CK_WARPS * iw) {
      const int it = base_it + slot;  // uniform trip count: shuffles
      const int g = min(it, items - 1) / PIECES;
      const int col = (min(it, items - 1) % PIECES) * PIECE;
      float acc[PIECE];
#pragma unroll
      for (int i = 0; i < PIECE; ++i) acc[i] = 0.0f;
      if (it < items) {
        for (int r = slice; r < rows; r += sl) {
          const float p = Ps[g * CH + r];
          float x[PIECE];
          load_piece(vs + r * RS + col, x);
#pragma unroll
          for (int i = 0; i < PIECE; ++i) acc[i] = fmaf(p, x[i], acc[i]);
        }
      }
      for (int off = iw; off < 32; off *= 2)
#pragma unroll
        for (int i = 0; i < PIECE; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      if (it < items && slice == 0) {
#pragma unroll
        for (int i = 0; i < PIECE; ++i)
          Acc[g * D + col + i] = fmaf(Acc[g * D + col + i], Alpha[g], acc[i]);
      }
    }
    __syncthreads();  // the stage and Ps are free again
  }
  cluster_merge<T, D, CK_THREADS>(Acc, M, L, Ps,
                                  out + ((size_t)bi * H + h0) * D, G);
}

// the kernel over a grid of (n_splits, KV, b) blocks, clusters of n_splits
template <typename T>
int launch_cluster(void (*kernel)(const T*, const T*, const T*, T*, int, int,
                                  int, int, int, float),
                   int threads, int smem, int b, int KV, int n_splits,
                   cudaStream_t s, const T* q, const T* k, const T* v, T* out,
                   int H, int smax, int cache_len, int split_len,
                   float scale) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, KV, b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, out, H, KV, smax, cache_len,
                           split_len, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int H, int KV, int smax, int cache_len, int n_splits,
           int split_len, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    if (H / KV <= 16)
      return launch_cluster<T>(warp_kernel<D>, WK_THREADS, WarpSmem<D>::TOTAL,
                               b, KV, n_splits, s, qt, kt, vt, ot, H, smax,
                               cache_len, split_len, scale);
  }
  return launch_cluster<T>(chunk_kernel<T, D>, CK_THREADS,
                           ChunkSmem<T, D>(H / KV).total, b, KV, n_splits, s,
                           qt, kt, vt, ot, H, smax, cache_len, split_len,
                           scale);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16; d in {64, 112, 128}.  The wrapper
// checks shapes, contiguity, alignment and 1 <= cache_len <= smax, and
// gives the split plan: 1 <= n_splits <= 8 splits of split_len positions
// with (n_splits - 1) * split_len < cache_len <= n_splits * split_len.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, int b, int H, int KV, int smax, int d,
                            int cache_len, int n_splits, int split_len,
                            int dtype, void* stream) {
  if (b == 0) return 0;
  if (n_splits < 1 || n_splits > MAX_SPLITS || split_len < 1 ||
      (n_splits - 1) * split_len >= cache_len ||
      n_splits * split_len < cache_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(T, D)                                                  \
  return launch<T, D>(q, k, v, out, b, H, KV, smax, cache_len, n_splits,    \
                      split_len, s)
  if (dtype == 0 && d == 64) REPRO_DECODE(float, 64);
  if (dtype == 0 && d == 112) REPRO_DECODE(float, 112);
  if (dtype == 0 && d == 128) REPRO_DECODE(float, 128);
  if (dtype == 1 && d == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == 1 && d == 112) REPRO_DECODE(__nv_bfloat16, 112);
  if (dtype == 1 && d == 128) REPRO_DECODE(__nv_bfloat16, 128);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
