// flash_attention_bwd: the backward of flash attention (FA2 style), causal or
// not, GQA read natively, deterministic.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel (its
// training differentiates the XLA twins repro.models.layers.gqa_attend and
// repro.models.transformer.chunked_gqa_attend).  It is the backward of
// FlashAttentionFn, whose forward is flash_attention.cu (the port of
// src/repro/kernels/flash_attention/kernel.py: flash_attention_kernel_call).
// q, dO, out (b, sq, H, d) and k, v (b, skv, KV, d), float32 or bfloat16;
// lse (b, H, sq) float32, each row's log-sum-exp of the scaled logits,
// written by the forward.  With scale = d^-1/2, S = (q K^T) scale and
// P = exp(S - LSE) (the forward's softmax, rebuilt without a max pass):
//   dV = P^T dO      dP = dO V^T      Delta = rowsum(dO o out)
// (in bfloat16 out is the forward's float32 output, carried as its bf16
// value plus the residual the forward wrote beside it)
//   dS = P o (dP - Delta)     dQ = dS K scale      dK = dS^T q scale
// with each KV head's dK and dV summed over its group of query heads.
//
// What bounds it on this card: operations.  10 d operations a visible
// (query, key) pair and head (the minimal count: S, dV, dP, dQ and dK);
// at train_whisper's encoder (b = 4, s = 1,500, H = 16, d = 64,
// non-causal) 92.2 GFLOP against 20 MB: 0.093 ms on the bf16 tensor cores.
// The design recomputes S and dP in both kernels (14 d a pair): the price
// of writing dQ without atomics.
//
// Two launches, no atomics, so two backward passes are bit-equal:
//  1. dq kernel, one block per (64-query tile, query head, batch row): its
//     prologue forms Delta for its rows (float32, from dO and out) and
//     writes it for launch 2; then it walks the key tiles its rows see
//     (causal: up to its last row's frontier, honouring q_offset) and
//     accumulates dQ = sum dS K in float32 registers.
//  2. dkdv kernel, one block per (64-key tile, KV head, batch row): it
//     walks every query head of its group and every query tile that sees
//     its keys (causal: from the first tile whose last row reaches them)
//     and accumulates dK and dV in float32 registers, in that fixed order.
// bfloat16: four warps, warp w owning 16 rows of the block's tile; every
// product on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators) with operands by ldmatrix from tiles staged by cp.async in
// a two-slot ring (the next (head, tile)'s Q and dO, or the next key
// tile's K and V, in flight while this one is in the tensor cores).  Tiles
// are bf16 rows of 64 or 128 columns (d = 112 padded to 128, the padding
// zero-filled and never multiplied), 16-byte pieces XOR-swizzled by row.
// S, dP and the accumulators stay in registers; the accumulator fragments
// of P and dS, rounded to bf16 (the plain backward's p.to(dtype) and
// ds.to(dtype)), are the A fragments of the next products, so neither goes
// through shared memory.  Inner steps take 32 queries (keys in the dq
// kernel) at a time, so dK, dV and two 16 x 32 tiles fit in registers at
// d = 128.
// float32: the same two kernels on the FMA units, 256 threads, tiles as
// float32 rows in shared memory, 4 x 4 patches of S and dP a thread, P and
// dS through shared memory.  Nothing on the serving path runs either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE_ROWS = 64;  // query or key rows of a block's tile
constexpr int MW = 4;          // bf16 kernels: warps, 16 rows each
constexpr int MT = 32 * MW;
constexpr int SUB = 32;        // queries (dkdv) or keys (dq) an inner step

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; valid == false writes zeros and reads nothing
__device__ inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two adjacent n8 accumulator tiles (16 x 16) as an m16k16 A fragment
__device__ inline void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// bf16 tiles: rows of RB bytes cut in 16-byte pieces; piece c of row r
// sits at piece c ^ (r % 8), so the 8 rows an ldmatrix reads fall in
// distinct banks
template <int RB>
__device__ inline uint32_t swz_el(int r, int col) {  // bf16 element offset
  return r * RB + ((((col >> 3) ^ (r & 7))) << 4) + ((col & 7) << 1);
}

// 64 rows of one head of a (b, s, heads, D) bf16 tensor into a swizzled
// tile of DP columns: `base` is the tile's first row, `rows` of them real;
// columns past D and rows past `rows` read as zeros
template <int D, int DP>
__device__ inline void stage_tile(uint32_t tile, const __nv_bfloat16* base,
                                  long long row_stride, int rows,
                                  const __nv_bfloat16* any) {
  constexpr int PC = DP / 8, RB = 2 * DP, RSTEP = MT / PC;
  const int c = threadIdx.x % PC, r0 = threadIdx.x / PC;
#pragma unroll
  for (int i = 0; i < TILE_ROWS / RSTEP; ++i) {
    const int r = r0 + i * RSTEP;
    const bool ok = c < D / 8 && r < rows;
    cp_async16(tile + r * RB + ((c ^ (r & 7)) << 4),
               ok ? base + r * row_stride + c * 8 : any, ok);
  }
}

template <int D>
struct Bf16Tiles {
  static constexpr int DP = D <= 64 ? 64 : 128;  // padded columns
  static constexpr int RB = 2 * DP;
  static constexpr int TILE = TILE_ROWS * RB;
  static constexpr int KS = D / 16;  // k16 steps over d, n16 pairs over d
  static constexpr int SMEM = 6 * TILE;  // two fixed tiles, a ring of two pairs
};

// ---------------------------------------------------------------------------
// bfloat16: dq kernel (and Delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ out_lo,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int sq, int skv, int H,
                  int KV, int causal, int q_offset, float scale,
                  int n_qtiles) {
  using T = Bf16Tiles<D>;
  constexpr int RB = T::RB, TILE = T::TILE, KS = T::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float delta_s[TILE_ROWS];
  const uint32_t sb = smem_u32(smem);
  const uint32_t Qs = sb, Ds = sb + TILE, KV0 = sb + 2 * TILE;

  const int q0 = (n_qtiles - 1 - blockIdx.x) * TILE_ROWS;  // heaviest first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, qd = lane % 4, lr = lane % 8, lm = lane / 8;
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;
  const __nv_bfloat16* qh = q + ((size_t)bi * sq + q0) * qstride + h * D;
  const __nv_bfloat16* dh = dout + ((size_t)bi * sq + q0) * qstride + h * D;
  const __nv_bfloat16* kh = k + (size_t)bi * skv * kstride + kvh * D;
  const __nv_bfloat16* vh = v + (size_t)bi * skv * kstride + kvh * D;

  int kv_end = skv;
  if (causal) kv_end = min(skv, min(q0 + TILE_ROWS, sq) + q_offset);
  const int n_kt = (kv_end + TILE_ROWS - 1) / TILE_ROWS;

  auto stage_kv = [&](int kt, int slot) {
    const uint32_t dst = KV0 + slot * 2 * TILE;
    const int rows = skv - kt * TILE_ROWS;
    stage_tile<D, T::DP>(dst, kh + kt * TILE_ROWS * kstride, kstride, rows,
                         k);
    stage_tile<D, T::DP>(dst + TILE, vh + kt * TILE_ROWS * kstride, kstride,
                         rows, v);
  };
  stage_tile<D, T::DP>(Qs, qh, qstride, sq - q0, q);
  stage_tile<D, T::DP>(Ds, dh, qstride, sq - q0, dout);
  if (n_kt > 0) stage_kv(0, 0);
  cp_async_commit();

  // Delta = rowsum(dO o out) in float32 for this warp's 16 rows, from the
  // output's float32 value (out + out_lo): the rounded output alone moves
  // Delta by a bf16 rounding of out, which dQ carries to every key
  const size_t row_bh = ((size_t)bi * H + h) * sq;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + 16 * warp + r;
    float acc = 0.0f;
    if (row < sq) {
      const size_t off = ((size_t)bi * sq + row) * qstride + h * D;
      for (int c = 2 * lane; c < D; c += 64) {
        float2 o2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + off + c));
        if (out_lo != nullptr) {  // the output's float32 value, hi + lo
          const float2 l2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(out_lo + off + c));
          o2.x += l2.x;
          o2.y += l2.y;
        }
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
        acc = fmaf(o2.x, d2.x, fmaf(o2.y, d2.y, acc));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      delta_s[16 * warp + r] = acc;
      if (row < sq) delta[row_bh + row] = acc;
    }
  }
  __syncwarp();
  const int rA = 16 * warp + gr, rB = rA + 8;  // this thread's tile rows
  const float dlA = delta_s[rA], dlB = delta_s[rB];
  const float l2A = q0 + rA < sq ? lse[row_bh + q0 + rA] * LOG2E : 0.0f;
  const float l2B = q0 + rB < sq ? lse[row_bh + q0 + rB] * LOG2E : 0.0f;
  const float scale_log2 = scale * LOG2E;

  float dqacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqacc[i][e] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int slot = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < n_kt) stage_kv(kt + 1, slot ^ 1);
    cp_async_commit();
    const uint32_t Ks = KV0 + slot * 2 * TILE, Vs = Ks + TILE;
    const int k0 = kt * TILE_ROWS;
#pragma unroll
    for (int sub = 0; sub < TILE_ROWS / SUB; ++sub) {
      const int ks0 = sub * SUB;
      // keys wholly past this warp's last row: nothing to add
      if (k0 + ks0 >= skv ||
          (causal && k0 + ks0 > q0 + 16 * warp + 15 + q_offset))
        continue;
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int i = 0; i < SUB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], da[4];
        ldmatrix_x4(qa, Qs + swz_el<RB>(16 * warp + lr + (lm & 1) * 8,
                                        16 * kk + (lm >> 1) * 8));
        ldmatrix_x4(da, Ds + swz_el<RB>(16 * warp + lr + (lm & 1) * 8,
                                        16 * kk + (lm >> 1) * 8));
#pragma unroll
        for (int nn = 0; nn < SUB / 16; ++nn) {
          uint32_t bk[4], bv[4];
          const int kr = ks0 + 16 * nn + lr + (lm >> 1) * 8;
          ldmatrix_x4(bk, Ks + swz_el<RB>(kr, 16 * kk + (lm & 1) * 8));
          ldmatrix_x4(bv, Vs + swz_el<RB>(kr, 16 * kk + (lm & 1) * 8));
          mma_bf16(s[2 * nn], qa, bk[0], bk[1]);
          mma_bf16(s[2 * nn + 1], qa, bk[2], bk[3]);
          mma_bf16(dp[2 * nn], da, bv[0], bv[1]);
          mma_bf16(dp[2 * nn + 1], da, bv[2], bv[3]);
        }
      }
      // P = exp(S - LSE) where the key is visible, dS = P (dP - Delta)
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + ks0 + 8 * nt + 2 * qd + (e & 1);
          const int row = q0 + (e < 2 ? rA : rB);
          const bool ok = row < sq && kpos < skv &&
                          !(causal && kpos > row + q_offset);
          const float p =
              ok ? exp2f(fmaf(s[nt][e], scale_log2, -(e < 2 ? l2A : l2B)))
                 : 0.0f;
          dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dlA : dlB));
        }
      // dQ += dS K: dS (bf16) as the A fragment, K [key][d] by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int pp = 0; pp < KS; ++pp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Ks + swz_el<RB>(ks0 + 16 * kk + lr + (lm & 1) * 8,
                                               16 * pp + (lm >> 1) * 8));
          mma_bf16(dqacc[2 * pp], a, b[0], b[1]);
          mma_bf16(dqacc[2 * pp + 1], a, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + (r ? rB : rA);
    if (row >= sq) continue;
    __nv_bfloat16* o = dq + ((size_t)bi * sq + row) * qstride + h * D + 2 * qd;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(o + 8 * nt) =
          pack_bf16(dqacc[nt][2 * r] * scale, dqacc[nt][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: dkdv kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int sq, int skv, int H,
                    int KV, int causal, int q_offset, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int RB = T::RB, TILE = T::TILE, KS = T::KS;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = smem_u32(smem);
  const uint32_t Ks = sb, Vs = sb + TILE, QD0 = sb + 2 * TILE;

  const int k0 = blockIdx.x * TILE_ROWS, kvh = blockIdx.y, bi = blockIdx.z;
  const int group = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, qd = lane % 4, lr = lane % 8, lm = lane / 8;
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;

  // the query tiles that see this key tile, for each head of the group
  const int n_qt = (sq + TILE_ROWS - 1) / TILE_ROWS;
  const int qt0 = causal ? min(n_qt, max(0, k0 - q_offset) / TILE_ROWS) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = group * per_head;

  const size_t kv_off = ((size_t)bi * skv + k0) * kstride + kvh * D;
  stage_tile<D, T::DP>(Ks, k + kv_off, kstride, skv - k0, k);
  stage_tile<D, T::DP>(Vs, v + kv_off, kstride, skv - k0, v);
  auto stage_q = [&](int it, int slot) {
    const int h = kvh * group + it / per_head;
    const int qs = (qt0 + it % per_head) * TILE_ROWS;
    const size_t off = ((size_t)bi * sq + qs) * qstride + h * D;
    const uint32_t dst = QD0 + slot * 2 * TILE;
    stage_tile<D, T::DP>(dst, q + off, qstride, sq - qs, q);
    stage_tile<D, T::DP>(dst + TILE, dout + off, qstride, sq - qs, dout);
  };
  if (n_it > 0) stage_q(0, 0);
  cp_async_commit();

  const int kA = k0 + 16 * warp + gr, kB = kA + 8;  // this thread's keys
  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[i][e] = dvacc[i][e] = 0.0f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    const int slot = it & 1;
    cp_async_wait_all();
    __syncthreads();  // pair `it` landed; every warp is done with it - 1
    if (it + 1 < n_it) stage_q(it + 1, slot ^ 1);
    cp_async_commit();
    const int h = kvh * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * TILE_ROWS;
    const uint32_t Qs = QD0 + slot * 2 * TILE, Ds = Qs + TILE;
    const float* lse_h = lse + ((size_t)bi * H + h) * sq;
    const float* dl_h = delta + ((size_t)bi * H + h) * sq;
#pragma unroll
    for (int sub = 0; sub < TILE_ROWS / SUB; ++sub) {
      const int qs0 = sub * SUB;
      // queries past sq, or all before this warp's first key: nothing
      if (q0 + qs0 >= sq ||
          (causal && q0 + qs0 + SUB - 1 + q_offset < k0 + 16 * warp))
        continue;
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x SUB queries
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int i = 0; i < SUB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Ks + swz_el<RB>(16 * warp + lr + (lm & 1) * 8,
                                        16 * kk + (lm >> 1) * 8));
        ldmatrix_x4(va, Vs + swz_el<RB>(16 * warp + lr + (lm & 1) * 8,
                                        16 * kk + (lm >> 1) * 8));
#pragma unroll
        for (int nn = 0; nn < SUB / 16; ++nn) {
          uint32_t bq[4], bd[4];
          const int qr = qs0 + 16 * nn + lr + (lm >> 1) * 8;
          ldmatrix_x4(bq, Qs + swz_el<RB>(qr, 16 * kk + (lm & 1) * 8));
          ldmatrix_x4(bd, Ds + swz_el<RB>(qr, 16 * kk + (lm & 1) * 8));
          mma_bf16(s[2 * nn], ka, bq[0], bq[1]);
          mma_bf16(s[2 * nn + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * nn], va, bd[0], bd[1]);
          mma_bf16(dp[2 * nn + 1], va, bd[2], bd[3]);
        }
      }
      // P^T and dS^T = P^T (dP^T - Delta), masked where a key is hidden
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + qs0 + 8 * nt + 2 * qd + (e & 1);
          const int kpos = e < 2 ? kA : kB;
          const bool ok = qpos < sq && kpos < skv &&
                          !(causal && kpos > qpos + q_offset);
          float p = 0.0f, dl = 0.0f;
          if (ok) {
            p = exp2f(fmaf(s[nt][e], scale_log2, -lse_h[qpos] * LOG2E));
            dl = dl_h[qpos];
          }
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl);
        }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T (bf16) as A fragments,
      // dO and Q [query][d] by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
        const int qr = qs0 + 16 * kk + lr + (lm & 1) * 8;
#pragma unroll
        for (int pp = 0; pp < KS; ++pp) {
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, Ds + swz_el<RB>(qr, 16 * pp + (lm >> 1) * 8));
          ldmatrix_x4_trans(bq, Qs + swz_el<RB>(qr, 16 * pp + (lm >> 1) * 8));
          mma_bf16(dvacc[2 * pp], pa, bo[0], bo[1]);
          mma_bf16(dvacc[2 * pp + 1], pa, bo[2], bo[3]);
          mma_bf16(dkacc[2 * pp], sa, bq[0], bq[1]);
          mma_bf16(dkacc[2 * pp + 1], sa, bq[2], bq[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? kB : kA;
    if (key >= skv) continue;
    const size_t off = ((size_t)bi * skv + key) * kstride + kvh * D + 2 * qd;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * nt) =
          pack_bf16(dkacc[nt][2 * r] * scale, dkacc[nt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * nt) =
          pack_bf16(dvacc[nt][2 * r], dvacc[nt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int FT = 256;            // threads
constexpr int PS = TILE_ROWS + 4;  // row stride of the P / dS tiles

template <int D>
struct F32Tiles {
  static constexpr int DS = D + 4;  // row stride of a d-wide tile
  static constexpr int ROWS = TILE_ROWS * DS;
  static constexpr int SMEM = (4 * ROWS + 2 * TILE_ROWS * PS) * 4;
};

// 64 rows of one head of a (b, s, heads, D) float32 tensor, zeros past
// `rows`
template <int D>
__device__ inline void load_rows(float* dst, const float* base,
                                 long long row_stride, int rows) {
  constexpr int G4 = D / 4, DS = D + 4;
  for (int e = threadIdx.x; e < TILE_ROWS * G4; e += FT) {
    const int r = e / G4, c = e % G4;
    const float4 val = r < rows ? *reinterpret_cast<const float4*>(
                                      base + r * row_stride + 4 * c)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(dst + r * DS + 4 * c) = val;
  }
}

// acc[i][j] = sum_d A[ra + i][d] B[rb + j][d] over 4 rows of each
template <int D>
__device__ inline void patch(float (&acc)[4][4], const float* A, int ra,
                             const float* B, int rb) {
  constexpr int DS = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ra + i) * DS + d);
      b[i] = *reinterpret_cast<const float4*>(B + (rb + i) * DS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(a[i].w, b[j].w, fmaf(a[i].z, b[j].z,
                    fmaf(a[i].y, b[j].y, fmaf(a[i].x, b[j].x, acc[i][j]))));
  }
}

// acc[i][4 cb + c] += sum_r W[ri + i][r] X[r][64 cb + 4 tx + c]: W a 64 x 64
// tile of stride PS, X 64 rows of stride D + 4
template <int D>
__device__ inline void accumulate(float (&acc)[4][4 * ((D + 63) / 64)],
                                  const float* W, int ri, const float* X,
                                  int tx) {
  constexpr int CB = (D + 63) / 64, DS = D + 4;
  const bool last_cb = D % 64 == 0 || tx * 4 < D % 64;
#pragma unroll 4
  for (int r = 0; r < TILE_ROWS; ++r) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ri + i) * PS + r];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (cb == CB - 1 && !last_cb) continue;
      const float4 xv =
          *reinterpret_cast<const float4*>(X + r * DS + 64 * cb + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * cb + 0] = fmaf(w[i], xv.x, acc[i][4 * cb + 0]);
        acc[i][4 * cb + 1] = fmaf(w[i], xv.y, acc[i][4 * cb + 1]);
        acc[i][4 * cb + 2] = fmaf(w[i], xv.z, acc[i][4 * cb + 2]);
        acc[i][4 * cb + 3] = fmaf(w[i], xv.w, acc[i][4 * cb + 3]);
      }
    }
  }
}

template <int D>
__device__ inline void store_rows(float* base, long long row_stride, int r0,
                                  int rows, int tx,
                                  const float (&acc)[4][4 * ((D + 63) / 64)],
                                  float mul) {
  constexpr int CB = (D + 63) / 64;
  const bool last_cb = D % 64 == 0 || tx * 4 < D % 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i >= rows) continue;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (cb == CB - 1 && !last_cb) continue;
      *reinterpret_cast<float4*>(base + (r0 + i) * row_stride + 64 * cb +
                                 4 * tx) =
          make_float4(acc[i][4 * cb] * mul, acc[i][4 * cb + 1] * mul,
                      acc[i][4 * cb + 2] * mul, acc[i][4 * cb + 3] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ out,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int sq,
                 int skv, int H, int KV, int causal, int q_offset,
                 float scale, int n_qtiles) {
  using T = F32Tiles<D>;
  constexpr int CB = (D + 63) / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ds = Qs + T::ROWS;
  float* Ks = Ds + T::ROWS;  // the output tile first (Delta), then K
  float* Vs = Ks + T::ROWS;
  float* Ws = Vs + T::ROWS;  // dS [64][PS]
  float* stat = Ws + TILE_ROWS * PS;  // Delta, then LSE, per tile row

  const int q0 = (n_qtiles - 1 - blockIdx.x) * TILE_ROWS;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;
  const size_t qoff = ((size_t)bi * sq + q0) * qstride + h * D;
  const size_t row_bh = ((size_t)bi * H + h) * sq;

  load_rows<D>(Qs, q + qoff, qstride, sq - q0);
  load_rows<D>(Ds, dout + qoff, qstride, sq - q0);
  load_rows<D>(Ks, out + qoff, qstride, sq - q0);
  __syncthreads();
  if (tid < TILE_ROWS) {
    float acc = 0.0f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(Ds[tid * T::DS + d], Ks[tid * T::DS + d], acc);
    const bool ok = q0 + tid < sq;
    stat[tid] = acc;
    stat[TILE_ROWS + tid] = ok ? lse[row_bh + q0 + tid] : 0.0f;
    if (ok) delta[row_bh + q0 + tid] = acc;
  }

  int kv_end = skv;
  if (causal) kv_end = min(skv, min(q0 + TILE_ROWS, sq) + q_offset);
  const int n_kt = (kv_end + TILE_ROWS - 1) / TILE_ROWS;
  float acc[4][4 * CB];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CB; ++c) acc[i][c] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE_ROWS;
    __syncthreads();  // Delta read (kt == 0); the previous tile's readers done
    const size_t koff = ((size_t)bi * skv + k0) * kstride + kvh * D;
    load_rows<D>(Ks, k + koff, kstride, skv - k0);
    load_rows<D>(Vs, v + koff, kstride, skv - k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    patch<D>(s, Qs, 4 * ty, Ks, 4 * tx);
    patch<D>(dp, Ds, 4 * ty, Vs, 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        const bool ok = row < sq && kpos < skv &&
                        !(causal && kpos > row + q_offset);
        const float p =
            ok ? expf(s[i][j] * scale - stat[TILE_ROWS + r]) : 0.0f;
        Ws[r * PS + 4 * tx + j] = p * (dp[i][j] - stat[r]);
      }
    }
    __syncthreads();
    accumulate<D>(acc, Ws, 4 * ty, Ks, tx);
  }
  store_rows<D>(dq + qoff, qstride, 4 * ty, sq - q0, tx, acc, scale);
}

template <int D>
__global__ void __launch_bounds__(FT)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int sq, int skv, int H, int KV,
                   int causal, int q_offset, float scale) {
  using T = F32Tiles<D>;
  constexpr int CB = (D + 63) / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T::ROWS;
  float* Qs = Vs + T::ROWS;
  float* Ds = Qs + T::ROWS;
  float* Ps = Ds + T::ROWS;  // P^T [key][query]
  float* Ss = Ps + TILE_ROWS * PS;  // dS^T

  const int k0 = blockIdx.x * TILE_ROWS, kvh = blockIdx.y, bi = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;
  const size_t koff = ((size_t)bi * skv + k0) * kstride + kvh * D;
  load_rows<D>(Ks, k + koff, kstride, skv - k0);
  load_rows<D>(Vs, v + koff, kstride, skv - k0);

  const int n_qt = (sq + TILE_ROWS - 1) / TILE_ROWS;
  const int qt0 = causal ? min(n_qt, max(0, k0 - q_offset) / TILE_ROWS) : 0;
  float dka[4][4 * CB], dva[4][4 * CB];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CB; ++c) dka[i][c] = dva[i][c] = 0.0f;

  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const float* lse_h = lse + ((size_t)bi * H + h) * sq;
    const float* dl_h = delta + ((size_t)bi * H + h) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TILE_ROWS;
      const size_t qoff = ((size_t)bi * sq + q0) * qstride + h * D;
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(Qs, q + qoff, qstride, sq - q0);
      load_rows<D>(Ds, dout + qoff, qstride, sq - q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      patch<D>(s, Ks, 4 * ty, Qs, 4 * tx);
      patch<D>(dp, Vs, 4 * ty, Ds, 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i, kpos = k0 + r;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int qpos = q0 + 4 * tx + jj;
          const bool ok = qpos < sq && kpos < skv &&
                          !(causal && kpos > qpos + q_offset);
          const float p = ok ? expf(s[i][jj] * scale - lse_h[qpos]) : 0.0f;
          Ps[r * PS + 4 * tx + jj] = p;
          Ss[r * PS + 4 * tx + jj] = ok ? p * (dp[i][jj] - dl_h[qpos]) : 0.0f;
        }
      }
      __syncthreads();
      accumulate<D>(dva, Ps, 4 * ty, Ds, tx);
      accumulate<D>(dka, Ss, 4 * ty, Qs, tx);
    }
  }
  store_rows<D>(dk + koff, kstride, 4 * ty, skv - k0, tx, dka, scale);
  store_rows<D>(dv + koff, kstride, 4 * ty, skv - k0, tx, dva, 1.0f);
}

struct Args {
  const void *q, *k, *v, *out, *out_lo, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int b, sq, skv, H, KV, causal, q_offset;
};

template <int D>
int launch_bf16(const Args& a, cudaStream_t s) {
  using bf = __nv_bfloat16;
  constexpr int smem = Bf16Tiles<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const int n_qt = (a.sq + TILE_ROWS - 1) / TILE_ROWS;
  flash_bwd_dq_bf16<D><<<dim3(n_qt, a.H, a.b), MT, smem, s>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.out),
      static_cast<const bf*>(a.out_lo), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dq),
      a.sq, a.skv, a.H, a.KV, a.causal, a.q_offset, scale, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (a.skv + TILE_ROWS - 1) / TILE_ROWS;
  flash_bwd_dkdv_bf16<D><<<dim3(n_kt, a.KV, a.b), MT, smem, s>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.sq, a.skv,
      a.H, a.KV, a.causal, a.q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t s) {
  constexpr int smem = F32Tiles<D>::SMEM;
  constexpr int dq_smem = smem + 2 * TILE_ROWS * 4 - TILE_ROWS * PS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const int n_qt = (a.sq + TILE_ROWS - 1) / TILE_ROWS;
  flash_bwd_dq_f32<D><<<dim3(n_qt, a.H, a.b), FT, dq_smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.out),
      static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.sq, a.skv, a.H, a.KV, a.causal, a.q_offset,
      scale, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (a.skv + TILE_ROWS - 1) / TILE_ROWS;
  flash_bwd_dkdv_f32<D><<<dim3(n_kt, a.KV, a.b), FT, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.sq, a.skv, a.H, a.KV, a.causal, a.q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (mma.sync kernels); d in
// {64, 112, 128}.  q, out, dout, dq (b, sq, H, d); k, v, dk, dv
// (b, skv, KV, d), all contiguous and 16-byte aligned; out_lo the
// forward's bf16 output residual (bfloat16; may be null); lse the
// forward's (b, H, sq) float32; delta a (b, H, sq) float32 scratch.  Two
// launches on `stream`; nothing is allocated.  The wrapper checks shapes,
// dtypes, layouts and alignment.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* out_lo,
                               const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int b, int sq, int skv,
                               int H, int KV, int d, int causal, int q_offset,
                               int dtype, void* stream) {
  if (b == 0 || sq == 0 || skv == 0) return 0;
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, out_lo, dout, lse, delta, dq, dk, dv,
               b, sq, skv, H, KV, causal, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64) return launch_bf16<64>(a, s);
  if (dtype == 1 && d == 112) return launch_bf16<112>(a, s);
  if (dtype == 1 && d == 128) return launch_bf16<128>(a, s);
  if (dtype == 0 && d == 64) return launch_f32<64>(a, s);
  if (dtype == 0 && d == 112) return launch_f32<112>(a, s);
  if (dtype == 0 && d == 128) return launch_f32<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
