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
// What bounds it on this card: operations (flash_attention_grad_work in
// kernels/flash_attention/ops.py, unchanged).  10 d operations a visible
// (query, key) pair and head (the minimal count: S, dV, dP, dQ and dK);
// at train_whisper's encoder (b = 4, s = 1,500, H = 16, d = 64,
// non-causal) 92.2 GFLOP against 20 MB: 0.093 ms on the bf16 tensor cores.
// The design recomputes S and dP in both kernels (14 d a pair): the price
// of writing dQ without atomics.
//
// bfloat16: every product on wgmma.mma_async (float32 accumulators), every
// tile by TMA (cp.async.bulk.tensor from 4-D tensor maps over (b, s, heads,
// d), 128-byte swizzle, rows past the sequence zero-filled) into rings of
// two stages completed on mbarriers, one thread issuing the copies; the
// Hopper helpers are the forward's (hopper.cuh).  Two launches and no
// atomics, so two backward passes are bit-equal:
//  1. dq (flash_bwd_dq_wgmma): one block of two consumer warpgroups per
//     (128-query tile, head, batch row), heaviest causal tiles first; each
//     warpgroup owns 64 query rows and both share the K and V tiles of a
//     three-stage ring.  While the Q and dO tiles land, two lanes a row
//     form Delta (float32, from dO and out + out_lo, every 16-byte load
//     issued before any is used) and write it, with the rows' LSE in the
//     log2 domain, to a (2, b, H, sq rounded up to 64) float32 scratch for
//     launch 2.  Per key tile: S = Q K^T and dP = dO V^T as wgmma ss
//     m64n64k16 (A and B K-major in shared memory); P = exp(S scale - LSE),
//     masked only on the tiles that cross skv or the causal frontier; dS =
//     P (dP - Delta) rounded to bf16 pairs is already wgmma's A fragment,
//     so dQ += dS K is a wgmma rs m64n{d}k16 reading the K tile MN-major
//     through the transpose bit, as the forward reads V.  Past d = 64 the
//     products overlap the softmax: S and dP are two commit groups and P is
//     formed while dP is still in the tensor cores, and dQ is left in
//     flight while the next tile's S and dP go out, the stage it read
//     refilled once that S is done.  At d = 64 the registers are capped at
//     128 for two blocks a SM, and every product is waited for before the
//     softmax.
//  2. dkdv (flash_bwd_dkdv_wgmma): one warpgroup per (64-key tile, KV head,
//     split of the group, batch row); K and V by TMA once, then a ring of
//     two (Q tile, dO tile, the tile's LSE and Delta by 1-D bulk copy),
//     walked in a fixed order: the split's heads, then the query tiles that
//     see the keys.  S^T = K Q^T and dP^T = V dO^T (ss), P^T from each
//     column's LSE and dS^T from each column's Delta, then dV += P^T dO and
//     dK += dS^T Q (rs, dO and Q read MN-major) in float32 registers
//     (overlapping P^T with dP^T, or these products with the next
//     sub-tile's S^T, measured no faster at internvl2's layer or whisper's
//     encoder: three blocks a SM at d = 64, two past it, already overlap
//     one another).  At d = 64 the S^T products take 64 queries
//     (m64n64); at d 112 and 128 they take 32 (m64n32), so that dK and dV
//     (up to 128 registers a thread) and the S^T / dP^T tiles fit without
//     spilling (one warpgroup, no setmaxnreg).
//  3. Filling the card: where b ceil(skv / 64) KV leaves the dkdv grid
//     under one wave of 132 blocks (train, internvl2's layer: 128), the
//     wrapper cuts each group into splits of whole heads (ops.py:
//     dkdv_splits, about two blocks a SM); each split writes float32 dK
//     and dV partials and flash_bwd_dkdv_sum adds them in split order,
//     scales dK and rounds once.  Two launches without a split, three with.
// d = 112: 224-byte rows are not whole 128-byte swizzle atoms, so a tile
// is two 64-column sub-tiles and the tensor map's extent zero-fills
// columns 112..127 (the forward's layout).
// Shared memory a block (dq / dkdv): d 64 82,944 / 52,224 bytes; d 112
// and 128 164,864 / 101,376.  Registers a thread (-Xptxas -v, dq / dkdv):
// d 64 128 (capped; 196 bytes spilled) / 154, d 112 187 / 170, d 128
// 198 / 186; the split sum 40.
// Measured (bwd_ab.py on an NVIDIA H100 80GB HBM3, 700.00 W; the backward
// alone, CUDA events, then device time under the profiler): train's shape
// (q 8 x 512 x 14 x 64 over 2 KV heads, causal, 3 splits) 0.110 ms, device
// 0.103 (dq 0.051, dkdv 0.049, sum 0.003); whisper's encoder (4 x 1,500 x
// 16 x 64) 0.486, device 0.485 (dq 0.261, dkdv 0.224); internvl2's layer
// (q 2 x 512 x 64 x 128 over 8, causal, 3 splits) 0.197, device 0.190;
// whisper's cross attention (q 187, kv 1,500) 0.132, device 0.126.  The
// design before (mma.sync, cp.async) took 0.273, 0.813, 0.427 and 0.149
// in the same run; SDPA's backward (cuDNN) 0.083, 0.280, 0.149 and 0.063
// of device time.
// float32: the two kernels on the FMA units, 256 threads, tiles as float32
// rows in shared memory, 4 x 4 patches of S and dP a thread, P and dS
// through shared memory.  Nothing on the serving path runs either.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE_ROWS = 64;  // query or key rows of a tile

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA (sm_90a)
// ---------------------------------------------------------------------------

constexpr int DQ_GROUPS = 2;  // dq: consumer warpgroups a block, 64 rows each
constexpr int DQ_THREADS = 128 * DQ_GROUPS;
constexpr int DQ_ROWS = TILE_ROWS * DQ_GROUPS;
constexpr int KV_THREADS = 128;  // dkdv: one warpgroup a block, 64 keys
constexpr int DQ_STAGES = 3;  // dq's ring of (K, V) tiles
constexpr int STAGES = 2;     // dkdv's ring of (Q, dO, LSE, Delta)
constexpr int STAT_BYTES = 2 * TILE_ROWS * 4;  // a query tile's LSE and Delta

template <int D>
struct Bf16Tiles {
  static constexpr int NSUB = (D + 63) / 64;  // 64-column sub-tiles
  static constexpr int KSTEPS = D / 16;       // k16 steps over d
  static constexpr int TILE = NSUB * TILE_ROWS * ROW_BYTES;  // 64 rows
  // dkdv: the queries of one S^T / dP^T product (m64n{QS}); 32 past d 64,
  // so dK, dV (D / 2 float32 registers each), S^T, dP^T and their bf16
  // fragments stay in registers
  static constexpr int QS = D == 64 ? 64 : 32;
  // 1024 bytes of slack align every tile to the 1024-byte swizzle period
  static constexpr int DQ_SMEM =
      1024 + 2 * DQ_GROUPS * TILE + DQ_STAGES * 2 * TILE;
  static constexpr int STAGE = 2 * TILE + 1024;  // Q, dO, LSE and Delta
  static constexpr int DKDV_SMEM = 1024 + 2 * TILE + STAGES * STAGE;
};

// ---------------------------------------------------------------------------
// bfloat16: dq kernel (and Delta)
// ---------------------------------------------------------------------------

__device__ inline float2 bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// d = 64 caps the registers at 128 a thread, so two blocks share a SM
// (155 a thread left one, and whisper's encoder ran 1.5x slower)
template <int D>
__global__ void __launch_bounds__(DQ_THREADS, D == 64 ? 2 : 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __nv_bfloat16* __restrict__ out,
                   const __nv_bfloat16* __restrict__ out_lo,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ stats,
                   __nv_bfloat16* __restrict__ dq, int sq, int skv, int H,
                   int KV, int causal, int q_offset, int sqp,
                   float scale_log2, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int BK = TILE_ROWS, NS = DQ_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + NS];  // Q and dO, each stage
  __shared__ float delta_s[DQ_GROUPS][TILE_ROWS];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t skv_tiles = base + 2 * DQ_GROUPS * T::TILE;  // K, V a stage
  const uint32_t bar_q = smem_u32(&bars[0]);

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;  // heaviest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, wg = tid / 128;
  const int qw = q0 + wg * TILE_ROWS;  // this warpgroup's first row
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const uint32_t sQ = base + wg * T::TILE;
  const uint32_t sDO = base + (DQ_GROUPS + wg) * T::TILE;

  // the block loads key tiles [0, n_tiles), those some row of it reaches;
  // this warpgroup computes tiles [0, my_tiles), of which [0, n_full) lie
  // wholly inside skv and at or below its first row's causal frontier.
  // The warpgroup holding the block's last row has my_tiles == n_tiles,
  // so every stage's phases complete in order.
  int kv_end = skv, my_end = skv, n_full = skv / BK;
  if (causal) {
    kv_end = min(skv, min(q0 + DQ_ROWS, sq) + q_offset);
    my_end = min(skv, min(qw + TILE_ROWS, sq) + q_offset);
    n_full = min(n_full, (qw + q_offset + 1) / BK);
  }
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int my_tiles = qw < sq ? (my_end + BK - 1) / BK : 0;

  auto load_kv = [&](int tile) {
    const int stage = tile % NS;
    const uint32_t bar = smem_u32(&bars[1 + stage]);
    const uint32_t dst = skv_tiles + stage * 2 * T::TILE;
    mbar_expect_tx(bar, 2 * T::TILE);
#pragma unroll
    for (int s = 0; s < T::NSUB; ++s) {
      tma_load_4d(dst + s * BK * ROW_BYTES, &tk, bar, s * 64, kvh, tile * BK,
                  bi);
      tma_load_4d(dst + T::TILE + s * BK * ROW_BYTES, &tv, bar, s * 64, kvh,
                  tile * BK, bi);
    }
  };

  if (tid == 0) mbar_init_all(bars, 1 + NS);
  __syncthreads();
  if (tid == 0) {  // the one producer: Q and dO, then the first stages
    mbar_expect_tx(bar_q, 2 * DQ_GROUPS * T::TILE);
#pragma unroll
    for (int g = 0; g < DQ_GROUPS; ++g)
#pragma unroll
      for (int s = 0; s < T::NSUB; ++s) {
        const uint32_t off = g * T::TILE + s * TILE_ROWS * ROW_BYTES;
        tma_load_4d(base + off, &tq, bar_q, s * 64, h, q0 + g * TILE_ROWS,
                    bi);
        tma_load_4d(base + DQ_GROUPS * T::TILE + off, &tdo, bar_q, s * 64, h,
                    q0 + g * TILE_ROWS, bi);
      }
    for (int t = 0; t < NS && t < n_tiles; ++t) load_kv(t);
  }

  // while the tiles land: Delta = rowsum(dO o out) in float32, from the
  // output's float32 value (out + out_lo; the rounded output alone moves
  // Delta by a bf16 rounding of out, which dQ carries to every key), two
  // lanes a row and every 16-byte load issued before any is used; with the
  // rows' LSE in the log2 domain it goes out for the dkdv launch, zeros on
  // the rows from sq up to sqp
  const size_t row_bh = (size_t)bi * H + h;
  const long long qstride = (long long)H * D;
  {
    constexpr int VPL = D / 16;  // 16-byte pieces of a row a lane
    // pieces loaded before any is used: the whole row half past d = 64;
    // at d = 64, half of it at a time (the registers are capped at 128)
    constexpr int VB = D == 64 ? VPL / 2 : VPL;
    const int row = qw + 16 * warp + lane / 2, half = lane % 2;
    float acc = 0.0f;
    if (row < sq) {
      const size_t off =
          ((size_t)bi * sq + row) * qstride + h * D + half * VPL * 8;
#pragma unroll
      for (int v0 = 0; v0 < VPL; v0 += VB) {
        uint4 o[VB], lo[VB], dd[VB];
#pragma unroll
        for (int v = 0; v < VB; ++v) {
          o[v] = *reinterpret_cast<const uint4*>(out + off + 8 * (v0 + v));
          lo[v] = *reinterpret_cast<const uint4*>(out_lo + off + 8 * (v0 + v));
          dd[v] = *reinterpret_cast<const uint4*>(dout + off + 8 * (v0 + v));
        }
#pragma unroll
        for (int v = 0; v < VB; ++v) {
          const uint32_t ow[4] = {o[v].x, o[v].y, o[v].z, o[v].w};
          const uint32_t lw[4] = {lo[v].x, lo[v].y, lo[v].z, lo[v].w};
          const uint32_t dw[4] = {dd[v].x, dd[v].y, dd[v].z, dd[v].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = bf16x2(ow[j]), b = bf16x2(lw[j]);
            const float2 c = bf16x2(dw[j]);
            acc = fmaf(a.x + b.x, c.x, fmaf(a.y + b.y, c.y, acc));
          }
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[wg][16 * warp + lane / 2] = acc;
      if (row < sqp) {
        stats[row_bh * sqp + row] =
            row < sq ? lse[row_bh * sq + row] * LOG2E : 0.0f;
        stats[(size_t)gridDim.y * H * sqp + row_bh * sqp + row] = acc;
      }
    }
  }
  __syncwarp();

  // this thread's rows of the tile: r0 and r0 + 8; its columns in each
  // 8-column group: c0 and c0 + 1 (wgmma's accumulator fragment)
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  float l2r[2], dlr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r0 + 8 * i;
    l2r[i] = row < sq ? lse[row_bh * sq + row] * LOG2E : 0.0f;
    dlr[i] = delta_s[wg][r0 + 8 * i];
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.0f;

  // Per tile t: S = Q K^T and dP = dO V^T go out as two groups behind
  // tile t - 1's dQ product; once S (and with it that dQ) is done, the
  // block frees tile t - 1's stage for tile t - 1 + NS and the warpgroup
  // forms P while dP is still in the tensor cores; then dS and dQ += dS K,
  // left in flight into tile t + 1 (past d = 64).
  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % NS;
    const bool mine = t < my_tiles;  // tiles past the frontier: none
    const uint32_t sk = skv_tiles + stage * 2 * T::TILE;
    const uint32_t sv = sk + T::TILE;
    float s[BK / 2], dp[BK / 2];
    if (mine) {
      mbar_wait(smem_u32(&bars[1 + stage]), (t / NS) & 1);
      // k16 step kk reads 32 bytes of sub-tile kk / 4 of each operand,
      // both K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * TILE_ROWS * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(sQ + off, 16, 1024),
                     sw128_desc(sk + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * TILE_ROWS * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss_n64(dp, sw128_desc(sDO + off, 16, 1024),
                     sw128_desc(sv + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // S, and tile t - 1's dQ; at d = 64 dP too (see below)
      if constexpr (D == 64) wgmma_wait_all();
      else wgmma_wait<1>();
      pin(s);
      pin(dqa);
    } else {
      wgmma_wait_all();  // this warpgroup's last dQ
      pin(dqa);
    }
    __syncthreads();  // every warpgroup is done with tile t - 1's stage
    if (tid == 0 && t >= 1 && t - 1 + NS < n_tiles) load_kv(t - 1 + NS);
    if (!mine) continue;

    // P = exp(S - LSE) where the key is visible (masks only where the
    // tile needs them), then dS = P (dP - Delta) as bf16 A fragments
    const bool masked = t >= n_full;
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          const int kpos = k0 + 8 * j + c0 + e;
          const int qpos = qw + r0 + 8 * i;
          const bool ok = !masked || (kpos < skv && qpos < sq &&
                                      !(causal && kpos > qpos + q_offset));
          s[x] = ok ? exp2f(fmaf(s[x], scale_log2, -l2r[i])) : 0.0f;
        }
    wgmma_wait<0>();
    pin(dp);
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * j + 2 * i;
        da[j / 2][2 * (j % 2) + i] =
            pack_bf16(s[x] * (dp[x] - dlr[i]), s[x + 1] * (dp[x + 1] - dlr[i]));
      }

    // dQ += dS K: B = the K tile [key][d], MN-major through the
    // transpose bit (as the forward reads V); 16 keys are 16 rows of
    // every sub-tile, the sub-tiles a tile's 64 rows apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(dqa, da[kk],
                  sw128_desc(sk + kk * 16 * ROW_BYTES, TILE_ROWS * ROW_BYTES,
                             1024));
    wgmma_commit();
    // at d = 64 every product is waited for at once: in flight across
    // the softmax, their registers pushed the count past the 128 that two
    // blocks a SM allow (ptxas spilled and serialised the wgmma)
    if constexpr (D == 64) wgmma_wait_all();
  }
  wgmma_wait_all();
  pin(dqa);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r0 + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* o = dq + ((size_t)bi * sq + row) * qstride + h * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: dkdv kernel, and the sum of a split group's partials
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ stats,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ part, int sq, int skv, int H,
                     int KV, int causal, int q_offset, int sqp, int splits,
                     float scale_log2, float scale) {
  using T = Bf16Tiles<D>;
  constexpr int QS = T::QS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];  // K and V, each stage

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + T::TILE, ring = base + 2 * T::TILE;

  const int k0 = blockIdx.x * TILE_ROWS, bi = blockIdx.z;
  const int kvh = blockIdx.y / splits, split = blockIdx.y % splits;
  const int group = H / KV;
  // this block's query heads: its split of the group, whole heads
  const int h0 = kvh * group + split * group / splits;
  const int h1 = kvh * group + (split + 1) * group / splits;
  // the query tiles that see this key tile (causal: from the first tile
  // whose last row reaches it), for each head
  const int n_qt = (sq + TILE_ROWS - 1) / TILE_ROWS;
  const int qt0 = causal ? min(n_qt, max(0, k0 - q_offset) / TILE_ROWS) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = (h1 - h0) * per_head;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t plane = (size_t)gridDim.z * H * sqp;

  // item `it`: head h0 + it / per_head, query tile qt0 + it % per_head:
  // its Q and dO tiles by TMA, its LSE and Delta rows by bulk copy
  auto load_item = [&](int it, int stage) {
    const int h = h0 + it / per_head;
    const int qs = (qt0 + it % per_head) * TILE_ROWS;
    const uint32_t bar = smem_u32(&bars[1 + stage]);
    const uint32_t dst = ring + stage * T::STAGE;
    mbar_expect_tx(bar, 2 * T::TILE + STAT_BYTES);
#pragma unroll
    for (int s = 0; s < T::NSUB; ++s) {
      tma_load_4d(dst + s * TILE_ROWS * ROW_BYTES, &tq, bar, s * 64, h, qs,
                  bi);
      tma_load_4d(dst + T::TILE + s * TILE_ROWS * ROW_BYTES, &tdo, bar,
                  s * 64, h, qs, bi);
    }
    const float* st = stats + ((size_t)bi * H + h) * sqp + qs;
    bulk_load(dst + 2 * T::TILE, st, TILE_ROWS * 4, bar);
    bulk_load(dst + 2 * T::TILE + TILE_ROWS * 4, st + plane, TILE_ROWS * 4,
              bar);
  };

  if (tid == 0) mbar_init_all(bars, 1 + STAGES);
  __syncthreads();
  if (tid == 0) {  // the one producer: K and V, then the first stages
    const uint32_t bar = smem_u32(&bars[0]);
    mbar_expect_tx(bar, 2 * T::TILE);
#pragma unroll
    for (int s = 0; s < T::NSUB; ++s) {
      tma_load_4d(sK + s * TILE_ROWS * ROW_BYTES, &tk, bar, s * 64, kvh, k0,
                  bi);
      tma_load_4d(sV + s * TILE_ROWS * ROW_BYTES, &tv, bar, s * 64, kvh, k0,
                  bi);
    }
    for (int it = 0; it < STAGES && it < n_it; ++it) load_item(it, it);
  }

  // this thread's keys: k0 + r0 and k0 + r0 + 8; its queries in each
  // 8-column group of S^T: c0 and c0 + 1
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;

  mbar_wait(smem_u32(&bars[0]), 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    const uint32_t sQ = ring + stage * T::STAGE, sDO = sQ + T::TILE;
    const float* lse2 =
        reinterpret_cast<const float*>(smem_raw + (sDO + T::TILE - raw));
    const float* dlt = lse2 + TILE_ROWS;
    const int q0 = (qt0 + it % per_head) * TILE_ROWS;
    mbar_wait(smem_u32(&bars[1 + stage]), (it / STAGES) & 1);
#pragma unroll
    for (int sub = 0; sub < TILE_ROWS / QS; ++sub) {
      const int qa = q0 + sub * QS;
      // queries past sq, or all before this tile's first key: nothing
      if (qa >= sq || (causal && qa + QS - 1 + q_offset < k0)) continue;
      const bool full = qa + QS <= sq && k0 + TILE_ROWS <= skv &&
                        (!causal || k0 + TILE_ROWS - 1 <= qa + q_offset);
      // S^T = K Q^T and dP^T = V dO^T for the 64 keys x QS queries
      float st[QS / 2], dpt[QS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * TILE_ROWS * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss<QS>(st, sw128_desc(sK + off, 16, 1024),
                     sw128_desc(sQ + sub * QS * ROW_BYTES + off, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * TILE_ROWS * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss<QS>(dpt, sw128_desc(sV + off, 16, 1024),
                     sw128_desc(sDO + sub * QS * ROW_BYTES + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      // P^T from each column's LSE, dS^T = P^T (dP^T - Delta), masked
      // where a key is hidden; both as bf16 A fragments
      uint32_t pa[QS / 16][4], sa[QS / 16][4];
#pragma unroll
      for (int j = 0; j < QS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const int col = sub * QS + 8 * j + c0 + e;
            const int qpos = q0 + col, kpos = k0 + r0 + 8 * i;
            const bool ok = full || (qpos < sq && kpos < skv &&
                                     !(causal && kpos > qpos + q_offset));
            p[e] = ok ? exp2f(fmaf(st[x], scale_log2, -lse2[col])) : 0.0f;
            ds[e] = p[e] * (dpt[x] - dlt[col]);
          }
          pa[j / 2][2 * (j % 2) + i] = pack_bf16(p[0], p[1]);
          sa[j / 2][2 * (j % 2) + i] = pack_bf16(ds[0], ds[1]);
        }

      // dV += P^T dO and dK += dS^T Q: B = the dO and Q rows [query][d],
      // MN-major through the transpose bit
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        const uint32_t off = (sub * QS + kk * 16) * ROW_BYTES;
        wgmma_pv<D>(dva, pa[kk],
                    sw128_desc(sDO + off, TILE_ROWS * ROW_BYTES, 1024));
        wgmma_pv<D>(dka, sa[kk],
                    sw128_desc(sQ + off, TILE_ROWS * ROW_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dva);
      pin(dka);
    }

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + STAGES < n_it) load_item(it + STAGES, stage);
  }

  // dK (times the scale) and dV in bf16, or this split's float32 partials
  const size_t n_el = (size_t)gridDim.z * skv * KV * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    if (key >= skv) continue;
    const size_t off = (((size_t)bi * skv + key) * KV + kvh) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float k0v = dka[4 * j + 2 * i], k1v = dka[4 * j + 2 * i + 1];
      const float v0v = dva[4 * j + 2 * i], v1v = dva[4 * j + 2 * i + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            pack_bf16(k0v * scale, k1v * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_bf16(v0v, v1v);
      } else {
        float* pk = part + split * n_el + off + 8 * j;
        *reinterpret_cast<float2*>(pk) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(pk + splits * n_el) = make_float2(v0v, v1v);
      }
    }
  }
}

// dK = scale * sum of the splits' partials, dV = their sum, each summed in
// split order in float32 and rounded once: four elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, long long n, int splits,
                   float scale) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 ks = *reinterpret_cast<const float4*>(part + i);
  float4 vs = *reinterpret_cast<const float4*>(part + splits * n + i);
  for (int s = 1; s < splits; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(part + s * n + i);
    const float4 b = *reinterpret_cast<const float4*>(part + (splits + s) * n + i);
    ks.x += a.x; ks.y += a.y; ks.z += a.z; ks.w += a.w;
    vs.x += b.x; vs.y += b.y; vs.z += b.z; vs.w += b.w;
  }
  *reinterpret_cast<uint2*>(dk + i) =
      make_uint2(pack_bf16(ks.x * scale, ks.y * scale),
                 pack_bf16(ks.z * scale, ks.w * scale));
  *reinterpret_cast<uint2*>(dv + i) =
      make_uint2(pack_bf16(vs.x, vs.y), pack_bf16(vs.z, vs.w));
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
  float *stats, *part;
  void *dq, *dk, *dv;
  int b, sq, skv, H, KV, causal, q_offset, splits;
};

template <int D>
int launch_bf16(const Args& a, cudaStream_t s) {
  using bf = __nv_bfloat16;
  using T = Bf16Tiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, a.q, a.b, a.sq, a.H, D, TILE_ROWS) ||
      !tensor_map(&tk, a.k, a.b, a.skv, a.KV, D, TILE_ROWS) ||
      !tensor_map(&tv, a.v, a.b, a.skv, a.KV, D, TILE_ROWS) ||
      !tensor_map(&tdo, a.dout, a.b, a.sq, a.H, D, TILE_ROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::DKDV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D), scale_log2 = scale * LOG2E;
  const int sqp = (a.sq + TILE_ROWS - 1) / TILE_ROWS * TILE_ROWS;
  flash_bwd_dq_wgmma<D><<<dim3(a.H, a.b, (a.sq + DQ_ROWS - 1) / DQ_ROWS),
                          DQ_THREADS, T::DQ_SMEM, s>>>(
      tq, tk, tv, tdo, static_cast<const bf*>(a.out),
      static_cast<const bf*>(a.out_lo), static_cast<const bf*>(a.dout), a.lse,
      a.stats, static_cast<bf*>(a.dq), a.sq, a.skv, a.H, a.KV, a.causal,
      a.q_offset, sqp, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (a.skv + TILE_ROWS - 1) / TILE_ROWS;
  flash_bwd_dkdv_wgmma<D><<<dim3(n_kt, a.KV * a.splits, a.b), KV_THREADS,
                            T::DKDV_SMEM, s>>>(
      tq, tk, tv, tdo, a.stats, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.part, a.sq, a.skv, a.H, a.KV, a.causal,
      a.q_offset, sqp, a.splits, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const long long n = (long long)a.b * a.skv * a.KV * D;
  flash_bwd_dkdv_sum<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(
      a.part, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), n, a.splits,
      scale);
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
      static_cast<const float*>(a.dout), a.lse, a.stats,
      static_cast<float*>(a.dq), a.sq, a.skv, a.H, a.KV, a.causal, a.q_offset,
      scale, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (a.skv + TILE_ROWS - 1) / TILE_ROWS;
  flash_bwd_dkdv_f32<D><<<dim3(n_kt, a.KV, a.b), FT, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.stats, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.sq, a.skv, a.H, a.KV, a.causal, a.q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (wgmma kernels); d in
// {64, 112, 128}.  q, out, dout, dq (b, sq, H, d); k, v, dk, dv
// (b, skv, KV, d), all contiguous and 16-byte aligned; out_lo the
// forward's bf16 output residual (bfloat16 only, required there); lse the
// forward's (b, H, sq) float32.  stats: a float32 scratch of 2 b H sqp
// values (sqp = sq rounded up to 64): the bf16 dq launch writes each
// row's LSE (log2 domain) and Delta there for the dkdv launch; the
// float32 kernels use its first b H sq as Delta.  splits (bfloat16; 1 to
// H / KV, kernels/flash_attention/ops.py: dkdv_splits): the dkdv blocks a
// KV head's query group is cut into, whole heads each; above 1, `part`
// (a float32 scratch of 2 splits b skv KV d) takes their dK and dV
// partials and a third launch sums them in split order.  Two or three
// launches on `stream`; nothing is allocated.  The wrapper checks shapes,
// dtypes, layouts and alignment.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* out_lo,
                               const void* dout, const float* lse,
                               float* stats, float* part, void* dq, void* dk,
                               void* dv, int b, int sq, int skv, int H,
                               int KV, int d, int causal, int q_offset,
                               int splits, int dtype, void* stream) {
  if (b == 0 || sq == 0 || skv == 0) return 0;
  if (KV < 1 || H % KV || splits < 1 || splits > H / KV ||
      (dtype == 1 && (out_lo == nullptr || (splits > 1 && part == nullptr))))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, out_lo, dout, lse, stats, part, dq, dk, dv,
               b, sq, skv, H, KV, causal, q_offset, splits};
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
