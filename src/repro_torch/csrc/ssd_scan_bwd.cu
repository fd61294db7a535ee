// ssd_scan_bwd: the backward of the Mamba-2 SSD chunked scan over the
// forward's 64-position chunks, the chunks spread over the grid.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel (its
// training differentiates the XLA twin repro.models.ssm.ssd_chunked).  It
// is the backward of SsdScanFn, whose forward is ssd_scan.cu (the port of
// src/repro/kernels/ssm_scan/kernel.py: ssd_scan_kernel_call), which saves
// the float32 state S_k before each chunk k.  In a chunk, with a_t = dt_t A
// (A = -exp(a_log)), cum_t = sum_{s<=t} a_s, T = cum_63,
// L[t,s] = exp(cum_t - cum_s) for s <= t (else 0), G = C B^T and
// Q[t,s] = dy_t . x_s, and dS' the cotangent of the state after the chunk:
//   W = G L dt_s   M = Q L dt_s   R = G L Q   Z = R dt_s
//   u_s = exp(T - cum_s) dt_s
//   dx_s  = sum_t W[t,s] dy_t + u_s B_s^T dS' + D dy_s
//   dB_s  = sum_t M[t,s] C_t + u_s dS' x_s           (per head, float32)
//   dC_t  = sum_s M[t,s] B_s + exp(cum_t) S_k dy_t    (per head, float32)
//   ddt_s = sum_t R[t,s] + exp(T - cum_s) v_s + A sum_{t>=s} dcum_t,
//           v_s = B_s . (dS' x_s)
//   dcum_t = sum_s Z[t,s] - sum_s Z[s,t] + exp(cum_t) C_t . (S_k dy_t)
//            - u_t v_t  (+ exp(T) <S_k, dS'> + sum_s u_s v_s at t = 63)
//   da_log += A sum_t dt_t sum_{t'>=t} dcum_t'     dd_skip += sum_t dy_t . x_t
//   dS    = exp(T) dS' + (C o exp(cum))^T dy       (the previous chunk's dS')
// The chunks depend on each other only through dS': dS' of chunk k is
// D_k = exp(T_{k+1}) D_{k+1} + local_{k+1}, local_k = (C o exp(cum))^T dy
// over chunk k, from D_{nc-1} = the final state's cotangent (or 0) to
// D_{-1}, the initial state's gradient.  dB and dC leave per head and the
// wrapper sums each group's heads in a fixed order (as da_log and dd_skip
// over the chunks and batch rows), so no atomics: two backward passes are
// bit-equal.  Positions past S read as zeros (x, dt, B, C, dy), which
// keeps cum flat and adds nothing, as in the forward.
//
// What bounds it on this card: bytes (ssd_scan_grad_work in
// kernels/ssm_scan/ops.py, unchanged).  The minimal work a (batch row,
// head, chunk) is 2 L^2 (3 N + 2 P) + 8 L N P operations (G, Q, W^T dy,
// M^T C and M B; the four state products); at train_hybrid's shape
// (B = 3, S = 512, H = 112, P = N = 64) 12.2 GFLOP, 0.012 ms on the bf16
// tensor cores, against about 112 MB (the inputs, dy, the saved chunk
// states and the gradients): 0.0335 ms at 3.35 TB/s.
//
// bfloat16: three launches.
//  1. ssd_bwd_carry_kernel, one block a (head, batch row): the reverse
//     scan of dS' over the chunks in float32, from the last chunk to the
//     first.  dS' is a chunk's local term, local_k = (C o exp(cum))^T dy
//     (one 64 x N x P product, C o exp(cum) split into bf16 hi + lo), and
//     exp(T_k) times the later chunks' carry, so the pass computes local_k
//     on the way (the chunk-parallel local terms and the scan as one
//     launch): each warp keeps its 16-row slabs of dS' in registers, writes
//     D_k into slot k of a (B, H, nc, N, P) float32 scratch and carries
//     D_{k-1} = exp(T_k) D_k + local_k; C and dy come by cp.async a chunk
//     ahead.  The last carry is the initial state's gradient.  dS' never
//     leaves float32 between chunks; it is split into bf16 hi + lo only
//     where it enters a product.
//  2. ssd_bwd_chunk_kernel, one block a (head, chunk, batch row), the
//     chunks independent (2,688 blocks at train_hybrid, where one block a
//     (head, row) walking its 8 chunks in turn gave 336, 1.27 waves): every
//     gradient of the chunk from its D_k and the forward's S_k (both
//     float32, read eight pairs a thread at a time and split into bf16
//     hi + lo), four warps; warp w owns chunk positions 16 w .. 16 w + 15,
//     as the s rows of W^T, M^T, dx and dB (the t blocks j >= w) and as
//     the t rows of dC (the s blocks j <= w); warp 0 scans the chunk's dt
//     and, after the products, reduces dcum into ddt and the chunk's parts
//     of da_log and dd_skip.
//  3. ssd_bwd_group_sum_kernel: the per-head float32 dB and dC summed over
//     each group's heads in head order, rounded to bf16 once, and the
//     chunks' parts of da_log and dd_skip summed (a row's chunks, then the
//     rows).
// The products stay on mma.sync m16n8k16 (bf16 operands, float32
// accumulators), not wgmma: a chunk's products are 16-row triangular
// blocks (t >= s) whose float32 operands (W^T and M^T from accumulator
// fragments, S_k, D_k, C o exp(cum)) enter split into bf16 hi + lo, two
// products each, as the forward splits its weights and its state update
// (tests/test_torch_ssd_hopper.py: one bf16 rounding there breaks the
// state's 1e-4); wgmma's 64-row tiles would multiply the masked half of
// the triangle too.  x, dy, B and C come by cp.async into tiles of bf16
// rows XOR-swizzled by 16-byte piece, read by ldmatrix.  Shared memory a
// block at P = N = 64: pass 2 about 84 KB (two blocks a SM), pass 1 about
// 33 KB.  Registers a thread (-Xptxas -v) at P = N = 64: pass 1 140, pass
// 2 236, pass 3 32 (at P = N = 128 pass 2 spills 124 bytes).
// Measured (bwd_ab.py on an NVIDIA H100 80GB HBM3, 700.00 W) at
// train_hybrid's shape, x 3 x 512 x 112 x 64, B and C 3 x 512 x 1 x 64 as
// views of one activation: 0.237 ms, device 0.231 (pass 1 0.034, pass 2
// 0.157, pass 3 0.040), against 0.330 (device 0.318: the single walk
// 0.268, the group sums in torch 0.047) for the design before, in the same
// run.  Pass 2 moves about 210 MB (0.063 ms at 3.35 TB/s) and runs two
// blocks of four warps a SM (registers and shared memory both allow no
// more): the products' dependent chains, not bytes, set its time.
//
// float32: ssd_bwd_kernel, one block a (head, batch row), 256 threads on
// the FMA units walking the chunks from last to first with dS' carried in
// the output buffer of the initial state's gradient (in device memory,
// cached), nothing rounded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;  // chunk length (the forward's)

// warp 0: the chunk's dcum (its row parts, the column parts of `nw` warps
// and the chunk total's at t = 63), its reverse cumulative sum r, then
// ddt_t = ddtx_t + A r_t (positions t < valid) and da += dt_t r_t
__device__ inline void chunk_scalars(const float* dts, const float* ddtx,
                                     const float* rowdc, const float* colpart,
                                     int nw, float dcum_last, float A,
                                     float* ddt, long long ddt_stride,
                                     int valid, float& da) {
  const int lane = threadIdx.x % 32;
  float v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = lane + 32 * r;
    float d = rowdc[t];
    for (int w = 0; w < nw; ++w) d += colpart[w * L + t];
    if (t == L - 1) d += dcum_last;
    v[r] = d;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o0 = __shfl_down_sync(0xffffffffu, v[0], off);
    const float o1 = __shfl_down_sync(0xffffffffu, v[1], off);
    if (lane + off < 32) {
      v[0] += o0;
      v[1] += o1;
    }
  }
  v[0] += __shfl_sync(0xffffffffu, v[1], 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = lane + 32 * r;
    if (t < valid) ddt[t * ddt_stride] = fmaf(A, v[r], ddtx[t]);
    da = fmaf(dts[t], v[r], da);
  }
}

// warp 0: the chunk's dt (zero past S) and its scalars: cum, dt, exp(cum),
// exp(T - cum), u = exp(T - cum) dt, then exp(T) at aux[5 L]
__device__ inline void chunk_scan(const float* dth, long long dt_stride,
                                  int t0, int S, float A, float* aux) {
  const int lane = threadIdx.x % 32;
  const float d0 = t0 + lane < S ? dth[(t0 + lane) * dt_stride] : 0.0f;
  const float d1 =
      t0 + lane + 32 < S ? dth[(t0 + lane + 32) * dt_stride] : 0.0f;
  float v0 = d0 * A, v1 = d1 * A;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o0 = __shfl_up_sync(0xffffffffu, v0, off);
    const float o1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (lane >= off) {
      v0 += o0;
      v1 += o1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float total = __shfl_sync(0xffffffffu, v1, 31);
  const float vs[2] = {v0, v1}, ds[2] = {d0, d1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = lane + 32 * r;
    aux[t] = vs[r];
    aux[L + t] = ds[r];
    aux[2 * L + t] = expf(vs[r]);
    aux[3 * L + t] = expf(total - vs[r]);
    aux[4 * L + t] = aux[3 * L + t] * ds[r];
  }
  if (lane == 0) aux[5 * L] = expf(total);
}

// aux layout (floats): cum, dt, exp(cum), exp(T - cum), u, [5 L] exp(T),
// then ddtx, rowdc, the column parts (one row a warp), lpart (per warp:
// sum u v, then <S_k, dS'>)
constexpr int AX_DDTX = 5 * L + 4;
constexpr int AX_ROWDC = AX_DDTX + L;
constexpr int AX_COL = AX_ROWDC + L;

// ---------------------------------------------------------------------------
// bfloat16: three passes, the chunks spread over the grid
// ---------------------------------------------------------------------------

constexpr int MW = 4;
constexpr int MT = 32 * MW;
constexpr int AX_LPART = AX_COL + MW * L;
constexpr int AX_RED = AX_LPART + 2 * MW;  // the warps' dd_skip parts
constexpr int AUX_MMA = AX_RED + MW;

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += (ahi + alo) b: a float32 operand as its bf16 hi + lo parts
__device__ inline void mma_split(float (&c)[4], const uint32_t (&ahi)[4],
                                 const uint32_t (&alo)[4], uint32_t b0,
                                 uint32_t b1) {
  mma_bf16(c, ahi, b0, b1);
  mma_bf16(c, alo, b0, b1);
}
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ inline float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ inline void split_pair(float v0, float v1, uint32_t& hi,
                                  uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 hf = unpack_bf16(hi);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}
__device__ inline void split_scaled(uint32_t v, float u0, float u1,
                                    uint32_t& hi, uint32_t& lo) {
  const float2 vf = unpack_bf16(v);
  split_pair(vf.x * u0, vf.y * u1, hi, lo);
}
// two adjacent n8 accumulator tiles as an m16k16 A fragment, split
__device__ inline void acc_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                 const float (&c0)[4], const float (&c1)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

template <int RB>
__device__ inline uint32_t swz_el(int r, int col) {  // bf16 element offset
  return r * RB + ((((col >> 3) ^ (r & 7))) << 4) + ((col & 7) << 1);
}

// one chunk's rows of a (B, S, ., width) operand into a swizzled tile of
// RB-byte rows; `valid` 16-byte pieces of a row are real, rows past S zero
template <int RB>
__device__ inline void stage_rows(uint32_t tile, const __nv_bfloat16* src,
                                  long long ts, int valid, int t0, int S) {
  constexpr int PC = RB / 16, RSTEP = MT / PC;
  const int c = threadIdx.x % PC, r0 = threadIdx.x / PC;
#pragma unroll
  for (int i = 0; i < L / RSTEP; ++i) {
    const int r = r0 + i * RSTEP;
    const bool ok = c < valid && t0 + r < S;
    cp_async16(tile + r * RB + ((c ^ (r & 7)) << 4),
               ok ? src + (long long)(t0 + r) * ts + c * 8 : src, ok);
  }
}

template <int PP, int NP>
struct BwdSmem {
  static constexpr int XB = 2 * PP, BB = 2 * NP;  // row bytes
  static constexpr int X0 = 0;                // x      [L][PP]
  static constexpr int DY0 = X0 + L * XB;     // dy     [L][PP]
  static constexpr int B0 = DY0 + L * XB;     // B      [L][NP]
  static constexpr int C0 = B0 + L * BB;      // C      [L][NP]
  static constexpr int SH0 = C0 + L * BB;     // S_k hi [NP][PP]
  static constexpr int SL0 = SH0 + NP * XB;   // S_k lo
  static constexpr int DH0 = SL0 + NP * XB;   // dS' hi [NP][PP]
  static constexpr int DL0 = DH0 + NP * XB;   // dS' lo
  static constexpr int MH0 = DL0 + NP * XB;   // M^T hi [L s][L t]
  static constexpr int ML0 = MH0 + L * 128;   // M^T lo
  static constexpr int A0 = ML0 + L * 128;    // aux floats
  static constexpr int TOTAL = A0 + AUX_MMA * 4;
};

template <int PP, int NP>
struct CarrySmem {
  static constexpr int XB = 2 * PP, BB = 2 * NP;
  static constexpr int TILES = L * BB + L * XB;  // one chunk's C, then dy
  static constexpr int ECUM = 2 * TILES;         // each warp's L + 4 floats
  static constexpr int TOTAL = ECUM + MW * (L + 4) * 4;
};

// one warp's scan of a chunk's dt (zero past S), the arithmetic of
// chunk_scan: e[t] = exp(cum_t) and e[L] = exp(T)
__device__ inline void chunk_decay(float d0, float d1, float A, float* e) {
  const int lane = threadIdx.x % 32;
  float v0 = d0 * A, v1 = d1 * A;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o0 = __shfl_up_sync(0xffffffffu, v0, off);
    const float o1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (lane >= off) {
      v0 += o0;
      v1 += o1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  const float total = __shfl_sync(0xffffffffu, v1, 31);
  e[lane] = expf(v0);
  e[lane + 32] = expf(v1);
  if (lane == 0) e[L] = expf(total);
}

// pass 1, one block per (head, batch row): the reverse scan over the
// chunks, from the last to the first.  Warp w keeps rows 16 (w + 4 i) of
// dS' in float32 registers (mma.sync accumulator fragments).
// At chunk k it writes D_k (dS' after the chunk) into slot k of `carry`,
// forms the chunk's own term local_k = (C o exp(cum))^T dy (C o exp(cum)
// split into bf16 hi + lo) and carries D_{k-1} = exp(T_k) D_k + local_k;
// the last carry is the initial state's gradient.  C and dy tiles come by
// cp.async one chunk ahead; each warp scans the chunk's dt itself
template <int PP, int NP>
__global__ void __launch_bounds__(MT)
ssd_bwd_carry_kernel(const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const __nv_bfloat16* __restrict__ cm,
                     const __nv_bfloat16* __restrict__ dy,
                     const float* __restrict__ dstate,
                     float* __restrict__ carry, float* __restrict__ ds_out,
                     int S, int H, int G, int P, int N, long long bbs,
                     long long bts) {
  using SM = CarrySmem<PP, NP>;
  constexpr int XB = SM::XB, BB = SM::BB;
  constexpr int PK = PP / 16;
  constexpr int NSW = NP / 16 / MW;  // row slabs a warp: 16 (w + 4 i)
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t sb = smem_u32(sm);
  const int h = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, qd = lane % 4, lr = lane % 8, lm = lane / 8;
  const float A = -expf(a_log[h]);
  const int nc = (S + L - 1) / L;
  float* ecum = reinterpret_cast<float*>(sm + SM::ECUM) + warp * (L + 4);
  const __nv_bfloat16* ch = cm + bi * bbs + (long long)(h / (H / G)) * N;
  const long long dys = (long long)H * P;
  const __nv_bfloat16* dyh = dy + (size_t)bi * S * dys + (long long)h * P;
  const float* dth = dt + (size_t)bi * S * H + h;
  const size_t st_off = ((size_t)bi * H + h) * N * P;
  const size_t slot_floats = (size_t)N * P;
  float* slots = carry + ((size_t)bi * H + h) * nc * slot_floats;

  auto stage = [&](int ck) {
    const uint32_t base = sb + (ck & 1) * SM::TILES;
    stage_rows<BB>(base, ch, bts, N / 8, ck * L, S);
    stage_rows<XB>(base + L * BB, dyh, dys, P / 8, ck * L, S);
    cp_async_commit();
  };
  auto dt_at = [&](int t) { return t < S ? dth[(long long)t * H] : 0.0f; };

  // dS' <- the final state's cotangent (or 0), this thread's elements
  float d[NSW][PK][2][4];
#pragma unroll
  for (int i = 0; i < NSW; ++i)
#pragma unroll
    for (int pp = 0; pp < PK; ++pp)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 16 * (warp + MW * i) + gr + 8 * r;
          const int p = 16 * pp + 8 * hh + 2 * qd;
          float2 v = make_float2(0.0f, 0.0f);
          if (dstate != nullptr && n < N && p < P)
            v = *reinterpret_cast<const float2*>(dstate + st_off +
                                                 (size_t)n * P + p);
          d[i][pp][hh][2 * r] = v.x;
          d[i][pp][hh][2 * r + 1] = v.y;
        }

  stage(nc - 1);
  float dt0 = dt_at((nc - 1) * L + lane), dt1 = dt_at((nc - 1) * L + lane + 32);
  for (int ck = nc - 1; ck >= 0; --ck) {
    cp_async_wait_all();
    __syncthreads();  // chunk ck landed; every warp is done with ck + 1
    if (ck > 0) stage(ck - 1);
    chunk_decay(dt0, dt1, A, ecum);
    if (ck > 0) {  // the next chunk's dt, in flight during this one
      dt0 = dt_at((ck - 1) * L + lane);
      dt1 = dt_at((ck - 1) * L + lane + 32);
    }
    __syncwarp();
    const float eT = ecum[L];
    const uint32_t Cs = sb + (ck & 1) * SM::TILES, DYs = Cs + L * BB;
    float* slot = slots + ck * slot_floats;
#pragma unroll
    for (int i = 0; i < NSW; ++i) {
      const int m = warp + MW * i;
#pragma unroll
      for (int pp = 0; pp < PK; ++pp) {
        float acc[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hh][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < L / 16; ++ks) {
          uint32_t af[4], hi[4], lo[4], b[4];
          ldmatrix_x4_trans(af, Cs + swz_el<BB>(16 * ks + lr + (lm >> 1) * 8,
                                                16 * m + (lm & 1) * 8));
          const int s0 = 16 * ks + 2 * qd;
          split_scaled(af[0], ecum[s0], ecum[s0 + 1], hi[0], lo[0]);
          split_scaled(af[1], ecum[s0], ecum[s0 + 1], hi[1], lo[1]);
          split_scaled(af[2], ecum[s0 + 8], ecum[s0 + 9], hi[2], lo[2]);
          split_scaled(af[3], ecum[s0 + 8], ecum[s0 + 9], hi[3], lo[3]);
          ldmatrix_x4_trans(b, DYs + swz_el<XB>(16 * ks + lr + (lm & 1) * 8,
                                                16 * pp + (lm >> 1) * 8));
          mma_split(acc[0], hi, lo, b[0], b[1]);
          mma_split(acc[1], hi, lo, b[2], b[3]);
        }
        // D_k out, then D_{k-1} = exp(T_k) D_k + local_k
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = 16 * m + gr + 8 * r, p = 16 * pp + 8 * hh + 2 * qd;
            float* dv = &d[i][pp][hh][2 * r];
            if (n < N && p < P)
              *reinterpret_cast<float2*>(slot + (size_t)n * P + p) =
                  make_float2(dv[0], dv[1]);
            dv[0] = fmaf(eT, dv[0], acc[hh][2 * r]);
            dv[1] = fmaf(eT, dv[1], acc[hh][2 * r + 1]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NSW; ++i)
#pragma unroll
    for (int pp = 0; pp < PK; ++pp)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = 16 * (warp + MW * i) + gr + 8 * r;
          const int p = 16 * pp + 8 * hh + 2 * qd;
          if (n < N && p < P)
            *reinterpret_cast<float2*>(ds_out + st_off + (size_t)n * P + p) =
                make_float2(d[i][pp][hh][2 * r], d[i][pp][hh][2 * r + 1]);
        }
}

// pass 2, one block per (head, chunk, batch row), the chunks independent:
// every gradient of the chunk from D_k (slot k of `carry`, float32, split
// into bf16 hi + lo) and the forward's saved S_k
template <int PP, int NP>
__global__ void __launch_bounds__(MT, (PP == 64 && NP == 64) ? 2 : 1)
ssd_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm,
                     const float* __restrict__ d_skip,
                     const float* __restrict__ chunk_states,
                     const float* __restrict__ carry,
                     const __nv_bfloat16* __restrict__ dy,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dbh, float* __restrict__ dch,
                     float* __restrict__ da_part, float* __restrict__ dd_part,
                     int S, int H, int G, int P, int N, long long xbs,
                     long long xts, long long bbs, long long bts) {
  using SM = BwdSmem<PP, NP>;
  constexpr int XB = SM::XB, BB = SM::BB;
  constexpr int PK = PP / 16, NK = NP / 16;  // k16 steps / n16 pairs
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t sb = smem_u32(sm);
  float* aux = reinterpret_cast<float*>(sm + SM::A0);
  const float* cum = aux;
  const float* dts = aux + L;
  const float* ecum = aux + 2 * L;
  const float* el = aux + 3 * L;
  const float* u = aux + 4 * L;

  const int h = blockIdx.x, ck = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y, t0 = ck * L;
  const int grp = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, qd = lane % 4, lr = lane % 8, lm = lane / 8;
  const float A = -expf(a_log[h]);
  const float D = d_skip[h];
  const size_t chunk_off = (((size_t)bi * H + h) * nc + ck) * N * P;
  const long long dys = (long long)H * P;  // dy's token stride
  auto bf_at = [&](int off) {  // one bf16 of a tile, as float32
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(sm + off));
  };

  stage_rows<XB>(sb + SM::X0, x + bi * xbs + (long long)h * P, xts, P / 8,
                 t0, S);
  stage_rows<XB>(sb + SM::DY0, dy + (size_t)bi * S * dys + (long long)h * P,
                 dys, P / 8, t0, S);
  stage_rows<BB>(sb + SM::B0, bm + bi * bbs + (long long)grp * N, bts, N / 8,
                 t0, S);
  stage_rows<BB>(sb + SM::C0, cm + bi * bbs + (long long)grp * N, bts, N / 8,
                 t0, S);
  cp_async_commit();
  if (warp == 0) chunk_scan(dt + (size_t)bi * S * H + h, H, t0, S, A, aux);
  for (int i = lane; i < L; i += 32) aux[AX_COL + warp * L + i] = 0.0f;
  // S_k and D_k (float32) -> hi + lo; <S_k, D_k> on the way.  The loads
  // go out eight pairs at a time before any is used, so a block waits out
  // a device-memory round trip every eight pairs, not every pair
  {
    constexpr int PER = NP * (PP / 2) / MT;  // float2 pairs a thread
    constexpr int BATCH = PER < 8 ? PER : 8;
    const float* sk = chunk_states + chunk_off;
    const float* dk = carry + chunk_off;
    float sdot = 0.0f;
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += BATCH) {
      float2 v[BATCH], w[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int e = threadIdx.x + (i0 + i) * MT;
        const int n = e / (PP / 2), p = 2 * (e % (PP / 2));
        v[i] = w[i] = make_float2(0.0f, 0.0f);
        if (n < N && p < P) {
          v[i] = *reinterpret_cast<const float2*>(sk + (size_t)n * P + p);
          w[i] = *reinterpret_cast<const float2*>(dk + (size_t)n * P + p);
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int e = threadIdx.x + (i0 + i) * MT;
        const int n = e / (PP / 2), p = 2 * (e % (PP / 2));
        const uint32_t off = swz_el<XB>(n, p);
        uint32_t hi, lo;
        split_pair(v[i].x, v[i].y, hi, lo);
        *reinterpret_cast<uint32_t*>(sm + SM::SH0 + off) = hi;
        *reinterpret_cast<uint32_t*>(sm + SM::SL0 + off) = lo;
        split_pair(w[i].x, w[i].y, hi, lo);
        *reinterpret_cast<uint32_t*>(sm + SM::DH0 + off) = hi;
        *reinterpret_cast<uint32_t*>(sm + SM::DL0 + off) = lo;
        sdot = fmaf(v[i].x, w[i].x, fmaf(v[i].y, w[i].y, sdot));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sdot += __shfl_xor_sync(0xffffffffu, sdot, o);
    if (lane == 0) aux[AX_LPART + MW + warp] = sdot;
  }
  cp_async_wait_all();
  __syncthreads();

  const int rA = 16 * warp + gr, rB = rA + 8;  // this thread's chunk rows
  float da = 0.0f, dsk = 0.0f;
  const uint32_t Xs = sb + SM::X0, DYs = sb + SM::DY0;
  const uint32_t Bs = sb + SM::B0, Cs = sb + SM::C0;

  // ---- the s rows: W^T, M^T, R^T, Z^T over t blocks j >= w ----
  float dxacc[PP / 8][4], dbacc[NP / 8][4];
#pragma unroll
  for (int i = 0; i < PP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxacc[i][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < NP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[i][e] = 0.0f;
  float rr[2] = {0.0f, 0.0f}, rz[2] = {0.0f, 0.0f};
  const float cumA = cum[rA], cumB = cum[rB];
  const float dtA = dts[rA], dtB = dts[rB];
  for (int j = 0; j < MW; ++j) {
    if (j < warp) {  // t < s: M^T is zero there
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off =
            swz_el<128>(r & 1 ? rB : rA, 16 * j + 2 * qd + (r >> 1) * 8);
        *reinterpret_cast<uint32_t*>(sm + SM::MH0 + off) = 0u;
        *reinterpret_cast<uint32_t*>(sm + SM::ML0 + off) = 0u;
      }
      continue;
    }
    float gT[2][4], qT[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) gT[hh][e] = qT[hh][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {  // G^T = B C^T
      uint32_t a[4], b[4];
      ldmatrix_x4(a, Bs + swz_el<BB>(16 * warp + lr + (lm & 1) * 8,
                                     16 * ks + (lm >> 1) * 8));
      ldmatrix_x4(b, Cs + swz_el<BB>(16 * j + lr + (lm >> 1) * 8,
                                     16 * ks + (lm & 1) * 8));
      mma_bf16(gT[0], a, b[0], b[1]);
      mma_bf16(gT[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int ks = 0; ks < PK; ++ks) {  // Q^T = x dy^T
      uint32_t a[4], b[4];
      ldmatrix_x4(a, Xs + swz_el<XB>(16 * warp + lr + (lm & 1) * 8,
                                     16 * ks + (lm >> 1) * 8));
      ldmatrix_x4(b, DYs + swz_el<XB>(16 * j + lr + (lm >> 1) * 8,
                                      16 * ks + (lm & 1) * 8));
      mma_bf16(qT[0], a, b[0], b[1]);
      mma_bf16(qT[1], a, b[2], b[3]);
    }
    float cz[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * j + 8 * hh + 2 * qd + (e & 1);
        const int s = e < 2 ? rA : rB;
        // masked BEFORE the exp: t < s would be cum_t - cum_s > 0
        const float lam =
            t >= s ? expf(cum[t] - (e < 2 ? cumA : cumB)) : 0.0f;
        const float dts_ = e < 2 ? dtA : dtB;
        const float g = gT[hh][e], qq = qT[hh][e];
        const float rv = g * lam * qq;
        rr[e >> 1] += rv;
        rz[e >> 1] += rv * dts_;
        cz[hh][e & 1] += rv * dts_;
        gT[hh][e] = g * lam * dts_;   // W^T
        qT[hh][e] = qq * lam * dts_;  // M^T
      }
    // Z^T's column sums over this warp's 16 rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = cz[hh][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gr == 0)
          aux[AX_COL + warp * L + 16 * j + 8 * hh + 2 * qd + c] = v;
      }
    uint32_t whi[4], wlo[4], mhi[4], mlo[4];
    acc_split(whi, wlo, gT[0], gT[1]);
    acc_split(mhi, mlo, qT[0], qT[1]);
#pragma unroll
    for (int pp = 0; pp < PK; ++pp) {  // dx += W^T dy
      uint32_t b[4];
      ldmatrix_x4_trans(b, DYs + swz_el<XB>(16 * j + lr + (lm & 1) * 8,
                                            16 * pp + (lm >> 1) * 8));
      mma_split(dxacc[2 * pp], whi, wlo, b[0], b[1]);
      mma_split(dxacc[2 * pp + 1], whi, wlo, b[2], b[3]);
    }
#pragma unroll
    for (int np = 0; np < NK; ++np) {  // dB += M^T C
      uint32_t b[4];
      ldmatrix_x4_trans(b, Cs + swz_el<BB>(16 * j + lr + (lm & 1) * 8,
                                           16 * np + (lm >> 1) * 8));
      mma_split(dbacc[2 * np], mhi, mlo, b[0], b[1]);
      mma_split(dbacc[2 * np + 1], mhi, mlo, b[2], b[3]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // M^T [s][t] for the t rows' dC
      const int off =
          swz_el<128>(r & 1 ? rB : rA, 16 * j + 2 * qd + (r >> 1) * 8);
      *reinterpret_cast<uint32_t*>(sm + SM::MH0 + off) = mhi[r];
      *reinterpret_cast<uint32_t*>(sm + SM::ML0 + off) = mlo[r];
    }
  }

  // ---- the s rows' state terms: x dS'^T (dB, v), B dS' (dx) ----
  const float uA = u[rA], uB = u[rB];
  const uint32_t DH = sb + SM::DH0, DL = sb + SM::DL0;
  float v[2] = {0.0f, 0.0f};
#pragma unroll
  for (int np = 0; np < NK; ++np) {
    float xs[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[hh][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < PK; ++ks) {
      uint32_t a[4], bhi[4], blo[4];
      ldmatrix_x4(a, Xs + swz_el<XB>(16 * warp + lr + (lm & 1) * 8,
                                     16 * ks + (lm >> 1) * 8));
      const int br = 16 * np + lr + (lm >> 1) * 8;
      ldmatrix_x4(bhi, DH + swz_el<XB>(br, 16 * ks + (lm & 1) * 8));
      ldmatrix_x4(blo, DL + swz_el<XB>(br, 16 * ks + (lm & 1) * 8));
      mma_bf16(xs[0], a, bhi[0], bhi[1]);
      mma_bf16(xs[0], a, blo[0], blo[1]);
      mma_bf16(xs[1], a, bhi[2], bhi[3]);
      mma_bf16(xs[1], a, blo[2], blo[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * np + 8 * hh + 2 * qd + (e & 1);
        const int s = e < 2 ? rA : rB;
        v[e >> 1] = fmaf(bf_at(SM::B0 + swz_el<BB>(s, n)), xs[hh][e],
                         v[e >> 1]);
        dbacc[2 * np + hh][e] =
            fmaf(e < 2 ? uA : uB, xs[hh][e], dbacc[2 * np + hh][e]);
      }
  }
#pragma unroll
  for (int pp = 0; pp < PK; ++pp) {
    float bs[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) bs[hh][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t a[4], bhi[4], blo[4];
      ldmatrix_x4(a, Bs + swz_el<BB>(16 * warp + lr + (lm & 1) * 8,
                                     16 * ks + (lm >> 1) * 8));
      const int br = 16 * ks + lr + (lm & 1) * 8;
      ldmatrix_x4_trans(bhi, DH + swz_el<XB>(br, 16 * pp + (lm >> 1) * 8));
      ldmatrix_x4_trans(blo, DL + swz_el<XB>(br, 16 * pp + (lm >> 1) * 8));
      mma_bf16(bs[0], a, bhi[0], bhi[1]);
      mma_bf16(bs[0], a, blo[0], blo[1]);
      mma_bf16(bs[1], a, bhi[2], bhi[3]);
      mma_bf16(bs[1], a, blo[2], blo[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dxacc[2 * pp + hh][e] =
            fmaf(e < 2 ? uA : uB, bs[hh][e], dxacc[2 * pp + hh][e]);
  }
  // skip: dx += D dy, dd_skip += x . dy; then dx and dB out
#pragma unroll
  for (int pt = 0; pt < PP / 8; ++pt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r ? rB : rA, p = 8 * pt + 2 * qd;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          sm + SM::X0 + swz_el<XB>(s, p)));
      const float2 dv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          sm + SM::DY0 + swz_el<XB>(s, p)));
      dxacc[pt][2 * r] = fmaf(D, dv.x, dxacc[pt][2 * r]);
      dxacc[pt][2 * r + 1] = fmaf(D, dv.y, dxacc[pt][2 * r + 1]);
      dsk = fmaf(xv.x, dv.x, fmaf(xv.y, dv.y, dsk));
      if (t0 + s < S && p < P)
        *reinterpret_cast<uint32_t*>(
            dx + (((size_t)bi * S + t0 + s) * H + h) * P + p) =
            pack_bf16(dxacc[pt][2 * r], dxacc[pt][2 * r + 1]);
    }
#pragma unroll
  for (int nt = 0; nt < NP / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r ? rB : rA, n = 8 * nt + 2 * qd;
      if (t0 + s < S && n < N)
        *reinterpret_cast<float2*>(
            dbh + (((size_t)bi * S + t0 + s) * H + h) * N + n) =
            make_float2(dbacc[nt][2 * r], dbacc[nt][2 * r + 1]);
    }
  // the s rows' scalars: v_s, sum_t R^T, sum_t Z^T over the quad
  float luv = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
      rr[r] += __shfl_xor_sync(0xffffffffu, rr[r], o);
      rz[r] += __shfl_xor_sync(0xffffffffu, rz[r], o);
    }
    const int s = r ? rB : rA;
    const float us = r ? uB : uA;
    if (qd == 0) {
      aux[AX_DDTX + s] = fmaf(el[s], v[r], rr[r]);
      aux[AX_ROWDC + s] = -rz[r] - us * v[r];
      luv = fmaf(us, v[r], luv);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    luv += __shfl_xor_sync(0xffffffffu, luv, o);
  if (lane == 0) aux[AX_LPART + warp] = luv;
  __syncthreads();  // M^T whole; every read of dS' done

  // ---- the t rows: dC = M B + exp(cum_t) S_k dy_t ----
  const float ecA = ecum[rA], ecB = ecum[rB];
  const uint32_t MH = sb + SM::MH0, ML = sb + SM::ML0;
  const uint32_t SHs = sb + SM::SH0, SLs = sb + SM::SL0;
  float inter[2] = {0.0f, 0.0f};
#pragma unroll
  for (int np = 0; np < NK; ++np) {
    float mc[2][4], ic[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) mc[hh][e] = ic[hh][e] = 0.0f;
    for (int j = 0; j <= warp; ++j) {
      uint32_t ahi[4], alo[4], b[4];
      const int ar = 16 * j + lr + (lm >> 1) * 8;
      ldmatrix_x4_trans(ahi, MH + swz_el<128>(ar, 16 * warp + (lm & 1) * 8));
      ldmatrix_x4_trans(alo, ML + swz_el<128>(ar, 16 * warp + (lm & 1) * 8));
      ldmatrix_x4_trans(b, Bs + swz_el<BB>(16 * j + lr + (lm & 1) * 8,
                                           16 * np + (lm >> 1) * 8));
      mma_split(mc[0], ahi, alo, b[0], b[1]);
      mma_split(mc[1], ahi, alo, b[2], b[3]);
    }
#pragma unroll
    for (int ks = 0; ks < PK; ++ks) {
      uint32_t a[4], bhi[4], blo[4];
      ldmatrix_x4(a, DYs + swz_el<XB>(16 * warp + lr + (lm & 1) * 8,
                                      16 * ks + (lm >> 1) * 8));
      const int br = 16 * np + lr + (lm >> 1) * 8;
      ldmatrix_x4(bhi, SHs + swz_el<XB>(br, 16 * ks + (lm & 1) * 8));
      ldmatrix_x4(blo, SLs + swz_el<XB>(br, 16 * ks + (lm & 1) * 8));
      mma_bf16(ic[0], a, bhi[0], bhi[1]);
      mma_bf16(ic[0], a, blo[0], blo[1]);
      mma_bf16(ic[1], a, bhi[2], bhi[3]);
      mma_bf16(ic[1], a, blo[2], blo[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? rB : rA, n = 16 * np + 8 * hh + 2 * qd;
        const float ec = r ? ecB : ecA;
        const float i0 = ec * ic[hh][2 * r], i1 = ec * ic[hh][2 * r + 1];
        inter[r] = fmaf(bf_at(SM::C0 + swz_el<BB>(t, n)), i0,
                        fmaf(bf_at(SM::C0 + swz_el<BB>(t, n + 1)), i1,
                             inter[r]));
        if (t0 + t < S && n < N)
          *reinterpret_cast<float2*>(
              dch + (((size_t)bi * S + t0 + t) * H + h) * N + n) =
              make_float2(mc[hh][2 * r] + i0, mc[hh][2 * r + 1] + i1);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inter[r] += __shfl_xor_sync(0xffffffffu, inter[r], 1);
    inter[r] += __shfl_xor_sync(0xffffffffu, inter[r], 2);
    if (qd == 0) aux[AX_ROWDC + (r ? rB : rA)] += inter[r];
  }

  __syncthreads();  // the scalars' parts written
  if (warp == 0) {
    float dT = 0.0f, sd = 0.0f;
    for (int w = 0; w < MW; ++w) {
      dT += aux[AX_LPART + w];
      sd += aux[AX_LPART + MW + w];
    }
    chunk_scalars(dts, aux + AX_DDTX, aux + AX_ROWDC, aux + AX_COL, MW,
                  fmaf(aux[5 * L], sd, dT), A,
                  ddt + ((size_t)bi * S + t0) * H + h, H, S - t0, da);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dsk += __shfl_xor_sync(0xffffffffu, dsk, o);
  if (lane == 0) aux[AX_RED + warp] = dsk;
  __syncthreads();
  if (threadIdx.x == 0) {  // the chunk's parts of da_log and dd_skip
    float t = 0.0f;
    for (int w = 0; w < MW; ++w) t += aux[AX_RED + w];
    const size_t o = ((size_t)bi * H + h) * nc + ck;
    dd_part[o] = t;
    da_part[o] = A * da;
  }
}

// pass 3: dB and dC summed over each group's heads in head order and
// rounded to bf16, two values of a (token, group) row a thread, eight
// heads' loads in flight before any is added; the last block also sums
// da_log's and dd_skip's parts, over each row's chunks and then the rows
constexpr int GS_THREADS = 128;
__global__ void __launch_bounds__(GS_THREADS)
ssd_bwd_group_sum_kernel(const float* __restrict__ dbh,
                         const float* __restrict__ dch,
                         const float* __restrict__ da_part,
                         const float* __restrict__ dd_part,
                         __nv_bfloat16* __restrict__ db,
                         __nv_bfloat16* __restrict__ dc,
                         float* __restrict__ da_log, float* __restrict__ dd,
                         long long rows, int B, int H, int G, int N, int nc) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float sa = 0.0f, sd = 0.0f;
      for (int bi = 0; bi < B; ++bi) {
        const size_t o = ((size_t)bi * H + h) * nc;
        float ta = 0.0f, td = 0.0f;
        for (int k = 0; k < nc; ++k) {
          ta += da_part[o + k];
          td += dd_part[o + k];
        }
        sa += ta;
        sd += td;
      }
      da_log[h] = sa;
      dd[h] = sd;
    }
    return;
  }
  const int n2 = N / 2, hg = H / G;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * G * n2) return;
  const long long row = i / (G * n2);
  const int g = (int)(i % (G * n2)) / n2, c = (int)(i % n2);
  const size_t in = ((size_t)row * H + (size_t)g * hg) * N + 2 * c;
  float2 sb = *reinterpret_cast<const float2*>(dbh + in);
  float2 sc = *reinterpret_cast<const float2*>(dch + in);
  int j = 1;
  for (; j + 8 <= hg; j += 8) {
    float2 a[8], b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a[u] = *reinterpret_cast<const float2*>(dbh + in + (size_t)(j + u) * N);
      b[u] = *reinterpret_cast<const float2*>(dch + in + (size_t)(j + u) * N);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sb.x += a[u].x;
      sb.y += a[u].y;
      sc.x += b[u].x;
      sc.y += b[u].y;
    }
  }
  for (; j < hg; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(dbh + in + (size_t)j * N);
    const float2 b = *reinterpret_cast<const float2*>(dch + in + (size_t)j * N);
    sb.x += a.x;
    sb.y += a.y;
    sc.x += b.x;
    sc.y += b.y;
  }
  const size_t out = ((size_t)row * G + g) * N + 2 * c;
  *reinterpret_cast<uint32_t*>(db + out) = pack_bf16(sb.x, sb.y);
  *reinterpret_cast<uint32_t*>(dc + out) = pack_bf16(sc.x, sc.y);
}

// ---------------------------------------------------------------------------
// float32: ssd_bwd_kernel, FMA tiles
// ---------------------------------------------------------------------------

constexpr int FT = 256;
constexpr int FW = FT / 32;
constexpr int AX_FLPART = AX_COL + FW * L;  // sum u v, then <S_k, dS'>
constexpr int AX_FV = AX_FLPART + 2 * FW;   // the last reduction's
constexpr int AUX_F32 = AX_FV + L;
constexpr int WS = L + 1;  // row stride of W^T and M^T

// floats: x, dy [L][P + 4]; B, C [L][N + 4]; W^T, M^T [L][L + 1]; XS
// (x dS'^T, then dy S_k^T) [L][N + 1]; aux
int f32_smem_floats(int P, int N) {
  return 2 * L * (P + 4) + 2 * L * (N + 4) + 2 * L * WS + L * (N + 1) +
         AUX_F32;
}

__global__ void __launch_bounds__(FT)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ d_skip,
               const float* __restrict__ chunk_states,
               const float* __restrict__ dy, const float* __restrict__ dstate,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dbh, float* __restrict__ dch,
               float* __restrict__ da_part, float* __restrict__ dd_part,
               float* __restrict__ ds, int S, int H, int G, int P, int N,
               long long xbs, long long xts, long long bbs, long long bts) {
  extern __shared__ float4 smf4[];
  const int P4 = P + 4, N4 = N + 4, N1 = N + 1;
  float* Xs = reinterpret_cast<float*>(smf4);
  float* DYs = Xs + L * P4;
  float* Bs = DYs + L * P4;
  float* Cs = Bs + L * N4;
  float* WT = Cs + L * N4;
  float* MT = WT + L * WS;
  float* XS = MT + L * WS;
  float* aux = XS + L * N1;
  const float* cum = aux;
  const float* dts = aux + L;
  const float* ecum = aux + 2 * L;
  const float* el = aux + 3 * L;
  const float* u = aux + 4 * L;

  const int h = blockIdx.x, bi = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float A = -expf(a_log[h]);
  const float D = d_skip[h];
  const int n_chunks = (S + L - 1) / L;
  const size_t st_off = ((size_t)bi * H + h) * N * P;
  float* dS = ds + st_off;  // dS', carried in the output buffer
  const long long dys = (long long)H * P;
  for (int e = tid; e < N * P; e += FT)
    dS[e] = dstate != nullptr ? dstate[st_off + e] : 0.0f;

  float da = 0.0f, dsk = 0.0f;
  for (int ck = n_chunks - 1; ck >= 0; --ck) {
    const int t0 = ck * L;
    __syncthreads();  // the later chunk is done; dS' visible
    for (int e = tid; e < L * (P / 4); e += FT) {
      const int r = e / (P / 4), c = 4 * (e % (P / 4));
      const bool ok = t0 + r < S;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(Xs + r * P4 + c) =
          ok ? *reinterpret_cast<const float4*>(
                   x + bi * xbs + (t0 + r) * xts + (long long)h * P + c)
             : z;
      *reinterpret_cast<float4*>(DYs + r * P4 + c) =
          ok ? *reinterpret_cast<const float4*>(
                   dy + ((size_t)bi * S + t0 + r) * dys + (long long)h * P + c)
             : z;
    }
    for (int e = tid; e < L * (N / 4); e += FT) {
      const int r = e / (N / 4), c = 4 * (e % (N / 4));
      const bool ok = t0 + r < S;
      const long long off = bi * bbs + (t0 + r) * bts + (long long)grp * N + c;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(Bs + r * N4 + c) =
          ok ? *reinterpret_cast<const float4*>(bm + off) : z;
      *reinterpret_cast<float4*>(Cs + r * N4 + c) =
          ok ? *reinterpret_cast<const float4*>(cm + off) : z;
    }
    if (warp == 0) chunk_scan(dt + (size_t)bi * S * H + h, H, t0, S, A, aux);
    for (int i = lane; i < L; i += 32) aux[AX_COL + warp * L + i] = 0.0f;
    __syncthreads();

    // W^T, M^T and the R^T / Z^T sums: thread (ty, tx) takes rows
    // s = 4 ty + i and columns t = 4 tx + j
    {
      const int ty = tid / 16, tx = tid % 16;
      float g[4][4], q[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = q[i][j] = 0.0f;
      if (tx >= ty) {  // the patch reaches t >= s
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              g[i][j] = fmaf(Bs[(4 * ty + i) * N4 + n],
                             Cs[(4 * tx + j) * N4 + n], g[i][j]);
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              q[i][j] = fmaf(Xs[(4 * ty + i) * P4 + p],
                             DYs[(4 * tx + j) * P4 + p], q[i][j]);
      }
      float rr[4], rz[4], cz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * ty + i;
        rr[i] = rz[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * tx + j;
          const float lam = t >= s ? expf(cum[t] - cum[s]) : 0.0f;
          const float rv = g[i][j] * lam * q[i][j];
          rr[i] += rv;
          rz[i] += rv * dts[s];
          cz[j] += rv * dts[s];
          WT[s * WS + t] = g[i][j] * lam * dts[s];
          MT[s * WS + t] = q[i][j] * lam * dts[s];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          rr[i] += __shfl_xor_sync(0xffffffffu, rr[i], o);
          rz[i] += __shfl_xor_sync(0xffffffffu, rz[i], o);
        }
      if (tx == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aux[AX_DDTX + 4 * ty + i] = rr[i];
          aux[AX_ROWDC + 4 * ty + i] = -rz[i];
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cz[j] += __shfl_xor_sync(0xffffffffu, cz[j], 16);
        if (lane < 16) aux[AX_COL + warp * L + 4 * tx + j] = cz[j];
      }
    }
    // XS = x dS'^T
    for (int e = tid; e < L * N; e += FT) {
      const int s = e / N, n = e % N;
      float acc = 0.0f;
      for (int p = 0; p < P; ++p)
        acc = fmaf(Xs[s * P4 + p], dS[(size_t)n * P + p], acc);
      XS[s * N1 + n] = acc;
    }
    __syncthreads();
    if (tid < L) {  // v_s and the s rows' state scalars
      const int s = tid;
      float vv = 0.0f;
      for (int n = 0; n < N; ++n)
        vv = fmaf(Bs[s * N4 + n], XS[s * N1 + n], vv);
      aux[AX_DDTX + s] = fmaf(el[s], vv, aux[AX_DDTX + s]);
      aux[AX_ROWDC + s] -= u[s] * vv;
      float luv = u[s] * vv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        luv += __shfl_xor_sync(0xffffffffu, luv, o);
      if (lane == 0) aux[AX_FLPART + warp] = luv;
    }
    // dB = M^T C + u_s XS, dx = W^T dy + u_s B dS' + D dy
    for (int e = tid; e < L * N; e += FT) {
      const int s = e / N, n = e % N;
      float acc = u[s] * XS[s * N1 + n];
      for (int t = s; t < L; ++t)
        acc = fmaf(MT[s * WS + t], Cs[t * N4 + n], acc);
      if (t0 + s < S) dbh[(((size_t)bi * S + t0 + s) * H + h) * N + n] = acc;
    }
    for (int e = tid; e < L * P; e += FT) {
      const int s = e / P, p = e % P;
      float acc = 0.0f, st = 0.0f;
      for (int t = s; t < L; ++t)
        acc = fmaf(WT[s * WS + t], DYs[t * P4 + p], acc);
      for (int n = 0; n < N; ++n)
        st = fmaf(Bs[s * N4 + n], dS[(size_t)n * P + p], st);
      const float dyv = DYs[s * P4 + p];
      acc = fmaf(D, dyv, fmaf(u[s], st, acc));
      dsk = fmaf(Xs[s * P4 + p], dyv, dsk);
      if (t0 + s < S) dx[(((size_t)bi * S + t0 + s) * H + h) * P + p] = acc;
    }
    __syncthreads();  // XS read
    // XS = dy S_k^T; then dC = M C... = M B + exp(cum_t) XS
    const float* sk =
        chunk_states + (((size_t)bi * H + h) * n_chunks + ck) * N * P;
    for (int e = tid; e < L * N; e += FT) {
      const int t = e / N, n = e % N;
      float acc = 0.0f;
      for (int p = 0; p < P; ++p)
        acc = fmaf(DYs[t * P4 + p], sk[(size_t)n * P + p], acc);
      XS[t * N1 + n] = acc;
    }
    float sdot = 0.0f;
    for (int e = tid; e < N * P; e += FT) sdot = fmaf(sk[e], dS[e], sdot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sdot += __shfl_xor_sync(0xffffffffu, sdot, o);
    if (lane == 0) aux[AX_FLPART + FW + warp] = sdot;
    __syncthreads();
    for (int e = tid; e < L * N; e += FT) {
      const int t = e / N, n = e % N;
      float acc = ecum[t] * XS[t * N1 + n];
      for (int s = 0; s <= t; ++s)
        acc = fmaf(MT[s * WS + t], Bs[s * N4 + n], acc);
      if (t0 + t < S) dch[(((size_t)bi * S + t0 + t) * H + h) * N + n] = acc;
    }
    if (tid < L) {
      const int t = tid;
      float acc = 0.0f;
      for (int n = 0; n < N; ++n)
        acc = fmaf(Cs[t * N4 + n], XS[t * N1 + n], acc);
      aux[AX_ROWDC + t] = fmaf(ecum[t], acc, aux[AX_ROWDC + t]);
    }
    __syncthreads();  // every read of dS' done
    const float eT = aux[5 * L];
    for (int e = tid; e < N * P; e += FT) {
      const int n = e / P, p = e % P;
      float acc = 0.0f;
      for (int t = 0; t < L; ++t)
        acc = fmaf(Cs[t * N4 + n] * ecum[t], DYs[t * P4 + p], acc);
      dS[e] = fmaf(eT, dS[e], acc);
    }
    if (warp == 0) {
      float dT = 0.0f, sd = 0.0f;
      for (int w = 0; w < FW; ++w) {
        dT += w < 2 ? aux[AX_FLPART + w] : 0.0f;
        sd += aux[AX_FLPART + FW + w];
      }
      chunk_scalars(dts, aux + AX_DDTX, aux + AX_ROWDC, aux + AX_COL, FW,
                    fmaf(eT, sd, dT), A,
                    ddt + ((size_t)bi * S + t0) * H + h, H, S - t0, da);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dsk += __shfl_xor_sync(0xffffffffu, dsk, o);
  __syncthreads();
  float* red = aux + AX_FV;
  if (lane == 0) red[warp] = dsk;
  if (warp == 0)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int w = 0; w < FW; ++w) t += red[w];
    dd_part[(size_t)bi * H + h] = t;
    da_part[(size_t)bi * H + h] = A * da;
  }
}

struct Args {
  const void *x, *b, *c, *dy;
  const float *dt, *a_log, *d_skip, *chunk_states, *dstate;
  void *dx, *db, *dc;
  float *ddt, *dbh, *dch, *da_part, *dd_part, *ds, *carry, *da_log, *dd;
  int B, S, H, G, P, N;
  long long xbs, xts, bbs, bts;
};

template <int PP, int NP>
int launch_mma(const Args& r, cudaStream_t s) {
  using bf = __nv_bfloat16;
  constexpr int smem = BwdSmem<PP, NP>::TOTAL;
  constexpr int csmem = CarrySmem<PP, NP>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<PP, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_carry_kernel<PP, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               csmem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_carry_kernel<PP, NP><<<dim3(r.H, r.B), MT, csmem, s>>>(
      r.dt, r.a_log, static_cast<const bf*>(r.c), static_cast<const bf*>(r.dy),
      r.dstate, r.carry, r.ds, r.S, r.H, r.G, r.P, r.N, r.bbs, r.bts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nc = (r.S + L - 1) / L;
  ssd_bwd_chunk_kernel<PP, NP><<<dim3(r.H, nc, r.B), MT, smem, s>>>(
      static_cast<const bf*>(r.x), r.dt, r.a_log, static_cast<const bf*>(r.b),
      static_cast<const bf*>(r.c), r.d_skip, r.chunk_states, r.carry,
      static_cast<const bf*>(r.dy), static_cast<bf*>(r.dx), r.ddt, r.dbh,
      r.dch, r.da_part, r.dd_part, r.S, r.H, r.G, r.P, r.N, r.xbs, r.xts,
      r.bbs, r.bts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)r.B * r.S;
  const long long n = rows * r.G * (r.N / 2);
  ssd_bwd_group_sum_kernel<<<(unsigned)((n + GS_THREADS - 1) / GS_THREADS) + 1,
                             GS_THREADS, 0, s>>>(
      r.dbh, r.dch, r.da_part, r.dd_part, static_cast<bf*>(r.db),
      static_cast<bf*>(r.dc), r.da_log, r.dd, rows, r.B, r.H, r.G, r.N, nc);
  return (int)cudaGetLastError();
}

int launch_fma(const Args& r, cudaStream_t s) {
  const int smem = f32_smem_floats(r.P, r.N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<<<dim3(r.H, r.B), FT, smem, s>>>(
      static_cast<const float*>(r.x), r.dt, r.a_log,
      static_cast<const float*>(r.b), static_cast<const float*>(r.c),
      r.d_skip, r.chunk_states, static_cast<const float*>(r.dy), r.dstate,
      static_cast<float*>(r.dx), r.ddt, r.dbh, r.dch, r.da_part, r.dd_part,
      r.ds, r.S, r.H, r.G, r.P, r.N, r.xbs, r.xts, r.bbs, r.bts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of x, b, c, dy and dx): 0 = float32 (ssd_bwd_kernel), 1 = bfloat16
// (the three passes).  x, b, c read through (batch, token) strides as in
// ssd_scan_launch; dt (B, S, H), chunk_states (B, H, nc, N, P) (the
// forward's; nc = ceil(S / 64)) and dstate (B, H, N, P, may be null)
// float32 and contiguous; dy and dx (B, S, H, P) contiguous.  Out: ddt
// (B, S, H), the per-head dB and dC (B, S, H, N), da_log's and dd_skip's
// parts (float32: (B, H) one a batch row; bfloat16: (B, H, nc) one a
// chunk) and ds (B, H, N, P) the initial state's gradient, all float32.
// bfloat16 also takes the float32 scratch `carry` (B, H, nc, N, P), each
// chunk's dS', and writes db and dc (B, S, G, N, bf16), the per-head dB
// and dC summed over each group's heads in head order, and da_log and dd
// (H, float32), the parts summed over each row's chunks, then the rows;
// float32 reads and writes none of these (may be null) and leaves those
// sums to the caller.  Nothing is allocated; one launch in float32,
// three in bfloat16.
int ssd_scan_bwd_launch(const void* x, const float* dt, const float* a_log,
                        const void* b, const void* c, const float* d_skip,
                        const float* chunk_states, const void* dy,
                        const float* dstate, void* dx, float* ddt, float* dbh,
                        float* dch, float* da_part, float* dd_part, float* ds,
                        float* carry, void* db, void* dc, float* da_log,
                        float* dd, int B, int S, int H, int G, int P, int N,
                        int dtype, long long xbs, long long xts,
                        long long bbs, long long bts, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (P % 16 || N % 16 || P < 16 || N < 16 || P > 128 || N > 128 || G < 1 ||
      H % G ||
      (dtype == 1 && (carry == nullptr || db == nullptr || dc == nullptr ||
                      da_log == nullptr || dd == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args r{x, b, c, dy, dt, a_log, d_skip, chunk_states, dstate, dx, db,
               dc, ddt, dbh, dch, da_part, dd_part, ds, carry, da_log, dd,
               B, S, H, G, P, N, xbs, xts, bbs, bts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma(r, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (P <= 64)
    return N <= 64 ? launch_mma<64, 64>(r, s) : launch_mma<64, 128>(r, s);
  return N <= 64 ? launch_mma<128, 64>(r, s) : launch_mma<128, 128>(r, s);
}

}  // extern "C"
