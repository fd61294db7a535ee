// ssd_scan: the Mamba-2 SSD chunked scan, one block per (head, batch row).
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py: ssd_scan_kernel_call
// (body _ssd_kernel), the kernel twin of repro.models.ssm.ssd_chunked.
// x (B, S, H, P) and b, c (B, S, G, N) in float32 or bfloat16, read
// through batch and token strides (the model passes slices of one
// activation); dt (B, S, H), a_log and d_skip (H,) and the optional
// initial state (B, H, N, P) in float32.  With A = -exp(a_log[h]) and,
// inside a chunk, the inclusive cumulative log decay cum_t = sum_{s<=t}
// dt_s A:
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s     (intra)
//         + exp(cum_t) C_t . S                                     (inter)
//         + D x_t                                                  (skip)
//   S    <- exp(total) S + sum_s B_s (x_s exp(total - cum_s) dt_s)  (update)
// with S the (N, P) float32 state carried across chunks.  Head h reads B/C
// group h / (H / G), the group-major order of the reference's jnp.repeat;
// the repeat is never materialised.  y goes out in x's dtype and the final
// state in float32.  Both kernels walk the sequence in chunks of L = 64
// inside one block, so one launch covers a whole Mamba-2 block and nothing
// but y and the final state goes back to device memory; a fixed chunk with
// a masked ragged tail (dt = x = B = C = 0 past S keeps cum flat and adds
// nothing) replaces the reference's fallback to one chunk of length S when
// S is not a multiple of 128.  P and N are multiples of 16 up to 128.
//
// What bounds it on this card: bytes.  At zamba2-7b's prefill (B = 8,
// S = 1024, H = 112, P = N = 64, bf16) a launch moves about 255 MB (x in
// and y out at 117 MB each): 0.076 ms at 3.35 TB/s, against 0.046 ms for
// the reference's ~45 GFLOP at chunk 128 on the bf16 tensor cores.
//
// bfloat16: ssd_mma_kernel, four warps, the chunk's products on the tensor
// cores (mma.sync m16n8k16, bf16 operands, float32 accumulators).  Warp w
// owns chunk rows 16 w .. 16 w + 15 of y and rows 16 w + 64 i of the
// state, which lives in its float32 accumulator fragments for the whole
// sequence.  Per chunk: y = exp(cum_t) (C S) with S's bf16 copy in shared
// memory as the B operand; then for each 16-position block j <= w,
// G = C B^T from ldmatrix fragments, W = G exp(cum_t - cum_s) dt_s in
// registers (below the diagonal block as G alpha_j(t) beta_s, two factors
// of at most 1 that the scan warp tabulates once a chunk; on it masked
// BEFORE the exp, since above the diagonal cum_t - cum_s > 0 overflows and
// inf * 0 is NaN), and W's accumulator fragment is the A fragment of
// y += W x (the flash trick: W never goes through shared memory), split
// into bf16 hi + lo, two products: W rounded once to bf16 puts y about
// nine times further from the float32 scan at the model's dt, which moved
// the reduced zamba2's logits on the card past their 4e-2 against the CPU.
// y + D x leaves by 16-byte stores gathered by a transpose within each
// quad.  The state update S <- exp(total) S + (B u)^T x (u_s =
// exp(total - cum_s) dt_s) splits its float32 operand B u the same way:
// a single bf16 rounding there moves the final state by about 6e-4
// relative over 1,024 positions, the split by under 1e-6
// (tests/test_torch_ssd_hopper.py).  x and B come in a two-chunk ring of
// cp.async copies issued a chunk ahead, C in one buffer refilled once every
// warp holds its fragments; tiles are bf16 with 16-byte pieces XOR-swizzled
// by row, so ldmatrix and the copies hit distinct banks without padding.
// Two block barriers a chunk.  52 KB of shared memory and 128 registers a
// thread at P = N = 64: four blocks an SM.  Warp 0, whose intra work is the
// smallest, scans the next chunk's dt with shuffles.
//
// With a non-null `chunk_states` (the trainable form, SsdScanFn) both
// kernels also write the float32 state before each chunk, (B, H, nc, N, P),
// for the backward (ssd_scan_bwd.cu); inference passes null.
//
// float32: ssd_kernel, 256 threads on the FMA units.  Per chunk it stages
// x (float32, [L][PP]), B and C (transposed, [N][L + 4]) and dt; two warps
// take the inclusive scan of dt A with shuffles.  The weights W[t][s] are
// computed as 4 x 4 patches of C B^T, masked before the exp, and patches
// wholly above the diagonal are skipped.  Each thread then owns four
// columns of y (and of the state) on rows strided by 256 / (PP / 4); PP is
// P rounded up to 32, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;        // chunk length
constexpr int LS = L + 4;    // padded row stride of W, B^T and C^T
constexpr int THREADS = 256;
constexpr int MAX_N = 128;

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

__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

int smem_floats(int PP, int N) { return L * PP + L * LS + N * PP + 2 * N * LS + 4 * L; }

template <typename T, int PP>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ state_out, float* __restrict__ chunk_states,
           int S, int H, int G, int P, int N, long long xbs, long long xts,
           long long bbs, long long bts) {
  constexpr int CG = PP / 4;                      // 4-column groups
  constexpr int RGS = THREADS / CG;               // row groups = row stride
  constexpr int YR = L / RGS;                     // y rows per thread
  constexpr int SR = (MAX_N + RGS - 1) / RGS;     // state rows, at most
  constexpr int VN = Vec<T>::N;

  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // [L][PP]   x
  float* W = Xs + L * PP;                       // [L][LS]   intra weights
  float* Ss = W + L * LS;                       // [N][PP]   state
  float* Bt = Ss + N * PP;                      // [N][LS]   B^T
  float* Ct = Bt + N * LS;                      // [N][LS]   C^T
  float* cum = Ct + N * LS;                     // [L] inclusive log decay
  float* dts = cum + L;                         // [L] dt
  float* ecum = dts + L;                        // [L] exp(cum)
  float* u = ecum + L;                          // [L] exp(total - cum) dt

  const int h = blockIdx.x, bi = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const float A = -expf(a_log[h]);
  const float D = d_skip[h];
  const int rg = tid / CG, cg = tid % CG;
  const int p0 = cg * 4;
  const bool col_ok = p0 < P;  // P is a multiple of 16: whole groups
  const size_t st_off = ((size_t)bi * H + h) * N * P;

  for (int e = tid; e < N * PP; e += THREADS) {
    const int n = e / PP, p = e % PP;
    Ss[e] = (init != nullptr && p < P) ? init[st_off + (size_t)n * P + p]
                                       : 0.0f;
  }

  const int n_chunks = (S + L - 1) / L;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * L;
    __syncthreads();  // the previous chunk's readers are done
    if (chunk_states != nullptr) {  // the state before this chunk
      float* cs =
          chunk_states + (((size_t)bi * H + h) * n_chunks + ck) * N * P;
      for (int e = tid; e < N * P; e += THREADS)
        cs[e] = Ss[(e / P) * PP + e % P];
    }

    // dt and its scaled inclusive scan, one warp per 32 positions
    if (tid < L) {
      const int t = t0 + tid;
      const float d = t < S ? dt[((size_t)bi * S + t) * H + h] : 0.0f;
      dts[tid] = d;
      float v = d * A;
      const int lane = tid & 31;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      cum[tid] = v;
    }
    // x rows, 16-byte loads
    const int PG = P / VN;
    for (int e = tid; e < L * PG; e += THREADS) {
      const int r = e / PG, gi = e % PG;
      const int t = t0 + r;
      float buf[VN];
      if (t < S) {
        Vec<T>::load(x + bi * xbs + t * xts + (size_t)h * P + gi * VN, buf);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) buf[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < VN; i += 4) store4(&Xs[r * PP + gi * VN + i], buf + i);
    }
    // B and C rows of this head's group, stored transposed
    const int NG = N / VN;
    for (int e = tid; e < L * NG; e += THREADS) {
      const int r = e % L, gi = e / L;
      const int t = t0 + r;
      float bb[VN], cc[VN];
      if (t < S) {
        const long long off = bi * bbs + t * bts + (long long)grp * N + gi * VN;
        Vec<T>::load(bm + off, bb);
        Vec<T>::load(cm + off, cc);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) bb[i] = cc[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        Bt[(gi * VN + i) * LS + r] = bb[i];
        Ct[(gi * VN + i) * LS + r] = cc[i];
      }
    }
    __syncthreads();
    if (tid >= 32 && tid < L) cum[tid] += cum[31];
    __syncthreads();
    const float total = cum[L - 1];  // past S, dt = 0 keeps cum flat
    if (tid < L) {
      ecum[tid] = expf(cum[tid]);
      u[tid] = expf(total - cum[tid]) * dts[tid];
    }

    // W[t][s] = (s <= t) ? (C_t . B_s) exp(cum_t - cum_s) dt_s : 0
    {
      const int ty = tid / 16, tx = tid % 16;
      float w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] = 0.0f;
      if (tx <= ty) {  // the patch reaches the diagonal or lies below it
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LS + ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * LS + tx * 4]);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] = fmaf(c4[i], b4[j], w[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx * 4 + j;
            w[i][j] = s <= t ? w[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) store4(&W[(ty * 4 + i) * LS + tx * 4], w[i]);
    }
    __syncthreads();

    // y = W x + exp(cum) (C S) + D x on this thread's rows and columns
    if (col_ok) {
      float acc[YR][4], inter[YR][4];
#pragma unroll
      for (int i = 0; i < YR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = inter[i][j] = 0.0f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * PP + p0]);
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const float wv = W[(rg + RGS * i) * LS + s];
          acc[i][0] = fmaf(wv, xv.x, acc[i][0]);
          acc[i][1] = fmaf(wv, xv.y, acc[i][1]);
          acc[i][2] = fmaf(wv, xv.z, acc[i][2]);
          acc[i][3] = fmaf(wv, xv.w, acc[i][3]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 sv = *reinterpret_cast<const float4*>(&Ss[n * PP + p0]);
#pragma unroll
        for (int i = 0; i < YR; ++i) {
          const float cv = Ct[n * LS + rg + RGS * i];
          inter[i][0] = fmaf(cv, sv.x, inter[i][0]);
          inter[i][1] = fmaf(cv, sv.y, inter[i][1]);
          inter[i][2] = fmaf(cv, sv.z, inter[i][2]);
          inter[i][3] = fmaf(cv, sv.w, inter[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int t = rg + RGS * i;
        if (t0 + t >= S) continue;
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[t * PP + p0]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
        const float e = ecum[t];
        float out[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[j] = fmaf(D, xs[j], fmaf(e, inter[i][j], acc[i][j]));
        store4(y + (((size_t)bi * S + t0 + t) * H + h) * P + p0, out);
      }
    }
    __syncthreads();  // every reader of the old state is done

    // S <- exp(total) S + B^T (u x)
    if (col_ok) {
      const float et = expf(total);
      float acc[SR][4];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float us = u[s];
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * PP + p0]);
        const float x4[4] = {xv.x * us, xv.y * us, xv.z * us, xv.w * us};
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const int n = rg + RGS * i;
          if (n < N) {
            const float bv = Bt[n * LS + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv, x4[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int n = rg + RGS * i;
        if (n >= N) continue;
        float* sp = &Ss[n * PP + p0];
        const float4 old = *reinterpret_cast<const float4*>(sp);
        const float nv[4] = {fmaf(et, old.x, acc[i][0]), fmaf(et, old.y, acc[i][1]),
                             fmaf(et, old.z, acc[i][2]), fmaf(et, old.w, acc[i][3])};
        store4(sp, nv);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS)
    state_out[st_off + e] = Ss[(e / P) * PP + e % P];
}

// ---------------------------------------------------------------------------
// bfloat16: ssd_mma_kernel, the chunk's products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MW = 4;  // warps: warp w owns chunk rows 16 w .. 16 w + 15
constexpr int MT = 32 * MW;
constexpr int AUX = 8 * L + 4;  // floats of one chunk's scalars, below

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; valid == false writes 16 zero bytes (rows past
// S, columns past P or N) and reads nothing
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
__device__ inline float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// a float32 pair as a bf16 pair hi plus the bf16 pair lo of what hi misses
__device__ inline void split_pair(float v0, float v1, uint32_t& hi,
                                  uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 hf = unpack_bf16(hi);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}
// the bf16 pair v scaled by (u0, u1) in float32, split
__device__ inline void split_scaled(uint32_t v, float u0, float u1,
                                    uint32_t& hi, uint32_t& lo) {
  const float2 vf = unpack_bf16(v);
  split_pair(vf.x * u0, vf.y * u1, hi, lo);
}

// Tiles in shared memory are rows of RB bytes cut in 16-byte pieces; piece
// c of row r sits at piece c ^ (r % 8), so the 8 rows an ldmatrix reads
// (and the cp.async writes) fall in distinct banks without padding
template <int RB>
__device__ inline uint32_t swz(int r, int c) {
  return r * RB + ((c ^ (r & 7)) << 4);
}
template <int RB>
__device__ inline uint32_t swz_el(int r, int col) {  // bf16 element offset
  return swz<RB>(r, col >> 3) + ((col & 7) << 1);
}

// One chunk's rows of a (B, S, ., width) operand into a swizzled tile:
// row r is position t0 + r, `valid` 16-byte pieces of it are real.  Each
// thread copies one column piece of every MT / PC-th row
template <int RB>
__device__ inline void stage_rows(uint32_t tile, const __nv_bfloat16* src,
                                  long long ts, int valid, int t0, int S) {
  constexpr int PC = RB / 16, RSTEP = MT / PC;
  const int c = threadIdx.x % PC, r0 = threadIdx.x / PC;
  const bool col_ok = c < valid;
  const __nv_bfloat16* p = src + (t0 + r0) * ts + c * 8;
#pragma unroll
  for (int i = 0; i < L / RSTEP; ++i) {
    const int r = r0 + i * RSTEP;
    const bool ok = col_ok && t0 + r < S;
    cp_async16(tile + swz<RB>(r, c), ok ? p + i * RSTEP * ts : src, ok);
  }
}

// 4 x 4 transpose of 32-bit words across the lanes of a quad: lane q ends
// with v[j] = lane j's v[q]
__device__ inline void quad_transpose(uint32_t (&v)[4], int q) {
  const bool odd = q & 1, high = q & 2;
  uint32_t s0 = odd ? v[0] : v[1], s1 = odd ? v[2] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) {
    v[0] = s0;
    v[2] = s1;
  } else {
    v[1] = s0;
    v[3] = s1;
  }
  s0 = high ? v[0] : v[2];
  s1 = high ? v[1] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (high) {
    v[0] = s0;
    v[1] = s1;
  } else {
    v[2] = s0;
    v[3] = s1;
  }
}

// shared memory in byte offsets, for P and N padded to PP and NP (64 or
// 128): x and B in a ring of two chunks, C in one (its copy for the next
// chunk starts once every warp has its fragments), the bf16 copy of the
// state [NP][PP], and two chunks' scalars: [L] each of cum, dt,
// u = exp(total - cum) dt, exp(cum), beta and alpha_0..2 (see scan), then
// exp(total)
template <int PP, int NP>
struct MmaSmem {
  static constexpr int XB = 2 * PP, BB = 2 * NP;  // row bytes
  static constexpr int X_TILE = L * XB, B_TILE = L * BB;
  static constexpr int X0 = 0;
  static constexpr int B0 = X0 + 2 * X_TILE;
  static constexpr int C0 = B0 + 2 * B_TILE;
  static constexpr int S0 = C0 + B_TILE;
  static constexpr int A0 = S0 + NP * XB;
  static constexpr int TOTAL = A0 + 2 * AUX * 4;
};

// the float32 state held in the warps' accumulators, (N, P) row-major
template <int NSW, int PT>
__device__ inline void store_state(float* dst, const float (&sacc)[NSW][PT][4],
                                   int warp, int g, int q, int P, int N) {
#pragma unroll
  for (int i = 0; i < NSW; ++i) {
    const int n0 = 16 * (warp + MW * i) + g;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = 8 * pt + 2 * q;
      if (p >= P) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + 8 * r;
        if (n < N)
          *reinterpret_cast<float2*>(dst + (size_t)n * P + p) =
              make_float2(sacc[i][pt][2 * r], sacc[i][pt][2 * r + 1]);
      }
    }
  }
}

template <int PP, int NP>
__global__ void __launch_bounds__(MT, (PP == 64 && NP == 64) ? 4 : 1)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ a_log,
               const __nv_bfloat16* __restrict__ bm,
               const __nv_bfloat16* __restrict__ cm,
               const float* __restrict__ d_skip,
               const float* __restrict__ init, __nv_bfloat16* __restrict__ y,
               float* __restrict__ state_out,
               float* __restrict__ chunk_states, int S, int H, int G, int P,
               int N, long long xbs, long long xts, long long bbs,
               long long bts) {
  using SM = MmaSmem<PP, NP>;
  constexpr int XB = SM::XB, BB = SM::BB;
  constexpr int PT = PP / 8;   // n8 tiles of y and of the state
  constexpr int NK = NP / 16;  // k16 steps over N
  constexpr int NSW = NK / MW;  // state row slabs a warp owns: m = w + 4 i
  static_assert(NK % MW == 0, "N is padded to 64 or 128");

  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t sbase = smem_u32(smem_mma);
  float* aux = reinterpret_cast<float*>(smem_mma + SM::A0);

  const int h = blockIdx.x, bi = blockIdx.y;
  const int grp = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;      // mma fragment coordinates
  const int lr = lane % 8, lm = lane / 8;    // ldmatrix row and matrix
  const float A = -expf(a_log[h]);
  const float D = d_skip[h];
  const int n_chunks = (S + L - 1) / L;
  const size_t st_off = ((size_t)bi * H + h) * N * P;
  const __nv_bfloat16* xh = x + bi * xbs + (long long)h * P;
  const __nv_bfloat16* bh = bm + bi * bbs + (long long)grp * N;
  const __nv_bfloat16* chh = cm + bi * bbs + (long long)grp * N;
  const float* dth = dt + (size_t)bi * S * H + h;

  // warp 0: chunk k's dt at positions lane and lane + 32 (zero past S),
  // then its scalars into buffer k % 2
  auto load_dt = [&](int k, float& d0, float& d1) {
    const int t = k * L + lane;
    d0 = t < S ? dth[(size_t)t * H] : 0.0f;
    d1 = t + 32 < S ? dth[(size_t)(t + 32) * H] : 0.0f;
  };
  auto scan = [&](int k, float d0, float d1) {
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
    float* a = aux + (k & 1) * AUX;
    a[lane] = v0;
    a[lane + 32] = v1;
    a[L + lane] = d0;
    a[L + lane + 32] = d1;
    a[2 * L + lane] = expf(total - v0) * d0;
    a[2 * L + lane + 32] = expf(total - v1) * d1;
    a[3 * L + lane] = expf(v0);
    a[3 * L + lane + 32] = expf(v1);
    // the decay across 16-position blocks, in two factors that never
    // exceed 1: beta_s = exp(cum_e - cum_s) dt_s with e the last position
    // of s's block, alpha_j(t) = exp(cum_t - cum_{16 j + 15}) for t past
    // block j (clamped at 0 elsewhere, where it is not read)
    const float e0 = __shfl_sync(0xffffffffu, v0, lane | 15);
    const float e1 = __shfl_sync(0xffffffffu, v1, lane | 15);
    a[4 * L + lane] = expf(e0 - v0) * d0;
    a[4 * L + lane + 32] = expf(e1 - v1) * d1;
    const float ends[3] = {__shfl_sync(0xffffffffu, v0, 15),
                           __shfl_sync(0xffffffffu, v0, 31),
                           __shfl_sync(0xffffffffu, v1, 15)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[(5 + j) * L + lane] = expf(fminf(v0 - ends[j], 0.0f));
      a[(5 + j) * L + lane + 32] = expf(fminf(v1 - ends[j], 0.0f));
    }
    if (lane == 0) a[8 * L] = expf(total);
  };

  stage_rows<XB>(sbase + SM::X0, xh, xts, P / 8, 0, S);
  stage_rows<BB>(sbase + SM::B0, bh, bts, N / 8, 0, S);
  stage_rows<BB>(sbase + SM::C0, chh, bts, N / 8, 0, S);
  cp_async_commit();

  // the state: float32 accumulators of the warps that own its rows, and a
  // bf16 copy in shared memory for C S (zeros in the padding)
  float sacc[NSW][PT][4];
#pragma unroll
  for (int i = 0; i < NSW; ++i) {
    const int n0 = 16 * (warp + MW * i) + g;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 8 * (e / 2), p = 8 * pt + 2 * q + e % 2;
        sacc[i][pt][e] = (init != nullptr && n < N && p < P)
                             ? init[st_off + (size_t)n * P + p]
                             : 0.0f;
      }
      *reinterpret_cast<uint32_t*>(smem_mma + SM::S0 +
                                   swz_el<XB>(n0, 8 * pt + 2 * q)) =
          pack_bf16(sacc[i][pt][0], sacc[i][pt][1]);
      *reinterpret_cast<uint32_t*>(smem_mma + SM::S0 +
                                   swz_el<XB>(n0 + 8, 8 * pt + 2 * q)) =
          pack_bf16(sacc[i][pt][2], sacc[i][pt][3]);
    }
  }
  float d0 = 0.0f, d1 = 0.0f;
  if (warp == 0) {
    load_dt(0, d0, d1);
    scan(0, d0, d1);
    load_dt(1, d0, d1);
  }

  const int tA = 16 * warp + g, tB = tA + 8;  // this thread's chunk rows
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * L, st = ck & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk ck staged, its scalars and the state written;
                      // every warp is done with chunk ck - 1
    if (ck + 1 < n_chunks) {
      stage_rows<XB>(sbase + SM::X0 + (st ^ 1) * SM::X_TILE, xh, xts, P / 8,
                     t0 + L, S);
      stage_rows<BB>(sbase + SM::B0 + (st ^ 1) * SM::B_TILE, bh, bts, N / 8,
                     t0 + L, S);
      if (warp == 0) {  // the lightest warp: its intra work is 1 block
        scan(ck + 1, d0, d1);
        load_dt(ck + 2, d0, d1);
      }
    }
    cp_async_commit();
    const uint32_t Xs = sbase + SM::X0 + st * SM::X_TILE;
    const uint32_t Bs = sbase + SM::B0 + st * SM::B_TILE;
    const uint32_t Cs = sbase + SM::C0, Sb = sbase + SM::S0;
    const unsigned char* xg = smem_mma + SM::X0 + st * SM::X_TILE;
    const float* a = aux + st * AUX;
    if (chunk_states != nullptr)  // the float32 state before this chunk
      store_state(chunk_states + (((size_t)bi * H + h) * n_chunks + ck) *
                                     N * P,
                  sacc, warp, g, q, P, N);

    // C's A fragments of this warp's rows
    uint32_t cf[NK][4];
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      ldmatrix_x4(cf[ks], Cs + swz_el<BB>(16 * warp + lr + (lm & 1) * 8,
                                          16 * ks + (lm >> 1) * 8));

    // inter: y = exp(cum_t) (C S), S the bf16 copy of the state before the
    // chunk
    float yacc[PT][4];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Sb + swz_el<XB>(16 * ks + lr + (lm & 1) * 8,
                                             16 * pp + (lm >> 1) * 8));
        mma_bf16(yacc[2 * pp], cf[ks], b[0], b[1]);
        mma_bf16(yacc[2 * pp + 1], cf[ks], b[2], b[3]);
      }
    const float eA = a[3 * L + tA], eB = a[3 * L + tB];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      yacc[pt][0] *= eA;
      yacc[pt][1] *= eA;
      yacc[pt][2] *= eB;
      yacc[pt][3] *= eB;
    }

    // intra: for each 16-position block j of s up to the diagonal,
    // G = C B^T (two n8 tiles), then W = G exp(cum_t - cum_s) dt_s: below
    // the diagonal block as G alpha_j(t) beta_s, on it masked BEFORE the
    // exp (above the diagonal cum_t - cum_s > 0 would overflow, and
    // inf * 0 is NaN); then y += W x with W's accumulator fragment, split
    // into bf16 hi + lo, as the A fragments
    const float cA = a[tA], cB = a[tB];
    for (int j = 0; j <= warp; ++j) {
      float gacc[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[hh][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t b[4];
        ldmatrix_x4(b, Bs + swz_el<BB>(16 * j + lr + (lm >> 1) * 8,
                                       16 * ks + (lm & 1) * 8));
        mma_bf16(gacc[0], cf[ks], b[0], b[1]);
        mma_bf16(gacc[1], cf[ks], b[2], b[3]);
      }
      if (j < warp) {
        const float alA = a[(5 + j) * L + tA], alB = a[(5 + j) * L + tB];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gacc[hh][e] = gacc[hh][e] * (e < 2 ? alA : alB) *
                          a[4 * L + 16 * j + 8 * hh + 2 * q + e % 2];
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 16 * j + 8 * hh + 2 * q + e % 2;
            const int t = e < 2 ? tA : tB;
            const float ct = e < 2 ? cA : cB;
            gacc[hh][e] =
                s <= t ? gacc[hh][e] * expf(ct - a[s]) * a[L + s] : 0.0f;
          }
      }
      uint32_t whi[4], wlo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(gacc[r / 2][2 * (r % 2)], gacc[r / 2][2 * (r % 2) + 1],
                   whi[r], wlo[r]);
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Xs + swz_el<XB>(16 * j + lr + (lm & 1) * 8,
                                             16 * pp + (lm >> 1) * 8));
        mma_bf16(yacc[2 * pp], whi, b[0], b[1]);
        mma_bf16(yacc[2 * pp], wlo, b[0], b[1]);
        mma_bf16(yacc[2 * pp + 1], whi, b[2], b[3]);
        mma_bf16(yacc[2 * pp + 1], wlo, b[2], b[3]);
      }
    }

    // skip: y += D x; then 16-byte stores of whole 8-column pieces, each
    // gathered from its quad by a 4 x 4 transpose
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const float2 xa = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          xg + swz_el<XB>(tA, 8 * pt + 2 * q)));
      const float2 xb = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          xg + swz_el<XB>(tB, 8 * pt + 2 * q)));
      yacc[pt][0] = fmaf(D, xa.x, yacc[pt][0]);
      yacc[pt][1] = fmaf(D, xa.y, yacc[pt][1]);
      yacc[pt][2] = fmaf(D, xb.x, yacc[pt][2]);
      yacc[pt][3] = fmaf(D, xb.y, yacc[pt][3]);
    }
#pragma unroll
    for (int jg = 0; jg < PT; jg += 4)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = pack_bf16(yacc[jg + jj][2 * half],
                            yacc[jg + jj][2 * half + 1]);
        quad_transpose(v, q);
        const int t = t0 + (half ? tB : tA), col = 8 * (jg + q);
        if (t < S && col < P)
          *reinterpret_cast<uint4*>(
              y + (((size_t)bi * S + t) * H + h) * P + col) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }

    __syncthreads();  // every warp has read C and the state's bf16 copy
    if (ck + 1 < n_chunks)
      stage_rows<BB>(sbase + SM::C0, chh, bts, N / 8, t0 + L, S);
    cp_async_commit();

    // S <- exp(total) S + (B u)^T x: the A fragments of B^T by
    // ldmatrix.trans, scaled by u_s in float32 and split into bf16 hi + lo,
    // two products with x's fragments
    const float et = a[8 * L];
#pragma unroll
    for (int i = 0; i < NSW; ++i) {
      const int m = warp + MW * i;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i][pt][e] *= et;
#pragma unroll
      for (int ks = 0; ks < L / 16; ++ks) {
        uint32_t af[4], hi[4], lo[4];
        ldmatrix_x4_trans(af, Bs + swz_el<BB>(16 * ks + lr + (lm >> 1) * 8,
                                              16 * m + (lm & 1) * 8));
        // a0, a1 hold s = 16 ks + 2 q, + 1; a2, a3 the same + 8
        const int s0 = 16 * ks + 2 * q;
        const float u0 = a[2 * L + s0], u1 = a[2 * L + s0 + 1];
        const float u8 = a[2 * L + s0 + 8], u9 = a[2 * L + s0 + 9];
        split_scaled(af[0], u0, u1, hi[0], lo[0]);
        split_scaled(af[1], u0, u1, hi[1], lo[1]);
        split_scaled(af[2], u8, u9, hi[2], lo[2]);
        split_scaled(af[3], u8, u9, hi[3], lo[3]);
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Xs + swz_el<XB>(16 * ks + lr + (lm & 1) * 8,
                                               16 * pp + (lm >> 1) * 8));
          mma_bf16(sacc[i][2 * pp], hi, b[0], b[1]);
          mma_bf16(sacc[i][2 * pp], lo, b[0], b[1]);
          mma_bf16(sacc[i][2 * pp + 1], hi, b[2], b[3]);
          mma_bf16(sacc[i][2 * pp + 1], lo, b[2], b[3]);
        }
      }
      const int n0 = 16 * m + g;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        *reinterpret_cast<uint32_t*>(smem_mma + SM::S0 +
                                     swz_el<XB>(n0, 8 * pt + 2 * q)) =
            pack_bf16(sacc[i][pt][0], sacc[i][pt][1]);
        *reinterpret_cast<uint32_t*>(smem_mma + SM::S0 +
                                     swz_el<XB>(n0 + 8, 8 * pt + 2 * q)) =
            pack_bf16(sacc[i][pt][2], sacc[i][pt][3]);
      }
    }
  }

  store_state(state_out + st_off, sacc, warp, g, q, P, N);
}

struct Args {
  const void *x, *b, *c;
  const float *dt, *a_log, *d_skip, *init;
  void* y;
  float *state, *chunk_states;
  int B, S, H, G, P, N;
  long long xbs, xts, bbs, bts;
};

template <int PP>
int launch_fma(const Args& r, cudaStream_t s) {
  const int smem = smem_floats(PP, r.N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<float, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<float, PP><<<dim3(r.H, r.B), THREADS, smem, s>>>(
      static_cast<const float*>(r.x), r.dt, r.a_log,
      static_cast<const float*>(r.b), static_cast<const float*>(r.c),
      r.d_skip, r.init, static_cast<float*>(r.y), r.state, r.chunk_states,
      r.S, r.H, r.G, r.P, r.N, r.xbs, r.xts, r.bbs, r.bts);
  return (int)cudaGetLastError();
}

int launch_fma_p(const Args& r, cudaStream_t s) {
  if (r.P <= 32) return launch_fma<32>(r, s);
  if (r.P <= 64) return launch_fma<64>(r, s);
  return launch_fma<128>(r, s);
}

template <int PP, int NP>
int launch_mma(const Args& r, cudaStream_t s) {
  constexpr int smem = MmaSmem<PP, NP>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_mma_kernel<PP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  ssd_mma_kernel<PP, NP><<<dim3(r.H, r.B), MT, smem, s>>>(
      static_cast<const bf*>(r.x), r.dt, r.a_log, static_cast<const bf*>(r.b),
      static_cast<const bf*>(r.c), r.d_skip, r.init, static_cast<bf*>(r.y),
      r.state, r.chunk_states, r.S, r.H, r.G, r.P, r.N, r.xbs, r.xts, r.bbs,
      r.bts);
  return (int)cudaGetLastError();
}

int launch_mma_pn(const Args& r, cudaStream_t s) {
  if (r.P <= 64)
    return r.N <= 64 ? launch_mma<64, 64>(r, s) : launch_mma<64, 128>(r, s);
  return r.N <= 64 ? launch_mma<128, 64>(r, s) : launch_mma<128, 128>(r, s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of x, b, c and y): 0 = float32 (ssd_kernel), 1 = bfloat16
// (ssd_mma_kernel).  init may be null (a zero initial state).
// chunk_states may be null (inference); else it receives the float32 state
// before each 64-position chunk, (B, H, ceil(S / 64), N, P), which the
// backward (ssd_scan_bwd.cu) reads.  x's rows
// are at x + b * xbs + t * xts (elements) with (H, P) packed; b's and c's
// at b * bbs + t * bts with (G, N) packed; dt, y and the state are
// contiguous.  The wrapper checks shapes (P and N multiples of 16 up to
// 128, H % G == 0), dtypes, layouts and 16-byte alignment.
int ssd_scan_launch(const void* x, const float* dt, const float* a_log,
                    const void* b, const void* c, const float* d_skip,
                    const float* init, void* y, float* state,
                    float* chunk_states, int B, int S,
                    int H, int G, int P, int N, int dtype, long long xbs,
                    long long xts, long long bbs, long long bts,
                    void* stream) {
  if (B == 0 || S == 0) return 0;
  if (P % 16 || N % 16 || P < 16 || N < 16 || P > 128 || N > MAX_N ||
      G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  const Args r{x, b, c, dt, a_log, d_skip, init, y, state, chunk_states,
               B, S, H, G, P, N, xbs, xts, bbs, bts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fma_p(r, s);
  if (dtype == 1) return launch_mma_pn(r, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
