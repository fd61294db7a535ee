// ssd_scan: the Mamba-2 SSD chunked scan, one block per (head, batch row).
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py: ssd_scan_kernel_call
// (body _ssd_kernel), the kernel twin of repro.models.ssm.ssd_chunked.
// x (B, S, H, P) and b, c (B, S, G, N) in float32 or bfloat16; dt (B, S, H),
// a_log and d_skip (H,) and the optional initial state (B, H, N, P) in
// float32.  With A = -exp(a_log[h]) and, inside a chunk, the inclusive
// cumulative log decay cum_t = sum_{s<=t} dt_s A:
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s     (intra)
//         + exp(cum_t) C_t . S                                     (inter)
//         + D x_t                                                  (skip)
//   S    <- exp(total) S + sum_s B_s (x_s exp(total - cum_s) dt_s)  (update)
// with S the (N, P) float32 state carried across chunks.  Head h reads B/C
// group h / (H / G), the group-major order of the reference's jnp.repeat;
// the repeat is never materialised.  All arithmetic is float32; y goes out
// in x's dtype and the final state in float32.
//
// What bounds it on this card: bytes.  At zamba2-7b's prefill (B = 8,
// S = 1024, H = 112, P = N = 64, bf16) a launch moves about 255 MB (x in
// and y out at 117 MB each) and does about 45 GFLOP at the reference's
// chunk of 128: 0.076 ms at 3.35 TB/s against 0.046 ms on the bf16 tensor
// cores.  This first version runs on the float32 FMA units (67 TFLOP/s),
// whose ceiling for its ~27 GFLOP is about 0.4 ms.
//
// Design: one 256-thread block per (head, batch row) walks the sequence in
// chunks of L = 64 positions and keeps the state in shared memory, so one
// launch covers a whole Mamba-2 block and nothing but y and the final state
// goes back to device memory.  Per chunk it stages x (float32, [L][PP]),
// B and C (transposed, [N][L + 4]) and dt; two warps take the inclusive
// scan of dt A with shuffles.  The weights W[t][s] are computed as 4 x 4
// patches of C B^T; the decay is masked BEFORE the exp (above the diagonal
// cum_t - cum_s > 0 would overflow, and inf * 0 is NaN), and patches wholly
// above the diagonal are skipped.  Each thread then owns four columns of y
// (and of the state) on rows strided by 256 / (PP / 4).  A fixed chunk
// with a masked ragged tail (dt = x = B = C = 0 past S keeps cum flat and
// adds nothing) replaces the reference's fallback to one chunk of length S
// when S is not a multiple of 128.  P and N are multiples of 16 up to 128;
// PP is P rounded up to 32, 64 or 128.  Tensor cores (mma / wgmma) and TMA
// are later work.
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

__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

int smem_floats(int PP, int N) { return L * PP + L * LS + N * PP + 2 * N * LS + 4 * L; }

template <typename T, int PP>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int G, int P, int N) {
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
        Vec<T>::load(x + (((size_t)bi * S + t) * H + h) * P + gi * VN, buf);
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
        const size_t off = (((size_t)bi * S + t) * G + grp) * N + gi * VN;
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

template <typename T, int PP>
int launch(const void* x, const float* dt, const float* a_log, const void* b,
           const void* c, const float* d_skip, const float* init, void* y,
           float* state, int B, int S, int H, int G, int P, int N,
           cudaStream_t s) {
  const int smem = smem_floats(PP, N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_kernel<T, PP><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b),
      static_cast<const T*>(c), d_skip, init, static_cast<T*>(y), state, S, H,
      G, P, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* a_log, const void* b,
             const void* c, const float* d_skip, const float* init, void* y,
             float* state, int B, int S, int H, int G, int P, int N,
             cudaStream_t s) {
  if (P <= 32)
    return launch<T, 32>(x, dt, a_log, b, c, d_skip, init, y, state, B, S, H,
                         G, P, N, s);
  if (P <= 64)
    return launch<T, 64>(x, dt, a_log, b, c, d_skip, init, y, state, B, S, H,
                         G, P, N, s);
  return launch<T, 128>(x, dt, a_log, b, c, d_skip, init, y, state, B, S, H,
                        G, P, N, s);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  init may be null
// (a zero initial state).  The wrapper checks shapes (P and N multiples of
// 16 up to 128, H % G == 0), dtypes, contiguity and 16-byte alignment.
int ssd_scan_launch(const void* x, const float* dt, const float* a_log,
                    const void* b, const void* c, const float* d_skip,
                    const float* init, void* y, float* state, int B, int S,
                    int H, int G, int P, int N, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (P % 16 || N % 16 || P < 16 || N < 16 || P > 128 || N > MAX_N ||
      G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, dt, a_log, b, c, d_skip, init, y, state, B, S,
                           H, G, P, N, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, a_log, b, c, d_skip, init, y, state,
                                   B, S, H, G, P, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
