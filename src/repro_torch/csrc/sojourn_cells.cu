// sojourn_cells: the job-ordered FIFO M/G/B sojourn scan, one thread block
// per (cell, policy) program.
//
// Replaces: src/repro/kernels/sojourn_sweep/kernel.py:sojourn_cells_pallas
// (body _sojourn_kernel -> cell_recursion), which computes what
// src/repro/kernels/sojourn_sweep/ref.py:sojourn_cells_reference does.
//
// What bounds it on this card: not bytes and not operations.  Each program
// is a chain of J dependent dispatches; each dispatch needs the min (and the
// argmin) of the replica sets' free times before the next can start, and
// the clone/relaunch triggers are resolved in time order with a
// data-dependent number of passes.  The bytes bound (svc + alt read once)
// is far below the time of that chain, so the kernel is latency-bound.
//
// Design: one block per (cell, policy) program, so the thousands of
// programs of a planning sweep run side by side; the block has one warp
// when the sets are few and up to eight when they are many (the launcher
// picks about eight sets per thread), which shortens each pass over the
// sets when only a few programs exist.  The per-set state (free, doneg,
// trig, jobid: 16 bytes per set) lives in dynamic shared memory.  Every min
// and argmin over the sets is a strided scan followed by a lexicographic
// reduction (warp shuffles, then across warps through shared memory), so
// ties go to the lowest index exactly as jnp.argmin does (index 0 when all
// entries are inf).  The min of the free times found by the last, idle pass
// of the event resolution is reused by the dispatch that follows it (no
// state changed in between).  The arithmetic is only float adds,
// subtracts, compares and min/max, in the same order as the reference, and
// the file is built with -fmad=false: the outputs are bit-equal to the
// plain version and to ref.py on float32 inputs.  RESOLVE=false (no lane
// can arm a trigger) skips the event-resolution pass, as the reference's
// static flag does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_CLONE = 1;
constexpr int KIND_RELAUNCH = 2;
constexpr int KIND_HEDGED = 3;
constexpr int INT_MAX_ = 2147483647;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;
constexpr int SETS_PER_THREAD = 8;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool less2(float v, int i, float ov, int oi) {
  return ov < v || (ov == v && oi < i);
}

__device__ __forceinline__ bool less3(float v, int j, int i, float ov, int oj,
                                      int oi) {
  return ov < v || (ov == v && (oj < j || (oj == j && oi < i)));
}

struct Scratch {
  float v[MAX_WARPS];
  int j[MAX_WARPS];
  int i[MAX_WARPS];
};

// (v, i) lexicographic min across the block; every thread gets the result.
__device__ __forceinline__ void block_argmin(float& v, int& i, Scratch& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (less2(v, i, ov, oi)) {
      v = ov;
      i = oi;
    }
  }
  const int nw = blockDim.x >> 5;
  if (nw == 1) return;
  if ((threadIdx.x & 31) == 0) {
    s.v[threadIdx.x >> 5] = v;
    s.i[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = s.v[0];
  i = s.i[0];
  for (int w = 1; w < nw; ++w) {
    if (less2(v, i, s.v[w], s.i[w])) {
      v = s.v[w];
      i = s.i[w];
    }
  }
  __syncthreads();
}

// (v, j, i) lexicographic min across the block.
__device__ __forceinline__ void block_argmin3(float& v, int& j, int& i,
                                              Scratch& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oj = __shfl_xor_sync(FULL, j, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (less3(v, j, i, ov, oj, oi)) {
      v = ov;
      j = oj;
      i = oi;
    }
  }
  const int nw = blockDim.x >> 5;
  if (nw == 1) return;
  if ((threadIdx.x & 31) == 0) {
    s.v[threadIdx.x >> 5] = v;
    s.j[threadIdx.x >> 5] = j;
    s.i[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = s.v[0];
  j = s.j[0];
  i = s.i[0];
  for (int w = 1; w < nw; ++w) {
    if (less3(v, j, i, s.v[w], s.j[w], s.i[w])) {
      v = s.v[w];
      j = s.j[w];
      i = s.i[w];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float fmin_ref(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float fmax_ref(float a, float b) { return b > a ? b : a; }

// min over the live sets of free (lowest index among ties) -> (m, g).
__device__ __forceinline__ void min_free(const float* free, int ng, float& m,
                                         int& g, Scratch& s) {
  float v = f_inf();
  int gi = INT_MAX_;
  for (int k = threadIdx.x; k < ng; k += blockDim.x) {
    float f = free[k];
    if (f < v || (f == v && k < gi)) {
      v = f;
      gi = k;
    }
  }
  block_argmin(v, gi, s);
  m = v;
  g = gi == INT_MAX_ ? 0 : gi;  // no live set: jnp.argmin's index 0
}

// argmin of free over the live sets with free <= t, excluding `skip`;
// returns INT_MAX when no set qualifies.
__device__ __forceinline__ int idle_argmin(const float* free, int ng, float t,
                                           int skip, Scratch& s) {
  float v = f_inf();
  int hi = INT_MAX_;
  for (int k = threadIdx.x; k < ng; k += blockDim.x) {
    float f = free[k];
    if (k != skip && f <= t && (f < v || (f == v && k < hi))) {
      v = f;
      hi = k;
    }
  }
  block_argmin(v, hi, s);
  return hi;
}

template <bool RESOLVE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
sojourn_cells_kernel(const float* __restrict__ arr, const float* __restrict__ svc,
                     const float* __restrict__ alt, const int* __restrict__ kinds,
                     const float* __restrict__ thresholds,
                     const uint8_t* __restrict__ hmasks,
                     const int* __restrict__ n_groups, float* __restrict__ out,
                     int* __restrict__ extra_out, int n_pol, int n_jobs,
                     int n_g) {
  extern __shared__ unsigned char smem[];
  __shared__ Scratch scratch;
  float* s_free = reinterpret_cast<float*>(smem);
  float* s_doneg = s_free + n_g;
  float* s_trig = s_doneg + n_g;
  int* s_jobid = reinterpret_cast<int*>(s_trig + n_g);

  const int prog = blockIdx.x;
  const int c = prog / n_pol;
  const int p = prog % n_pol;
  const int tid = threadIdx.x;
  const float INF = f_inf();
  const int kind = kinds[p];
  const float thr = thresholds[c * n_pol + p];
  const int ng = min(n_groups[c], n_g);
  const bool is_clone = kind == KIND_CLONE;
  const bool armed_policy =
      (kind == KIND_CLONE || kind == KIND_RELAUNCH) && thr < INF;
  const float* svc_c = svc + (size_t)c * n_jobs * n_g;
  const float* alt_c = alt + (size_t)c * n_jobs * n_g;
  const uint8_t* hm = hmasks + (size_t)p * n_jobs;
  float* out_l = out + (size_t)prog * n_jobs;

  for (int k = tid; k < n_g; k += blockDim.x) {
    s_free[k] = k < ng ? 0.0f : INF;
    s_doneg[k] = 0.0f;
    s_trig[k] = INF;
    s_jobid[k] = INT_MAX_;
  }
  for (int k = tid; k < n_jobs; k += blockDim.x) out_l[k] = 0.0f;
  int extra = 0;
  __syncthreads();

  // Fire or disarm armed triggers in time order (ties by job id) while
  // they fall before the next dispatch at max(limit, min free).  Returns
  // with (m, g0) = the min and argmin of free in the final state.
  auto resolve = [&](float limit, float& m, int& g0) {
    while (true) {
      min_free(s_free, ng, m, g0, scratch);
      float bv = INF;
      int bj = INT_MAX_, bg = INT_MAX_;
      for (int k = tid; k < ng; k += blockDim.x) {
        float tr = s_trig[k];
        float eff = INF;
        if (tr < INF) {
          float dn = s_doneg[k];
          float t = tr;
          if (is_clone) {
            while (t < dn && t < m) t = t + thr;
          }
          eff = fmin_ref(t, dn);
        }
        int jb = s_jobid[k];
        if (less3(bv, bj, bg, eff, jb, k)) {
          bv = eff;
          bj = jb;
          bg = k;
        }
      }
      block_argmin3(bv, bj, bg, scratch);
      const float t = bv;
      if (!(t < INF)) return;  // nothing armed
      const int g = bg;
      const int jid = s_jobid[g];
      const float d = s_doneg[g];
      const bool disarm = t >= d;
      const float start = fmax_ref(limit, m);
      const bool doit = (t < start) || (t <= start && disarm);
      if (!doit) return;
      float done_new;
      int h = -1;
      if (disarm) {
        done_new = d;
      } else if (is_clone) {
        h = idle_argmin(s_free, ng, t, -1, scratch);
        if (h == INT_MAX_) h = 0;
        done_new = fmin_ref(d, t + alt_c[(size_t)jid * n_g + h]);
      } else {
        done_new = t + alt_c[(size_t)jid * n_g + g];
      }
      __syncthreads();
      if (tid == 0) {
        s_free[g] = done_new;
        if (h >= 0) s_free[h] = done_new;
        s_doneg[g] = done_new;
        s_trig[g] = INF;
        out_l[jid] = done_new - arr[jid];
      }
      extra += disarm ? 0 : 1;
      __syncthreads();
    }
  };

  for (int i = 0; i < n_jobs; ++i) {
    const float a = arr[i];
    float m;
    int g;
    if (RESOLVE) {
      resolve(a, m, g);
    } else {
      min_free(s_free, ng, m, g, scratch);
    }
    const float start = fmax_ref(a, m);
    const float d0 = start + svc_c[(size_t)i * n_g + g];
    float d_final = d0;
    int h = -1;
    if (kind == KIND_HEDGED && hm[i]) {
      const int hi = idle_argmin(s_free, ng, start, g, scratch);
      if (hi != INT_MAX_) {
        h = hi;
        d_final = fmin_ref(d0, start + alt_c[(size_t)i * n_g + h]);
      }
    }
    const float d_primary = armed_policy ? d0 : d_final;
    __syncthreads();
    if (tid == 0) {
      s_free[g] = d_primary;
      if (h >= 0) s_free[h] = d_final;
      s_doneg[g] = d_primary;
      s_trig[g] = armed_policy ? start + thr : INF;
      s_jobid[g] = i;
      if (!armed_policy) out_l[i] = d_final - a;
    }
    extra += h >= 0 ? 1 : 0;
    __syncthreads();
  }
  if (RESOLVE) {
    float m;
    int g;
    resolve(INF, m, g);
  }
  if (tid == 0) extra_out[prog] = extra;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest group count the shared-memory state holds (16 bytes per set).
int sojourn_cells_max_groups() {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (max_optin - (int)sizeof(Scratch)) / 16;
}

int sojourn_cells_launch(const float* arr, const float* svc, const float* alt,
                         const int* kinds, const float* thresholds,
                         const uint8_t* hmasks, const int* n_groups, float* out,
                         int* extra, int n_cells, int n_pol, int n_jobs, int n_g,
                         int resolve, void* stream) {
  const size_t smem = (size_t)16 * n_g;
  const int n_prog = n_cells * n_pol;
  int warps = (n_g + 32 * SETS_PER_THREAD - 1) / (32 * SETS_PER_THREAD);
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (resolve) {
    err = cudaFuncSetAttribute(sojourn_cells_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sojourn_cells_kernel<true><<<n_prog, 32 * warps, smem, s>>>(
        arr, svc, alt, kinds, thresholds, hmasks, n_groups, out, extra, n_pol,
        n_jobs, n_g);
  } else {
    err = cudaFuncSetAttribute(sojourn_cells_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sojourn_cells_kernel<false><<<n_prog, 32 * warps, smem, s>>>(
        arr, svc, alt, kinds, thresholds, hmasks, n_groups, out, extra, n_pol,
        n_jobs, n_g);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
