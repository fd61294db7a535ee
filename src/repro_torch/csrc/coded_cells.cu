// coded_cells: the k-th smallest of N worker times per trial, k per cell.
//
// Replaces: src/repro/kernels/sojourn_sweep/kernel.py:coded_cells_pallas
// (body _coded_kernel -> coded_cell: sort each row, take column k-1).
//
// What bounds it on this card: bytes.  Each of the C*T rows of N float32
// values is read once and one value is written; the selection is a few
// compares and integer counts per element, which no tensor core helps.
// So the design is about memory access, occupancy and instruction count.
//
// Short rows (N <= 64; the planner's N = 16): a sub-group of W lanes owns
// one row, W the next power of two >= N (capped at 32, two values a lane
// above 32), so a warp holds 32/W neighbouring rows and its loads are one
// contiguous span.  Lane i holds x_i; the sub-group sorts its values with
// a bitonic network of shuffles (10 compare-exchange steps at W = 16) and
// lane (k-1) % W writes element k-1.  Pad lanes hold +inf, which sorts at
// or after every value, so element k-1 (k <= N) is the row's k-th; where
// that is +inf the row holds the same +inf.  Every loop is unrolled over
// the compile-time W: no per-thread array is indexed at run time, so
// nothing lives in local memory.  (A rank count over W shuffles, the other
// way to select here, takes more instructions a row.)
//
// Long rows: one 256-thread block owns one row.  It reads the row from
// device memory once, through registers into shared memory as the floats'
// order-preserving 32-bit keys, taking the row's least and largest key on
// the way.  Each radix pass then reads shared memory: an 8-bit digit of
// the key's offset from the candidates' least key, at the shift that spans
// their range (key - lo) >> s, counted in per-warp histograms, merged and
// scanned block-wide to find the bin that holds the k-th.  The first digit
// thereby covers the row's own range, mantissa bits included, instead of
// the sign and exponent bits that a fixed split would spend it on (service
// times span a few octaves).  A pass leaves the bin's candidates, which a
// filter pass compacts into a small buffer with their new least and
// largest key; later passes read only those.  Each pass takes 8 bits off
// the range, so at most 4 run; the selection ends when the candidates'
// range is one key, or when at most 32 candidates are left, which one warp
// sorts by the short rows' bitonic network.  Rows too long for shared memory
// run the same passes over device memory.  Both paths return one of the
// input floats unchanged, so the output is bit-equal to torch.sort +
// gather (up to the sign of a zero, which the service times never carry).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL_N = 64;
constexpr int SHORT_THREADS = 256;
constexpr int RADIX_THREADS = 256;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int RADIX_BITS = 8;
constexpr int RADIX_BINS = 1 << RADIX_BITS;  // one bin a thread in the scan
constexpr int CAND_CAP = 1024;               // compacted candidates a buffer
constexpr int RANK_MAX = 32;                 // one warp sorts this few
constexpr int MAX_PASSES = 4;                // 32 key bits / 8 a pass
constexpr int LOAD_UNROLL = 8;               // float4 loads in flight a thread
constexpr int HOST_QUORUMS = 64;             // ks passed by value up to this

static_assert(RADIX_BINS == RADIX_THREADS, "the scan gives one bin a thread");

// ks by value in the launch's parameters (read from the constant bank)
struct Quorums {
  int k[HOST_QUORUMS];
};

struct Scratch {
  uint32_t wlo[RADIX_WARPS], whi[RADIX_WARPS];
  int wsum[RADIX_WARPS];
  int digit, below, count, fill;
};

// shared memory of the radix kernel: per-warp histograms, two candidate
// buffers, the scratch, then the staged row's keys
constexpr int HIST_WORDS = RADIX_WARPS * RADIX_BINS;
constexpr int SCRATCH_WORDS = 32;
static_assert(sizeof(Scratch) <= SCRATCH_WORDS * 4, "scratch too small");
constexpr int FIXED_WORDS = HIST_WORDS + 2 * CAND_CAP + SCRATCH_WORDS;
constexpr size_t FIXED_BYTES = FIXED_WORDS * 4;
static_assert(FIXED_BYTES % 16 == 0, "keys must start 16-byte aligned");

__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t key) {
  const uint32_t u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(u);
}

__device__ __forceinline__ int quorum(const int* ks, const Quorums& q, int c) {
  return ks ? __ldg(ks + c) : q.k[c];
}

// Bitonic sort, ascending, of the W * V values of each sub-group of W
// lanes, element e = i + u * W in lane i's v[u]: a compare-exchange with
// the lane i ^ stride by shuffle for strides below W, with the lane's other
// value for the stride W (V = 2).  Every index is known at compile time.
template <int W, int V, class T>
__device__ __forceinline__ void bitonic_sort(T (&v)[V], int i) {
  static_assert(W >= 1 && W <= 32 && (W & (W - 1)) == 0, "W: power of two");
  static_assert(V == 1 || (V == 2 && W == 32), "two values only at W = 32");
#pragma unroll
  for (int size = 2; size <= W * V; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      T p[V];
#pragma unroll
      for (int u = 0; u < V; ++u)
        p[u] = stride >= W ? v[(u ^ 1) & (V - 1)]
                           : __shfl_xor_sync(FULL, v[u], stride, W);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = i + u * W;
        const bool up = (e & size) == 0;  // this run ascends
        const bool low = (e & stride) == 0;
        v[u] = up == low ? min(v[u], p[u]) : max(v[u], p[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// short rows: W lanes a row, V values a lane
// ---------------------------------------------------------------------------

template <int W, int V>
__global__ void __launch_bounds__(SHORT_THREADS)
coded_warp_kernel(const float* __restrict__ times, const int* __restrict__ ks,
                  const __grid_constant__ Quorums q, float* __restrict__ out,
                  int rows, int n_trials, int n) {
  const int t = blockIdx.x * SHORT_THREADS + threadIdx.x;
  const int row = t / W;
  const int i = t & (W - 1);
  const bool active = row < rows;
  const float* x = times + (long long)row * n;
  float v[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int j = i + u * W;
    v[u] = active && j < n ? __ldg(x + j) : __int_as_float(0x7f800000);
  }
  bitonic_sort<W, V>(v, i);
  // element k-1 of the sorted sub-group: lane (k-1) % W, value (k-1) / W
  const int e = active ? quorum(ks, q, row / n_trials) - 1 : -1;
  float val = v[0];
#pragma unroll
  for (int u = 1; u < V; ++u)
    if (e >= u * W) val = v[u];
  if (e >= 0 && (e & (W - 1)) == i) out[row] = val;
}

// The launch floor: no work, the short-row kernel's parameters and grid.
__global__ void coded_floor_kernel(const float* __restrict__ times,
                                   const int* __restrict__ ks,
                                   const __grid_constant__ Quorums q,
                                   float* __restrict__ out, int rows,
                                   int n_trials, int n) {}

// ---------------------------------------------------------------------------
// long rows: one block a row, radix select on the keys
// ---------------------------------------------------------------------------

__device__ __forceinline__ void block_range(uint32_t& lo, uint32_t& hi,
                                            Scratch* sc) {
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sc->wlo[warp] = lo;
    sc->whi[warp] = hi;
  }
  __syncthreads();
  lo = sc->wlo[0];
  hi = sc->whi[0];
#pragma unroll
  for (int w = 1; w < RADIX_WARPS; ++w) {
    lo = min(lo, sc->wlo[w]);
    hi = max(hi, sc->whi[w]);
  }
}

// f(key) for every element of the full row: the staged keys, or the row
// in device memory (float4 loads where the row is 16-byte aligned)
template <bool kStaged, class F>
__device__ __forceinline__ void for_each_key(const float* __restrict__ x,
                                             const uint32_t* keys, int n,
                                             F&& f) {
  if (kStaged) {
    const uint4* k4 = reinterpret_cast<const uint4*>(keys);
    const int n4 = n >> 2;
    for (int j = threadIdx.x; j < n4; j += RADIX_THREADS) {
      const uint4 v = k4[j];
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += RADIX_THREADS)
      f(keys[i]);
  } else if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = n >> 2;
    for (int j = threadIdx.x; j < n4; j += RADIX_THREADS) {
      const float4 v = __ldg(x4 + j);
      f(key_of(v.x));
      f(key_of(v.y));
      f(key_of(v.z));
      f(key_of(v.w));
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += RADIX_THREADS)
      f(key_of(__ldg(x + i)));
  } else {
    for (int i = threadIdx.x; i < n; i += RADIX_THREADS)
      f(key_of(__ldg(x + i)));
  }
}

// The row's keys into shared memory (staged) and their range; one read of
// the row, LOAD_UNROLL float4 loads in flight a thread.
template <bool kStaged>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         uint32_t* keys, int n, uint32_t& lo,
                                         uint32_t& hi) {
  lo = 0xffffffffu;
  hi = 0u;
  if (!kStaged) {
    for_each_key<false>(x, nullptr, n, [&](uint32_t key) {
      lo = min(lo, key);
      hi = max(hi, key);
    });
    return;
  }
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint4* k4 = reinterpret_cast<uint4*>(keys);
    const int n4 = n >> 2;
    for (int j0 = threadIdx.x; j0 < n4; j0 += RADIX_THREADS * LOAD_UNROLL) {
      float4 v[LOAD_UNROLL];
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int j = j0 + u * RADIX_THREADS;
        v[u] = j < n4 ? __ldg(x4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int j = j0 + u * RADIX_THREADS;
        if (j < n4) {
          const uint4 kk = make_uint4(key_of(v[u].x), key_of(v[u].y),
                                      key_of(v[u].z), key_of(v[u].w));
          lo = min(lo, min(min(kk.x, kk.y), min(kk.z, kk.w)));
          hi = max(hi, max(max(kk.x, kk.y), max(kk.z, kk.w)));
          k4[j] = kk;
        }
      }
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += RADIX_THREADS) {
      const uint32_t key = key_of(__ldg(x + i));
      keys[i] = key;
      lo = min(lo, key);
      hi = max(hi, key);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += RADIX_THREADS) {
      const uint32_t key = key_of(__ldg(x + i));
      keys[i] = key;
      lo = min(lo, key);
      hi = max(hi, key);
    }
  }
}

// f(key) for every candidate: the full row or a compacted buffer
template <bool kStaged, class F>
__device__ __forceinline__ void for_each_candidate(
    const float* __restrict__ x, const uint32_t* keys, int n,
    const uint32_t* cand, int m, F&& f) {
  if (cand == nullptr) {
    for_each_key<kStaged>(x, keys, n, f);
  } else {
    for (int i = threadIdx.x; i < m; i += RADIX_THREADS) f(cand[i]);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(RADIX_THREADS)
coded_radix_kernel(const float* __restrict__ times, const int* __restrict__ ks,
                   const __grid_constant__ Quorums q, float* __restrict__ out,
                   int* __restrict__ pass_counts, int n_trials, int n) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;
  uint32_t* cbuf = smem + HIST_WORDS;
  Scratch* sc = reinterpret_cast<Scratch*>(cbuf + 2 * CAND_CAP);
  uint32_t* keys = smem + FIXED_WORDS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const float* x = times + (long long)row * n;
  int k = quorum(ks, q, row / n_trials);
  int* pc = pass_counts ? pass_counts + (long long)row * MAX_PASSES : nullptr;

  uint32_t lo, hi;
  load_row<kStaged>(x, keys, n, lo, hi);
  block_range(lo, hi, sc);

  const uint32_t* src = nullptr;  // nullptr: the full row
  int m = n;
  int pass = 0;
  for (;; ++pass) {
    if (lo == hi) {
      if (tid == 0) out[row] = float_of(lo);
      break;
    }
    if (src != nullptr && m <= RANK_MAX) {
      if (warp == 0) {  // the last few candidates: one warp sorts them
        uint32_t v[1] = {lane < m ? src[lane] : 0xffffffffu};
        bitonic_sort<32, 1>(v, lane);
        if (lane == k - 1) out[row] = float_of(v[0]);
      }
      break;
    }
    // histogram of (key - lo) >> s over the candidates, one per warp
    const uint32_t span = hi - lo;
    const int s = max(0, 32 - __clz(span) - RADIX_BITS);
    const bool all_in = pass == 0;  // every key of the row is in [lo, hi]
    uint32_t* wh = hist + warp * RADIX_BINS;
#pragma unroll
    for (int b = lane; b < RADIX_BINS; b += 32) wh[b] = 0u;
    __syncwarp();
    for_each_candidate<kStaged>(x, keys, n, src, m, [&](uint32_t key) {
      const uint32_t off = key - lo;
      if (all_in || off <= span) atomicAdd(&wh[off >> s], 1u);
    });
    __syncthreads();
    // merge the warps' counts and scan the bins block-wide: thread b owns
    // bin b; the one whose bin holds the k-th publishes it
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < RADIX_WARPS; ++w)
      cnt += (int)hist[w * RADIX_BINS + tid];
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) sc->wsum[warp] = incl;
    if (tid == 0) sc->fill = 0;
    __syncthreads();
    int excl = incl - cnt;
#pragma unroll
    for (int w = 0; w < RADIX_WARPS; ++w) excl += w < warp ? sc->wsum[w] : 0;
    if (excl < k && k <= excl + cnt) {
      sc->digit = tid;
      sc->below = excl;
      sc->count = cnt;
    }
    __syncthreads();
    const uint32_t nlo = lo + ((uint32_t)sc->digit << s);
    const uint32_t nspan = min((uint32_t)(((uint64_t)1 << s) - 1), hi - nlo);
    const int src_m = m;
    k -= sc->below;
    m = sc->count;
    if (pc != nullptr && tid == 0 && pass < MAX_PASSES) pc[pass] = m;
    // the bin's keys: their range, and the keys compacted when they fit
    uint32_t* dst = nullptr;
    if (m <= CAND_CAP) dst = src == cbuf ? cbuf + CAND_CAP : cbuf;
    uint32_t blo = 0xffffffffu, bhi = 0u;
    for_each_candidate<kStaged>(x, keys, n, src, src_m, [&](uint32_t key) {
      if (key - nlo <= nspan) {
        blo = min(blo, key);
        bhi = max(bhi, key);
        if (dst != nullptr) dst[atomicAdd(&sc->fill, 1)] = key;
      }
    });
    lo = blo;
    hi = bhi;
    block_range(lo, hi, sc);
    if (dst != nullptr) src = dst;
  }
  if (pc != nullptr && tid == 0)
    for (int p = pass; p < MAX_PASSES; ++p) pc[p] = 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of at most this many values run the radix select from shared memory
// (the rest from device memory): the card's opt-in shared memory a block,
// less the histograms, candidate buffers and scratch.
int coded_cells_max_staged_n(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return (int)((optin - (long long)FIXED_BYTES) / 4);
}

int coded_cells_host_quorums(void) { return HOST_QUORUMS; }

int coded_cells_max_passes(void) { return MAX_PASSES; }

}  // extern "C"

namespace {

int set_quorums(const int* ks, const int* ks_host, int n_cells, Quorums* q) {
  if (ks != nullptr) return 0;
  if (ks_host == nullptr || n_cells > HOST_QUORUMS)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_cells; ++c) q->k[c] = ks_host[c];
  return 0;
}

// lanes a row of the short-row kernel, V values a lane
int short_width(int n) {
  int w = 1;
  while (w < n && w < 32) w <<= 1;
  return w;
}

template <int W, int V>
cudaError_t launch_short(const float* times, const int* ks, const Quorums& q,
                         float* out, int rows, int n_trials, int n,
                         cudaStream_t s, bool floor_only) {
  const long long threads = (long long)rows * W;
  if (threads > 0x7fffffffLL - SHORT_THREADS) return cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((threads + SHORT_THREADS - 1) / SHORT_THREADS);
  if (floor_only)
    coded_floor_kernel<<<blocks, SHORT_THREADS, 0, s>>>(times, ks, q, out,
                                                        rows, n_trials, n);
  else
    coded_warp_kernel<W, V><<<blocks, SHORT_THREADS, 0, s>>>(
        times, ks, q, out, rows, n_trials, n);
  return cudaGetLastError();
}

cudaError_t dispatch_short(const float* times, const int* ks, const Quorums& q,
                           float* out, int rows, int n_trials, int n,
                           cudaStream_t s, bool floor_only) {
  switch (n <= 32 ? short_width(n) : 64) {
    case 1: return launch_short<1, 1>(times, ks, q, out, rows, n_trials, n, s, floor_only);
    case 2: return launch_short<2, 1>(times, ks, q, out, rows, n_trials, n, s, floor_only);
    case 4: return launch_short<4, 1>(times, ks, q, out, rows, n_trials, n, s, floor_only);
    case 8: return launch_short<8, 1>(times, ks, q, out, rows, n_trials, n, s, floor_only);
    case 16: return launch_short<16, 1>(times, ks, q, out, rows, n_trials, n, s, floor_only);
    case 32: return launch_short<32, 1>(times, ks, q, out, rows, n_trials, n, s, floor_only);
    default: return launch_short<32, 2>(times, ks, q, out, rows, n_trials, n, s, floor_only);
  }
}

template <bool kStaged>
cudaError_t launch_radix(const float* times, const int* ks, const Quorums& q,
                         float* out, int* pass_counts, int rows, int n_trials,
                         int n, cudaStream_t s) {
  // once a process: let a block take the card's opt-in shared memory, and
  // the SM its largest carveout (four blocks of a 10,000-value row)
  static cudaError_t setup = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(coded_radix_kernel<kStaged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(coded_radix_kernel<kStaged>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (setup != cudaSuccess) return setup;
  const size_t bytes =
      FIXED_BYTES + (kStaged ? ((size_t)n * 4 + 15) / 16 * 16 : 0);
  coded_radix_kernel<kStaged><<<(unsigned)rows, RADIX_THREADS, bytes, s>>>(
      times, ks, q, out, pass_counts, n_trials, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ks: the quorums on the card, or nullptr and ks_host: the quorums in host
// memory (at most HOST_QUORUMS cells), passed by value in the launch.
// pass_counts (rows x MAX_PASSES) or nullptr: the candidates left after
// each radix pass, 0 for passes not run; it implies force_radix.
// force_radix != 0 runs the radix select on short rows too (to hold the
// two paths against each other on the same input).
int coded_cells_launch(const float* times, const int* ks, const int* ks_host,
                       float* out, int* pass_counts, int n_cells,
                       int n_trials, int n, int force_radix, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)n_cells * n_trials;
  if (rows == 0) return 0;
  if (n < 1 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Quorums q{};
  int code = set_quorums(ks, ks_host, n_cells, &q);
  if (code != 0) return code;
  if (n <= SMALL_N && !force_radix && pass_counts == nullptr)
    return (int)dispatch_short(times, ks, q, out, (int)rows, n_trials, n, s,
                               false);
  if (n <= coded_cells_max_staged_n())
    return (int)launch_radix<true>(times, ks, q, out, pass_counts, (int)rows,
                                   n_trials, n, s);
  return (int)launch_radix<false>(times, ks, q, out, pass_counts, (int)rows,
                                  n_trials, n, s);
}

// An empty kernel with the short-row kernel's parameters and grid for this
// shape: the device time of a launch that does no work.
int coded_cells_floor_launch(const float* times, const int* ks,
                             const int* ks_host, float* out, int* pass_counts,
                             int n_cells, int n_trials, int n,
                             int force_radix, void* stream) {
  (void)pass_counts;
  (void)force_radix;
  const long long rows = (long long)n_cells * n_trials;
  if (rows == 0) return 0;
  if (n < 1 || n > SMALL_N || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Quorums q{};
  int code = set_quorums(ks, ks_host, n_cells, &q);
  if (code != 0) return code;
  return (int)dispatch_short(times, ks, q, out, (int)rows, n_trials, n,
                             static_cast<cudaStream_t>(stream), true);
}

}  // extern "C"
