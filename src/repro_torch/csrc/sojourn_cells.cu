// sojourn_cells: the job-ordered FIFO M/G/B sojourn scan, one warp per
// (cell, policy) program, every program of a sweep in one launch.
//
// Replaces: src/repro/kernels/sojourn_sweep/kernel.py:sojourn_cells_pallas
// (body _sojourn_kernel -> cell_recursion), which computes what
// src/repro/kernels/sojourn_sweep/ref.py:sojourn_cells_reference does.
//
// What bounds it on this card: neither bytes nor operations.  Each program
// is a chain of J dependent dispatches: a dispatch needs the argmin of the
// replica sets' free times, and the service draw of the set it picks,
// before the next can start.  The least time of a program is J times the
// on-chip latency of one dispatch (the chain bound), not the time to read
// svc and alt.
//
// Design.
// - One warp (one block) per program, all (cell, policy) programs of a
//   sweep in one launch.  Each program reads its own n_groups[c] (ng, at
//   most the padded row width n_g) and decides at run time whether it
//   resolves triggers: resolve && (clone or relaunch) && threshold < inf.
//   resolve=0 skips the pass for every program, as the reference's static
//   flag does.  A program never reads past its own ng.
// - Tournament trees.  The per-set state (free, doneg, trigger time,
//   trigger aux, job id: 20 bytes a set) lives in dynamic shared memory.
//   Two trees run over the sets: one over free keyed by (free, index) that
//   keeps the lowest two, one over the armed triggers keyed by (effective
//   time, job id, index).  Sets form nodes of 128, four a lane; a node's
//   entry (its lowest two, or its lowest trigger) lives in a register of
//   the lane that keeps it (lane l keeps nodes l * slots + s, slots set at
//   run time by the program's ng; the kernel is built for 1 node a lane, up
//   to 4,096 sets, and for 3, up to 12,288, and the launch picks the first
//   that holds its widest program).  Keys are the
//   order-preserving uint32 image of the floats (-0 and +0 share it); the
//   warp's lowest comes from __reduce_min_sync on the key and then on the
//   index (or job id) among the lanes holding it, so ties go to the lowest
//   index, as jnp.argmin breaks them.  A set past ng holds +inf and is
//   never written, so it loses every tie and needs no mask.  A change to a
//   set is a walk: its node is re-reduced from its sets and, at the same
//   time, the root from the other kept nodes and the changed node's sets
//   (independent warp reductions in one instruction stream); the keeping
//   lane stores the new node.  A program of one node needs only the first.
//   A walk's time is its instruction count more than any one latency, so
//   the code avoids branches and empty merges.  There is no block barrier
//   in the loop.
// - Hedged dispatch: the idle set is the free root's second (the runner-up
//   of g) if its free <= start.  Clone: the idle set is the free tree's root
//   (tt >= m when a clone fires, and g's free is d > tt, so the root is the
//   lowest-index minimum of the idle sets).
// - Clone triggers advance lazily.  A clone's effective time depends on m
//   = min(free) through the reference's re-arm loop (t += thr while t < done
//   and t < m).  Only the trigger tree's root is advanced, by the same float
//   adds, while its effective time is below m; its time is stored and its
//   path recomputed.  This equals the reference's per-pass recomputation
//   as long as m never decreased since a stored t was advanced: the adds
//   from the base time stop at the first t with !(t < done && t < m), and
//   for m' <= m that index is no later than for m, so continuing from the
//   stored t gives the same float.  m never decreases in a clone program
//   with non-negative draws: a dispatch writes start + svc >= start >= m
//   over the argmin, a clone fire writes min(d, tt + alt) >= tt >= m (a
//   firing clone has tt < d, so its advance stopped at tt >= m) and a
//   disarm rewrites free[g] = d.  The kernel does not rely on it: when m
//   falls below the largest m any stored t was advanced with (possible
//   only with negative draws), it recomputes every clone trigger from its
//   base time and rebuilds the trees, exactly as the reference would.
//   Relaunch's effective time min(tr, done) does not depend on m.
// - The draws off the chain.  With no trigger event in between, job i + 2
//   goes to the free root or its second after job i's update, so after
//   each update lane 0 issues cp.async copies of those two entries of svc
//   row i + 2 (and of the arrival and hedge-mask word) into a small shared
//   ring, waited on two jobs later, and an L2 prefetch of row i + 3 at the
//   same two sets.  A hedged program copies the next job's alt at the new
//   second one job ahead.  A relaunch loads its redraw alt[i, g] when it
//   arms and parks it in the trigger aux slot one job later.  A miss loads
//   on demand.  No row is streamed.
// The arithmetic is only float adds, subtracts, compares and min/max, in
// the reference's order, and the file is built with -fmad=false: outputs
// are bit-equal to the plain version and to ref.py in float32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_CLONE = 1;
constexpr int KIND_RELAUNCH = 2;
constexpr int KIND_HEDGED = 3;
constexpr int INT_MAX_ = 2147483647;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t JOB_NONE = 0xffffffffu;
constexpr int RING = 4;    // prefetch ring slots

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float fmin_ref(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float fmax_ref(float a, float b) { return b > a ? b : a; }

// x < y  <=>  fkey(x) < fkey(y) for non-NaN floats; -0 and +0 share a key.
__device__ __forceinline__ uint32_t fkey(float f) {
  uint32_t b = __float_as_uint(f);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

constexpr int LOG_FAN = 7;
constexpr int FAN = 1 << LOG_FAN;  // sets a node: four a lane
constexpr int MAX_SLOTS = 3;       // nodes a lane keeps: 96 nodes, 12,288 sets
constexpr uint32_t KNONE = 0xffffffffu;

// Shared memory of a launch of row width n_g: 20 bytes a set (free, doneg,
// tt, aux, jobid), n_g rounded up to whole nodes; -1 past 96 nodes.
__host__ __device__ inline int set_slots(int n_g) {
  return round_up(n_g < 1 ? 1 : n_g, FAN);
}

__host__ __device__ inline int smem_bytes(int n_g) {
  const int gp = set_slots(n_g);
  return gp / FAN > 32 * MAX_SLOTS ? -1 : 20 * gp;
}

// The float of an order-preserving key (a zero comes back as +0, which no
// use of it can tell from -0: every use is a comparison or max(a, m), which
// returns a on ties).
__device__ __forceinline__ float kval(uint32_t h) {
  return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}

// (key, index) of a set in the free tree; (KNONE, INT_MAX) loses to all.
struct Pair {
  uint32_t k;
  int i;
};

__device__ __forceinline__ bool lt(const Pair& a, const Pair& b) {
  return (a.k < b.k) | ((a.k == b.k) & (a.i < b.i));
}

// The lowest two pairs of a range of sets.
struct Top2 {
  Pair a, b;
};

__device__ __forceinline__ Top2 merge2(const Top2& x, const Top2& y) {
  const bool c1 = lt(y.a, x.a);
  const Pair lo = c1 ? y.a : x.a, hi = c1 ? x.a : y.a;
  const Pair l2 = lt(y.b, x.b) ? y.b : x.b;
  return {lo, lt(l2, hi) ? l2 : hi};
}

// (key of the effective time, job id, set) of a trigger; an unarmed set is
// (fkey(inf), JOB_NONE).
struct Trip {
  uint32_t k, j;
  int i;
};

__device__ __forceinline__ Trip pick3(const Trip& x, const Trip& y) {
  const bool s = (y.k < x.k) |
                 ((y.k == x.k) & ((y.j < x.j) | ((y.j == x.j) & (y.i < x.i))));
  return s ? y : x;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The warp's lowest two in (key, index) order: the least key, then the
// least index holding it; then the same over every lane's best but the
// winner's, which offers its second instead.
__device__ __forceinline__ Top2 warp_top2(const Top2& v) {
  Top2 r;
  r.a.k = __reduce_min_sync(FULL, v.a.k);
  r.a.i = (int)__reduce_min_sync(
      FULL, v.a.k == r.a.k ? (uint32_t)v.a.i : 0x7fffffffu);
  const Pair c = (v.a.k == r.a.k && v.a.i == r.a.i) ? v.b : v.a;
  r.b.k = __reduce_min_sync(FULL, c.k);
  r.b.i = (int)__reduce_min_sync(FULL, c.k == r.b.k ? (uint32_t)c.i : 0x7fffffffu);
  return r;
}

__device__ __forceinline__ Trip warp_trip(const Trip& v) {
  Trip r;
  r.k = __reduce_min_sync(FULL, v.k);
  r.j = __reduce_min_sync(FULL, v.k == r.k ? v.j : JOB_NONE);
  r.i = (int)__reduce_min_sync(
      FULL, (v.k == r.k && v.j == r.j) ? (uint32_t)v.i : 0x7fffffffu);
  return r;
}

template <int S>  // nodes a lane keeps, at most MAX_SLOTS
struct Prog {
  float* fr;  // free time of each set
  float* dn;  // completion of the set's current job (doneg)
  float* tt;  // trigger time (clone: advanced lazily); inf = unarmed
  float* ax;  // clone: base trigger time; relaunch: the parked redraw
  int* jb;    // job id of the set's current job
  int ng;
  int n_nodes;  // this program's nodes of FAN sets
  int slots;    // nodes a lane keeps: lane l keeps nodes l * slots + s
  bool clone;
  Top2 fs[S];  // this lane's nodes of the free tree
  Trip ts[S];  // and of the trigger tree
  Top2 froot;          // the warp's roots, the same in every lane
  Trip troot;
};

// A lane's four sets of node p, reduced.  A set at or past ng holds +inf
// from the start and is never written, so with its index at or past ng it
// loses every tie to a set of the cell.
template <int S>
__device__ __forceinline__ Top2 kids_free(const Prog<S>& P, int p) {
  const int base = (p << LOG_FAN) + 4 * lane_id();
  const float4 v = *reinterpret_cast<const float4*>(P.fr + base);
  const Pair c0 = {fkey(v.x), base}, c1 = {fkey(v.y), base + 1};
  const Pair c2 = {fkey(v.z), base + 2}, c3 = {fkey(v.w), base + 3};
  const bool s01 = lt(c1, c0), s23 = lt(c3, c2);
  const Top2 x = {s01 ? c1 : c0, s01 ? c0 : c1};
  const Top2 y = {s23 ? c3 : c2, s23 ? c2 : c3};
  return merge2(x, y);
}

template <int S>
__device__ __forceinline__ Trip kids_trig(const Prog<S>& P, int p) {
  const int base = (p << LOG_FAN) + 4 * lane_id();
  const float INF = f_inf();
  const float4 t = *reinterpret_cast<const float4*>(P.tt + base);
  const float4 d = *reinterpret_cast<const float4*>(P.dn + base);
  const float4 a = P.clone ? *reinterpret_cast<const float4*>(P.ax + base) : t;
  const int4 j4 = *reinterpret_cast<const int4*>(P.jb + base);
  const float tv[4] = {t.x, t.y, t.z, t.w};
  const float dv[4] = {d.x, d.y, d.z, d.w};
  const float av[4] = {a.x, a.y, a.z, a.w};
  const int jv[4] = {j4.x, j4.y, j4.z, j4.w};
  Trip c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool armed = av[j] < INF;  // a set past ng is never armed
    c[j] = {armed ? fkey(fmin_ref(tv[j], dv[j])) : fkey(INF),
            armed ? (uint32_t)jv[j] : JOB_NONE, base + j};
  }
  return pick3(pick3(c[0], c[1]), pick3(c[2], c[3]));
}

// This lane's kept nodes, but nodes xa and xb (being recomputed).
template <int S>
__device__ __forceinline__ Top2 kept_free(const Prog<S>& P, int xa, int xb) {
  const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
  Top2 r = none;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane_id() * P.slots + s;
    const bool keep = s < P.slots && q < P.n_nodes && q != xa && q != xb;
    const Top2 v = keep ? P.fs[s] : none;
    r = s == 0 ? v : merge2(r, v);
  }
  return r;
}

template <int S>
__device__ __forceinline__ Trip kept_trig(const Prog<S>& P, int x) {
  const Trip none = {KNONE, JOB_NONE, INT_MAX_};
  Trip r = none;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int q = lane_id() * P.slots + s;
    const bool keep = s < P.slots && q < P.n_nodes && q != x;
    const Trip v = keep ? P.ts[s] : none;
    r = s == 0 ? v : pick3(r, v);
  }
  return r;
}

// Recompute after a change to free sets fa and fb (NF of them; fb may
// equal fa) and trigger set ta (T).  A changed node is re-reduced from its
// sets, four a lane, and at the same time the root from every lane's kept
// nodes but the changed ones plus the changed nodes' sets: independent warp
// reductions (a program of one node skips the second).  The lane keeping a
// changed node updates it.  The sets' new state is in shared memory.
template <int S, int NF, bool T>
__device__ __forceinline__ void walk(Prog<S>& P, int fa, int fb, int ta) {
  __syncwarp();
  if (NF > 0) {
    const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
    const int pa = fa >> LOG_FAN, pb = (NF == 2 ? fb : fa) >> LOG_FAN;
    const bool two = NF == 2 && pb != pa;
    const Top2 ca = kids_free(P, pa);
    const Top2 cb = two ? kids_free(P, pb) : none;
    const Top2 na = warp_top2(ca);
    const Top2 nb = two ? warp_top2(cb) : na;
    if (P.n_nodes == 1) {
      P.froot = na;
    } else {
      Top2 rc = merge2(kept_free(P, pa, pb), ca);
      if (two) rc = merge2(rc, cb);
      P.froot = warp_top2(rc);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = lane_id() * P.slots + s;
      P.fs[s] = q == pa ? na : (two && q == pb ? nb : P.fs[s]);
    }
  }
  if (T) {
    const int pt = ta >> LOG_FAN;
    const Trip ct = kids_trig(P, pt);
    const Trip nt = warp_trip(ct);
    P.troot = P.n_nodes == 1 ? nt : warp_trip(pick3(kept_trig(P, pt), ct));
#pragma unroll
    for (int s = 0; s < S; ++s)
      P.ts[s] = lane_id() * P.slots + s == pt ? nt : P.ts[s];
  }
}

// Every node and both roots from the sets.
template <int S>
__device__ __forceinline__ void build_trees(Prog<S>& P) {
  __syncwarp();
  const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
  const Trip none3 = {KNONE, JOB_NONE, INT_MAX_};
#pragma unroll
  for (int s = 0; s < S; ++s) {
    P.fs[s] = none;
    P.ts[s] = none3;
  }
  for (int q = 0; q < P.n_nodes; ++q) {
    const Top2 n = warp_top2(kids_free(P, q));
    const Trip t = warp_trip(kids_trig(P, q));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool mine = lane_id() * P.slots + s == q;
      P.fs[s] = mine ? n : P.fs[s];
      P.ts[s] = mine ? t : P.ts[s];
    }
  }
  P.froot = warp_top2(kept_free(P, -1, -1));
  P.troot = warp_trip(kept_trig(P, -1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// One slot of the prefetch ring: what row r of the scan will need.
struct Slot {
  float sv[2];   // svc[r, set[k]]
  float alt;     // alt[r, alt_set] (hedged)
  float arr;     // arrivals[r]
  uint32_t hm;   // the aligned word holding hedge_mask[r]
  int set[2];
  int alt_set;
};

template <int S>
__global__ void __launch_bounds__(32)
sojourn_cells_kernel(const float* __restrict__ arr, const float* __restrict__ svc,
                     const float* __restrict__ alt, const int* __restrict__ kinds,
                     const float* __restrict__ thresholds,
                     const uint8_t* __restrict__ hmasks,
                     const int* __restrict__ n_groups, float* __restrict__ out,
                     int* __restrict__ extra_out, int n_pol, int n_jobs, int n_g,
                     int resolve) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Slot ring[RING];
  const int prog = blockIdx.x;
  const int c = prog / n_pol;
  const int p = prog % n_pol;
  const int me = lane_id();
  const float INF = f_inf();
  const int kind = kinds[p];
  const float thr = thresholds[c * n_pol + p];
  const bool armed_policy =
      (kind == KIND_CLONE || kind == KIND_RELAUNCH) && thr < INF;
  const bool do_resolve = resolve && armed_policy;
  const bool is_clone = kind == KIND_CLONE;
  const bool hedged = kind == KIND_HEDGED;
  const float* svc_c = svc + (size_t)c * n_jobs * n_g;
  const float* alt_c = alt + (size_t)c * n_jobs * n_g;
  const uint8_t* hm = hmasks + (size_t)p * n_jobs;
  float* out_l = out + (size_t)prog * n_jobs;

  Prog<S> P;
  const int gp = set_slots(n_g);
  P.ng = min(n_groups[c], n_g);
  P.n_nodes = (max(P.ng, 1) + FAN - 1) / FAN;
  P.slots = (P.n_nodes + 31) / 32;
  P.clone = is_clone;
  P.fr = reinterpret_cast<float*>(smem);
  P.dn = P.fr + gp;
  P.tt = P.dn + gp;
  P.ax = P.tt + gp;
  P.jb = reinterpret_cast<int*>(P.ax + gp);
  for (int k = me; k < gp; k += 32) {
    P.fr[k] = k < P.ng ? 0.0f : INF;
    P.dn[k] = 0.0f;
    P.tt[k] = INF;
    P.ax[k] = INF;
    P.jb[k] = INT_MAX_;
  }
  if (P.ng == 0) {
    // no replica set: every job starts at inf, as the plain version
    // computes it; an armed job never fires
    for (int i = me; i < n_jobs; i += 32) {
      const float a = arr[i];
      const float d0 = fmax_ref(a, INF) + svc_c[(size_t)i * n_g];
      out_l[i] = armed_policy ? 0.0f : d0 - a;
    }
    if (me == 0) extra_out[prog] = 0;
    return;
  }
  for (int k = me; k < n_jobs; k += 32) out_l[k] = 0.0f;
  build_trees(P);

  int extra = 0;
  float m_hw = -INF;  // largest m a stored clone trigger was advanced with
  int park_g = -1;    // relaunch: redraw loaded at arming, not yet parked
  float park_v = 0.0f;

  // All clone triggers from their base times at this m, and the trees anew.
  auto recompute_clones = [&](float m) {
    __syncwarp();
    for (int k = me; k < P.ng; k += 32) {
      float t = P.ax[k];
      if (t < INF) {
        const float d = P.dn[k];
        while (t < d && t < m) t = t + thr;
        P.tt[k] = t;
      }
    }
    build_trees(P);
  };

  // Fire or disarm armed triggers in time order (ties by job id) while they
  // fall before the next dispatch at max(limit, min free).
  auto resolve_events = [&](float limit) {
    if (park_g >= 0) {
      if (me == 0) P.ax[park_g] = park_v;
      park_g = -1;
    }
    while (true) {
      const float m = kval(P.froot.a.k);
      if (is_clone) {
        if (m < m_hw) {
          recompute_clones(m);
          m_hw = m;
        }
        while (kval(P.troot.k) < INF) {  // lazy re-arm of the root below m
          const int r = P.troot.i;
          __syncwarp();
          float t = P.tt[r];
          const float d = P.dn[r];
          if (!(t < d && t < m)) break;
          do {
            t = t + thr;
          } while (t < d && t < m);
          __syncwarp();
          if (me == 0) P.tt[r] = t;
          m_hw = fmax_ref(m_hw, m);
          walk<S, 0, true>(P, 0, 0, r);
        }
      }
      if (!(kval(P.troot.k) < INF)) return;  // nothing armed
      const int g = P.troot.i;
      const int jid = (int)P.troot.j;
      const float a_j = arr[jid];  // for the sojourn, stored after the walk
      __syncwarp();
      const float d = P.dn[g];
      const float t = fmin_ref(P.tt[g], d);
      const bool disarm = t >= d;
      const float start = fmax_ref(limit, m);
      if (!((t < start) || (t <= start && disarm))) return;
      float done_new;
      int h = -1;
      if (disarm) {
        done_new = d;
      } else if (is_clone) {
        h = P.froot.a.i;
        done_new = fmin_ref(d, t + alt_c[(size_t)jid * n_g + h]);
      } else {
        done_new = t + P.ax[g];
      }
      const bool moved = __float_as_uint(P.fr[g]) != __float_as_uint(done_new);
      __syncwarp();
      if (me == 0) {
        P.fr[g] = done_new;
        P.dn[g] = done_new;
        P.tt[g] = INF;
        P.ax[g] = INF;
      }
      if (h >= 0 && me == 0) P.fr[h] = done_new;
      if (h >= 0)
        walk<S, 2, true>(P, g, h, g);
      else if (moved)
        walk<S, 1, true>(P, g, g, g);
      else
        walk<S, 0, true>(P, 0, 0, g);
      if (me == 0) out_l[jid] = done_new - a_j;
      extra += disarm ? 0 : 1;
    }
  };

  // Lane 0 fills the ring slot of `row`: svc at the free root and at its
  // second, the arrival and the hedge-mask word, and for a hedged program
  // alt of the row before at the second; then an L2 prefetch a row on.
  auto issue_row = [&](int row) {
    if (me != 0) return;
    const int s0 = P.froot.a.i < P.ng ? P.froot.a.i : -1;
    const int s1 = P.froot.b.i < P.ng ? P.froot.b.i : -1;
    if (hedged && row >= 1 && row - 1 < n_jobs && s1 >= 0) {
      Slot& prev = ring[(row - 1) % RING];
      prev.alt_set = s1;
      cp_async4(&prev.alt, alt_c + (size_t)(row - 1) * n_g + s1);
    }
    if (row >= n_jobs) return;
    Slot& s = ring[row % RING];
    const float* r = svc_c + (size_t)row * n_g;
    s.set[0] = s0;
    s.set[1] = s1;
    s.alt_set = -1;
    if (s0 >= 0) cp_async4(&s.sv[0], r + s0);
    if (s1 >= 0) cp_async4(&s.sv[1], r + s1);
    cp_async4(&s.arr, arr + row);
    cp_async4(&s.hm, reinterpret_cast<const void*>(
                         reinterpret_cast<uintptr_t>(hm + row) & ~uintptr_t(3)));
    if (row + 1 < n_jobs) {
      if (s0 >= 0) prefetch_l2(r + n_g + s0);
      if (s1 >= 0) prefetch_l2(r + n_g + s1);
    }
  };

  issue_row(0);
  cp_async_commit();
  issue_row(1);
  cp_async_commit();
  for (int i = 0; i < n_jobs; ++i) {
    Slot& s = ring[i % RING];
    cp_async_wait<1>();  // row i's copies; row i + 1's may still fly
    __syncwarp();
    const float a = s.arr;
    const int hshift = 8 * (int)(reinterpret_cast<uintptr_t>(hm + i) & 3);
    const bool hedge_i = hedged && ((s.hm >> hshift) & 0xffu);
    if (do_resolve) resolve_events(a);
    const int g = P.froot.a.i;
    const float m = kval(P.froot.a.k);
    const float start = fmax_ref(a, m);
    const float sv = g == s.set[0] ? s.sv[0]
                     : g == s.set[1] ? s.sv[1] : svc_c[(size_t)i * n_g + g];
    const float d0 = start + sv;
    float d_final = d0;
    int h = -1;
    if (hedge_i) {
      const int ri = P.froot.b.i;  // the runner-up of g: the best but g
      if (ri < P.ng && kval(P.froot.b.k) <= start) {
        h = ri;
        float av;
        if (ri == s.alt_set) {
          cp_async_wait<0>();
          __syncwarp();
          av = s.alt;
        } else {
          av = alt_c[(size_t)i * n_g + ri];
        }
        d_final = fmin_ref(d0, start + av);
      }
    }
    const float d_primary = armed_policy ? d0 : d_final;
    __syncwarp();
    if (me == 0) {
      P.fr[g] = d_primary;
      P.dn[g] = d_primary;
    }
    if (h >= 0 && me == 0) P.fr[h] = d_final;
    if (me == 0 && !armed_policy) out_l[i] = d_final - a;
    extra += h >= 0 ? 1 : 0;
    if (armed_policy) {
      const float tr = start + thr;
      if (!is_clone && do_resolve) {
        if (park_g >= 0 && me == 0) P.ax[park_g] = park_v;
        park_g = g;
        park_v = alt_c[(size_t)i * n_g + g];
      }
      if (me == 0) {
        P.tt[g] = tr;
        if (is_clone) P.ax[g] = tr;
        P.jb[g] = i;
      }
    }
    if (do_resolve)
      walk<S, 1, true>(P, g, g, g);
    else if (h >= 0)
      walk<S, 2, false>(P, g, h, 0);
    else
      walk<S, 1, false>(P, g, g, 0);
    issue_row(i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (do_resolve) resolve_events(INF);
  if (me == 0) extra_out[prog] = extra;
}

template <int S>
int launch(dim3 grid, int smem, cudaStream_t stream, const float* arr,
           const float* svc, const float* alt, const int* kinds,
           const float* thresholds, const uint8_t* hmasks, const int* n_groups,
           float* out, int* extra, int n_pol, int n_jobs, int n_g, int resolve) {
  cudaError_t err = cudaFuncSetAttribute(
      sojourn_cells_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sojourn_cells_kernel<S><<<grid, 32, smem, stream>>>(
      arr, svc, alt, kinds, thresholds, hmasks, n_groups, out, extra, n_pol,
      n_jobs, n_g, resolve);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest row width whose per-set state and group entries fit one block's
// shared memory beside the kernel's static prefetch ring.
int sojourn_cells_max_groups() {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, sojourn_cells_kernel<MAX_SLOTS>) != cudaSuccess)
    return 0;
  const int room = max_optin - (int)attr.sharedSizeBytes;
  int lo = 0, hi = 1 << 20;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    const int b = smem_bytes(mid);
    if (b > 0 && b <= room) lo = mid; else hi = mid - 1;
  }
  return lo;
}

int sojourn_cells_launch(const float* arr, const float* svc, const float* alt,
                         const int* kinds, const float* thresholds,
                         const uint8_t* hmasks, const int* n_groups, float* out,
                         int* extra, int n_cells, int n_pol, int n_jobs, int n_g,
                         int resolve, void* stream) {
  const int smem = smem_bytes(n_g);
  if (smem <= 0) return (int)cudaErrorInvalidValue;
  // one node a lane when the widest program fits 32 nodes, else three
  const bool narrow = set_slots(n_g) / FAN <= 32;
  const dim3 grid(n_cells * n_pol);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (narrow)
    return launch<1>(grid, smem, s, arr, svc, alt, kinds, thresholds, hmasks,
                     n_groups, out, extra, n_pol, n_jobs, n_g, resolve);
  return launch<MAX_SLOTS>(grid, smem, s, arr, svc, alt, kinds, thresholds,
                           hmasks, n_groups, out, extra, n_pol, n_jobs, n_g,
                           resolve);
}

}  // extern "C"
