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
// - Tournament trees.  Each set has 20 bytes of state (free, doneg,
//   trigger time, trigger aux, job id).  Two trees run over the sets: one
//   over free keyed by (free, index) that keeps the lowest two, one over
//   the armed triggers keyed by (effective time, job id, index).  Sets
//   form nodes of 128, four a lane; a node's entry (its lowest two, or its
//   lowest trigger: 28 bytes) is kept by one lane (where the nodes sit in
//   registers, lane l keeps nodes l * slots + s, slots = ceil(nodes / 32)
//   set at run time by the program's ng; in the tables, lane q % 32 keeps
//   node q).
// - Instantiations of one kernel body, picked by the launch's row width
//   n_g.  Staged (sojourn_cells_kernel<S>): the sets' state lives in
//   dynamic shared memory and a lane's nodes in registers, S = 1 node a
//   lane up to 4,096 sets, S = 3 above; the state's 20 bytes a set cap n_g
//   at what one block's shared memory holds (sojourn_cells_max_groups:
//   11,520 on the H100).  Unstaged (sojourn_cells_kernel_wide<S>, any
//   wider row): the sets' hot words (free, trigger time, doneg: what every
//   walk reads) live in dynamic shared memory for the first kh sets and,
//   if every set's hot words fit, the cold ones (aux, job id) for the
//   first kc; the rest in a device-memory scratch the caller allocates
//   (sojourn_cells_wide_split, sojourn_cells_state_words).  kh and kc are
//   whole nodes, so a node's sets are on one side, the same in every lane.
//   The jobs fill the lowest free sets first, so a program that meets
//   fewer jobs than kh sets never leaves shared memory.  Up to 128 nodes
//   (16,384 sets) S = WIDE_SLOTS: the lanes keep the nodes in registers,
//   as the staged kernel does (every hot word and 4,352 sets' cold words
//   on chip at 16,384).  Past it S = 0, a third level: nodes form groups
//   of 32, node q being lane q % 32's node of group q / 32, so a group is
//   reduced across the warp as a node is, and the root from each lane's
//   group entries (lane l keeps groups l + 32 s, one up to 131,072 sets).
//   A walk reduces the changed node, its group and the root at once, each
//   from one value a lane: the lane's table entry in the changed group
//   (the changed node's left out) or its group entries (the changed
//   group's left out), merged with its sets of the changed node, so its
//   cost does not grow with the width up to 131,072 sets.  The node and
//   group tables (16 bytes an entry: the lowest two, or the lowest
//   trigger padded, one ld.shared.v4) sit in dynamic shared memory ahead
//   of the set words (the first 17,792 sets' hot words at 65,536); their
//   32 bytes a node cap n_g at sojourn_cells_max_wide_groups (897,024 on
//   the H100).  All instantiations run the same steps on the same
//   values.  Keys are the order-preserving uint32 image of the floats (-0
//   and +0 share it); the warp's lowest comes from __reduce_min_sync on
//   the key and then on the index (or job id) among the lanes holding it,
//   so ties go to the lowest index, as jnp.argmin breaks them.  A set past ng holds +inf and is
//   never written, so it loses every tie and needs no mask.  A change to a
//   set is a walk: its node is re-reduced from its sets and, at the same
//   time, the root from the other kept nodes and the changed node's sets
//   (independent warp reductions in one instruction stream); the keeping
//   lane stores the new node.  A program of one node needs only the first.
//   Lane 0 writes a set's state and the warp reads it after __syncwarp,
//   which orders shared and global memory alike.
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
constexpr int MAX_SLOTS = 3;       // nodes a lane keeps in registers: 96 nodes
constexpr uint32_t KNONE = 0xffffffffu;
constexpr int STATE_WORDS = 5;     // free, doneg, tt, aux, jobid
constexpr int WIDE_SLOTS = 4;      // unstaged: nodes a lane keeps in registers
constexpr int ENTRY_BYTES = 16;    // unstaged: a table entry (Top2, or Trip padded)
constexpr int HOT_BYTES = 12;      // unstaged: a set's free, tt and doneg
constexpr int COLD_BYTES = 8;      // and its aux and job id

// Shared memory of a staged launch of row width n_g: 20 bytes a set, n_g
// rounded up to whole nodes; -1 past 96 nodes.
__host__ __device__ inline int set_slots(int n_g) {
  return round_up(n_g < 1 ? 1 : n_g, FAN);
}

__host__ __device__ inline int smem_bytes(int n_g) {
  const int gp = set_slots(n_g);
  return gp / FAN > 32 * MAX_SLOTS ? -1 : 4 * STATE_WORDS * gp;
}

// Entries in whole rows of 32.  (round_up is left to FAN alone: called
// with another multiple, it lost the compiler the fact that every set
// count is FAN's multiple, and the staged kernel a register.)
__host__ __device__ inline int whole_rows(int g) { return (g + 31) / 32 * 32; }

// Groups of 32 nodes in an unstaged launch of row width n_g; whether its
// lanes keep the nodes in registers (up to WIDE_SLOTS a lane: 16,384
// sets); and, when they do not, the node and group tables' shared memory:
// both padded to whole rows of 32 entries, a free and a trigger table of
// each.
__host__ __device__ inline int wide_groups(int n_g) {
  return (set_slots(n_g) / FAN + 31) / 32;
}

__host__ __device__ inline bool wide_in_registers(int n_g) {
  return wide_groups(n_g) <= WIDE_SLOTS;
}

__host__ __device__ inline long long wide_table_bytes(int n_g) {
  if (wide_in_registers(n_g)) return 0;
  const int g = wide_groups(n_g);
  return 2LL * ENTRY_BYTES * (32LL * g + whole_rows(g));
}

__host__ __device__ inline long long wide_smem_bytes(int n_g, int kh, int kc) {
  return wide_table_bytes(n_g) + (long long)HOT_BYTES * kh +
         (long long)COLD_BYTES * kc;
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

// Shared memory by its 32-bit address, so that the tables and the split
// set words of the unstaged kernel with tables are read and written with
// ld/st.shared whichever way the compiler merges its branches (plain
// pointers there became generic loads, 2-5% slower on the card).
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint4 lds4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t lds1(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts1(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ Top2 ld_top2(uint32_t a) {
  const uint4 v = lds4(a);
  return {{v.x, (int)v.y}, {v.z, (int)v.w}};
}

__device__ __forceinline__ void st_top2(uint32_t a, const Top2& t) {
  sts4(a, make_uint4(t.a.k, (uint32_t)t.a.i, t.b.k, (uint32_t)t.b.i));
}

__device__ __forceinline__ Trip ld_trip(uint32_t a) {
  const uint4 v = lds4(a);
  return {v.x, v.y, (int)v.z};
}

__device__ __forceinline__ void st_trip(uint32_t a, const Trip& t) {
  sts4(a, make_uint4(t.k, t.j, (uint32_t)t.i, 0u));
}

// A set's words, in the order the unstaged kernel ranks them: free (every
// free walk), trigger time and doneg (every trigger walk) are hot; aux
// (clone) and job id (trigger walks of clone and relaunch) cold.
enum Word { FR = 0, TT = 1, DN = 2, AX = 3, JB = 4 };

// S: nodes a lane keeps in registers (staged: at most MAX_SLOTS; unstaged:
// WIDE_SLOTS, or 0 for the node and group tables in shared memory).  W:
// unstaged, each word of the first kh (hot) or kc (cold) sets in shared
// memory and of the others in the scratch.
template <int S, bool W = false>
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
  Top2 fs[S > 0 ? S : 1];  // this lane's nodes of the free tree
  Trip ts[S > 0 ? S : 1];  // and of the trigger tree
  // W: word w of the first kh / kc sets in shared memory (S = 0: at
  // address on[w] + 4 s; S > 0: at fr .. jb, every set's hot words, kh
  // being n_g's whole row), of the others in the scratch at
  // off[w][s - kh / kc]
  uint32_t on[STATE_WORDS];
  float* off[STATE_WORDS];
  int kh, kc;
  int n_groups;  // S = 0: this program's groups of 32 nodes
  int gslots;    // and the group entries a lane keeps (lane l: l + 32 s)
  uint32_t ftab, ttab;    // S = 0: node q's entries at ftab / ttab + 16 q
  uint32_t gftab, gttab;  // and group q's at gftab / gttab + 16 q
  Top2 froot;          // the warp's roots, the same in every lane
  Trip troot;
};

// W: the sets staged on chip for word w.
template <int S, bool W>
__device__ __forceinline__ int staged(const Prog<S, W>& P, int w) {
  return w < AX ? P.kh : P.kc;
}

// Word WD of set s, and its store.  s is the same in every lane.  With
// the tables (S = 0) every word is split, its shared side reached by
// address; with the nodes in registers the hot words all sit in shared
// memory (fr, tt, dn) and the cold ones are split at kc (ax, jb).
template <int WD, int S, bool W>
__device__ __forceinline__ float ldw(const Prog<S, W>& P, int s) {
  if constexpr (W && S == 0) {
    const int k = staged(P, WD);
    return s < k ? __uint_as_float(lds1(P.on[WD] + 4u * s))
                 : P.off[WD][s - k];
  } else if constexpr (W && WD == AX) {
    return s < P.kc ? P.ax[s] : P.off[AX][s - P.kc];
  } else {
    return WD == FR ? P.fr[s] : WD == TT ? P.tt[s] : WD == DN ? P.dn[s]
                                                               : P.ax[s];
  }
}

template <int WD, int S, bool W>
__device__ __forceinline__ void stw(Prog<S, W>& P, int s, float v) {
  if constexpr (W && S == 0) {
    const int k = staged(P, WD);
    if (s < k)
      sts1(P.on[WD] + 4u * s, __float_as_uint(v));
    else
      P.off[WD][s - k] = v;
  } else if constexpr (W && WD == AX) {
    if (s < P.kc)
      P.ax[s] = v;
    else
      P.off[AX][s - P.kc] = v;
  } else {
    (WD == FR ? P.fr : WD == TT ? P.tt : WD == DN ? P.dn : P.ax)[s] = v;
  }
}

template <int S, bool W>
__device__ __forceinline__ void st_job(Prog<S, W>& P, int s, int v) {
  if constexpr (W && S == 0) {
    if (s < P.kc)
      sts1(P.on[JB] + 4u * s, (uint32_t)v);
    else
      reinterpret_cast<int*>(P.off[JB])[s - P.kc] = v;
  } else if constexpr (W) {
    if (s < P.kc)
      P.jb[s] = v;
    else
      reinterpret_cast<int*>(P.off[JB])[s - P.kc] = v;
  } else {
    P.jb[s] = v;
  }
}

// W: the four words of a lane's sets base .. base + 3 of word WD.  base is
// a node's first set plus 4 x lane and the staged counts are whole nodes,
// so every lane takes the same side.
template <int WD, int S, bool W>
__device__ __forceinline__ uint4 ld_sets(const Prog<S, W>& P, int base) {
  const int k = staged(P, WD);
  if (base < k) return lds4(P.on[WD] + 4u * base);
  return *reinterpret_cast<const uint4*>(P.off[WD] + (base - k));
}

__device__ __forceinline__ float4 as_f4(uint4 v) {
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                     __uint_as_float(v.z), __uint_as_float(v.w));
}

// A lane's four sets of node p, reduced.  A set at or past ng holds +inf
// from the start and is never written, so with its index at or past ng it
// loses every tie to a set of the cell.
template <int S, bool W>
__device__ __forceinline__ Top2 kids_free(const Prog<S, W>& P, int p) {
  const int base = (p << LOG_FAN) + 4 * lane_id();
  float4 v;
  if constexpr (W && S == 0)
    v = as_f4(ld_sets<FR>(P, base));
  else
    v = *reinterpret_cast<const float4*>(P.fr + base);
  const Pair c0 = {fkey(v.x), base}, c1 = {fkey(v.y), base + 1};
  const Pair c2 = {fkey(v.z), base + 2}, c3 = {fkey(v.w), base + 3};
  const bool s01 = lt(c1, c0), s23 = lt(c3, c2);
  const Top2 x = {s01 ? c1 : c0, s01 ? c0 : c1};
  const Top2 y = {s23 ? c3 : c2, s23 ? c2 : c3};
  return merge2(x, y);
}

template <int S, bool W>
__device__ __forceinline__ Trip kids_trig(const Prog<S, W>& P, int p) {
  const int base = (p << LOG_FAN) + 4 * lane_id();
  const float INF = f_inf();
  float4 t, d, a;
  int4 j4;
  if constexpr (W && S == 0) {
    t = as_f4(ld_sets<TT>(P, base));
    d = as_f4(ld_sets<DN>(P, base));
    a = P.clone ? as_f4(ld_sets<AX>(P, base)) : t;
    const uint4 j = ld_sets<JB>(P, base);
    j4 = make_int4((int)j.x, (int)j.y, (int)j.z, (int)j.w);
  } else if constexpr (W) {
    // the cold words of a node past kc are in the scratch
    t = *reinterpret_cast<const float4*>(P.tt + base);
    d = *reinterpret_cast<const float4*>(P.dn + base);
    a = t;
    if (base < P.kc) {
      if (P.clone) a = *reinterpret_cast<const float4*>(P.ax + base);
      j4 = *reinterpret_cast<const int4*>(P.jb + base);
    } else {
      const int x = base - P.kc;
      if (P.clone) a = *reinterpret_cast<const float4*>(P.off[AX] + x);
      j4 = *reinterpret_cast<const int4*>(P.off[JB] + x);
    }
  } else {
    t = *reinterpret_cast<const float4*>(P.tt + base);
    d = *reinterpret_cast<const float4*>(P.dn + base);
    a = P.clone ? *reinterpret_cast<const float4*>(P.ax + base) : t;
    j4 = *reinterpret_cast<const int4*>(P.jb + base);
  }
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

// Nodes in registers: this lane's kept nodes, but nodes xa and xb (being
// recomputed).  The unstaged kernel's WIDE_SLOTS are more than most of
// its programs fill, so it stops at the program's own (a uniform branch).
template <int S, bool W>
__device__ __forceinline__ Top2 kept_free(const Prog<S, W>& P, int xa, int xb) {
  const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
  Top2 r = none;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if constexpr (W) {
      if (s > 0 && s >= P.slots) break;
    }
    const int q = lane_id() * P.slots + s;
    const bool keep = s < P.slots && q < P.n_nodes && q != xa && q != xb;
    const Top2 v = keep ? P.fs[s] : none;
    r = s == 0 ? v : merge2(r, v);
  }
  return r;
}

template <int S, bool W>
__device__ __forceinline__ Trip kept_trig(const Prog<S, W>& P, int x) {
  const Trip none = {KNONE, JOB_NONE, INT_MAX_};
  Trip r = none;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if constexpr (W) {
      if (s > 0 && s >= P.slots) break;
    }
    const int q = lane_id() * P.slots + s;
    const bool keep = s < P.slots && q < P.n_nodes && q != x;
    const Trip v = keep ? P.ts[s] : none;
    r = s == 0 ? v : pick3(r, v);
  }
  return r;
}

// Unstaged: this lane's group entries, but groups xa and xb (being
// recomputed).  Entries past the program's groups hold none.
template <int S, bool W>
__device__ __forceinline__ Top2 groups_free(const Prog<S, W>& P, int xa, int xb) {
  const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
  Top2 r = none;
  for (int s = 0; s < P.gslots; ++s) {
    const int q = (s << 5) + lane_id();
    const Top2 v = ld_top2(P.gftab + ENTRY_BYTES * q);
    r = merge2(r, q != xa && q != xb ? v : none);
  }
  return r;
}

template <int S, bool W>
__device__ __forceinline__ Trip groups_trig(const Prog<S, W>& P, int x) {
  const Trip none = {KNONE, JOB_NONE, INT_MAX_};
  Trip r = none;
  for (int s = 0; s < P.gslots; ++s) {
    const int q = (s << 5) + lane_id();
    const Trip v = ld_trip(P.gttab + ENTRY_BYTES * q);
    r = pick3(r, q != x ? v : none);
  }
  return r;
}

// Unstaged walk: node pa (and pb) from their sets; the changed groups from
// each lane's entry of the group (the changed nodes' left out) and its
// sets of the changed nodes; the root from each lane's group entries (the
// changed groups' left out) and its share of the changed groups.  Node q's
// and group q's entries are kept by lane q % 32, which alone reads them.
// Every load comes first and every store last, so that the loads' latency
// overlaps and no reduction waits on a load issued after another one.
template <int NF, bool T>
__device__ __forceinline__ void walk_wide(Prog<0, true>& P, int fa, int fb,
                                          int ta) {
  const int me = lane_id();
  const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
  const Trip none3 = {KNONE, JOB_NONE, INT_MAX_};
  const int pa = fa >> LOG_FAN, pb = (NF == 2 ? fb : fa) >> LOG_FAN;
  const bool two = NF == 2 && pb != pa;
  const int ga = pa >> 5, gb = pb >> 5;
  const bool twog = two && gb != ga;
  const int qa = (ga << 5) + me, qb = (gb << 5) + me;
  const int pt = ta >> LOG_FAN, gt = pt >> 5;
  const int qt = (gt << 5) + me;
  const bool many = P.n_groups > 1;
  // loads: the changed nodes' sets, this lane's entries of the changed
  // groups, its other group entries
  Top2 ca = none, cb = none, va = none, vb = none, kept = none;
  Trip ct = none3, vt = none3, keptt = none3;
  if (NF > 0) {
    ca = kids_free(P, pa);
    if (two) cb = kids_free(P, pb);
    va = ld_top2(P.ftab + ENTRY_BYTES * qa);
    if (twog) vb = ld_top2(P.ftab + ENTRY_BYTES * qb);
    if (many) kept = groups_free(P, ga, twog ? gb : ga);
  }
  if (T) {
    ct = kids_trig(P, pt);
    vt = ld_trip(P.ttab + ENTRY_BYTES * qt);
    if (many) keptt = groups_trig(P, gt);
  }
  // reductions
  Top2 na = none, nb = none, g_a = none, g_b = none;
  Trip nt = none3, g_t = none3;
  if (NF > 0) {
    na = warp_top2(ca);
    nb = two ? warp_top2(cb) : na;
    if (P.n_nodes == 1) {
      P.froot = na;
    } else {
      Top2 ea = merge2(qa != pa && qa != pb ? va : none, ca);
      if (two && !twog) ea = merge2(ea, cb);
      const Top2 eb = twog ? merge2(qb != pb ? vb : none, cb) : none;
      if (!many) {
        P.froot = warp_top2(ea);
      } else {
        g_a = warp_top2(ea);
        g_b = twog ? warp_top2(eb) : g_a;
        Top2 rc = merge2(kept, ea);
        if (twog) rc = merge2(rc, eb);
        P.froot = warp_top2(rc);
      }
    }
  }
  if (T) {
    nt = warp_trip(ct);
    if (P.n_nodes == 1) {
      P.troot = nt;
    } else {
      const Trip et = pick3(qt != pt ? vt : none3, ct);
      if (!many) {
        P.troot = warp_trip(et);
      } else {
        g_t = warp_trip(et);
        P.troot = warp_trip(pick3(keptt, et));
      }
    }
  }
  // stores, by the lanes that keep the entries
  if (NF > 0) {
    if (P.n_nodes > 1 && many) {
      if (me == (ga & 31)) st_top2(P.gftab + ENTRY_BYTES * ga, g_a);
      if (twog && me == (gb & 31)) st_top2(P.gftab + ENTRY_BYTES * gb, g_b);
    }
    if (me == (pa & 31)) st_top2(P.ftab + ENTRY_BYTES * pa, na);
    if (two && me == (pb & 31)) st_top2(P.ftab + ENTRY_BYTES * pb, nb);
  }
  if (T) {
    if (P.n_nodes > 1 && many && me == (gt & 31))
      st_trip(P.gttab + ENTRY_BYTES * gt, g_t);
    if (me == (pt & 31)) st_trip(P.ttab + ENTRY_BYTES * pt, nt);
  }
}

// Recompute after a change to free sets fa and fb (NF of them; fb may
// equal fa) and trigger set ta (T).  A changed node is re-reduced from its
// sets, four a lane, and at the same time the root from every lane's kept
// nodes but the changed ones plus the changed nodes' sets: independent warp
// reductions (a program of one node skips the second).  The lane keeping a
// changed node updates it.  The sets' new state is already stored.
template <int S, bool W, int NF, bool T>
__device__ __forceinline__ void walk(Prog<S, W>& P, int fa, int fb, int ta) {
  __syncwarp();
  if constexpr (S == 0) {
    walk_wide<NF, T>(P, fa, fb, ta);
    return;
  } else {
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
}

// Unstaged: every node, every group and both roots from the sets.  The
// program's node rows and group slots start empty, so entries past its
// nodes and groups lose every merge.
__device__ __forceinline__ void build_wide(Prog<0, true>& P) {
  const int me = lane_id();
  const Top2 none = {{KNONE, INT_MAX_}, {KNONE, INT_MAX_}};
  const Trip none3 = {KNONE, JOB_NONE, INT_MAX_};
  for (int s = 0; s < P.n_groups; ++s) {
    const int q = (s << 5) + me;
    st_top2(P.ftab + ENTRY_BYTES * q, none);
    st_trip(P.ttab + ENTRY_BYTES * q, none3);
  }
  for (int s = 0; s < P.gslots; ++s) {
    const int q = (s << 5) + me;
    st_top2(P.gftab + ENTRY_BYTES * q, none);
    st_trip(P.gttab + ENTRY_BYTES * q, none3);
  }
  for (int q = 0; q < P.n_nodes; ++q) {
    const Top2 n = warp_top2(kids_free(P, q));
    const Trip t = warp_trip(kids_trig(P, q));
    if (me == (q & 31)) {
      st_top2(P.ftab + ENTRY_BYTES * q, n);
      st_trip(P.ttab + ENTRY_BYTES * q, t);
    }
  }
  if (P.n_groups == 1) {
    P.froot = warp_top2(ld_top2(P.ftab + ENTRY_BYTES * me));
    P.troot = warp_trip(ld_trip(P.ttab + ENTRY_BYTES * me));
    return;
  }
  for (int g = 0; g < P.n_groups; ++g) {
    const int q = (g << 5) + me;
    const Top2 n = warp_top2(ld_top2(P.ftab + ENTRY_BYTES * q));
    const Trip t = warp_trip(ld_trip(P.ttab + ENTRY_BYTES * q));
    if (me == (g & 31)) {
      st_top2(P.gftab + ENTRY_BYTES * g, n);
      st_trip(P.gttab + ENTRY_BYTES * g, t);
    }
  }
  P.froot = warp_top2(groups_free(P, -1, -1));
  P.troot = warp_trip(groups_trig(P, -1));
}

// Every node and both roots from the sets.
template <int S, bool W>
__device__ __forceinline__ void build_trees(Prog<S, W>& P) {
  __syncwarp();
  if constexpr (S == 0) {
    build_wide(P);
    return;
  } else {
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

// One program of the scan, in either instantiation (Prog's S and W).
// state: W's device-memory scratch, sojourn_cells_state_words(n_g, kh, kc)
// words a program; kh, kc: W's sets whose hot / cold words are staged in
// shared memory (whole nodes).
template <int S, bool W>
__device__ __forceinline__ void sojourn_program(
    const float* __restrict__ arr, const float* __restrict__ svc,
    const float* __restrict__ alt, const int* __restrict__ kinds,
    const float* __restrict__ thresholds, const uint8_t* __restrict__ hmasks,
    const int* __restrict__ n_groups, float* __restrict__ out,
    int* __restrict__ extra_out, int n_pol, int n_jobs, int n_g, int resolve,
    float* state, int kh, int kc) {
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

  Prog<S, W> P;
  const int gp = set_slots(n_g);
  P.ng = min(n_groups[c], n_g);
  P.n_nodes = (max(P.ng, 1) + FAN - 1) / FAN;
  P.slots = (P.n_nodes + 31) / 32;
  P.clone = is_clone;
  if constexpr (W) {
    // the node and group tables (S = 0), then the staged set words
    P.kh = kh;
    P.kc = kc;
    unsigned char* const sets = smem + wide_table_bytes(n_g);
    if constexpr (S == 0) {
      const int rows = wide_groups(n_g), gpad = whole_rows(rows);
      P.n_groups = (P.n_nodes + 31) / 32;
      P.gslots = (P.n_groups + 31) / 32;
      P.ftab = saddr(smem);
      P.ttab = P.ftab + ENTRY_BYTES * 32 * rows;
      P.gftab = P.ttab + ENTRY_BYTES * 32 * rows;
      P.gttab = P.gftab + ENTRY_BYTES * gpad;
      P.on[FR] = saddr(sets);
      P.on[TT] = P.on[FR] + 4u * kh;
      P.on[DN] = P.on[TT] + 4u * kh;
      P.on[AX] = P.on[DN] + 4u * kh;
      P.on[JB] = P.on[AX] + 4u * kc;
    } else {
      P.fr = reinterpret_cast<float*>(sets);
      P.tt = P.fr + kh;
      P.dn = P.tt + kh;
      P.ax = P.dn + kh;
      P.jb = reinterpret_cast<int*>(P.ax + kc);
    }
    const int xh = gp - kh, xc = gp - kc;
    P.off[FR] = state + (size_t)prog * (3 * (size_t)xh + 2 * (size_t)xc);
    P.off[TT] = P.off[FR] + xh;
    P.off[DN] = P.off[TT] + xh;
    P.off[AX] = P.off[DN] + xh;
    P.off[JB] = P.off[AX] + xc;
    for (int k = me; k < gp; k += 32) {
      stw<FR>(P, k, k < P.ng ? 0.0f : INF);
      stw<DN>(P, k, 0.0f);
      stw<TT>(P, k, INF);
      stw<AX>(P, k, INF);
      st_job(P, k, INT_MAX_);
    }
  } else {
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
      float t = ldw<AX>(P, k);
      if (t < INF) {
        const float d = ldw<DN>(P, k);
        while (t < d && t < m) t = t + thr;
        stw<TT>(P, k, t);
      }
    }
    build_trees(P);
  };

  // Fire or disarm armed triggers in time order (ties by job id) while they
  // fall before the next dispatch at max(limit, min free).
  auto resolve_events = [&](float limit) {
    if (park_g >= 0) {
      if (me == 0) stw<AX>(P, park_g, park_v);
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
          float t = ldw<TT>(P, r);
          const float d = ldw<DN>(P, r);
          if (!(t < d && t < m)) break;
          do {
            t = t + thr;
          } while (t < d && t < m);
          __syncwarp();
          if (me == 0) stw<TT>(P, r, t);
          m_hw = fmax_ref(m_hw, m);
          walk<S, W, 0, true>(P, 0, 0, r);
        }
      }
      if (!(kval(P.troot.k) < INF)) return;  // nothing armed
      const int g = P.troot.i;
      const int jid = (int)P.troot.j;
      const float a_j = arr[jid];  // for the sojourn, stored after the walk
      __syncwarp();
      const float d = ldw<DN>(P, g);
      const float t = fmin_ref(ldw<TT>(P, g), d);
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
        done_new = t + ldw<AX>(P, g);
      }
      const bool moved =
          __float_as_uint(ldw<FR>(P, g)) != __float_as_uint(done_new);
      __syncwarp();
      if (me == 0) {
        stw<FR>(P, g, done_new);
        stw<DN>(P, g, done_new);
        stw<TT>(P, g, INF);
        stw<AX>(P, g, INF);
      }
      if (h >= 0 && me == 0) stw<FR>(P, h, done_new);
      if (h >= 0)
        walk<S, W, 2, true>(P, g, h, g);
      else if (moved)
        walk<S, W, 1, true>(P, g, g, g);
      else
        walk<S, W, 0, true>(P, 0, 0, g);
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
      stw<FR>(P, g, d_primary);
      stw<DN>(P, g, d_primary);
    }
    if (h >= 0 && me == 0) stw<FR>(P, h, d_final);
    if (me == 0 && !armed_policy) out_l[i] = d_final - a;
    extra += h >= 0 ? 1 : 0;
    if (armed_policy) {
      const float tr = start + thr;
      if (!is_clone && do_resolve) {
        if (park_g >= 0 && me == 0) stw<AX>(P, park_g, park_v);
        park_g = g;
        park_v = alt_c[(size_t)i * n_g + g];
      }
      if (me == 0) {
        stw<TT>(P, g, tr);
        if (is_clone) stw<AX>(P, g, tr);
        st_job(P, g, i);
      }
    }
    if (do_resolve)
      walk<S, W, 1, true>(P, g, g, g);
    else if (h >= 0)
      walk<S, W, 2, false>(P, g, h, 0);
    else
      walk<S, W, 1, false>(P, g, g, 0);
    issue_row(i + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (do_resolve) resolve_events(INF);
  if (me == 0) extra_out[prog] = extra;
}

template <int S>
__global__ void __launch_bounds__(32)
sojourn_cells_kernel(const float* __restrict__ arr, const float* __restrict__ svc,
                     const float* __restrict__ alt, const int* __restrict__ kinds,
                     const float* __restrict__ thresholds,
                     const uint8_t* __restrict__ hmasks,
                     const int* __restrict__ n_groups, float* __restrict__ out,
                     int* __restrict__ extra_out, int n_pol, int n_jobs, int n_g,
                     int resolve) {
  sojourn_program<S, false>(arr, svc, alt, kinds, thresholds, hmasks, n_groups,
                            out, extra_out, n_pol, n_jobs, n_g, resolve,
                            nullptr, 0, 0);
}

template <int S>
__global__ void __launch_bounds__(32)
sojourn_cells_kernel_wide(const float* __restrict__ arr,
                          const float* __restrict__ svc,
                          const float* __restrict__ alt,
                          const int* __restrict__ kinds,
                          const float* __restrict__ thresholds,
                          const uint8_t* __restrict__ hmasks,
                          const int* __restrict__ n_groups,
                          float* __restrict__ out, int* __restrict__ extra_out,
                          int n_pol, int n_jobs, int n_g, int resolve,
                          float* state, int kh, int kc) {
  sojourn_program<S, true>(arr, svc, alt, kinds, thresholds, hmasks, n_groups,
                           out, extra_out, n_pol, n_jobs, n_g, resolve, state,
                           kh, kc);
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

template <int S>
int launch_wide(int smem, cudaStream_t stream, const float* arr,
                const float* svc, const float* alt, const int* kinds,
                const float* thresholds, const uint8_t* hmasks,
                const int* n_groups, float* out, int* extra, float* state,
                int n_cells, int n_pol, int n_jobs, int n_g, int resolve,
                int kh, int kc) {
  cudaError_t err = cudaFuncSetAttribute(
      sojourn_cells_kernel_wide<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sojourn_cells_kernel_wide<S><<<dim3(n_cells * n_pol), 32, (size_t)smem,
                                 stream>>>(
      arr, svc, alt, kinds, thresholds, hmasks, n_groups, out, extra, n_pol,
      n_jobs, n_g, resolve, state, kh, kc);
  return (int)cudaGetLastError();
}

// Shared memory a block may take beside a kernel's static ring, or -1.
int smem_room(const void* kernel) {
  int dev = 0, max_optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return max_optin - (int)attr.sharedSizeBytes;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest row width whose per-set state fits one block's shared memory
// beside the kernel's static prefetch ring: the staged instantiations'.
int sojourn_cells_max_groups() {
  const int room = smem_room((const void*)sojourn_cells_kernel<MAX_SLOTS>);
  int lo = 0, hi = 1 << 20;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    const int b = smem_bytes(mid);
    if (b > 0 && b <= room) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Largest row width whose node and group tables fit one block's shared
// memory beside the ring: the unstaged instantiation's (with no set words
// staged).
int sojourn_cells_max_wide_groups() {
  const int room = smem_room((const void*)sojourn_cells_kernel_wide<0>);
  int lo = 0, hi = 1 << 24;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (wide_table_bytes(mid) <= room) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The unstaged split at row width n_g: the first *kh sets keep their hot
// words (free, trigger time, doneg) in shared memory beside the tables,
// and, when every set's hot words fit, the first *kc their cold ones (aux,
// job id); both whole nodes.  cudaErrorInvalidValue when the tables do not
// fit.
int sojourn_cells_wide_split(int n_g, int* kh, int* kc) {
  const int room = smem_room((const void*)sojourn_cells_kernel_wide<0>);
  const long long avail = (long long)room - wide_table_bytes(n_g);
  if (n_g < 1 || room < 0 || avail < 0) return (int)cudaErrorInvalidValue;
  const int gp = set_slots(n_g);
  *kh = (int)min((long long)gp, avail / (HOT_BYTES * FAN) * FAN);
  *kc = *kh < gp ? 0
                 : (int)min((long long)gp,
                            (avail - (long long)HOT_BYTES * gp) /
                                (COLD_BYTES * FAN) * FAN);
  return 0;
}

// Words of device-memory scratch a program of the unstaged instantiation
// keeps at row width n_g and split kh, kc: the hot words of the sets past
// kh and the cold ones of the sets past kc.
long long sojourn_cells_state_words(int n_g, int kh, int kc) {
  const int gp = set_slots(n_g);
  return 3LL * (gp - kh) + 2LL * (gp - kc);
}

// The staged instantiations, n_g <= sojourn_cells_max_groups().
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

// The unstaged instantiation, at any n_g <= sojourn_cells_max_wide_groups()
// and split kh, kc (whole nodes, at most n_g's, kh all of them where the
// lanes keep the nodes in registers; sojourn_cells_wide_split gives the
// one that fills shared memory); state: n_cells x n_pol x
// sojourn_cells_state_words(n_g, kh, kc) floats of device memory (null
// when that is 0), written before they are read.
int sojourn_cells_wide_launch(const float* arr, const float* svc,
                              const float* alt, const int* kinds,
                              const float* thresholds, const uint8_t* hmasks,
                              const int* n_groups, float* out, int* extra,
                              float* state, int n_cells, int n_pol, int n_jobs,
                              int n_g, int resolve, int kh, int kc,
                              void* stream) {
  if (n_g < 1) return (int)cudaErrorInvalidValue;
  const int gp = set_slots(n_g);
  const long long smem = wide_smem_bytes(n_g, kh, kc);
  if (kh < 0 || kc < 0 || kh > gp || kc > gp || kh % FAN || kc % FAN ||
      (wide_in_registers(n_g) && kh != gp) ||
      (state == nullptr && sojourn_cells_state_words(n_g, kh, kc) > 0) ||
      smem > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_in_registers(n_g))
    return launch_wide<WIDE_SLOTS>((int)smem, s, arr, svc, alt, kinds,
                                   thresholds, hmasks, n_groups, out, extra,
                                   state, n_cells, n_pol, n_jobs, n_g,
                                   resolve, kh, kc);
  return launch_wide<0>((int)smem, s, arr, svc, alt, kinds, thresholds,
                        hmasks, n_groups, out, extra, state, n_cells, n_pol,
                        n_jobs, n_g, resolve, kh, kc);
}

}  // extern "C"
