// HBMC triangular sweeps in round-major coordinates: the fused
// forward+backward sweep z = (L L^T)^{-1} q (the IC(0) apply of every PCG
// iteration of the round-major layout) and the single sweep of the index
// layout, each for one or B right-hand sides.
//
// Semantics kept from the reference, in every kernel here:
//   * gather: an index c in [-m, 0) wraps, c outside [-m, m) reads 0 (the
//     jnp.take fill_value=0 rule; the packing uses c == m for holes);
//   * the state starts at zero: a forward step g reads 0 from every slice
//     at or after g, which no earlier step has written.  The gather masks
//     those positions itself, so the output buffer needs no zero pass and
//     may hold any values on entry;
//   * the product vals*y is rounded before it is summed, k = 0..K-1 in
//     order (no fused multiply-add), as the reference multiplies
//     elementwise and then sums;
//   * padding lanes (vals = 0, dinv = 0) are computed like any other, so a
//     NaN in y propagates exactly as in the reference;
//   * backward step g >= S writes slice 2S-1-g and takes as right-hand side
//     the y value the same thread overwrites, read before the store (every
//     slice was written by the forward steps).
//
// Every kernel here runs one barrier-free segment of its table per launch:
// one thread per (lane, column) runs the steps [g0, g1) of the segment in
// order, on the same lane at every step, and the host issues one launch
// per segment (kernels/segments.py), so the kernel boundary is the only
// barrier.  The cut np.arange(G) gives one launch per step, the round
// barrier of the reference's sequential grid.
//
//   Why the boundary is enough.  The segments are cut so that within one,
//   a thread reads only positions of its own lane (written by itself, in
//   program order) or positions that no step of the segment writes
//   (written by an earlier launch); and no thread writes a position that
//   another lane reads in the same segment.  So no grid barrier, fence or
//   cooperative launch is needed, and every (lane, column) does exactly the
//   step-major arithmetic: the result is bitwise the plain version's, and
//   column j of a batched call is bitwise the single-RHS kernel's on column
//   j.  y is written in the same launch that reads it, so it is never read
//   through the read-only path (no __ldg, no const __restrict__ on y).
//   HBMC gives one segment per color boundary: at the 1M plan (S=32,
//   R=32768, K=4, two colors) 3 launches per fused apply and 2 per sweep,
//   against 64 and 32 per round.
//
// Single right-hand side (B1, B5): segment_single.
//   It replaces the Pallas kernels repro/kernels/hbmc_trisolve.py
//   hbmc_trisolve_fused (body _fused_kernel, FUSED) and hbmc_trisolve
//   (body _trisolve_kernel).  Bound: bytes -- the tables once, q once, y
//   written once; at the 1M plan in f64 134 MB per fused apply (0.040 ms at
//   3.35 TB/s) and 75 MB per sweep (0.023 ms).  One RHS gives only R
//   threads (19,424 on the thermal2 cell, 32,768 at the 1M plan: 4-8 warps
//   an SM), each running a chain of 8-32 dependent steps a launch, so an
//   apply costs its steps' latencies, not their bytes, unless each thread
//   keeps several steps' loads in flight.
//
//   What held the chain: a third of the live gathers read a position the
//   same launch wrote (0.31 on the thermal2 cell's plan, 94% of those one
//   step back), all of the reading thread's own lane.  Read through y,
//   which the launch writes and so is not __restrict__, each step's loads
//   stayed behind the previous step's store in program order, and its
//   table operands could be loaded only one step ahead.
//
//   The on-chip path (run_segment_on_chip; the host picks it for a segment
//   of a few steps or more, K <= KP, entries indexed in int32): no load of
//   y waits on a store of the same launch.  Each live gather of step g is
//   classified from (c, lane, g0, g) (read_step):
//   * a slice that a step of the launch before g wrote -- by the segment
//     contract above, then, the thread's own entry -- comes from chip: the
//     previous step's output in a register (distance 1), else a
//     per-thread ring of the launch's outputs in shared memory,
//     min(g1 - g0, RING_STEPS) steps deep (dynamic shared memory sized by
//     the host).  A writer more than RING_STEPS steps back is read from y,
//     whose store is then that many steps old;
//   * anything else -- another lane's entry, or an own slice an earlier
//     launch wrote -- is read-only for the launch, so it is loaded ahead:
//     the step's row (its K columns and values as pairs where K is even,
//     and dinv) AHEAD steps before its compute, evict-first (__ldcs, so the
//     tables streaming through L2 do not push out y, which the gathers
//     read back), and its gathers, q or the backward step's own y[dest],
//     READ_AHEAD steps before.
//   The compute then depends on registers and shared memory only.  K is a
//   template parameter (1..KP), so a row sits in registers whole and the
//   rings of rows and reads in flight are indexed statically: a loop
//   unrolled by AHEAD, no register copied while its load is in flight (a
//   copy would wait for the load).  Every store to y stays: later
//   launches, extract and the SpMV read it.
//
//   Design runs (H100, PERF.md section 6), an apply on the thermal2 cell's
//   plan: 0.261 ms plain, 0.189 on chip.  What is left: without table or
//   gather traffic the loop still takes about 0.13 ms, the latency of its
//   instruction stream at 4-5 warps an SM.  Loading further ahead spills
//   (AHEAD 6, READ_AHEAD 3); 64 or 32 threads a block, ring reads for the
//   previous step, and runtime K with a guard per entry were no faster or
//   slower.  Staging the rows in shared memory by cp.async read 0.194, or
//   0.174 with an evict-first L2 hint, which raised an illegal instruction
//   in one instantiation (a sweep, f64, K = 4): not kept.
//
//   The plain path (run_segment_single; shorter segments, which have
//   little or nothing to forward, and K > KP): step g+1's table operands
//   are loaded before the gathers of step g, and every read of y keeps its
//   place in program order.  It needs a third of the registers, which a
//   table of many short segments and many lanes (g3_circuit's 240 rounds)
//   needs for the occupancy that hides its gathers.
//
//   The lane-group path (segment_single_grouped; the host picks it, and G,
//   for a table of K > KP entries a row where a group fits): where a
//   step has few lanes and long rows -- the audikw_1 cell's fused table
//   (480, 1,580, 80) -- one thread a lane leaves ~0.4 warps an SM, each
//   thread walking 80 entries one dependent load after another: latency,
//   not bytes (19 us a step).  G threads of one warp take a lane instead
//   (G a power of two, G <= GROUP_MAX, G <= K, R x G at most about half
//   the card's resident threads):
//   thread t loads entries t, t + G, ... of the row (coalesced across the
//   group, evict-first, GROUP_AHEAD steps ahead), multiplies them by what
//   they read, and puts the rounded products in shared memory; the
//   group's first thread adds them in k order, holes included, and stores
//   the step's output.  While it adds, the group issues the next step's
//   gathers: every position but the lane's own entry of the slice the
//   current step writes is final by then (the segment contract), and that
//   one comes from the current step's output, handed over by a shuffle.
//   __syncwarp after the products and after the store orders the group,
//   so the sum, the masking and every value read are run_step's and the
//   result stays bitwise.  Bound: bytes, as the plain path; the floor of a
//   step is the first thread's K dependent adds, and the group's
//   instruction stream at ~3 warps a scheduler.
//
//   Design runs (H100, PERF.md section 6), B1 an apply on the audikw_1
//   cell's plan on replayed graphs: 9.09 ms plain; 0.931 grouped with the
//   gathers in the step; 0.826 with them issued during the previous sum;
//   0.612 with int32 positions and ceil(K / G) entries a thread (1.27 us a
//   step, 29 launches of ~5.6 us start-up each).  Slower: G = 16 or 8
//   (fewer threads in flight a lane), the first thread's products read 16
//   ahead in registers or in pairs, reads through __ldcg; GROUP_AHEAD 2
//   reads the same as 3.  Where the rule picks G < 32 the group still
//   beats a thread a lane, bitwise, on graph-Laplacian plans of the
//   g3_circuit family (ms an apply, plain -> grouped): G = 16 at (864,
//   5,440, 19) 6.36 -> 1.85; G = 8 at (448, 8,935, 13) 1.83 -> 0.92; G = 4
//   at (480, 26,843, 14) 3.19 -> 2.33-2.46; G = 2 at (480, 53,523, 14)
//   4.62 -> 4.38.  The gain shrinks as R x G nears its cap.
//
//   The paths do the same arithmetic in the same order, so they are
//   bitwise each other and the plain version; the host picks one per
//   segment (segments.single_paths) and passes its code to the entry point
//   (launch_single).

// B right-hand sides (B3, B6): fused_segment_batched replaces
//   hbmc_trisolve_fused_batched (body _fused_batched_kernel);
//   sweep_segment_batched replaces hbmc_trisolve_batched (body
//   _trisolve_batched_kernel); both run run_segment.  y is (S*R, B),
//   row-major.  One thread per (lane, column), the column fastest, so the B
//   threads of a lane share each table load and their gathers y[c*B + b]
//   hit B contiguous values.
//
//   Bound: bytes -- the tables once, q once and y written once: at the 1M
//   plan with B=8 in f64 about 252 MB per fused apply (0.075 ms at
//   3.35 TB/s) and 193 MB per sweep (0.058 ms).  What is left is memory
//   traffic the bound does not count: the gathers re-read y (67 MB at B=8,
//   beside a 50 MB L2), about one 64-byte row per lane and step from
//   another lane's block, written a color earlier and mostly gone from L2
//   by then.  Loading the next step's table entries into registers ahead
//   of the current step's gathers, staging them in shared memory by
//   cp.async.bulk on an mbarrier ring, column pairs, streaming loads and a
//   register cache of the thread's last row all gave the same time to 0.5%
//   (PERF.md): at B=8 the kernel is held by DRAM traffic, not by its
//   instruction stream, so its body is the plain per-step loop.
//
// The shard step (shard_step; hbmc_trisolve_shard_step*): one fused step of
//   one rank's lane block of a fused table sharded over a mesh axis, one RHS
//   or B.  It is the per-device body of the reference's
//   repro/core/trisolve.py _dist_substitute_fused (jnp inside shard_map, no
//   Pallas kernel there): the rank computes its lanes' updates from its
//   replica of y, and the caller all-gathers the step's slice across the
//   ranks (core/trisolve.py), one collective per step.  It runs run_step's
//   arithmetic (run_step_lanes, with the table's lane stride apart from the
//   state's), so a mesh solve is bitwise the single-device plan with the
//   same lane padding, and with r_loc == r_full, lane0 == 0 a step of it is
//   bitwise a step of B1 / B3.  One launch per step: the all-gather between
//   two steps is the barrier.  Bound: bytes, as B1 / B3 over the 2S steps
//   of an apply; at one step a launch and a collective, not its bytes, set
//   its time (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "rounded_ops.cuh"

namespace {

// Single RHS, plain path: entries of a step's table row prefetched into
// registers (the rest, up to K, load in step); the on-chip path takes
// tables of up to KP entries a row, K a template parameter.
constexpr int KP = 8;
// B1 / B5: threads a block, one per lane.
constexpr int SINGLE_THREADS = 128;
// On-chip path: the most steps of its own outputs a thread keeps in its
// ring in shared memory (a power of two; 32 KB a block in f64).
constexpr int RING_STEPS = 32;
// On-chip path: a step's row loads AHEAD steps, and its other reads
// READ_AHEAD steps, ahead of its compute.
constexpr int AHEAD = 4;
constexpr int READ_AHEAD = 2;
// Lane-group path: at most GROUP_MAX threads (one warp) a lane; each
// thread of a group loads at most GP entries of a step's row ahead, so a
// row's first chunk is at most G x GP entries.
constexpr int GROUP_MAX = 32;
constexpr int GP = 4;
// Lane-group path: a step's row loads GROUP_AHEAD steps ahead of its
// compute, its reads one step ahead.
constexpr int GROUP_AHEAD = 3;

// vals_j * y[c_j] for one entry (term), and acc plus it (add_term): the
// gather is masked (c in [-m, 0) wraps; c outside [-m, m), or at or after
// lim, reads 0) and the product is rounded before it is added.  y holds nb
// columns, row-major; it is written by earlier steps of the same sweep, so
// it is read with plain loads, not the read-only path.
template <typename T>
__device__ __forceinline__ T term(int32_t c, T v, const T* y, int64_t m,
                                  int64_t lim, int nb, int b) {
  int64_t cj = c;
  if (cj < 0) cj += m;
  const T yj = (cj >= 0 && cj < lim) ? y[cj * nb + b] : T(0);
  return mul_rn(v, yj);
}

template <typename T>
__device__ __forceinline__ T add_term(T acc, int32_t c, T v, const T* y,
                                      int64_t m, int64_t lim, int nb, int b) {
  return add_rn(acc, term(c, v, y, m, lim, nb, b));
}

// acc plus the entries j = j0..k-1 of a row, in order, for one (lane,
// column).
template <typename T>
__device__ __forceinline__ T gather_dot(const int32_t* __restrict__ c,
                                        const T* __restrict__ v, const T* y,
                                        int j0, int k, int64_t m, int64_t lim,
                                        int nb, int b, T acc) {
  for (int j = j0; j < k; ++j)
    acc = add_term(acc, c[j], v[j], y, m, lim, nb, b);
  return acc;
}

// Step g of a fused (FUSED) or single-sweep table for one (lane, column) of
// nb columns, for a block of lanes of the state: the table (and dinv) has
// r_tab lanes a step, the state y and the right-hand side q have r_y, and
// the table's lane `lane` is the state's lane lane0 + lane.  A forward step
// reads the slices before g (those at or after g are still zero), a
// backward step all of them.  With r_tab == r_y and lane0 == 0 it is the
// whole table's step (run_step); the shard step runs it on one rank's lane
// block of a table sharded over a mesh.
template <typename T, bool FUSED>
__device__ __forceinline__ void run_step_lanes(
    const int32_t* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ dinv, const T* __restrict__ q, T* y, int g, int s,
    int r_tab, int r_y, int lane0, int k, int nb, int lane, int b) {
  const int64_t m = (int64_t)s * r_y;
  const int64_t row = (int64_t)g * r_tab + lane;
  const int64_t at = (int64_t)g * r_y + lane0 + lane;
  const bool fwd = !FUSED || g < s;
  const T acc = gather_dot(cols + row * k, vals + row * k, y, 0, k, m,
                           fwd ? (int64_t)g * r_y : m, nb, b, T(0));
  const int64_t dest =
      ((int64_t)(fwd ? g : 2 * s - 1 - g) * r_y + lane0 + lane) * nb + b;
  const T q_cur = fwd ? q[at * nb + b] : y[dest];
  y[dest] = (q_cur - acc) * dinv[row];
}

// Step g of a whole fused (FUSED) or single-sweep table for one (lane,
// column) of nb columns.
template <typename T, bool FUSED>
__device__ __forceinline__ void run_step(const int32_t* __restrict__ cols,
                                         const T* __restrict__ vals,
                                         const T* __restrict__ dinv,
                                         const T* __restrict__ q, T* y,
                                         int g, int s, int r, int k, int nb,
                                         int lane, int b) {
  run_step_lanes<T, FUSED>(cols, vals, dinv, q, y, g, s, r, r, 0, k, nb,
                           lane, b);
}

// Steps [g0, g1) of a fused (FUSED) or single-sweep table for nb columns:
// one thread per (lane, column), the column fastest, the same lane at every
// step.
template <typename T, bool FUSED>
__device__ __forceinline__ void run_segment(const int32_t* __restrict__ cols,
                                            const T* __restrict__ vals,
                                            const T* __restrict__ dinv,
                                            const T* __restrict__ q, T* y,
                                            int g0, int g1, int s, int r,
                                            int k, int nb) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)r * nb) return;
  const int lane = (int)(t / nb);
  const int b = (int)(t - (int64_t)lane * nb);
  for (int g = g0; g < g1; ++g)
    run_step<T, FUSED>(cols, vals, dinv, q, y, g, s, r, k, nb, lane, b);
}

// The read-only operands of one step of one lane (single RHS): the first
// min(K, KP) entries of its row, dinv, and q for a forward step.  They
// are read once per apply, so they are loaded evict-first (__ldcs): the
// 134 MB they stream through the 50 MB L2 at the 1M plan then does not
// push out the state y, which the gathers read back.
template <typename T>
struct StepOperands {
  int32_t c[KP];
  T v[KP];
  T d, q;
};

template <typename T, bool FUSED>
__device__ __forceinline__ void load_operands(
    StepOperands<T>& o, const int32_t* __restrict__ cols,
    const T* __restrict__ vals, const T* __restrict__ dinv,
    const T* __restrict__ q, int g, int s, int r, int k, int lane) {
  const int64_t row = (int64_t)g * r + lane;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < k) {
      o.c[j] = __ldcs(cols + row * k + j);
      o.v[j] = __ldcs(vals + row * k + j);
    }
  }
  o.d = __ldcs(dinv + row);
  if (!FUSED || g < s) o.q = __ldcs(q + row);
}

// Step g of a fused (FUSED) or single-sweep table for one RHS, lane `lane`,
// from its prefetched operands o: run_step's arithmetic and accesses to y.
template <typename T, bool FUSED>
__device__ __forceinline__ void run_step_single(
    const StepOperands<T>& o, const int32_t* __restrict__ cols,
    const T* __restrict__ vals, T* y, int g, int s, int r, int k,
    int lane) {
  const int64_t m = (int64_t)s * r;
  const int64_t row = (int64_t)g * r + lane;
  const bool fwd = !FUSED || g < s;
  const int64_t lim = fwd ? (int64_t)g * r : m;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < KP; ++j)
    if (j < k) acc = add_term(acc, o.c[j], o.v[j], y, m, lim, 1, 0);
  if (k > KP)
    acc = gather_dot(cols + row * k, vals + row * k, y, KP, k, m, lim, 1, 0,
                     acc);
  const int64_t dest = (int64_t)(fwd ? g : 2 * s - 1 - g) * r + lane;
  const T q_cur = fwd ? o.q : y[dest];
  y[dest] = (q_cur - acc) * o.d;
}

// Steps [g0, g1) of a fused (FUSED) or single-sweep table for one RHS, one
// thread per lane.  The read-only operands of step g+1 are loaded before
// the gathers of step g; the arithmetic, and the order of every access to
// y, are run_step's.
template <typename T, bool FUSED>
__device__ __forceinline__ void run_segment_single(
    const int32_t* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ dinv, const T* __restrict__ q, T* y, int g0,
    int g1, int s, int r, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= r) return;
  StepOperands<T> next = {};   // entries past K stay 0, never read
  load_operands<T, FUSED>(next, cols, vals, dinv, q, g0, s, r, k, lane);
  for (int g = g0; g < g1; ++g) {
    const StepOperands<T> cur = next;
    if (g + 1 < g1)
      load_operands<T, FUSED>(next, cols, vals, dinv, q, g + 1, s, r, k,
                              lane);
    run_step_single<T, FUSED>(cur, cols, vals, y, g, s, r, k, lane);
  }
}

// The KN entries of a table row at p, evict-first: in pairs (int2, float2,
// double2) where KN is even (a row then starts on a pair's boundary), else
// one by one.
template <typename T> struct Pair;
template <> struct Pair<int> { using type = int2; };
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T, int KN>
__device__ __forceinline__ void load_row(T (&out)[KN], const T* p) {
  if constexpr (KN % 2 == 0) {
    const auto* p2 = reinterpret_cast<const typename Pair<T>::type*>(p);
#pragma unroll
    for (int j = 0; j < KN / 2; ++j) {
      const auto v = __ldcs(p2 + j);
      out[2 * j] = v.x;
      out[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KN; ++j) out[j] = __ldcs(p + j);
  }
}

// A step's table row (on-chip path, KN entries): its columns, values and
// dinv, loaded AHEAD steps ahead of its compute.
template <typename T, int KN>
struct StepRow {
  int c[KN];
  T v[KN];
  T d;
};

// Where a read of the on-chip path finds its value (StepReads::from): the
// thread's ring at a slot below RING_STEPS, the previous step's output
// (FROM_LAST), or the value read ahead from y (FROM_Y; 0 where the read is
// masked).
constexpr int FROM_LAST = RING_STEPS;
constexpr int FROM_Y = -1;

// What step g reads besides its row (on-chip path), issued READ_AHEAD
// steps ahead of its compute: each entry's gather from y where the launch
// does not write it, q for a forward step (evict-first) or the backward
// step's own right-hand side y[dest] likewise, and the source of each
// (entry KN: the right-hand side).
template <typename T, int KN>
struct StepReads {
  T y[KN];
  T q;
  int from[KN + 1];
};

// The reads of step g of lane `lane` in the launch [g0, g1), from its
// columns c (on-chip path; every index fits int32).  A live read (c
// wrapped into [0, lim)) of a slice that a step of the launch before g
// wrote is on chip: by the segment contract it is of the lane's own entry,
// so its slice x is (p - lane) / r exactly (a float product, rounded: the
// quotient is below S), and its latest writer w -- forward step x, or
// backward step 2S-1-x where that is before g -- lies in the launch.  The
// launch's writes before g are the forward slices [g0, min(g, S)) and, for
// a backward step, the slices [2S-g, 2S-1-max(g0, S)] of the backward
// steps.  A writer more than RING_STEPS steps back is read from y, stored
// that many steps before.
template <typename T, bool FUSED, int KN>
__device__ __forceinline__ void read_step(StepReads<T, KN>& rd,
                                          const int (&c)[KN],
                                          const T* __restrict__ q, const T* y,
                                          int g, int g0, int s, int r,
                                          float rinv, int lane) {
  const int m = s * r;
  const bool fwd = !FUSED || g < s;
  const int lim = fwd ? g * r : m;
  // positions written in the launch before g: forward [lo_f, hi_f),
  // backward [lo_b, hi_b)
  const int lo_f = g0 * r, hi_f = fwd ? g * r : m;
  const int lo_b = fwd ? 0 : (2 * s - g) * r;
  const int hi_b = fwd ? 0 : (2 * s - (g0 > s ? g0 : s)) * r;
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    const int p = c[j] < 0 ? c[j] + m : c[j];
    const bool live = p >= 0 && p < lim;
    const int x = __float2int_rn(__int2float_rn(p - lane) * rinv);
    const bool back = p >= lo_b && p < hi_b;
    const int w = back ? 2 * s - 1 - x : x;
    const bool on = live && (back || p >= lo_f && p < hi_f) &&
                    g - w <= RING_STEPS;
    rd.from[j] = !on ? FROM_Y
                     : w == g - 1 ? FROM_LAST : (w - g0) & (RING_STEPS - 1);
    T yj = T(0);
    if (live && !on) yj = y[p];
    rd.y[j] = yj;
  }
  if (fwd) {
    rd.q = __ldcs(q + g * r + lane);
  } else {   // y[dest], written by forward step x
    const int x = 2 * s - 1 - g;
    const bool on = x >= g0 && g - x <= RING_STEPS;
    rd.from[KN] = !on ? FROM_Y
                      : x == g - 1 ? FROM_LAST : (x - g0) & (RING_STEPS - 1);
    T qj = T(0);
    if (!on) qj = y[x * r + lane];
    rd.q = qj;
  }
}

// A read's value from its source (on-chip path): `loaded` (FROM_Y),
// `last` (the previous step's output) or the thread's ring ring_t.
template <typename T>
__device__ __forceinline__ T sourced(int from, T loaded, T last,
                                     const T* ring_t) {
  T v = loaded;
  if (from == FROM_LAST) v = last;
  else if (from != FROM_Y) v = ring_t[from * SINGLE_THREADS];
  return v;
}

// Steps [g0, g1) of a fused (FUSED) or single-sweep table of KN entries a
// row for one RHS, one thread per lane, on the on-chip path.  Step g's row
// loads at the compute of step g - AHEAD, its other reads issue at the
// compute of step g - READ_AHEAD, and its output goes to y, to the ring
// and to a register; its arithmetic is run_step's.  The rows and reads of
// the steps in flight sit in rings indexed by (g - g0) % AHEAD, in a loop
// unrolled by AHEAD, so no register is copied while its load is in flight
// (the copy would wait for the load).  The ring (ring_t: this thread's
// column of the block's) holds min(g1 - g0, RING_STEPS) outputs.
template <typename T, bool FUSED, int KN>
__device__ __forceinline__ void run_segment_on_chip(
    const int32_t* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ dinv, const T* __restrict__ q, T* y, T* ring,
    int g0, int g1, int s, int r) {
  static_assert(READ_AHEAD < AHEAD, "a row arrives before its reads");
  const int lane = blockIdx.x * SINGLE_THREADS + threadIdx.x;
  if (lane >= r) return;
  T* ring_t = ring + threadIdx.x;
  const float rinv = 1.0f / (float)r;
  StepRow<T, KN> rows[AHEAD];
  StepReads<T, KN> rd[AHEAD];
  auto load_step_row = [&](StepRow<T, KN>& w, int g) {
    const int row = g * r + lane;
    load_row<int, KN>(w.c, cols + row * KN);
    load_row<T, KN>(w.v, vals + row * KN);
    w.d = __ldcs(dinv + row);
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i)
    if (g0 + i < g1) load_step_row(rows[i], g0 + i);
#pragma unroll
  for (int i = 0; i < READ_AHEAD; ++i)
    if (g0 + i < g1)
      read_step<T, FUSED, KN>(rd[i], rows[i].c, q, y, g0 + i, g0, s, r, rinv,
                              lane);
  T last = T(0);
  for (int base = g0; base < g1; base += AHEAD) {
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      const int g = base + i;
      if (g < g1) {
        const int ahead = (i + READ_AHEAD) % AHEAD;
        if (g + READ_AHEAD < g1)
          read_step<T, FUSED, KN>(rd[ahead], rows[ahead].c, q, y,
                                  g + READ_AHEAD, g0, s, r, rinv, lane);
        const StepRow<T, KN> row = rows[i];
        if (g + AHEAD < g1) load_step_row(rows[i], g + AHEAD);
        const StepReads<T, KN>& cur = rd[i];
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < KN; ++j)
          acc = add_rn(acc, mul_rn(row.v[j], sourced(cur.from[j], cur.y[j],
                                                     last, ring_t)));
        const T q_cur = FUSED && g >= s
                            ? sourced(cur.from[KN], cur.q, last, ring_t)
                            : cur.q;
        const T out = (q_cur - acc) * row.d;
        y[(FUSED && g >= s ? 2 * s - 1 - g : g) * r + lane] = out;
        ring_t[((g - g0) & (RING_STEPS - 1)) * SINGLE_THREADS] = out;
        last = out;
      }
    }
  }
}

// B1 (FUSED: a segment of the fused table, 2S steps, backward steps
// g >= S) and B5 (a segment of one sweep's table, S steps, step g writes
// slice g): on the on-chip path for rows of KN entries (KN = K), or on the
// plain path (KN = 0, any K).
template <typename T, bool FUSED, int KN>
__global__ void __launch_bounds__(SINGLE_THREADS)
    segment_single(const int32_t* __restrict__ cols,
                   const T* __restrict__ vals, const T* __restrict__ dinv,
                   const T* __restrict__ q, T* y, int g0, int g1, int s, int r,
                   int k) {
  // the on-chip path's ring: min(g1 - g0, RING_STEPS) x SINGLE_THREADS
  // values, sized at the launch
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  if constexpr (KN > 0)
    run_segment_on_chip<T, FUSED, KN>(cols, vals, dinv, q, y,
                                      reinterpret_cast<T*>(ring_bytes), g0,
                                      g1, s, r);
  else
    run_segment_single<T, FUSED>(cols, vals, dinv, q, y, g0, g1, s, r, k);
}

// Thread t's part of a step's row (lane-group path, NP entries a thread):
// entries t, t + G, ..., t + (NP-1) G, neighbouring threads on
// neighbouring entries, and for the group's first thread dinv and q (a
// forward step), all evict-first.  Entries past K stay 0, never loaded.
template <typename T, int NP>
struct GroupRow {
  int32_t c[NP];
  T v[NP];
  T d, q;
};

// What thread t's entries of a step read (lane-group path): each gather
// (0 where masked) and, for the first thread, a backward step's own
// right-hand side; bit i of `last` (bit NP: the right-hand side) marks a
// read of what the previous step of the launch wrote.
template <typename T, int NP>
struct GroupReads {
  T y[NP];
  T rhs;
  unsigned last;
};

template <typename T, bool FUSED, int G, int NP>
__device__ __forceinline__ void load_group_row(
    GroupRow<T, NP>& w, const int32_t* __restrict__ cols,
    const T* __restrict__ vals, const T* __restrict__ dinv,
    const T* __restrict__ q, int g, int s, int r, int k, int lane, int t) {
  const int64_t row = (int64_t)g * r + lane;
  const int32_t* __restrict__ cr = cols + row * k;
  const T* __restrict__ vr = vals + row * k;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int j = i * G + t;
    if (j < k) {
      w.c[i] = __ldcs(cr + j);
      w.v[i] = __ldcs(vr + j);
    }
  }
  if (t == 0) {
    w.d = __ldcs(dinv + row);
    if (!FUSED || g < s) w.q = __ldcs(q + row);
  }
}

// The reads of step g of lane `lane` (thread t of its group) from its row
// w, issued while step g - 1 is still summing.  A live read (masked as
// term's) of position `prev` -- the lane's own entry of the slice step
// g - 1 of the launch writes, -1 at the launch's first step -- is marked
// to take that step's output, whose store may not have landed; by the
// segment contract every other position is one that no step of the launch
// from g - 1 on writes before g reads it, so it is loaded now.  Positions
// are int32 (S*R fits: the host takes this path only then).
template <typename T, bool FUSED, int G, int NP>
__device__ __forceinline__ void read_group_step(GroupReads<T, NP>& rd,
                                                const GroupRow<T, NP>& w,
                                                const T* y, int g, int s,
                                                int r, int k, int lane, int t,
                                                int prev) {
  const int m = s * r;
  const bool fwd = !FUSED || g < s;
  const unsigned lim = fwd ? g * r : m;
  unsigned last = 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = w.c[i] < 0 ? w.c[i] + m : w.c[i];
    const bool live = i * G + t < k && (unsigned)p < lim;
    const bool own = live && p == prev;
    last |= (unsigned)own << i;
    T yj = T(0);
    if (live && !own) yj = y[p];
    rd.y[i] = yj;
  }
  if (t == 0 && !fwd) {   // y[dest], written by forward step 2S-1-g
    const int dest = (2 * s - 1 - g) * r + lane;
    const bool own = dest == prev;
    last |= (unsigned)own << NP;
    T rhs = T(0);
    if (!own) rhs = y[dest];
    rd.rhs = rhs;
  }
  rd.last = last;
}

// B1 / B5 on the lane-group path: steps [g0, g1) of a fused (FUSED) or
// single-sweep table for one RHS, G threads of one warp a lane (G a power
// of two, 2..GROUP_MAX), SINGLE_THREADS / G lanes a block, NP entries of a
// row's first chunk a thread.  A row goes in chunks of G x NP entries.
// Each thread multiplies its entries of the first chunk by what they read
// into the group's slots in shared memory; after a __syncwarp it issues
// its reads of the next step (read_group_step) and its loads of the row
// GROUP_AHEAD steps on, while the group's first thread adds the products
// in k order.  Further chunks (K > G x NP) load, gather and add in the
// step, a __syncwarp before and after each.  The first thread then stores
// the step's output; a __syncwarp, and a shuffle hands the output to the
// group for the next step's reads of it.  Every thread of the block runs
// every step, __syncwarp and shuffle, those past R computing nothing.  The
// rows and reads in flight sit in rings indexed by (g - g0) % GROUP_AHEAD,
// in a loop unrolled by GROUP_AHEAD, so no register is copied while its
// load is in flight.  The arithmetic, and the value each read sees, are
// run_step's.
template <typename T, bool FUSED, int G, int NP>
__global__ void __launch_bounds__(SINGLE_THREADS)
    segment_single_grouped(const int32_t* __restrict__ cols,
                           const T* __restrict__ vals,
                           const T* __restrict__ dinv,
                           const T* __restrict__ q, T* y, int g0, int g1,
                           int s, int r, int k) {
  static_assert(G >= 2 && G <= GROUP_MAX && (G & (G - 1)) == 0,
                "a group is a power of two within a warp");
  static_assert(NP >= 1 && NP <= GP, "at most GP entries a thread");
  constexpr int CHUNK = G * NP;
  __shared__ T prod[SINGLE_THREADS * NP];
  const int t = threadIdx.x % G;
  const int lane = blockIdx.x * (SINGLE_THREADS / G) + threadIdx.x / G;
  const bool active = lane < r;
  const bool lead = active && t == 0;
  T* const slots = prod + (threadIdx.x / G) * CHUNK;
  const int n0 = k < CHUNK ? k : CHUNK;
  GroupRow<T, NP> rows[GROUP_AHEAD] = {};
  GroupReads<T, NP> rd[GROUP_AHEAD] = {};
  if (active) {
#pragma unroll
    for (int i = 0; i < GROUP_AHEAD; ++i)
      if (g0 + i < g1)
        load_group_row<T, FUSED, G, NP>(rows[i], cols, vals, dinv, q, g0 + i,
                                        s, r, k, lane, t);
    read_group_step<T, FUSED, G, NP>(rd[0], rows[0], y, g0, s, r, k, lane, t,
                                     -1);
  }
  T last = T(0);
  for (int base = g0; base < g1; base += GROUP_AHEAD) {
#pragma unroll
    for (int i = 0; i < GROUP_AHEAD; ++i) {
      const int g = base + i;
      if (g < g1) {
        const bool fwd = !FUSED || g < s;
        const int dest = (fwd ? g : 2 * s - 1 - g) * r + lane;
        const GroupReads<T, NP>& cur = rd[i];
        // entries past K multiply 0 by 0 into slots the sum never reads
        if (active) {
#pragma unroll
          for (int ii = 0; ii < NP; ++ii)
            slots[ii * G + t] = mul_rn(
                rows[i].v[ii], (cur.last >> ii) & 1 ? last : cur.y[ii]);
        }
        const T d = rows[i].d, qf = rows[i].q;
        __syncwarp();
        if (active && g + 1 < g1)
          read_group_step<T, FUSED, G, NP>(rd[(i + 1) % GROUP_AHEAD],
                                           rows[(i + 1) % GROUP_AHEAD], y,
                                           g + 1, s, r, k, lane, t, dest);
        if (active && g + GROUP_AHEAD < g1)
          load_group_row<T, FUSED, G, NP>(rows[i], cols, vals, dinv, q,
                                          g + GROUP_AHEAD, s, r, k, lane, t);
        T acc = T(0);
        if (lead) {
#pragma unroll 8
          for (int j = 0; j < n0; ++j) acc = add_rn(acc, slots[j]);
        }
        if (k > CHUNK) {
          const int64_t m = (int64_t)s * r;
          const int64_t lim = fwd ? (int64_t)g * r : m;
          const int64_t row = (int64_t)g * r + lane;
          for (int cb = CHUNK; cb < k; cb += CHUNK) {
            __syncwarp();   // the first thread has read the last chunk
            if (active) {
#pragma unroll
              for (int ii = 0; ii < NP; ++ii) {
                const int j = cb + ii * G + t;
                if (j < k)
                  slots[ii * G + t] = term(__ldcs(cols + row * k + j),
                                           __ldcs(vals + row * k + j), y, m,
                                           lim, 1, 0);
              }
            }
            __syncwarp();
            if (lead) {
              const int n = k - cb < CHUNK ? k - cb : CHUNK;
#pragma unroll 8
              for (int j = 0; j < n; ++j) acc = add_rn(acc, slots[j]);
            }
          }
        }
        T out = T(0);
        if (lead) {
          const T rhs = fwd ? qf : (cur.last >> NP) & 1 ? last : cur.rhs;
          out = (rhs - acc) * d;
          y[dest] = out;
        }
        __syncwarp();
        last = __shfl_sync(0xffffffffu, out, 0, G);
      }
    }
  }
}

// B3: a segment of the fused table (2S steps, backward steps g >= S).
template <typename T>
__global__ void fused_segment_batched(const int32_t* __restrict__ cols,
                                      const T* __restrict__ vals,
                                      const T* __restrict__ dinv,
                                      const T* __restrict__ q, T* y, int g0,
                                      int g1, int s, int r, int k, int nb) {
  run_segment<T, true>(cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
}

// B6: a segment of one sweep's table (S steps, step g writes slice g).
template <typename T>
__global__ void sweep_segment_batched(const int32_t* __restrict__ cols,
                                      const T* __restrict__ vals,
                                      const T* __restrict__ dinv,
                                      const T* __restrict__ q, T* y, int g0,
                                      int g1, int s, int r, int k, int nb) {
  run_segment<T, false>(cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
}

// The shard step: fused step g of one rank's lane block [lane0, lane0 +
// r_loc) of a fused table sharded over a mesh axis, for nb columns (nb = 1:
// one RHS).  The table shard is (2S, r_loc, K); q (S, r_full[, B]) and y
// (S*r_full[, B]) are the replicated vectors, and the step writes the
// block's r_loc entries of slice dest(g) of y; the caller all-gathers the
// slice across the ranks before the next step.  One thread per (lane,
// column), 256 a block.
template <typename T>
__global__ void shard_step(const int32_t* __restrict__ cols,
                           const T* __restrict__ vals,
                           const T* __restrict__ dinv,
                           const T* __restrict__ q, T* y, int g, int s,
                           int r_loc, int k, int nb, int r_full, int lane0) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)r_loc * nb) return;
  const int lane = (int)(t / nb);
  const int b = (int)(t - (int64_t)lane * nb);
  run_step_lanes<T, true>(cols, vals, dinv, q, y, g, s, r_loc, r_full, lane0,
                          k, nb, lane, b);
}

template <typename T>
int launch_shard_step(const int32_t* cols, const T* vals, const T* dinv,
                      const T* q, T* y, int g, int s, int r_loc, int k,
                      int nb, int r_full, int lane0, cudaStream_t st,
                      int* launched) {
  if (g < 0 || g >= 2 * s || lane0 < 0 || r_loc < 1 ||
      (int64_t)lane0 + r_loc > r_full || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks =
      (unsigned)(((int64_t)r_loc * nb + threads - 1) / threads);
  shard_step<T><<<blocks, threads, 0, st>>>(cols, vals, dinv, q, y, g, s,
                                           r_loc, k, nb, r_full, lane0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return (int)cudaSuccess;
}

// One launch per segment: segs holds the nseg ascending start steps on the
// host (segs[0] == 0), segment i runs [segs[i], segs[i+1]) (the last up to
// n_steps); launch(i, g0, g1) issues its kernel.  *launched counts the
// launches issued.
template <typename Launch>
int for_each_segment(const int32_t* segs, int nseg, int n_steps,
                     int* launched, Launch launch) {
  if (nseg < 1 || segs[0] != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i) {
    const int g0 = segs[i];
    const int g1 = i + 1 < nseg ? segs[i + 1] : n_steps;
    if (g1 <= g0 || g1 > n_steps) return (int)cudaErrorInvalidValue;
    launch(i, g0, g1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

// B3 / B6: 256 threads a block, one per (lane, column).
template <typename T, bool FUSED>
int launch_segments(const int32_t* cols, const T* vals, const T* dinv,
                    const T* q, T* y, int s, int r, int k, int nb,
                    const int32_t* segs, int nseg, cudaStream_t st,
                    int* launched) {
  const int threads = 256;
  const unsigned blocks =
      (unsigned)(((int64_t)r * nb + threads - 1) / threads);
  return for_each_segment(
      segs, nseg, FUSED ? 2 * s : s, launched, [&](int, int g0, int g1) {
        if (FUSED)
          fused_segment_batched<T><<<blocks, threads, 0, st>>>(
              cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
        else
          sweep_segment_batched<T><<<blocks, threads, 0, st>>>(
              cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
      });
}

// B1 / B5 on the on-chip path, rows of KN entries: one launch, its ring
// min(g1 - g0, RING_STEPS) steps deep.
template <typename T, bool FUSED, int KN>
void launch_on_chip(const int32_t* cols, const T* vals, const T* dinv,
                    const T* q, T* y, int g0, int g1, int s, int r,
                    unsigned blocks, cudaStream_t st) {
  const int depth = g1 - g0 < RING_STEPS ? g1 - g0 : RING_STEPS;
  const size_t ring = (size_t)depth * SINGLE_THREADS * sizeof(T);
  segment_single<T, FUSED, KN><<<blocks, SINGLE_THREADS, ring, st>>>(
      cols, vals, dinv, q, y, g0, g1, s, r, KN);
}

// B1 / B5 on the lane-group path, G threads a lane and NP entries of a
// row's first chunk a thread: one launch.
template <typename T, bool FUSED, int G, int NP>
void launch_grouped(const int32_t* cols, const T* vals, const T* dinv,
                    const T* q, T* y, int g0, int g1, int s, int r, int k,
                    cudaStream_t st) {
  const unsigned blocks =
      (unsigned)(((int64_t)r * G + SINGLE_THREADS - 1) / SINGLE_THREADS);
  segment_single_grouped<T, FUSED, G, NP>
      <<<blocks, SINGLE_THREADS, 0, st>>>(cols, vals, dinv, q, y, g0, g1, s,
                                          r, k);
}

// The same with NP = ceil(K / G) entries a thread, taken from 2..GP (3
// only at G = GROUP_MAX: below it G is K's largest power of two, so a
// thread has at most two entries, unless R cuts G down).
template <typename T, bool FUSED, int G>
void launch_group(const int32_t* cols, const T* vals, const T* dinv,
                  const T* q, T* y, int g0, int g1, int s, int r, int k,
                  cudaStream_t st) {
  const int per = (k + G - 1) / G;
  if (per <= 2)
    return launch_grouped<T, FUSED, G, 2>(cols, vals, dinv, q, y, g0, g1, s,
                                          r, k, st);
  if constexpr (G == GROUP_MAX)
    if (per == 3)
      return launch_grouped<T, FUSED, G, 3>(cols, vals, dinv, q, y, g0, g1,
                                            s, r, k, st);
  launch_grouped<T, FUSED, G, GP>(cols, vals, dinv, q, y, g0, g1, s, r, k,
                                  st);
}

// B1 / B5: SINGLE_THREADS a block, one per lane, so the 1M plan's 32,768
// lanes make 256 blocks over the 132 SMs.  paths holds one code a segment,
// picked on the host (segments.single_paths): 0 the plain path, 1 the
// on-chip path, G in {2, 4, ..., GROUP_MAX} the lane-group path with G
// threads a lane.  A code whose kernel cannot take the table -- on chip
// past KP entries a row or at 2^31 entries, a group not a power of two in
// [2, GROUP_MAX] or at 2^31 positions -- refuses the call before any
// launch.
template <typename T, bool FUSED>
int launch_single(const int32_t* cols, const T* vals, const T* dinv,
                  const T* q, T* y, int s, int r, int k, const int32_t* segs,
                  int nseg, const int32_t* paths, cudaStream_t st,
                  int* launched) {
  const unsigned blocks =
      (unsigned)((r + SINGLE_THREADS - 1) / SINGLE_THREADS);
  const bool on_chip_fits =
      k >= 1 && k <= KP && (int64_t)(FUSED ? 2 * s : s) * r * k < (1ll << 31);
  // (every packed table's positions fit int32: its hole is S*R itself)
  const bool group_fits = (int64_t)s * r < (1ll << 31);
  for (int i = 0; i < nseg; ++i) {
    const int p = paths[i];
    const bool ok = p == 0 || (p == 1 && on_chip_fits) ||
                    (p >= 2 && p <= GROUP_MAX && (p & (p - 1)) == 0 &&
                     group_fits);
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  return for_each_segment(
      segs, nseg, FUSED ? 2 * s : s, launched, [&](int i, int g0, int g1) {
        const int p = paths[i];
        if (p == 0) {
          segment_single<T, FUSED, 0><<<blocks, SINGLE_THREADS, 0, st>>>(
              cols, vals, dinv, q, y, g0, g1, s, r, k);
          return;
        }
        if (p > 1) {
          switch (p) {
            case 2: return launch_group<T, FUSED, 2>(cols, vals, dinv, q, y, g0, g1, s, r, k, st);
            case 4: return launch_group<T, FUSED, 4>(cols, vals, dinv, q, y, g0, g1, s, r, k, st);
            case 8: return launch_group<T, FUSED, 8>(cols, vals, dinv, q, y, g0, g1, s, r, k, st);
            case 16: return launch_group<T, FUSED, 16>(cols, vals, dinv, q, y, g0, g1, s, r, k, st);
            default: return launch_group<T, FUSED, GROUP_MAX>(cols, vals, dinv, q, y, g0, g1, s, r, k, st);
          }
        }
        switch (k) {
          case 1: return launch_on_chip<T, FUSED, 1>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          case 2: return launch_on_chip<T, FUSED, 2>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          case 3: return launch_on_chip<T, FUSED, 3>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          case 4: return launch_on_chip<T, FUSED, 4>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          case 5: return launch_on_chip<T, FUSED, 5>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          case 6: return launch_on_chip<T, FUSED, 6>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          case 7: return launch_on_chip<T, FUSED, 7>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
          default: return launch_on_chip<T, FUSED, KP>(cols, vals, dinv, q, y, g0, g1, s, r, blocks, st);
        }
      });
}

}  // namespace

// Every entry point: y (S*R[, B]) may hold any values on entry and holds
// the result on return (stream-ordered); segs is a host array of the nseg
// ascending segment starts (segs[0] == 0), one launch per segment;
// for B1 / B5 paths is a host array of the nseg path codes (launch_single);
// *launched is incremented once per kernel launch issued; the return value
// is the first CUDA error.

extern "C" int hbmc_trisolve_fused_f64(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       const void* segs, int nseg,
                                       const void* paths, void* stream,
                                       int* launched) {
  return launch_single<double, true>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, (const int32_t*)segs, nseg,
      (const int32_t*)paths, (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_fused_f32(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       const void* segs, int nseg,
                                       const void* paths, void* stream,
                                       int* launched) {
  return launch_single<float, true>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, (const int32_t*)segs, nseg,
      (const int32_t*)paths, (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_fused_batched_f64(
    const void* cols, const void* vals, const void* dinv, const void* q,
    void* y, int s, int r, int k, int nb, const void* segs, int nseg,
    void* stream, int* launched) {
  return launch_segments<double, true>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, nb, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_fused_batched_f32(
    const void* cols, const void* vals, const void* dinv, const void* q,
    void* y, int s, int r, int k, int nb, const void* segs, int nseg,
    void* stream, int* launched) {
  return launch_segments<float, true>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, nb, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_f64(const void* cols, const void* vals,
                                 const void* dinv, const void* q,
                                 void* y, int s, int r, int k,
                                 const void* segs, int nseg,
                                 const void* paths, void* stream,
                                 int* launched) {
  return launch_single<double, false>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, (const int32_t*)segs, nseg,
      (const int32_t*)paths, (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_f32(const void* cols, const void* vals,
                                 const void* dinv, const void* q,
                                 void* y, int s, int r, int k,
                                 const void* segs, int nseg,
                                 const void* paths, void* stream,
                                 int* launched) {
  return launch_single<float, false>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, (const int32_t*)segs, nseg,
      (const int32_t*)paths, (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_batched_f64(const void* cols, const void* vals,
                                         const void* dinv, const void* q,
                                         void* y, int s, int r, int k,
                                         int nb, const void* segs, int nseg,
                                         void* stream, int* launched) {
  return launch_segments<double, false>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, nb, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_batched_f32(const void* cols, const void* vals,
                                         const void* dinv, const void* q,
                                         void* y, int s, int r, int k,
                                         int nb, const void* segs, int nseg,
                                         void* stream, int* launched) {
  return launch_segments<float, false>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, nb, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
}

// The shard step (see shard_step): fused step g of the lane block [lane0,
// lane0 + r_loc) of a table shard (2S, r_loc, K), reading q (S, r_full[, B])
// and y (S*r_full[, B]) and writing the block's entries of y's slice
// dest(g) in place; one launch.

extern "C" int hbmc_trisolve_shard_step_f64(const void* cols,
                                            const void* vals,
                                            const void* dinv, const void* q,
                                            void* y, int g, int s, int r_loc,
                                            int k, int r_full, int lane0,
                                            void* stream, int* launched) {
  return launch_shard_step<double>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, g, s, r_loc, k, 1, r_full, lane0,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_shard_step_f32(const void* cols,
                                            const void* vals,
                                            const void* dinv, const void* q,
                                            void* y, int g, int s, int r_loc,
                                            int k, int r_full, int lane0,
                                            void* stream, int* launched) {
  return launch_shard_step<float>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, g, s, r_loc, k, 1, r_full, lane0,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_shard_step_batched_f64(
    const void* cols, const void* vals, const void* dinv, const void* q,
    void* y, int g, int s, int r_loc, int k, int nb, int r_full, int lane0,
    void* stream, int* launched) {
  return launch_shard_step<double>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, g, s, r_loc, k, nb, r_full, lane0,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_shard_step_batched_f32(
    const void* cols, const void* vals, const void* dinv, const void* q,
    void* y, int g, int s, int r_loc, int k, int nb, int r_full, int lane0,
    void* stream, int* launched) {
  return launch_shard_step<float>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, g, s, r_loc, k, nb, r_full, lane0,
      (cudaStream_t)stream, launched);
}
