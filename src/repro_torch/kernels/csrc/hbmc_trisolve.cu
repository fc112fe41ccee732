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
// Single right-hand side (B1, B5): segment_single runs run_segment_single.
//   It replaces the Pallas kernels repro/kernels/hbmc_trisolve.py
//   hbmc_trisolve_fused (body _fused_kernel, FUSED) and hbmc_trisolve
//   (body _trisolve_kernel).  Bound: bytes -- the tables once, q once, y
//   written once; at the 1M plan in f64 134 MB per fused apply (0.040 ms at
//   3.35 TB/s) and 75 MB per sweep (0.023 ms).  One RHS gives only R =
//   32,768 threads, each running a chain of 16-32 dependent steps, so a
//   step costs the latency of its table loads and of its gathers, not
//   their bytes.  Two things shorten the chain:
//   * before the gathers of step g a thread loads step g+1's read-only
//     operands into registers (the first min(K, KP) entries of cols and
//     vals, dinv, and q for a forward step), so the DRAM latency of the
//     tables overlaps the current step's gathers and store.  Only
//     read-only operands move; every read and write of y keeps its place
//     in program order, so the segment argument above is unchanged.
//     Entries past KP load in step, in k order;
//   * those operands are read once per apply and are loaded evict-first
//     (__ldcs), so the tables streaming through L2 do not push out the
//     state y (8.4 MB), which the gathers read back.
//   Loading two or three steps ahead, L2-only or evict-last accesses to y,
//   and 64 or 256 threads a block instead of 128 gave no further gain in
//   design runs (PERF.md, section 6).
//
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

// Single RHS: entries of a step's table row prefetched into registers
// (the rest, up to K, load in step).
constexpr int KP = 8;

// acc + vals_j * y[c_j] for one entry: the gather is masked (c in [-m, 0)
// wraps; c outside [-m, m), or at or after lim, reads 0) and the product is
// rounded before it is added.  y holds nb columns, row-major; it is written
// by earlier steps of the same sweep, so it is read with plain loads, not
// the read-only path.
template <typename T>
__device__ __forceinline__ T add_term(T acc, int32_t c, T v, const T* y,
                                      int64_t m, int64_t lim, int nb, int b) {
  int64_t cj = c;
  if (cj < 0) cj += m;
  const T yj = (cj >= 0 && cj < lim) ? y[cj * nb + b] : T(0);
  return add_rn(acc, mul_rn(v, yj));
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

// B1 (FUSED: a segment of the fused table, 2S steps, backward steps
// g >= S) and B5 (a segment of one sweep's table, S steps, step g writes
// slice g).
template <typename T, bool FUSED>
__global__ void segment_single(const int32_t* __restrict__ cols,
                               const T* __restrict__ vals,
                               const T* __restrict__ dinv,
                               const T* __restrict__ q, T* y, int g0, int g1,
                               int s, int r, int k) {
  run_segment_single<T, FUSED>(cols, vals, dinv, q, y, g0, g1, s, r, k);
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
// n_steps); launch(g0, g1) issues its kernel.  *launched counts the
// launches issued.
template <typename Launch>
int for_each_segment(const int32_t* segs, int nseg, int n_steps,
                     int* launched, Launch launch) {
  if (nseg < 1 || segs[0] != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i) {
    const int g0 = segs[i];
    const int g1 = i + 1 < nseg ? segs[i + 1] : n_steps;
    if (g1 <= g0 || g1 > n_steps) return (int)cudaErrorInvalidValue;
    launch(g0, g1);
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
      segs, nseg, FUSED ? 2 * s : s, launched, [&](int g0, int g1) {
        if (FUSED)
          fused_segment_batched<T><<<blocks, threads, 0, st>>>(
              cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
        else
          sweep_segment_batched<T><<<blocks, threads, 0, st>>>(
              cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
      });
}

// B1 / B5: 128 threads a block, one per lane, so the 1M plan's 32,768
// lanes make 256 blocks over the 132 SMs.
template <typename T, bool FUSED>
int launch_single(const int32_t* cols, const T* vals, const T* dinv,
                  const T* q, T* y, int s, int r, int k, const int32_t* segs,
                  int nseg, cudaStream_t st, int* launched) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((r + threads - 1) / threads);
  return for_each_segment(
      segs, nseg, FUSED ? 2 * s : s, launched, [&](int g0, int g1) {
        segment_single<T, FUSED><<<blocks, threads, 0, st>>>(
            cols, vals, dinv, q, y, g0, g1, s, r, k);
      });
}

}  // namespace

// Every entry point: y (S*R[, B]) may hold any values on entry and holds
// the result on return (stream-ordered); segs is a host array of the nseg
// ascending segment starts (segs[0] == 0), one launch per segment;
// *launched is incremented once per kernel launch issued; the return value
// is the first CUDA error.

extern "C" int hbmc_trisolve_fused_f64(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       const void* segs, int nseg,
                                       void* stream, int* launched) {
  return launch_single<double, true>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_fused_f32(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       const void* segs, int nseg,
                                       void* stream, int* launched) {
  return launch_single<float, true>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
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
                                 const void* dinv, const void* q, void* y,
                                 int s, int r, int k, const void* segs,
                                 int nseg, void* stream, int* launched) {
  return launch_single<double, false>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_f32(const void* cols, const void* vals,
                                 const void* dinv, const void* q, void* y,
                                 int s, int r, int k, const void* segs,
                                 int nseg, void* stream, int* launched) {
  return launch_single<float, false>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, (const int32_t*)segs, nseg,
      (cudaStream_t)stream, launched);
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
