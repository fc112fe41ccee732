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
// Single right-hand side, one launch per step (B1, B5).
//   fused_step replaces the Pallas kernel repro/kernels/hbmc_trisolve.py
//   hbmc_trisolve_fused (body _fused_kernel); sweep_step replaces
//   hbmc_trisolve (body _trisolve_kernel).  The TPU ran the steps as one
//   sequential grid; here each step is one launch over the R lanes of its
//   round, one thread per lane, and the kernel boundary is the round
//   barrier.  Bound: bytes -- the tables once, q once, y written once; at
//   the 1M plan (S=32, R=32768, K=4, f64) 134 MB per fused apply (0.040 ms
//   at 3.35 TB/s) and 75 MB per sweep (0.023 ms).  Their 64 / 32 dependent
//   launches, not the bytes, set their time.
//
// B right-hand sides, one launch per barrier-free segment (B3, B6).
//   fused_segment_batched replaces hbmc_trisolve_fused_batched (body
//   _fused_batched_kernel); sweep_segment_batched replaces
//   hbmc_trisolve_batched (body _trisolve_batched_kernel); both run
//   run_segment.  y is (S*R, B), row-major.  One thread per (lane, column),
//   the column fastest, so the B threads of a lane share each table load
//   and their gathers y[c*B + b] hit B contiguous values.  Each thread runs
//   the steps [g0, g1) of one segment in order, on the same lane at every
//   step; the host issues one launch per segment (kernels/segments.py), and
//   the kernel boundary is the only barrier.
//
//   Why the boundary is enough.  The segments are cut so that within one,
//   a thread reads only positions of its own lane (written by itself, in
//   program order) or positions that no step of the segment writes
//   (written by an earlier launch); and no thread writes a position that
//   another lane reads in the same segment.  So no grid barrier, fence or
//   cooperative launch is needed, and every (lane, column) does exactly the
//   step-major arithmetic: the result is bitwise the plain version's, and
//   column j is bitwise the single-RHS kernel's on column j.  y is written
//   in the same launch that reads it, so it is never read through the
//   read-only path (no __ldg, no const __restrict__ on y).
//
//   Bound: bytes -- the tables once, q once and y written once: at the 1M
//   plan with B=8 in f64 about 252 MB per fused apply (0.075 ms at
//   3.35 TB/s) and 193 MB per sweep (0.058 ms).  HBMC gives one segment per
//   color boundary: 3 launches per fused apply and 2 per sweep at the 1M
//   plan, against 64 and 32 per round.  What is left is memory traffic the
//   bound does not count: the gathers re-read y (67 MB at B=8, beside a
//   50 MB L2), about one 64-byte row per lane and step from another lane's
//   block, written a color earlier and mostly gone from L2 by then.  Loading
//   the next step's table entries into registers ahead of the current
//   step's gathers, staging them in shared memory by cp.async.bulk on an
//   mbarrier ring, column pairs, streaming loads and a register cache of the
//   thread's last row all gave the same time to 0.5% (PERF.md): the kernel
//   is held by DRAM traffic, not by its instruction stream, so its body is
//   the plain per-step loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rounded_ops.cuh"

namespace {

// Sum over k of vals[j] * y[c[j]] for one (lane, column): the gather is
// masked (c in [-m, 0) wraps; c outside [-m, m), or at or after lim, reads
// 0), each product is rounded before it is added, k = 0..K-1 in order.  y
// holds nb columns, row-major; y is written by earlier steps of the same
// sweep, so it is read with plain loads, not the read-only path.
template <typename T>
__device__ __forceinline__ T gather_dot(const int32_t* __restrict__ c,
                                        const T* __restrict__ v, const T* y,
                                        int k, int64_t m, int64_t lim, int nb,
                                        int b) {
  T acc = T(0);
  for (int j = 0; j < k; ++j) {
    int64_t cj = c[j];
    if (cj < 0) cj += m;
    const T yj = (cj >= 0 && cj < lim) ? y[cj * nb + b] : T(0);
    acc = add_rn(acc, mul_rn(v[j], yj));
  }
  return acc;
}

// Step g of a fused (FUSED) or single-sweep table for one (lane, column) of
// nb columns: a forward step reads the slices before g (those at or after g
// are still zero), a backward step all of them.
template <typename T, bool FUSED>
__device__ __forceinline__ void run_step(const int32_t* __restrict__ cols,
                                         const T* __restrict__ vals,
                                         const T* __restrict__ dinv,
                                         const T* __restrict__ q, T* y,
                                         int g, int s, int r, int k, int nb,
                                         int lane, int b) {
  const int64_t m = (int64_t)s * r;
  const int64_t row = (int64_t)g * r + lane;
  const bool fwd = !FUSED || g < s;
  const T acc = gather_dot(cols + row * k, vals + row * k, y, k, m,
                           fwd ? (int64_t)g * r : m, nb, b);
  const int64_t dest =
      ((int64_t)(fwd ? g : 2 * s - 1 - g) * r + lane) * nb + b;
  const T q_cur = fwd ? q[row * nb + b] : y[dest];
  y[dest] = (q_cur - acc) * dinv[row];
}

template <typename T>
__global__ void fused_step(const int32_t* __restrict__ cols,
                           const T* __restrict__ vals,
                           const T* __restrict__ dinv,
                           const T* __restrict__ q, T* y, int g, int s,
                           int r, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= r) return;
  run_step<T, true>(cols, vals, dinv, q, y, g, s, r, k, 1, lane, 0);
}

// One round g of a single sweep (B5): lane t of round g writes y[g*R + t]
// from q at the same position.  The tables hold S rounds, and round g
// gathers only from slices 0..g-1, so no launch reads what it writes.
template <typename T>
__global__ void sweep_step(const int32_t* __restrict__ cols,
                           const T* __restrict__ vals,
                           const T* __restrict__ dinv,
                           const T* __restrict__ q, T* y, int g, int s,
                           int r, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= r) return;
  run_step<T, false>(cols, vals, dinv, q, y, g, s, r, k, 1, lane, 0);
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

// One launch per segment: segs holds the nseg ascending start steps on the
// host (segs[0] == 0), segment i runs [segs[i], segs[i+1]) (the last up to
// the table's end).  *launched counts the launches issued.
template <typename T, bool FUSED>
int launch_segments(const int32_t* cols, const T* vals, const T* dinv,
                    const T* q, T* y, int s, int r, int k, int nb,
                    const int32_t* segs, int nseg, cudaStream_t st,
                    int* launched) {
  const int n_steps = FUSED ? 2 * s : s;
  if (nseg < 1 || segs[0] != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks =
      (unsigned)(((int64_t)r * nb + threads - 1) / threads);
  for (int i = 0; i < nseg; ++i) {
    const int g0 = segs[i];
    const int g1 = i + 1 < nseg ? segs[i + 1] : n_steps;
    if (g1 <= g0 || g1 > n_steps) return (int)cudaErrorInvalidValue;
    if (FUSED)
      fused_segment_batched<T><<<blocks, threads, 0, st>>>(
          cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
    else
      sweep_segment_batched<T><<<blocks, threads, 0, st>>>(
          cols, vals, dinv, q, y, g0, g1, s, r, k, nb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

// One launch per step; *launched counts the launches issued.
template <typename T, bool FUSED>
int launch_steps(const int32_t* cols, const T* vals, const T* dinv,
                 const T* q, T* y, int s, int r, int k, cudaStream_t st,
                 int* launched) {
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  for (int g = 0; g < (FUSED ? 2 * s : s); ++g) {
    if (FUSED)
      fused_step<T><<<blocks, threads, 0, st>>>(cols, vals, dinv, q, y, g,
                                                s, r, k);
    else
      sweep_step<T><<<blocks, threads, 0, st>>>(cols, vals, dinv, q, y, g,
                                                s, r, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Every entry point: y (S*R[, B]) may hold any values on entry and holds
// the result on return (stream-ordered); *launched is incremented once per
// kernel launch issued; the return value is the first CUDA error.

extern "C" int hbmc_trisolve_fused_f64(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       void* stream, int* launched) {
  return launch_steps<double, true>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_fused_f32(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       void* stream, int* launched) {
  return launch_steps<float, true>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, (cudaStream_t)stream, launched);
}

// segs is a host array of the nseg ascending segment starts (segs[0] ==
// 0); one launch per segment.
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
                                 int s, int r, int k, void* stream,
                                 int* launched) {
  return launch_steps<double, false>(
      (const int32_t*)cols, (const double*)vals, (const double*)dinv,
      (const double*)q, (double*)y, s, r, k, (cudaStream_t)stream, launched);
}

extern "C" int hbmc_trisolve_f32(const void* cols, const void* vals,
                                 const void* dinv, const void* q, void* y,
                                 int s, int r, int k, void* stream,
                                 int* launched) {
  return launch_steps<float, false>(
      (const int32_t*)cols, (const float*)vals, (const float*)dinv,
      (const float*)q, (float*)y, s, r, k, (cudaStream_t)stream, launched);
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
