// Fused forward+backward HBMC triangular sweep, z = (L L^T)^{-1} q, in
// round-major coordinates (the IC(0) apply of every PCG iteration).
//
// Replaces the Pallas kernel repro/kernels/hbmc_trisolve.py
// hbmc_trisolve_fused (body _fused_kernel).  There, one sequential TPU grid
// of 2S steps carried the round -> round dependency for free.  A CUDA grid
// runs its blocks in no order, so here each fused step g is one launch of
// fused_step over the R lanes of that round, and the kernel boundary is the
// round barrier (the paper's "one synchronization per color").  The host
// entry point issues the 2S launches on one stream.
//
// Bound on the card: bytes.  One apply reads the tables once (cols int32 +
// vals, 2S*R*K each, dinv 2S*R), q once and writes y (S*R); the gathers hit
// y, which is re-read from L2.  At S=32, R=32768, K=4 in f64 that is about
// 134 MB, 0.04 ms at 3.35 TB/s -- while 64 launches cost several us each,
// so launch overhead dominates this first design.  A persistent kernel with
// a grid-wide barrier per step is later work.
//
// Semantics kept from the reference:
//   * gather: an index c in [-m, 0) wraps, c outside [-m, m) reads 0 (the
//     jnp.take fill_value=0 rule; the packing uses c == m for holes);
//   * the product vals*y is rounded before it is summed, k = 0..K-1 in
//     order (no fused multiply-add), as the reference multiplies
//     elementwise and then sums;
//   * padding lanes (vals = 0, dinv = 0) are computed like any other, so a
//     NaN in y propagates exactly as in the reference;
//   * backward step g >= S writes slice 2S-1-g and takes as right-hand side
//     the y value the same thread overwrites, read before the store.  Lanes
//     of one round are independent: no two threads touch one y entry.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rounded_ops.cuh"

namespace {

template <typename T>
__global__ void fused_step(const int32_t* __restrict__ cols,
                           const T* __restrict__ vals,
                           const T* __restrict__ dinv,
                           const T* __restrict__ q, T* y, int g, int s,
                           int r, int k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= r) return;
  const int64_t m = (int64_t)s * r;
  const int64_t row = (int64_t)g * r + lane;
  const int32_t* c = cols + row * k;
  const T* v = vals + row * k;
  T acc = T(0);
  for (int j = 0; j < k; ++j) {
    int64_t cj = c[j];
    if (cj < 0) cj += m;
    // y is written by this kernel's earlier launches: plain loads, not the
    // read-only path
    const T yj = (cj >= 0 && cj < m) ? y[cj] : T(0);
    acc = add_rn(acc, mul_rn(v[j], yj));
  }
  const int64_t dest = (int64_t)(g < s ? g : 2 * s - 1 - g) * r + lane;
  const T q_cur = g < s ? q[(int64_t)g * r + lane] : y[dest];
  y[dest] = (q_cur - acc) * dinv[row];
}

template <typename T>
int launch_fused(const int32_t* cols, const T* vals, const T* dinv,
                 const T* q, T* y, int s, int r, int k, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  for (int g = 0; g < 2 * s; ++g) {
    fused_step<T><<<blocks, threads, 0, st>>>(cols, vals, dinv, q, y, g, s,
                                              r, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y must hold S*R zeros on entry; it holds z on return (stream-ordered).
extern "C" int hbmc_trisolve_fused_f64(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       void* stream) {
  return launch_fused<double>((const int32_t*)cols, (const double*)vals,
                              (const double*)dinv, (const double*)q,
                              (double*)y, s, r, k, (cudaStream_t)stream);
}

extern "C" int hbmc_trisolve_fused_f32(const void* cols, const void* vals,
                                       const void* dinv, const void* q,
                                       void* y, int s, int r, int k,
                                       void* stream) {
  return launch_fused<float>((const int32_t*)cols, (const float*)vals,
                             (const float*)dinv, (const float*)q,
                             (float*)y, s, r, k, (cudaStream_t)stream);
}
