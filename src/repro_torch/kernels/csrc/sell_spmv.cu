// SELL-w sparse matrix-vector product, y = A x (the SpMV of every PCG
// iteration).
//
// Replaces the Pallas kernel repro/kernels/sell_spmv.py sell_spmv (body
// _sell_spmv_kernel).  The TPU kernel tiled 256 slices per grid step to fit
// VMEM and padded the slice axis to that tile; nothing here needs the tile,
// so there is no slice padding.  One thread per output row (slice s, lane
// l) loops over the K entries of its row: for fixed (s, k) the w lanes of a
// slice are w consecutive values, so neighbouring threads load neighbouring
// addresses.
//
// Bound on the card: bytes.  Each call reads vals and cols (n_slices*K*w
// each) and x once and writes y (n_slices*w); at the 1M-unknown thermal2
// plan (131072 slices, K=5, w=8) in f64 that is about 80 MB, 0.024 ms at
// 3.35 TB/s.  The random gathers of x are served from L2 (x is 8 MB).
//
// Semantics kept from the reference: an index in [-n, 0) wraps and one
// outside [-n, n) reads 0 (jnp.take fill_value=0); the product is rounded
// before it is summed, k in order; padding entries (cols = 0, vals = 0) are
// multiplied like any other, so a NaN in x propagates as in the reference.
//
// The batched form (replaces sell_spmv_batched, body
// _sell_spmv_batched_kernel) computes Y = A X for X (n, B), row-major.  One
// thread per (row, column), the column fastest: the B threads of a row
// share each vals/cols load, and their gathers X[c*B + b] hit B contiguous
// values.  Each thread does the single-RHS arithmetic on its column, so
// column j is bitwise equal to the single-RHS kernel on column j.  Bound:
// bytes; at the 1M plan with B=8 in f64, vals + cols + X + Y is about
// 197 MB, 0.059 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rounded_ops.cuh"

namespace {

template <typename T>
__global__ void sell_spmv_kernel(const T* __restrict__ vals,
                                 const int32_t* __restrict__ cols,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int64_t n_rows, int k, int w, int64_t nx) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t s = row / w;
  const int64_t base = s * k * w + (row - s * w);
  T acc = T(0);
  for (int j = 0; j < k; ++j) {
    int64_t c = cols[base + (int64_t)j * w];
    if (c < 0) c += nx;
    const T xc = (c >= 0 && c < nx) ? x[c] : T(0);
    acc = add_rn(acc, mul_rn(vals[base + (int64_t)j * w], xc));
  }
  y[row] = acc;
}

template <typename T>
__global__ void sell_spmv_batched_kernel(const T* __restrict__ vals,
                                         const int32_t* __restrict__ cols,
                                         const T* __restrict__ x,
                                         T* __restrict__ y, int64_t n_rows,
                                         int k, int w, int64_t nx, int nb) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * nb) return;
  const int64_t row = t / nb;
  const int b = (int)(t - row * nb);
  const int64_t s = row / w;
  const int64_t base = s * k * w + (row - s * w);
  T acc = T(0);
  for (int j = 0; j < k; ++j) {
    int64_t c = cols[base + (int64_t)j * w];
    if (c < 0) c += nx;
    const T xc = (c >= 0 && c < nx) ? x[c * nb + b] : T(0);
    acc = add_rn(acc, mul_rn(vals[base + (int64_t)j * w], xc));
  }
  y[t] = acc;
}

template <typename T>
int launch_spmv_batched(const T* vals, const int32_t* cols, const T* x,
                        T* y, int64_t n_slices, int k, int w, int64_t nx,
                        int nb, cudaStream_t st) {
  const int64_t n = n_slices * w * nb;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  sell_spmv_batched_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      vals, cols, x, y, n_slices * w, k, w, nx, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spmv(const T* vals, const int32_t* cols, const T* x, T* y,
                int64_t n_slices, int k, int w, int64_t nx,
                cudaStream_t st) {
  const int64_t n_rows = n_slices * w;
  if (n_rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_rows + threads - 1) / threads;
  sell_spmv_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      vals, cols, x, y, n_rows, k, w, nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sell_spmv_f64(const void* vals, const void* cols,
                             const void* x, void* y, int64_t n_slices, int k,
                             int w, int64_t nx, void* stream) {
  return launch_spmv<double>((const double*)vals, (const int32_t*)cols,
                             (const double*)x, (double*)y, n_slices, k, w,
                             nx, (cudaStream_t)stream);
}

extern "C" int sell_spmv_f32(const void* vals, const void* cols,
                             const void* x, void* y, int64_t n_slices, int k,
                             int w, int64_t nx, void* stream) {
  return launch_spmv<float>((const float*)vals, (const int32_t*)cols,
                            (const float*)x, (float*)y, n_slices, k, w, nx,
                            (cudaStream_t)stream);
}

extern "C" int sell_spmv_batched_f64(const void* vals, const void* cols,
                                     const void* x, void* y,
                                     int64_t n_slices, int k, int w,
                                     int64_t nx, int nb, void* stream) {
  return launch_spmv_batched<double>(
      (const double*)vals, (const int32_t*)cols, (const double*)x,
      (double*)y, n_slices, k, w, nx, nb, (cudaStream_t)stream);
}

extern "C" int sell_spmv_batched_f32(const void* vals, const void* cols,
                                     const void* x, void* y,
                                     int64_t n_slices, int k, int w,
                                     int64_t nx, int nb, void* stream) {
  return launch_spmv_batched<float>(
      (const float*)vals, (const int32_t*)cols, (const float*)x, (float*)y,
      n_slices, k, w, nx, nb, (cudaStream_t)stream);
}
