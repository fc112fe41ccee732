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
// _sell_spmv_batched_kernel) computes Y = A X for X (n, B), row-major.
// Bound: bytes; at the 1M plan with B=8 in f64, vals + cols + X + Y is
// about 197 MB, 0.059 ms, and a plain device copy of the same bytes takes
// 0.068 ms (times on an H100 80GB HBM3 at 700 W).  What held the first
// body (one thread per (row, column), a runtime-K loop of dependent 8-byte
// cols -> x loads, 0.120 ms) was the loads in flight: on cols that point
// each row at itself (x read once, in order) it still took 0.109 ms.  So:
// - K is a template parameter up to MAX_UNROLL_K, fully unrolled: a thread
//   issues all K cols and vals loads, then all K gathers, then the sum.  A
//   larger K runs in unrolled chunks of MAX_UNROLL_K, k in order.
// - One thread per (row, group of 16 bytes of columns): the vector variant
//   loads and stores 16 bytes (double2, float4) where B is a multiple of
//   the group and X is 16-byte aligned; any other shape runs the scalar
//   variant (one column a thread) of the same body.
// - With the loads in flight, the gathers showed: a row's other-colour
//   neighbours sit half the vector away in the round-major order, so X
//   came from DRAM about twice.  The blocks therefore walk the two halves
//   of the rows side by side (block 2i takes chunk i of the first half,
//   block 2i+1 chunk i of the second), and both reads of an X row fall in
//   L2 at about the same time.  It only reorders blocks, so any plan is
//   right under it.
// Each column keeps the single-RHS arithmetic (from 0, k in order, rounded
// product then rounded add), so column j is bitwise the single-RHS kernel
// on column j.  Evict-first table loads, streaming stores, an L2
// persistence window on X, 128 threads a block and 4 or 8 columns a thread
// were measured and gave nothing (PERF.md section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int MAX_UNROLL_K = 8;

template <typename T, int N>
struct Cols {  // N consecutive columns of one row of X or Y
  T v[N];
};

// N columns from p: one 16-byte load when N * sizeof(T) == 16 (the caller
// guarantees the alignment), else N == 1
template <typename T, int N>
__device__ __forceinline__ Cols<T, N> load_cols(const T* p) {
  Cols<T, N> o;
  if constexpr (N == 1) {
    o.v[0] = __ldg(p);
  } else if constexpr (std::is_same_v<T, double>) {
    static_assert(N == 2, "16 bytes of double");
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    o.v[0] = t.x;
    o.v[1] = t.y;
  } else {
    static_assert(N == 4, "16 bytes of float");
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o.v[0] = t.x;
    o.v[1] = t.y;
    o.v[2] = t.z;
    o.v[3] = t.w;
  }
  return o;
}

template <typename T, int N>
__device__ __forceinline__ void store_cols(T* p, const Cols<T, N>& a) {
  if constexpr (N == 1) {
    *p = a.v[0];
  } else if constexpr (std::is_same_v<T, double>) {
    *reinterpret_cast<double2*>(p) = make_double2(a.v[0], a.v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                a.v[3]);
  }
}

// acc += the products vals * X[cols] of the KU entries at entry, entry +
// w, ..., summed k in order; an index in [-nx, 0) wraps, one outside
// [-nx, nx) reads 0
template <typename T, int N, int KU>
__device__ __forceinline__ void add_entries(Cols<T, N>& acc,
                                            const T* __restrict__ vals,
                                            const int32_t* __restrict__ cols,
                                            const T* __restrict__ xg,
                                            int64_t entry, int w, int64_t nx,
                                            int nb) {
  int32_t c[KU];
  T v[KU];
#pragma unroll
  for (int j = 0; j < KU; ++j) {
    c[j] = __ldg(cols + entry + (int64_t)j * w);
    v[j] = __ldg(vals + entry + (int64_t)j * w);
  }
  Cols<T, N> xs[KU];
#pragma unroll
  for (int j = 0; j < KU; ++j) {
    int64_t cj = c[j];
    if (cj < 0) cj += nx;
    if (cj >= 0 && cj < nx) {
      xs[j] = load_cols<T, N>(xg + cj * nb);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) xs[j].v[i] = T(0);
    }
  }
#pragma unroll
  for (int j = 0; j < KU; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc.v[i] = add_rn(acc.v[i], mul_rn(v[j], xs[j].v[i]));
}

// the last k % MAX_UNROLL_K entries of a row past the unroll limit
template <typename T, int N, int R = MAX_UNROLL_K - 1>
__device__ __forceinline__ void add_tail(Cols<T, N>& acc, int r,
                                         const T* __restrict__ vals,
                                         const int32_t* __restrict__ cols,
                                         const T* __restrict__ xg,
                                         int64_t entry, int w, int64_t nx,
                                         int nb) {
  if constexpr (R > 0) {
    if (r == R)
      add_entries<T, N, R>(acc, vals, cols, xg, entry, w, nx, nb);
    else
      add_tail<T, N, R - 1>(acc, r, vals, cols, xg, entry, w, nx, nb);
  }
}

// One thread per (row, N columns); KU = K (1..MAX_UNROLL_K) or 0 for K
// past the limit.  gridDim.x is even: block b takes chunk
// (b % 2) * gridDim.x / 2 + b / 2 of the rows' thread range.
template <typename T, int N, int KU>
__global__ void sell_spmv_batched_kernel(const T* __restrict__ vals,
                                         const int32_t* __restrict__ cols,
                                         const T* __restrict__ x,
                                         T* __restrict__ y, int64_t n_rows,
                                         int k, int w, int64_t nx, int nb) {
  const int64_t chunk =
      (int64_t)(blockIdx.x % 2) * (gridDim.x / 2) + blockIdx.x / 2;
  const int groups = nb / N;
  const int64_t t = chunk * blockDim.x + threadIdx.x;
  if (t >= n_rows * groups) return;
  const int64_t row = t / groups;
  const int col = (int)(t - row * groups) * N;
  const int64_t s = row / w;
  const int64_t entry = s * k * w + (row - s * w);
  const T* xg = x + col;
  Cols<T, N> acc;
#pragma unroll
  for (int i = 0; i < N; ++i) acc.v[i] = T(0);
  if constexpr (KU > 0) {
    add_entries<T, N, KU>(acc, vals, cols, xg, entry, w, nx, nb);
  } else {
    int j = 0;
    for (; j + MAX_UNROLL_K <= k; j += MAX_UNROLL_K)
      add_entries<T, N, MAX_UNROLL_K>(acc, vals, cols, xg,
                                      entry + (int64_t)j * w, w, nx, nb);
    add_tail<T, N>(acc, k - j, vals, cols, xg, entry + (int64_t)j * w, w,
                   nx, nb);
  }
  store_cols<T, N>(y + row * nb + col, acc);
}

template <typename T, int N, int KU = MAX_UNROLL_K>
const void* batched_kernel_for(int k_unrolled) {
  if constexpr (KU < 0) {
    return nullptr;
  } else {
    if (k_unrolled == KU)
      return (const void*)sell_spmv_batched_kernel<T, N, KU>;
    return batched_kernel_for<T, N, KU - 1>(k_unrolled);
  }
}

// The instantiation for (columns a thread, unrolled K), or null where there
// is none
template <typename T>
const void* batched_kernel(int cols_per_thread, int k_unrolled) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (k_unrolled < 0 || k_unrolled > MAX_UNROLL_K) return nullptr;
  if (cols_per_thread == 1) return batched_kernel_for<T, 1>(k_unrolled);
  if (cols_per_thread == VEC) return batched_kernel_for<T, VEC>(k_unrolled);
  return nullptr;
}

// Launch the variant the wrapper chose (kernels/sell_spmv.py
// batched_launch).  A variant this build lacks, an unrolled K other than k
// (0 stands for k = 0 or k > MAX_UNROLL_K), an odd or short grid, or a
// vector variant on a misaligned X or Y is refused (cudaErrorInvalidValue)
// and nothing is launched.
template <typename T>
int launch_spmv_batched(const T* vals, const int32_t* cols, const T* x,
                        T* y, int64_t n_slices, int k, int w, int64_t nx,
                        int nb, int cols_per_thread, int k_unrolled,
                        int64_t blocks, int threads, cudaStream_t st,
                        int* launched) {
  const void* fn = batched_kernel<T>(cols_per_thread, k_unrolled);
  const int64_t n_rows = n_slices * w;
  const bool unroll_ok =
      k_unrolled == 0 ? k == 0 || k > MAX_UNROLL_K : k_unrolled == k;
  const bool aligned = cols_per_thread == 1 ||
      (nb % cols_per_thread == 0 && (uintptr_t)x % 16 == 0 &&
       (uintptr_t)y % 16 == 0);
  if (fn == nullptr || !unroll_ok || !aligned || blocks % 2 != 0 ||
      threads <= 0 || blocks > 0x7fffffff ||
      blocks * threads < n_rows * (nb / cols_per_thread))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  void* args[] = {(void*)&vals, (void*)&cols, (void*)&x,  (void*)&y,
                  (void*)&n_rows, (void*)&k,  (void*)&w,  (void*)&nx,
                  (void*)&nb};
  cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(threads), args, 0, st);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

// Registers a thread of the instantiation, or -1 where there is none
template <typename T>
int batched_registers(int cols_per_thread, int k_unrolled) {
  const void* fn = batched_kernel<T>(cols_per_thread, k_unrolled);
  cudaFuncAttributes a;
  if (fn == nullptr || cudaFuncGetAttributes(&a, fn) != cudaSuccess)
    return -1;
  return a.numRegs;
}

template <typename T>
int launch_spmv(const T* vals, const int32_t* cols, const T* x, T* y,
                int64_t n_slices, int k, int w, int64_t nx,
                cudaStream_t st, int* launched) {
  const int64_t n_rows = n_slices * w;
  if (n_rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n_rows + threads - 1) / threads;
  sell_spmv_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      vals, cols, x, y, n_rows, k, w, nx);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // namespace

// Every entry point: *launched is incremented once per kernel launch issued;
// the return value is the CUDA error of the launch.

extern "C" int sell_spmv_f64(const void* vals, const void* cols,
                             const void* x, void* y, int64_t n_slices, int k,
                             int w, int64_t nx, void* stream,
                             int* launched) {
  return launch_spmv<double>((const double*)vals, (const int32_t*)cols,
                             (const double*)x, (double*)y, n_slices, k, w,
                             nx, (cudaStream_t)stream, launched);
}

extern "C" int sell_spmv_f32(const void* vals, const void* cols,
                             const void* x, void* y, int64_t n_slices, int k,
                             int w, int64_t nx, void* stream,
                             int* launched) {
  return launch_spmv<float>((const float*)vals, (const int32_t*)cols,
                            (const float*)x, (float*)y, n_slices, k, w, nx,
                            (cudaStream_t)stream, launched);
}

extern "C" int sell_spmv_batched_f64(const void* vals, const void* cols,
                                     const void* x, void* y,
                                     int64_t n_slices, int k, int w,
                                     int64_t nx, int nb, int cols_per_thread,
                                     int k_unrolled, int64_t blocks,
                                     int threads, void* stream,
                                     int* launched) {
  return launch_spmv_batched<double>(
      (const double*)vals, (const int32_t*)cols, (const double*)x,
      (double*)y, n_slices, k, w, nx, nb, cols_per_thread, k_unrolled,
      blocks, threads, (cudaStream_t)stream, launched);
}

extern "C" int sell_spmv_batched_f32(const void* vals, const void* cols,
                                     const void* x, void* y,
                                     int64_t n_slices, int k, int w,
                                     int64_t nx, int nb, int cols_per_thread,
                                     int k_unrolled, int64_t blocks,
                                     int threads, void* stream,
                                     int* launched) {
  return launch_spmv_batched<float>(
      (const float*)vals, (const int32_t*)cols, (const float*)x, (float*)y,
      n_slices, k, w, nx, nb, cols_per_thread, k_unrolled, blocks, threads,
      (cudaStream_t)stream, launched);
}

// Registers a thread of a batched variant (not a launch entry point)
extern "C" int sell_spmv_batched_registers(int element_bytes,
                                           int cols_per_thread,
                                           int k_unrolled) {
  if (element_bytes == 8)
    return batched_registers<double>(cols_per_thread, k_unrolled);
  if (element_bytes == 4)
    return batched_registers<float>(cols_per_thread, k_unrolled);
  return -1;
}
