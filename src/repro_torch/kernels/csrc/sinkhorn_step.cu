// Log-domain Sinkhorn half-steps for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of repro/kernels/sinkhorn_step.py:
//   row_kernel  <- _row_kernel / sinkhorn_row_update_pallas[_batched]
//   col_kernel  <- _col_kernel / sinkhorn_col_update_pallas[_batched]
//
//   row:  f_i = eps * (log mu_i - LSE_p((g_p - C_ip) / eps))
//   col:  g_p = eps * (log nu_p - LSE_i((f_i - C_ip) / eps))
//
// over B lanes of a row-major (M, N) cost, one eps per lane read from device
// memory (so one compiled kernel serves every annealing stage and no host
// sync is needed to pass it).
//
// Bound: the bytes of C read once per half-step; everything else is O(M+N).
// Design:
//   * The TPU kernels walk the reduction axis as a sequential grid dimension
//     with (max, sumexp) scratch in VMEM.  CUDA blocks run in no order, so
//     the reduction lives inside one block: the row kernel gives each output
//     row one block whose threads stride over the row's columns (coalesced),
//     each with an online (max, sumexp) pair, then merge through warp
//     shuffles and shared memory.  The column kernel gives each block 32
//     neighbouring columns (one warp-wide, coalesced 32-element segment of
//     every row) and splits the rows over blockDim.y threads, merging the
//     partial pairs in shared memory.  No transposed copy of C is read.
//   * The ragged edge is masked by the loop bounds: no +inf padded copy of C.
//   * (g - C) / eps is a true IEEE division, as in the reference; build
//     without --use_fast_math.
//   * Zero-mass atoms: a -inf z contributes nothing, a merge with a -inf
//     running max takes the other side unchanged, and an all -inf reduction
//     finishes at lse = -inf (never NaN), as _online_lse_update/_finish_lse.
//   * The cost may be bf16 while the duals are f32 or f64: each element is
//     widened with __bfloat162float before the arithmetic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float neg_inf() { return __int_as_float(0xff800000); }
  __device__ static float ex(float x) { return expf(x); }
  __device__ static float lg(float x) { return logf(x); }
};
template <> struct Num<double> {
  __device__ static double neg_inf() {
    return __longlong_as_double(0xfff0000000000000ULL);
  }
  __device__ static double ex(double x) { return exp(x); }
  __device__ static double lg(double x) { return log(x); }
};

template <typename T> __device__ __forceinline__ T widen(float v) { return (T)v; }
template <typename T> __device__ __forceinline__ T widen(double v) { return (T)v; }
template <typename T> __device__ __forceinline__ T widen(__nv_bfloat16 v) {
  return (T)__bfloat162float(v);
}

// One element of the online (max, sumexp) reduction.
template <typename T>
__device__ __forceinline__ void lse_add(T& m, T& s, T z) {
  if (z == Num<T>::neg_inf()) return;            // contributes exp(-inf) = 0
  if (z > m) {
    s = (m == Num<T>::neg_inf() ? T(0) : s * Num<T>::ex(m - z)) + T(1);
    m = z;
  } else {
    s += Num<T>::ex(z - m);
  }
}

// Merge a partial (m2, s2) into (m, s).
template <typename T>
__device__ __forceinline__ void lse_merge(T& m, T& s, T m2, T s2) {
  if (m2 == Num<T>::neg_inf()) return;
  if (m == Num<T>::neg_inf()) { m = m2; s = s2; return; }
  if (m2 > m) {
    s = s * Num<T>::ex(m - m2) + s2;
    m = m2;
  } else {
    s = s + s2 * Num<T>::ex(m2 - m);
  }
}

template <typename T>
__device__ __forceinline__ T lse_finish(T m, T s) {
  return m == Num<T>::neg_inf() ? m : m + Num<T>::lg(s);
}

constexpr int ROW_THREADS = 256;
constexpr int COL_WIDTH = 32;    // columns per block (one warp wide)
constexpr int COL_SPLIT = 16;    // row subsets per block

template <typename CT, typename T>
__global__ void __launch_bounds__(ROW_THREADS)
row_kernel(const CT* __restrict__ cost, const T* __restrict__ g,
           const T* __restrict__ log_mu, const T* __restrict__ eps,
           T* __restrict__ f, int m_rows, int n_cols) {
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const CT* row = cost + ((int64_t)b * m_rows + i) * n_cols;
  const T* gb = g + (int64_t)b * n_cols;
  const T e = eps[b];
  T m = Num<T>::neg_inf(), s = T(0);
  for (int p = threadIdx.x; p < n_cols; p += ROW_THREADS) {
    lse_add(m, s, (gb[p] - widen<T>(row[p])) / e);
  }
  for (int off = 16; off > 0; off >>= 1) {
    T m2 = __shfl_down_sync(0xffffffffu, m, off);
    T s2 = __shfl_down_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  __shared__ T sm[ROW_THREADS / 32], ss[ROW_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sm[warp] = m; ss[warp] = s; }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0]; s = ss[0];
    for (int w = 1; w < ROW_THREADS / 32; ++w) lse_merge(m, s, sm[w], ss[w]);
    const int64_t o = (int64_t)b * m_rows + i;
    f[o] = e * (log_mu[o] - lse_finish(m, s));
  }
}

template <typename CT, typename T>
__global__ void __launch_bounds__(COL_WIDTH * COL_SPLIT)
col_kernel(const CT* __restrict__ cost, const T* __restrict__ f,
           const T* __restrict__ log_nu, const T* __restrict__ eps,
           T* __restrict__ g, int m_rows, int n_cols) {
  const int p = blockIdx.x * COL_WIDTH + threadIdx.x;
  const int b = blockIdx.y;
  const CT* cb = cost + (int64_t)b * m_rows * n_cols;
  const T* fb = f + (int64_t)b * m_rows;
  const T e = eps[b];
  T m = Num<T>::neg_inf(), s = T(0);
  if (p < n_cols) {
    for (int i = threadIdx.y; i < m_rows; i += COL_SPLIT) {
      lse_add(m, s, (fb[i] - widen<T>(cb[(int64_t)i * n_cols + p])) / e);
    }
  }
  __shared__ T sm[COL_SPLIT][COL_WIDTH], ss[COL_SPLIT][COL_WIDTH];
  sm[threadIdx.y][threadIdx.x] = m;
  ss[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && p < n_cols) {
    for (int y = 1; y < COL_SPLIT; ++y)
      lse_merge(m, s, sm[y][threadIdx.x], ss[y][threadIdx.x]);
    const int64_t o = (int64_t)b * n_cols + p;
    g[o] = e * (log_nu[o] - lse_finish(m, s));
  }
}

template <typename CT, typename T>
int launch_row(const void* cost, const void* g, const void* log_mu,
               const void* eps, void* f, int lanes, int m_rows, int n_cols,
               void* stream) {
  row_kernel<CT, T><<<dim3(m_rows, lanes), ROW_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const CT*)cost, (const T*)g, (const T*)log_mu, (const T*)eps, (T*)f,
      m_rows, n_cols);
  return (int)cudaGetLastError();
}

template <typename CT, typename T>
int launch_col(const void* cost, const void* f, const void* log_nu,
               const void* eps, void* g, int lanes, int m_rows, int n_cols,
               void* stream) {
  dim3 grid((n_cols + COL_WIDTH - 1) / COL_WIDTH, lanes);
  col_kernel<CT, T><<<grid, dim3(COL_WIDTH, COL_SPLIT), 0,
                      (cudaStream_t)stream>>>(
      (const CT*)cost, (const T*)f, (const T*)log_nu, (const T*)eps, (T*)g,
      m_rows, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

#define SINKHORN_ENTRY(NAME, FN, CT, T)                                     \
  extern "C" int NAME(const void* cost, const void* v, const void* logw,    \
                      const void* eps, void* out, int lanes, int m_rows,    \
                      int n_cols, void* stream) {                           \
    return FN<CT, T>(cost, v, logw, eps, out, lanes, m_rows, n_cols,        \
                     stream);                                               \
  }

SINKHORN_ENTRY(sinkhorn_row_f32_f32, launch_row, float, float)
SINKHORN_ENTRY(sinkhorn_row_f64_f64, launch_row, double, double)
SINKHORN_ENTRY(sinkhorn_row_bf16_f32, launch_row, __nv_bfloat16, float)
SINKHORN_ENTRY(sinkhorn_row_bf16_f64, launch_row, __nv_bfloat16, double)
SINKHORN_ENTRY(sinkhorn_col_f32_f32, launch_col, float, float)
SINKHORN_ENTRY(sinkhorn_col_f64_f64, launch_col, double, double)
SINKHORN_ENTRY(sinkhorn_col_bf16_f32, launch_col, __nv_bfloat16, float)
SINKHORN_ENTRY(sinkhorn_col_bf16_f64, launch_col, __nv_bfloat16, double)
