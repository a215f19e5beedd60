// FGC moment recursion for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of repro/kernels/fgc_scan.py:
//   fgc_apply_l       <- _fgc_kernel / fgc_apply_l_pallas
//                        y = L x,  L[i,j] = (i-j)^p for i > j
//   fgc_apply_dtilde  <- _dtilde_kernel / fgc_apply_dtilde_pallas
//                        y = (L + L^T) x,  D~[i,j] = |i-j|^p
// along axis 0 of a row-major (N, B) array.
//
// Recursion (paper eq. 3.9): with a_i[s] = sum_{j<i} (i-j)^s x_j,
//   y_i = a_i[p],   a_{i+1}[r] = sum_{s<=r} C(r,s) a_i[s] + x_i.
// L^T x is the same recursion run from the last row up (L^T x = flip(L flip x)).
//
// Bound: the bytes of x read plus y written (p is small, so the (p+1)^2 / 2
// multiply-adds per element are far below the card's arithmetic rate).
// Design:
//   * The TPU kernels carry the (p+1)-moment state across a sequential grid
//     axis of 128-row blocks in VMEM scratch.  CUDA blocks run in no order,
//     so the whole sweep of one column lives in one thread: the state sits in
//     registers, and a warp's 32 threads read 32 neighbouring columns of the
//     same row (coalesced).  p is a template parameter (0..8), so the state
//     arrays stay in registers.
//   * D~ runs the forward stream (writes y = Lx) and then the mirrored stream
//     from the last row up (y += L^T x) in the same thread, so no second
//     output array exists and y = Lx + L^T x is added in the reference's order.
//     That reads x twice and y once more than the bound counts.
//   * The moment state is accumulated in double whatever the element type:
//     the recursion's rounding error grows with N (the state a[p] is a sum
//     of N terms of size up to N^p); in f32 at N = 8192 it moved the
//     solver's energy, whose three terms cancel, by ~6e-3 relative.
//     Hopper has f64, and the kernel is bound by bytes, not by the few
//     f64 multiply-adds per element.  y is rounded to T when stored.
//   * Ragged N and B need no padding: the loops stop at N, threads past B exit.
//   * Parallelism is one thread per column: a narrow x (B = 1, the
//     squared-distance apply of a measure) is one sequential thread.  Making
//     that fast (row segments with a carried state) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int binom(int n, int k) {
  return (k < 0 || k > n) ? 0 : (k == 0 || k == n) ? 1
                                : binom(n - 1, k - 1) + binom(n - 1, k);
}

constexpr int THREADS = 128;
constexpr int MAX_P = 8;

// One stream of the recursion over the rows of column `col`.  `reverse`
// walks from the last row up; `accumulate` adds into y instead of writing.
template <typename T, int P>
__device__ __forceinline__ void stream(const T* __restrict__ x,
                                       T* __restrict__ y, int n, int cols,
                                       int col, bool reverse,
                                       bool accumulate) {
  double a[P + 1];
#pragma unroll
  for (int s = 0; s <= P; ++s) a[s] = 0.0;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const int i = reverse ? n - 1 - k : k;
    const int64_t o = (int64_t)i * cols + col;
    const double xi = (double)x[o];
    const double yi = a[P];
    // update from the highest moment down: a[r] needs the old a[s], s <= r
#pragma unroll
    for (int r = P; r >= 0; --r) {
      double acc = 0.0;
#pragma unroll
      for (int s = 0; s <= r; ++s) acc += double(binom(r, s)) * a[s];
      a[r] = acc + xi;
    }
    y[o] = accumulate ? (T)((double)y[o] + yi) : (T)yi;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
fgc_kernel(const T* __restrict__ x, T* __restrict__ y, int n, int cols,
           bool dtilde) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= cols) return;
  stream<T, P>(x, y, n, cols, col, false, false);
  if (dtilde) stream<T, P>(x, y, n, cols, col, true, true);
}

template <typename T, int P>
int launch_p(const void* x, void* y, int n, int cols, bool dtilde,
             cudaStream_t st) {
  fgc_kernel<T, P><<<(cols + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const T*)x, (T*)y, n, cols, dtilde);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, int n, int cols, int p, bool dtilde,
           void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  switch (p) {
    case 0: return launch_p<T, 0>(x, y, n, cols, dtilde, st);
    case 1: return launch_p<T, 1>(x, y, n, cols, dtilde, st);
    case 2: return launch_p<T, 2>(x, y, n, cols, dtilde, st);
    case 3: return launch_p<T, 3>(x, y, n, cols, dtilde, st);
    case 4: return launch_p<T, 4>(x, y, n, cols, dtilde, st);
    case 5: return launch_p<T, 5>(x, y, n, cols, dtilde, st);
    case 6: return launch_p<T, 6>(x, y, n, cols, dtilde, st);
    case 7: return launch_p<T, 7>(x, y, n, cols, dtilde, st);
    case 8: return launch_p<T, 8>(x, y, n, cols, dtilde, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(MAX_P == 8, "the switch above covers p = 0..MAX_P");

}  // namespace

#define FGC_ENTRY(NAME, T, DTILDE)                                          \
  extern "C" int NAME(const void* x, void* y, int n, int cols, int p,       \
                      void* stream) {                                       \
    return launch<T>(x, y, n, cols, p, DTILDE, stream);                     \
  }

FGC_ENTRY(fgc_apply_l_f32, float, false)
FGC_ENTRY(fgc_apply_l_f64, double, false)
FGC_ENTRY(fgc_apply_dtilde_f32, float, true)
FGC_ENTRY(fgc_apply_dtilde_f64, double, true)
