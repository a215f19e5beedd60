// Factored-plan (low-rank coupling) kernels for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas kernels of repro/kernels/lr_step.py:
//   lr_dykstra_half_*  <- _dykstra_half_kernel / lr_dykstra_half_pallas[_batched]
//   lr_gram_chain_*    <- _gram_chain_kernel   / lr_gram_chain_pallas[_batched]
//   lr_grad_combine_*  <- _grad_combine_kernel / lr_grad_combine_pallas[_batched]
//
// Every entry point takes B lanes: (B, N, .) factors and (B, .) vectors.
//
// B5, one factor side of a Dykstra sweep, for an (N, r) log-kernel lk:
//   f_i   = log w_i - LSE_j(gcol_j + lk_ij)      (-inf on zero-mass rows)
//   col_j = LSE_i(f_i + lk_ij)                   (at the new f)
// Bound: the bytes of lk read once and f written once.  The row LSE runs
// over only r lanes, so a group of `width` <= 32 lanes of one warp takes a
// row and reduces it with shuffles (r need not be a power of two: lanes past
// r are masked by the loop bound).  The column LSE is a reduction over all
// N rows, which the TPU carries in scratch across its in-order grid; CUDA
// blocks run in no order, so each block writes one partial (max, sumexp)
// pair per rank column and a second kernel merges the partials of every
// column in a fixed order (no float atomics: a sweep is bit-for-bit
// repeatable, so early-stopping counts are equal run to run).
//
// B6, the factor Gram chain for D = A B^T and a factor Q:
//   bq = B^T Q (c, r), gram = Q^T (A bq) (r, r), sq = Q^T 1, tq = Q^T w.
// Bound: the bytes of B, Q, w and then A, Q (two passes: the Gram needs the
// finished bq, a grid-wide dependency).  Each pass streams tiles of rows
// through shared memory; a thread sums one tile's rows for each of its
// items (a chain of at most 64 terms) and adds that to the block's partial
// sum in registers (in f32 one 1024-long chain is several times less
// accurate than the plain version's blocked sums); a fixed-order reduction
// over the blocks finishes each pass.
// Pass 1 treats [B | 1 | w] as one (N, c+2) operand, so bq, sq and tq are
// one product.  Pass 2 forms U = A bq for the tile's rows in shared memory
// and accumulates Q^T U.  All products are FMA loops written here.
//
// B7, the gradient assembly:
//   out = (2 (d2 s^T + 1 t^T) - 4 A W) diag(iq),   W (c, r).
// Bound: the bytes of A and d2 read and of the (N, r) output written.  One
// thread per output element; W, s, t and iq live in shared memory.  The
// elementwise tail uses round-to-nearest intrinsics so that the compiler
// cannot contract d2*s + t into an FMA: the kernel and its plain version
// then differ only in how the c-long dot is summed.
//
// Zero-mass atoms: a -inf term contributes nothing to an online (max,
// sumexp) pair, a merge with a -inf partial keeps the other side, a row
// whose lanes are all -inf has lse = -inf, and a zero-mass row (log w =
// -inf) gives f = -inf: never exp(-inf - (-inf)) = NaN, as the reference's
// guards (repro/kernels/sinkhorn_step.py _online_lse_update/_finish_lse).
//
// lk may be bf16 under f32 or f64 duals: each element is widened with
// __bfloat162float, and every sum is taken in the duals' type.
// Each kernel launches on the caller's stream and allocates nothing: the
// wrapper passes outputs and scratch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ITEMS = 16;          // register accumulators a thread
constexpr int SMEM_BYTES = 48 * 1024;  // static limit without opt-in

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float neg_inf() { return __int_as_float(0xff800000); }
  __device__ static float ex(float x) { return expf(x); }
  __device__ static float lg(float x) { return logf(x); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Num<double> {
  __device__ static double neg_inf() {
    return __longlong_as_double(0xfff0000000000000ULL);
  }
  __device__ static double ex(double x) { return exp(x); }
  __device__ static double lg(double x) { return log(x); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
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

// ---------------------------------------------------------------------------
// B5: Dykstra half-sweep
// ---------------------------------------------------------------------------

// Rows [blk*block_rows, ...) of one lane: the row duals f, then one partial
// (max, sumexp) per rank column, written to part_[ms][(b*r + j)*nblk + blk].
// width: lanes per row group (a power of two, min(32, >= r));
// cwidth: columns per pass of the column phase (a power of two, <= THREADS).
template <typename LT, typename T>
__global__ void __launch_bounds__(THREADS)
dykstra_rows(const LT* __restrict__ lk, const T* __restrict__ gcol,
             const T* __restrict__ logw, T* __restrict__ f,
             T* __restrict__ part_m, T* __restrict__ part_s, int n, int r,
             int block_rows, int width, int cwidth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* f_s = reinterpret_cast<T*>(smem_raw);       // block_rows
  T* m_s = f_s + block_rows;                     // THREADS
  T* s_s = m_s + THREADS;                        // THREADS
  const T NEG = Num<T>::neg_inf();
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int row0 = blk * block_rows;
  const int rows = min(block_rows, n - row0);
  const int64_t base = (int64_t)b * n + row0;
  const LT* lkb = lk + base * r;
  const T* gb = gcol + (int64_t)b * r;

  // row phase: a group of `width` lanes per row; every lane of a warp runs
  // the same number of iterations, so the shuffles never diverge
  const int lig = threadIdx.x % width;
  const int grp = threadIdx.x / width;
  const int ngrp = THREADS / width;
  for (int i0 = 0; i0 < rows; i0 += ngrp) {
    const int i = i0 + grp;
    const bool live = i < rows;
    T mx = NEG;
    if (live) {
      for (int j = lig; j < r; j += width) {
        const T z = gb[j] + widen<T>(lkb[(int64_t)i * r + j]);
        mx = z > mx ? z : mx;
      }
    }
    for (int off = width / 2; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, mx, off, width);
      mx = o > mx ? o : mx;
    }
    const bool fin = isfinite(mx);
    T sm = T(0);
    if (live && fin) {
      for (int j = lig; j < r; j += width)
        sm += Num<T>::ex(gb[j] + widen<T>(lkb[(int64_t)i * r + j]) - mx);
    }
    for (int off = width / 2; off > 0; off >>= 1)
      sm += __shfl_xor_sync(0xffffffffu, sm, off, width);
    if (live && lig == 0) {
      const T lse = fin ? mx + Num<T>::lg(sm) : NEG;
      const T lw = logw[base + i];
      const T fi = lw > NEG ? lw - lse : NEG;
      f[base + i] = fi;
      f_s[i] = fi;
    }
  }
  __syncthreads();

  // column phase at the new f: cwidth columns a pass, the block's rows
  // split over THREADS / cwidth subsets, merged in a fixed order
  const int jj = threadIdx.x % cwidth;
  const int sub = threadIdx.x / cwidth;
  const int nsub = THREADS / cwidth;
  for (int j0 = 0; j0 < r; j0 += cwidth) {
    const int j = j0 + jj;
    T m = NEG, s = T(0);
    if (j < r) {
      for (int i = sub; i < rows; i += nsub)
        lse_add(m, s, f_s[i] + widen<T>(lkb[(int64_t)i * r + j]));
    }
    m_s[threadIdx.x] = m;
    s_s[threadIdx.x] = s;
    __syncthreads();
    if (sub == 0 && j < r) {
      for (int k = 1; k < nsub; ++k)
        lse_merge(m, s, m_s[k * cwidth + jj], s_s[k * cwidth + jj]);
      const int64_t o = ((int64_t)b * r + j) * nblk + blk;
      part_m[o] = m;
      part_s[o] = s;
    }
    __syncthreads();
  }
}

// col[b, j] = LSE over the nblk partials of column j, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dykstra_cols(const T* __restrict__ part_m, const T* __restrict__ part_s,
             T* __restrict__ col, int r, int nblk) {
  __shared__ T m_s[THREADS], s_s[THREADS];
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t o = ((int64_t)b * r + j) * nblk;
  T m = Num<T>::neg_inf(), s = T(0);
  for (int k = threadIdx.x; k < nblk; k += THREADS)
    lse_merge(m, s, part_m[o + k], part_s[o + k]);
  m_s[threadIdx.x] = m;
  s_s[threadIdx.x] = s;
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) {
      T mm = m_s[threadIdx.x], ss = s_s[threadIdx.x];
      lse_merge(mm, ss, m_s[threadIdx.x + stride], s_s[threadIdx.x + stride]);
      m_s[threadIdx.x] = mm;
      s_s[threadIdx.x] = ss;
    }
  }
  if (threadIdx.x == 0) col[(int64_t)b * r + j] = lse_finish(m_s[0], s_s[0]);
}

int pow2_at_least(int v, int cap) {
  int w = 1;
  while (w < v && w < cap) w <<= 1;
  return w;
}

template <typename LT, typename T>
int launch_dykstra(const void* lk, const void* gcol, const void* logw,
                   void* f, void* col, void* part_m, void* part_s, int lanes,
                   int n, int r, int block_rows, void* stream) {
  const int nblk = (n + block_rows - 1) / block_rows;
  const size_t smem = (size_t)(block_rows + 2 * THREADS) * sizeof(T);
  if (smem > (size_t)SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dykstra_rows<LT, T><<<dim3(nblk, lanes), THREADS, smem, st>>>(
      (const LT*)lk, (const T*)gcol, (const T*)logw, (T*)f, (T*)part_m,
      (T*)part_s, n, r, block_rows, pow2_at_least(r, 32),
      pow2_at_least(r, THREADS));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dykstra_cols<T><<<dim3(r, lanes), THREADS, 0, st>>>(
      (const T*)part_m, (const T*)part_s, (T*)col, r, nblk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6: factor Gram chain
// ---------------------------------------------------------------------------

// Rows of a tile that fit `cols` values a row in the shared-memory budget.
template <typename T>
int tile_rows(int cols) {
  const int tr = SMEM_BYTES / (int)(sizeof(T) * cols);
  return tr < 64 ? tr : 64;
}

// Pass 1: part[(b*items + k*r + j)*nblk + blk] = sum over the block's rows
// of X[i,k] Q[i,j], with X = [B | 1 | w] (items = (c+2)*r).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_pass1(const T* __restrict__ bmat, const T* __restrict__ q,
           const T* __restrict__ w, T* __restrict__ part, int n, int c,
           int r, int block_rows, int tr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int na = c + 2;
  T* xs = reinterpret_cast<T*>(smem_raw);        // tr x na
  T* qs = xs + tr * na;                          // tr x r
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int row0 = blk * block_rows;
  const int rows = min(block_rows, n - row0);
  const int64_t base = (int64_t)b * n + row0;
  const int items = na * r;
  for (int it0 = 0; it0 < items; it0 += THREADS * MAX_ITEMS) {
    T acc[MAX_ITEMS];
#pragma unroll
    for (int u = 0; u < MAX_ITEMS; ++u) acc[u] = T(0);
    for (int t0 = 0; t0 < rows; t0 += tr) {
      const int tn = min(tr, rows - t0);
      __syncthreads();                           // the last tile is consumed
      for (int idx = threadIdx.x; idx < tn * na; idx += THREADS) {
        const int i = idx / na, k = idx % na;
        const int64_t gi = base + t0 + i;
        xs[idx] = k < c ? bmat[gi * c + k] : (k == c ? T(1) : w[gi]);
      }
      for (int idx = threadIdx.x; idx < tn * r; idx += THREADS)
        qs[idx] = q[(base + t0) * r + idx];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < MAX_ITEMS; ++u) {
        const int item = it0 + threadIdx.x + u * THREADS;
        if (item < items) {
          const int k = item / r, j = item % r;
          T a = T(0);
          for (int i = 0; i < tn; ++i) a = fma(xs[i * na + k], qs[i * r + j], a);
          acc[u] += a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAX_ITEMS; ++u) {
      const int item = it0 + threadIdx.x + u * THREADS;
      if (item < items) part[((int64_t)b * items + item) * nblk + blk] = acc[u];
    }
  }
}

// Pass 2: part[(b*r*r + j*r + l)*nblk + blk] = sum over the block's rows of
// Q[i,j] U[i,l], with U = A bq formed for the tile's rows in shared memory;
// bq is the first c rows of the lane's (c+2, r) pass-1 result.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_pass2(const T* __restrict__ amat, const T* __restrict__ q,
           const T* __restrict__ ext, T* __restrict__ part, int n, int c,
           int r, int block_rows, int tr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // tr x r
  T* us = qs + tr * r;                           // tr x r
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int row0 = blk * block_rows;
  const int rows = min(block_rows, n - row0);
  const int64_t base = (int64_t)b * n + row0;
  const T* bq = ext + (int64_t)b * (c + 2) * r;
  const int items = r * r;
  for (int it0 = 0; it0 < items; it0 += THREADS * MAX_ITEMS) {
    T acc[MAX_ITEMS];
#pragma unroll
    for (int u = 0; u < MAX_ITEMS; ++u) acc[u] = T(0);
    for (int t0 = 0; t0 < rows; t0 += tr) {
      const int tn = min(tr, rows - t0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < tn * r; idx += THREADS) {
        const int i = idx / r, l = idx % r;
        const T* ai = amat + (base + t0 + i) * c;
        T uu = T(0);
        for (int k = 0; k < c; ++k) uu = fma(ai[k], bq[k * r + l], uu);
        us[idx] = uu;
        qs[idx] = q[(base + t0) * r + idx];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < MAX_ITEMS; ++u) {
        const int item = it0 + threadIdx.x + u * THREADS;
        if (item < items) {
          const int j = item / r, l = item % r;
          T a = T(0);
          for (int i = 0; i < tn; ++i) a = fma(qs[i * r + j], us[i * r + l], a);
          acc[u] += a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MAX_ITEMS; ++u) {
      const int item = it0 + threadIdx.x + u * THREADS;
      if (item < items) part[((int64_t)b * items + item) * nblk + blk] = acc[u];
    }
  }
}

// out[b*items + item] = sum over the nblk partials, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sum_blocks(const T* __restrict__ part, T* __restrict__ out, int items,
           int nblk) {
  __shared__ T s_s[THREADS];
  const int64_t o = (int64_t)blockIdx.y * items + blockIdx.x;
  T s = T(0);
  for (int k = threadIdx.x; k < nblk; k += THREADS) s += part[o * nblk + k];
  s_s[threadIdx.x] = s;
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) s_s[threadIdx.x] += s_s[threadIdx.x + stride];
  }
  if (threadIdx.x == 0) out[o] = s_s[0];
}

template <typename T>
int launch_gram(const void* a, const void* bm, const void* q, const void* w,
                void* ext, void* gram, void* part1, void* part2, int lanes,
                int n, int c, int r, int block_rows, void* stream) {
  const int nblk = (n + block_rows - 1) / block_rows;
  const int tr1 = tile_rows<T>(c + 2 + r);
  const int tr2 = tile_rows<T>(2 * r);
  if (tr1 < 1 || tr2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gram_pass1<T><<<dim3(nblk, lanes), THREADS,
                  (size_t)tr1 * (c + 2 + r) * sizeof(T), st>>>(
      (const T*)bm, (const T*)q, (const T*)w, (T*)part1, n, c, r, block_rows,
      tr1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_blocks<T><<<dim3((c + 2) * r, lanes), THREADS, 0, st>>>(
      (const T*)part1, (T*)ext, (c + 2) * r, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_pass2<T><<<dim3(nblk, lanes), THREADS,
                  (size_t)tr2 * 2 * r * sizeof(T), st>>>(
      (const T*)a, (const T*)q, (const T*)ext, (T*)part2, n, c, r, block_rows,
      tr2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_blocks<T><<<dim3(r * r, lanes), THREADS, 0, st>>>(
      (const T*)part2, (T*)gram, r * r, nblk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B7: gradient assembly
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_combine(const T* __restrict__ amat, const T* __restrict__ wm,
             const T* __restrict__ d2, const T* __restrict__ sv,
             const T* __restrict__ tv, const T* __restrict__ iq,
             T* __restrict__ out, int n, int c, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);       // c x r
  T* s_s = w_s + c * r;
  T* t_s = s_s + r;
  T* iq_s = t_s + r;
  const int b = blockIdx.y;
  for (int idx = threadIdx.x; idx < c * r; idx += THREADS)
    w_s[idx] = wm[(int64_t)b * c * r + idx];
  for (int j = threadIdx.x; j < r; j += THREADS) {
    s_s[j] = sv[(int64_t)b * r + j];
    t_s[j] = tv[(int64_t)b * r + j];
    iq_s[j] = iq[(int64_t)b * r + j];
  }
  __syncthreads();
  const int64_t total = (int64_t)n * r;
  const T* ab = amat + (int64_t)b * n * c;
  const T* db = d2 + (int64_t)b * n;
  T* ob = out + (int64_t)b * total;
  for (int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * THREADS) {
    const int64_t i = idx / r;
    const int j = (int)(idx % r);
    const T* ai = ab + i * c;
    T quad = T(0);
    for (int k = 0; k < c; ++k) quad = fma(ai[k], w_s[k * r + j], quad);
    const T lin = Num<T>::add(Num<T>::mul(db[i], s_s[j]), t_s[j]);
    ob[idx] = Num<T>::mul(Num<T>::sub(Num<T>::mul(T(2), lin),
                                      Num<T>::mul(T(4), quad)),
                          iq_s[j]);
  }
}

template <typename T>
int launch_combine(const void* a, const void* wm, const void* d2,
                   const void* sv, const void* tv, const void* iq, void* out,
                   int lanes, int n, int c, int r, void* stream) {
  const size_t smem = (size_t)(c + 3) * r * sizeof(T);
  if (smem > (size_t)SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)n * r;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  grad_combine<T><<<dim3((unsigned)blocks, lanes), THREADS, smem,
                    (cudaStream_t)stream>>>(
      (const T*)a, (const T*)wm, (const T*)d2, (const T*)sv, (const T*)tv,
      (const T*)iq, (T*)out, n, c, r);
  return (int)cudaGetLastError();
}

}  // namespace

#define DYKSTRA_ENTRY(NAME, LT, T)                                           \
  extern "C" int NAME(const void* lk, const void* gcol, const void* logw,    \
                      void* f, void* col, void* part_m, void* part_s,        \
                      int lanes, int n, int r, int block_rows,               \
                      void* stream) {                                        \
    return launch_dykstra<LT, T>(lk, gcol, logw, f, col, part_m, part_s,     \
                                 lanes, n, r, block_rows, stream);           \
  }

DYKSTRA_ENTRY(lr_dykstra_half_f32_f32, float, float)
DYKSTRA_ENTRY(lr_dykstra_half_f64_f64, double, double)
DYKSTRA_ENTRY(lr_dykstra_half_bf16_f32, __nv_bfloat16, float)
DYKSTRA_ENTRY(lr_dykstra_half_bf16_f64, __nv_bfloat16, double)

#define GRAM_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* a, const void* b, const void* q,           \
                      const void* w, void* ext, void* gram, void* part1,     \
                      void* part2, int lanes, int n, int c, int r,           \
                      int block_rows, void* stream) {                        \
    return launch_gram<T>(a, b, q, w, ext, gram, part1, part2, lanes, n, c,  \
                          r, block_rows, stream);                            \
  }

GRAM_ENTRY(lr_gram_chain_f32, float)
GRAM_ENTRY(lr_gram_chain_f64, double)

#define COMBINE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* a, const void* wm, const void* d2,         \
                      const void* sv, const void* tv, const void* iq,        \
                      void* out, int lanes, int n, int c, int r,             \
                      void* stream) {                                        \
    return launch_combine<T>(a, wm, d2, sv, tv, iq, out, lanes, n, c, r,     \
                             stream);                                        \
  }

COMBINE_ENTRY(lr_grad_combine_f32, float)
COMBINE_ENTRY(lr_grad_combine_f64, double)
