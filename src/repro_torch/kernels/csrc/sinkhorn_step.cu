// Log-domain Sinkhorn half-steps for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of repro/kernels/sinkhorn_step.py:
//   row_kernel              <- _row_kernel / sinkhorn_row_update_pallas[_batched]
//   col_kernel + col_finish <- _col_kernel / sinkhorn_col_update_pallas[_batched]
//
//   row:  f_i = eps * (log mu_i - LSE_p((g_p - C_ip) / eps))
//   col:  g_p = eps * (log nu_p - LSE_i((f_i - C_ip) / eps))
//
// over B lanes of a row-major (M, N) cost, one eps per lane read from device
// memory (so one compiled kernel serves every annealing stage and no host
// sync is needed to pass it).
//
// What bounds them: the bytes of C, read once, against the issue of one IEEE
// division and one exp an element.  f32 issues just above its bytes bound;
// f64 spends ~34 FP64 operations an element (tools/sass_mix.py) and is
// issue-bound well above it, and only as fast as its loads overlap its
// arithmetic.  The design:
//   * Register-tiled LSE, the reference's _online_lse_update at register
//     scale: a thread holds a tile of values, takes the tile's max, rescales
//     its running sum once per tile (only when the max rises: exp(0) = 1
//     exactly, so the skip changes no bit) and adds the tile's exponentials
//     summed as a pairwise tree.  Independent division/exp chains, no branch
//     per element.  The -inf guards act per tile: a tile whose max is -inf
//     adds nothing, and a -inf running max rescales to 0.
//   * C in flight without registers: each thread copies its own 16-byte
//     vectors of the next tile into shared memory with cp.async while it
//     folds the current one (STAGES-deep ring, [stage][vector][thread], so
//     copies and reads are conflict-free).  Prefetching into registers
//     instead cost a block of occupancy and was slower in every dtype.
//   * B1: one warp per row, ROW_WARPS rows a block; the block stages each
//     segment of g in shared memory once, in the same copy groups, so g is
//     read once per ROW_WARPS rows.  A row's lane partials merge by warp
//     shuffles in a fixed tree.
//   * B2: a thread owns VEC adjacent columns (one 16-byte vector a row; a
//     warp reads 512 contiguous bytes) and f_i is one broadcast from shared
//     memory a row.  M is split over blocks (the wrapper picks the split so
//     the grid fills the card at least twice); a block's COL_WARPS warps take
//     interleaved tiles of its rows, merge in shared memory in warp order and
//     write one (max, sumexp) partial per column to scratch; col_finish
//     merges the splits in split order and finishes g.  Two launches, one C
//     entry point.
//   * Rows that are not 16-byte aligned (N * sizeof(C) not a multiple of 16,
//     or an offset base pointer) take the scalar-load instantiation of the
//     same kernel: the same tiles in the same order, loaded without the
//     ring, so the result does not depend on the alignment.
//   * Every merge runs in a fixed order and nothing is atomic: two launches
//     on the same inputs give the same bits.
//   * The ragged edge is masked in the tile (z = -inf); no padded copy of C.
//   * (g - C) / eps is a true IEEE division and exp is the accurate one, as
//     in the reference; build without --use_fast_math.
//   * The cost may be bf16 while the duals are f32 or f64: each element is
//     widened exactly (bf16 -> f32 is a 16-bit shift) before the arithmetic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int ROW_WARPS = THREADS / WARP;   // B1: rows a block, one warp each
constexpr int COL_WARPS = THREADS / WARP;   // B2: row groups of a block
constexpr int FINISH_THREADS = 256;

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

// One 16-byte vector of the cost: VEC elements, widened to the duals' type.
template <typename CT> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int VEC = 4;
  template <typename T>
  __device__ static void unpack(uint4 r, T (&o)[VEC]) {
    o[0] = (T)__uint_as_float(r.x);
    o[1] = (T)__uint_as_float(r.y);
    o[2] = (T)__uint_as_float(r.z);
    o[3] = (T)__uint_as_float(r.w);
  }
  template <typename T>
  __device__ static T one(const float* p) { return (T)*p; }
};
template <> struct Vec16<double> {
  static constexpr int VEC = 2;
  template <typename T>
  __device__ static void unpack(uint4 r, T (&o)[VEC]) {
    o[0] = (T)__hiloint2double((int)r.y, (int)r.x);
    o[1] = (T)__hiloint2double((int)r.w, (int)r.z);
  }
  template <typename T>
  __device__ static T one(const double* p) { return (T)*p; }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // bf16 is the top half of an f32: widening is exact
  __device__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ static float hi(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  template <typename T>
  __device__ static void unpack(uint4 r, T (&o)[VEC]) {
    o[0] = (T)lo(r.x); o[1] = (T)hi(r.x);
    o[2] = (T)lo(r.y); o[3] = (T)hi(r.y);
    o[4] = (T)lo(r.z); o[5] = (T)hi(r.z);
    o[6] = (T)lo(r.w); o[7] = (T)hi(r.w);
  }
  template <typename T>
  __device__ static T one(const __nv_bfloat16* p) {
    return (T)__bfloat162float(*p);
  }
};

// The VEC elements of C at p, widened, by scalar loads (rows that are not
// 16-byte aligned); `valid` of them lie inside the row, the others are 0
// and are masked by the caller.
template <typename CT, typename T>
__device__ __forceinline__ void load_scalar(const CT* p, int valid,
                                            T (&o)[Vec16<CT>::VEC]) {
#pragma unroll
  for (int v = 0; v < Vec16<CT>::VEC; ++v)
    o[v] = v < valid ? Vec16<CT>::template one<T>(p + v) : T(0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// z[0] <- the pairwise sum of z[0..2W) (W a power of two).
template <int W, typename T, int K>
__device__ __forceinline__ void tree_sum(T (&z)[K]) {
  if constexpr (W > 0) {
#pragma unroll
    for (int k = 0; k < W; ++k) z[k] += z[k + W];
    tree_sum<W / 2>(z);
  }
}

template <int W, typename T, int K>
__device__ __forceinline__ void tree_max(T (&z)[K]) {
  if constexpr (W > 0) {
#pragma unroll
    for (int k = 0; k < W; ++k) z[k] = fmax(z[k], z[k + W]);
    tree_max<W / 2>(z);
  }
}

// One register tile of the online (max, sumexp) reduction: the reference's
// _online_lse_update with the tile held by one thread.  z is consumed.
template <typename T, int K>
__device__ __forceinline__ void tile_add(T& m, T& s, T (&z)[K]) {
  T t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = z[k];
  tree_max<K / 2>(t);
  const T zmax = t[0];
  if (zmax == Num<T>::neg_inf()) return;      // an all -inf tile adds 0
  if (zmax > m) {                             // exp(m - m) = 1: skip it
    if (m != Num<T>::neg_inf()) s *= Num<T>::ex(m - zmax);   // else s = 0
    m = zmax;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) z[k] = Num<T>::ex(z[k] - m);
  tree_sum<K / 2>(z);
  s += z[0];
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

// Tile sizes.  A thread's share of a B1 segment is K = 16 dual values in U
// 16-byte loads of VEC cost elements, folded FOLD values at a time; a B2
// tile is UC rows of VEC columns, 128 bytes of duals.  f32 duals fold the
// whole segment, whose ring then leaves room for four blocks an SM (a 128-
// byte segment left room for three, and was slower).  f64 duals fold 8
// values and tile half the rows (at least 2): their division and exp
// chains hold twice the registers, and 16 of them at once cost a block of
// occupancy.
template <typename CT, typename T> struct Tile {
  static constexpr int VEC = Vec16<CT>::VEC;
  static constexpr bool WIDE = sizeof(T) == 8;
  static constexpr int K = 16 > VEC ? 16 : VEC;
  static constexpr int U = K / VEC;
  static constexpr int FOLD = WIDE && K / 2 >= VEC ? K / 2 : K;
  static constexpr int U128 = 128 / (int)sizeof(T) / VEC;
  static constexpr int UC = WIDE && U128 > 2 ? U128 / 2 : U128;
};

// Copy groups in flight: while a thread folds one tile, the copies of the
// next STAGES - 1 tiles are on their way into shared memory, so C is in
// flight without holding registers.
constexpr int STAGES = 2;

// B1: g in segments of SEG = WARP * K elements (2 or 4 KB) shared by the
// block's rows, and each thread's own U 16-byte vectors of C a segment, laid
// out [stage][u][thread] so that copies and reads are conflict-free.
template <typename CT, typename T>
constexpr size_t row_smem_bytes(bool aligned) {
  using TL = Tile<CT, T>;
  return STAGES * (WARP * TL::K * sizeof(T) +
                   (aligned ? TL::U * THREADS * sizeof(uint4) : 0));
}

// Issue the copies of segment sg: its g (every thread a share) and, when
// rows are aligned, this thread's vectors of C.  The caller commits.
template <typename CT, typename T, bool ALIGNED>
__device__ __forceinline__ void row_issue(int sg, bool active, const CT* row,
                                          const T* gb, T* gs, uint4* cr,
                                          int n, int lane) {
  using TL = Tile<CT, T>;
  constexpr int VEC = TL::VEC, U = TL::U, SEG = WARP * TL::K;
  const int base = sg * SEG, slot = sg % STAGES;
  T* gdst = gs + slot * SEG;
  if (ALIGNED) {
    constexpr int PER = 16 / (int)sizeof(T);
    for (int q = threadIdx.x * PER; q < SEG; q += THREADS * PER)
      if (base + q < n) cp_async16(gdst + q, gb + base + q);
    if (active) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + (u * WARP + lane) * VEC;
        if (p < n)
          cp_async16(cr + (slot * U + u) * THREADS + threadIdx.x, row + p);
      }
    }
  } else {
    for (int q = threadIdx.x; q < SEG; q += THREADS)
      if (base + q < n) cp_async_small<sizeof(T)>(gdst + q, gb + base + q);
  }
}

template <typename CT, typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
row_kernel(const CT* __restrict__ cost, const T* __restrict__ g,
           const T* __restrict__ log_mu, const T* __restrict__ eps,
           T* __restrict__ f, int m_rows, int n_cols) {
  using TL = Tile<CT, T>;
  constexpr int VEC = TL::VEC, K = TL::K, U = TL::U, FOLD = TL::FOLD;
  constexpr int SEG = WARP * K;
  extern __shared__ uint4 smem[];
  T* gs = reinterpret_cast<T*>(smem);                  // [STAGES][SEG]
  uint4* cr = smem + STAGES * SEG * sizeof(T) / sizeof(uint4);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int b = blockIdx.y;
  const int i = blockIdx.x * ROW_WARPS + warp;
  const bool active = i < m_rows;
  const CT* row = cost + ((int64_t)b * m_rows + (active ? i : 0)) * n_cols;
  const T* gb = g + (int64_t)b * n_cols;
  const T e = eps[b];
  const int nseg = (n_cols + SEG - 1) / SEG;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nseg)
      row_issue<CT, T, ALIGNED>(k, active, row, gb, gs, cr, n_cols, lane);
    cp_async_commit();
  }
  T m = Num<T>::neg_inf(), s = T(0);
  for (int sg = 0; sg < nseg; ++sg) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // segment sg is in; every warp is done with sg - 1
    if (sg + STAGES - 1 < nseg)
      row_issue<CT, T, ALIGNED>(sg + STAGES - 1, active, row, gb, gs, cr,
                                n_cols, lane);
    cp_async_commit();
    if (!active) continue;
    const int base = sg * SEG, slot = sg % STAGES;
    const T* gseg = gs + slot * SEG;
#pragma unroll
    for (int h = 0; h < K / FOLD; ++h) {
      T z[FOLD];
#pragma unroll
      for (int uu = 0; uu < FOLD / VEC; ++uu) {
        const int u = h * (FOLD / VEC) + uu;
        const int p = base + (u * WARP + lane) * VEC;
        T c[VEC];
        if (ALIGNED) {
          if (p < n_cols) {
            Vec16<CT>::unpack(cr[(slot * U + u) * THREADS + threadIdx.x], c);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) c[v] = T(0);
          }
        } else {
          load_scalar<CT, T>(row + p, n_cols - p, c);
        }
        // aligned rows mask whole vectors, the scalar loads each element
        const int q0 = (u * WARP + lane) * VEC;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const T zq = (gseg[q0 + v] - c[v]) / e;
          const bool in = ALIGNED ? p < n_cols : p + v < n_cols;
          z[uu * VEC + v] = in ? zq : Num<T>::neg_inf();
        }
      }
      tile_add(m, s, z);
    }
  }
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const T m2 = __shfl_down_sync(0xffffffffu, m, off);
    const T s2 = __shfl_down_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  if (active && lane == 0) {
    const int64_t o = (int64_t)b * m_rows + i;
    f[o] = e * (log_mu[o] - lse_finish(m, s));
  }
}

// B2: each warp's f for its tiles, [stage][warp][U], then (aligned rows)
// each thread's U vectors of C a tile, [stage][u][thread], then the block's
// merge arrays.
template <typename CT, typename T>
constexpr size_t col_smem_bytes(bool aligned) {
  using TL = Tile<CT, T>;
  return STAGES * COL_WARPS * TL::UC * sizeof(T) +
         (aligned ? STAGES * TL::UC * THREADS * sizeof(uint4) : 0) +
         2 * COL_WARPS * WARP * TL::VEC * sizeof(T);
}

// Issue the copies of this warp's tile t (rows i0 .. i0 + U): lane u < U
// copies f[i0 + u], and with aligned rows every lane its U vectors of C.
template <typename CT, typename T, bool ALIGNED>
__device__ __forceinline__ void col_issue(int t, int i0, int r1,
                                          const CT* cb, const T* fb, T* fr,
                                          uint4* cr, int n, int p0, int warp,
                                          int lane) {
  using TL = Tile<CT, T>;
  constexpr int U = TL::UC;
  const int slot = t % STAGES;
  if (lane < U && i0 + lane < r1)
    cp_async_small<sizeof(T)>(fr + (slot * COL_WARPS + warp) * U + lane,
                              fb + i0 + lane);
  if (ALIGNED && p0 < n) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u < r1)
        cp_async16(cr + (slot * U + u) * THREADS + threadIdx.x,
                   cb + (int64_t)(i0 + u) * n);
  }
}

// B2 pass 1: the (max, sumexp) partial of every column over the rows
// [split * split_rows, min(M, (split + 1) * split_rows)).  Warp w folds the
// U-row tiles that start at r0 + w * U, r0 + (w + COL_WARPS) * U, ...
template <typename CT, typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
col_kernel(const CT* __restrict__ cost, const T* __restrict__ f,
           const T* __restrict__ eps, T* __restrict__ part_m,
           T* __restrict__ part_s, int m_rows, int n_cols, int split_rows) {
  using TL = Tile<CT, T>;
  constexpr int VEC = TL::VEC, U = TL::UC, COLS = WARP * VEC;
  constexpr int STEP = COL_WARPS * U;
  extern __shared__ uint4 smem[];
  T* fr = reinterpret_cast<T*>(smem);             // [STAGES][COL_WARPS][U]
  uint4* cr = smem + (STAGES * COL_WARPS * U * sizeof(T) + 15) / 16;
  T* ms = reinterpret_cast<T*>(
      cr + (ALIGNED ? STAGES * U * THREADS : 0));  // [COL_WARPS][COLS]
  T* ss = ms + COL_WARPS * COLS;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int split = blockIdx.y, splits = gridDim.y;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * COLS + lane * VEC;
  const int r0 = split * split_rows;
  const int r1 = min(m_rows, r0 + split_rows);
  const CT* cb = cost + (int64_t)b * m_rows * n_cols + p0;
  const T* fb = f + (int64_t)b * m_rows;
  const T e = eps[b];
  const int first = r0 + warp * U;
  const int nt = first < r1 ? (r1 - first + STEP - 1) / STEP : 0;
  T m[VEC], s[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) { m[v] = Num<T>::neg_inf(); s[v] = T(0); }
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nt)
      col_issue<CT, T, ALIGNED>(k, first + k * STEP, r1, cb, fb, fr, cr,
                                n_cols, p0, warp, lane);
    cp_async_commit();
  }
  // Columns past N are computed on zeros and never written.
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();      // tile t is in; every lane is done with tile t - 1
    if (t + STAGES - 1 < nt)
      col_issue<CT, T, ALIGNED>(t + STAGES - 1,
                                first + (t + STAGES - 1) * STEP, r1, cb, fb,
                                fr, cr, n_cols, p0, warp, lane);
    cp_async_commit();
    const int i0 = first + t * STEP, slot = t % STAGES;
    T c[U][VEC], fi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = i0 + u < r1;   // a masked row: (-inf - 0) / eps = -inf
      fi[u] = in ? fr[(slot * COL_WARPS + warp) * U + u] : Num<T>::neg_inf();
      if (ALIGNED) {
        if (in && p0 < n_cols) {
          Vec16<CT>::unpack(cr[(slot * U + u) * THREADS + threadIdx.x], c[u]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) c[u][v] = T(0);
        }
      } else if (in) {
        load_scalar<CT, T>(cb + (int64_t)(i0 + u) * n_cols, n_cols - p0,
                           c[u]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) c[u][v] = T(0);
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      T z[U];
#pragma unroll
      for (int u = 0; u < U; ++u) z[u] = (fi[u] - c[u][v]) / e;
      tile_add(m[v], s[v], z);
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    ms[warp * COLS + lane * VEC + v] = m[v];
    ss[warp * COLS + lane * VEC + v] = s[v];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < COLS; c += THREADS) {
    const int p = blockIdx.x * COLS + c;
    if (p >= n_cols) continue;
    T mm = ms[c], sv = ss[c];
    for (int w = 1; w < COL_WARPS; ++w)
      lse_merge(mm, sv, ms[w * COLS + c], ss[w * COLS + c]);
    const int64_t o = ((int64_t)b * splits + split) * n_cols + p;
    part_m[o] = mm;
    part_s[o] = sv;
  }
}

// B2 pass 2: merge the splits of every column in split order and finish g.
template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS)
col_finish(const T* __restrict__ part_m, const T* __restrict__ part_s,
           const T* __restrict__ log_nu, const T* __restrict__ eps,
           T* __restrict__ g, int n_cols, int splits) {
  const int p = blockIdx.x * FINISH_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= n_cols) return;
  T m = Num<T>::neg_inf(), s = T(0);
  for (int k = 0; k < splits; ++k) {
    const int64_t o = ((int64_t)b * splits + k) * n_cols + p;
    lse_merge(m, s, part_m[o], part_s[o]);
  }
  const int64_t o = (int64_t)b * n_cols + p;
  g[o] = eps[b] * (log_nu[o] - lse_finish(m, s));
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Launch `kern` with `smem` bytes of dynamic shared memory, after raising
// the kernel's limit to it (by default 48 KB).
template <typename K, typename... A>
cudaError_t launch(K kern, dim3 grid, size_t smem, cudaStream_t st,
                   A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename CT, typename T>
int launch_row(const void* cost, const void* g, const void* log_mu,
               const void* eps, void* f, int lanes, int m_rows, int n_cols,
               void* stream) {
  const dim3 grid((m_rows + ROW_WARPS - 1) / ROW_WARPS, lanes);
  const bool al = aligned16(cost) && aligned16(g) &&
                  ((size_t)n_cols * sizeof(CT)) % 16 == 0;
  return (int)launch(al ? row_kernel<CT, T, true> : row_kernel<CT, T, false>,
                     grid, row_smem_bytes<CT, T>(al), (cudaStream_t)stream,
                     (const CT*)cost, (const T*)g, (const T*)log_mu,
                     (const T*)eps, (T*)f, m_rows, n_cols);
}

template <typename CT, typename T>
int launch_col(const void* cost, const void* f, const void* log_nu,
               const void* eps, void* g, void* part_m, void* part_s,
               int lanes, int m_rows, int n_cols, int splits, int split_rows,
               void* stream) {
  constexpr int COLS = WARP * Vec16<CT>::VEC;
  if (splits < 1 || split_rows < 1 ||
      (int64_t)splits * split_rows < m_rows ||
      (int64_t)(splits - 1) * split_rows >= m_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool al = aligned16(cost) && ((size_t)n_cols * sizeof(CT)) % 16 == 0;
  cudaError_t err = launch(
      al ? col_kernel<CT, T, true> : col_kernel<CT, T, false>,
      dim3((n_cols + COLS - 1) / COLS, splits, lanes),
      col_smem_bytes<CT, T>(al), st, (const CT*)cost, (const T*)f,
      (const T*)eps, (T*)part_m, (T*)part_s, m_rows, n_cols, split_rows);
  if (err != cudaSuccess) return (int)err;
  col_finish<T><<<dim3((n_cols + FINISH_THREADS - 1) / FINISH_THREADS, lanes),
                  FINISH_THREADS, 0, st>>>(
      (const T*)part_m, (const T*)part_s, (const T*)log_nu, (const T*)eps,
      (T*)g, n_cols, splits);
  return (int)cudaGetLastError();
}

}  // namespace

#define SINKHORN_ROW(NAME, CT, T)                                           \
  extern "C" int NAME(const void* cost, const void* g, const void* log_mu,  \
                      const void* eps, void* f, int lanes, int m_rows,      \
                      int n_cols, void* stream) {                           \
    return launch_row<CT, T>(cost, g, log_mu, eps, f, lanes, m_rows,        \
                             n_cols, stream);                               \
  }

#define SINKHORN_COL(NAME, CT, T)                                           \
  extern "C" int NAME(const void* cost, const void* f, const void* log_nu,  \
                      const void* eps, void* g, void* part_m, void* part_s, \
                      int lanes, int m_rows, int n_cols, int splits,        \
                      int split_rows, void* stream) {                       \
    return launch_col<CT, T>(cost, f, log_nu, eps, g, part_m, part_s,       \
                             lanes, m_rows, n_cols, splits, split_rows,     \
                             stream);                                       \
  }

SINKHORN_ROW(sinkhorn_row_f32_f32, float, float)
SINKHORN_ROW(sinkhorn_row_f64_f64, double, double)
SINKHORN_ROW(sinkhorn_row_bf16_f32, __nv_bfloat16, float)
SINKHORN_ROW(sinkhorn_row_bf16_f64, __nv_bfloat16, double)
SINKHORN_COL(sinkhorn_col_f32_f32, float, float)
SINKHORN_COL(sinkhorn_col_f64_f64, double, double)
SINKHORN_COL(sinkhorn_col_bf16_f32, __nv_bfloat16, float)
SINKHORN_COL(sinkhorn_col_bf16_f64, __nv_bfloat16, double)
