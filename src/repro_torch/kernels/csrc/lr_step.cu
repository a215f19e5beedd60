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
// Bound: the bytes of lk read once and f written once, against the issue of
// two exp an element (one for each LSE): f32 runs near its bytes bound, f64
// at about 2.3x it (~147 instructions an element, tools/sass_mix.py).
// The design:
//   * lk is read from device memory once.  A block takes a contiguous run
//     of rows (the wrapper's launch plan, `dykstra_plan`, sizes the runs so
//     that the grid is one wave of resident blocks, at least two an SM)
//     and walks it a tile at a time.  Each thread copies the 16-byte
//     vectors of the next tile that it will read itself into shared memory
//     with cp.async while it works on this one; both phases then read the
//     staged tile, from registers.
//   * Tier kernel, for r in {8, 16, 32, 64}: a lane holds K values of a row
//     (one 16-byte vector, two in f64, whose shuffles and logs then serve
//     twice the values) and a group of G = r / K lanes of one warp takes
//     the row, so a warp reads contiguous bytes.  A thread takes RT rows a
//     tile (RT * NV = 4 vectors) and works on them side by side.  The row
//     LSE is the reference's form: the row max (the lane's values, then a
//     shuffle tree over the group), then the sum of exp(z - max) (a
//     pairwise tree, then the shuffle tree), then the log, each lane taking
//     the logs of RT / G of the rows.  The column LSE is _online_lse_update
//     at register scale: for each of its K columns a thread takes the max
//     over its RT rows, rescales its running sum once (only when the max
//     rises, a warp-uniform branch: exp(0) = 1 changes no bit), then one
//     exp a value and a pairwise sum; no branch per element.  No barrier
//     in the loop: a thread reads only the vectors it copied, and a
//     group's log w after a warp barrier.
//   * General kernel, for every other r up to MAX_COLS: the tile is staged
//     whole (one span of tile_rows * r values), a group of up to 32 lanes
//     takes a row (max, then sum, then log, as above), and in the column
//     phase a thread takes one column of a subset of the tile's rows (or up
//     to 4 columns of all of them when r > 256): the subset's max, one
//     rescale, one exp an element, in a fixed order.
//   * Rows that are not 16-byte aligned (an unaligned base, or lanes whose
//     N * r * sizeof(lk) is not a multiple of 16) take the scalar-load
//     instantiation of the same kernel: the same tiles and the same order
//     of sums, loaded without cp.async, so the bits do not depend on the
//     alignment.
//   * A fixed-order merge without float atomics, in the reference's form
//     at each level (the max first, then the sums rescaled to it: exps that
//     do not wait on each other).  A block merges its threads' column
//     partials (shuffle trees, then its warps in order) into one
//     (max, sumexp) pair a column, writes it to scratch ([lane][block]
//     [column], so the merge's loads are contiguous) and takes an integer
//     ticket; the last block of a lane to finish merges the lane's
//     partials (strided subsets, then the subsets in order) and resets the
//     ticket for the next launch.  One launch a call, and two launches on
//     the same inputs give the same bits.
//
// B6, the factor Gram chain for D = A B^T and a factor Q:
//   bq = B^T Q (c, r), gram = Q^T (A bq) (r, r), sq = Q^T 1, tq = Q^T w.
// Since Q^T (A B^T Q) = (A^T Q)^T (B^T Q), the chain is one tall, skinny
// product X^T Q over the N rows, X = [B | A | 1 | w] (N, 2c + 2), and then
// the (r, c) (c, r) product gram = P^T bq with P = A^T Q: no grid-wide
// dependency, so one pass and one launch.  This is another association
// than the reference's Q^T (A bq); chip_smoke holds it to the f64 bar of
// the |.| chain and to the f32 rule, also on the exact factors of a point
// cloud shifted off the origin, where the Gram's c-long dot cancels.
// Bound: the bytes of A, B, Q and w read once.  The design:
//   * A block takes a run of whole rows (the wrapper's launch plan,
//     `gram_plan`: one wave of resident blocks, at least two an SM) and
//     walks it in tiles through a ring of GR_STAGES stages in shared
//     memory.  A tile is the four contiguous spans of its rows (B, A: rows
//     * c values; Q: rows * r; w), copied by cp.async: 16-byte copies over
//     each span's aligned body, single values before its first boundary,
//     the last copy partial.  A span lands at its source's 16-byte phase,
//     so aligned and offset inputs stage the same values in the same
//     places, and give the same bits.
//   * A thread owns a GR_KT x GR_JT register tile of the (2c + 2, r) sums.
//     A pass's tiles are spread over the threads (one each); the rest of
//     the block's threads repeat them as row groups, each taking every
//     groups-th row of a tile: one FMA chain of at most GR_MAX_CHAIN rows
//     (one 1024-row f32 chain failed the f32 bar), added to the thread's
//     running sums once a tile.  Each row costs GR_KT + GR_JT shared loads
//     for GR_KT * GR_JT FMAs; Q's GR_JT values are one or two 16-byte
//     loads where its rows are whole vectors (QVEC).  Where the sums
//     outnumber a block's threads' tiles (c, r far from the solves'), the
//     block walks the outputs in passes and reads its rows again, from L2:
//     correct there, not tuned.
//   * A fixed-order merge without float atomics.  The row groups fold in a
//     fixed tree in shared memory; the block's partial goes to scratch
//     ([lane][block][k][j]); then two levels of integer tickets: the last
//     block of each group of GR_GROUP blocks to finish sums the group's
//     partials (a pairwise tree), and the last group of the lane merges the
//     group sums in a fixed pairwise order (load batches summed as trees,
//     the batches by a binary-counter cascade; never a sequential chain
//     over the blocks, which fails the f32 rule) and writes bq, sq, tq and
//     the Gram.  Each last block resets its ticket.  Two launches on the
//     same inputs give the same bits.
//
// B7, the gradient assembly:
//   out = (2 (d2 s^T + 1 t^T) - 4 A W) diag(iq),   W (c, r).
// Bound: the bytes of A and d2 read and of the (N, r) output written.  A
// thread owns VW consecutive outputs of a row, 16 bytes (4 in f32, 2 in
// f64; one value where r is not a multiple of VW: the scalar
// instantiation), so its column slice, and its slice of W (the first
// CB_WREG rows; any further rows from L1), s, t and iq in registers, stay
// the same for its whole walk over the rows.  A block walks tiles of rows
// (one wave of blocks over the lanes' tiles); each tile's spans of A and
// d2 are staged by cp.async one tile ahead (as B6's), and the threads of a
// row read its c values of A from shared memory.  The stores are 16 bytes
// and coalesced.  The elementwise tail uses round-to-nearest intrinsics so
// that the compiler cannot contract d2*s + t into an FMA: the kernel and
// its plain version then differ only in how the c-long dot is summed.
//
// Zero-mass atoms: a -inf term contributes nothing to a (max, sumexp) pair,
// a merge with a -inf partial keeps the other side, a row whose lanes are
// all -inf has lse = -inf, and a zero-mass row (log w = -inf) gives
// f = -inf: never exp(-inf - (-inf)) = NaN, as the reference's guards
// (repro/kernels/sinkhorn_step.py _online_lse_update/_finish_lse).
//
// lk may be bf16 under f32 or f64 duals: each element is widened exactly
// (bf16 is the top half of an f32), and every sum is taken in the duals'
// type.  Each kernel launches on the caller's stream and allocates nothing:
// the wrapper passes outputs and scratch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr int MAX_COLS = 1024;         // c and r (lr_step.MAX_COLS)

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

// One 16-byte vector of lk: VEC elements; `load` reads one by scalar loads
// (p need not be 16-byte aligned).
template <typename LT> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int VEC = 4;
  __device__ static uint4 load(const float* p) {
    return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                      __float_as_uint(p[2]), __float_as_uint(p[3]));
  }
  template <typename T>
  __device__ static void unpack(uint4 r, T (&o)[VEC]) {
    o[0] = (T)__uint_as_float(r.x);
    o[1] = (T)__uint_as_float(r.y);
    o[2] = (T)__uint_as_float(r.z);
    o[3] = (T)__uint_as_float(r.w);
  }
};
template <> struct Vec16<double> {
  static constexpr int VEC = 2;
  __device__ static uint4 load(const double* p) {
    return make_uint4(__double2loint(p[0]), __double2hiint(p[0]),
                      __double2loint(p[1]), __double2hiint(p[1]));
  }
  template <typename T>
  __device__ static void unpack(uint4 r, T (&o)[VEC]) {
    o[0] = (T)__hiloint2double((int)r.y, (int)r.x);
    o[1] = (T)__hiloint2double((int)r.w, (int)r.z);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static uint4 load(const __nv_bfloat16* p) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return make_uint4(q[0] | (unsigned)q[1] << 16, q[2] | (unsigned)q[3] << 16,
                      q[4] | (unsigned)q[5] << 16, q[6] | (unsigned)q[7] << 16);
  }
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
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

// The first `bytes` (0 < bytes <= 16) of a 16-byte copy; the rest is
// zero-filled and not read from global memory.
__device__ __forceinline__ void cp_async16_part(void* smem, const void* gmem,
                                                int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes) : "memory");
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's latest commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The larger of a and b: fmaxf in f32 (one instruction); in f64 a compare
// and select, where fmax's NaN handling costs several (no NaN reaches it).
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) {
  return a > b ? a : b;
}

// z[0] <- the pairwise sum (max) of z[0..2W) (W a power of two).
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
    for (int k = 0; k < W; ++k) z[k] = vmax(z[k], z[k + W]);
    tree_max<W / 2>(z);
  }
}

// Merge `count` (max, sumexp) partials m[q * stride], s[q * stride] in a
// fixed order, in the reference's form: the max first, then the sums
// rescaled to it (an empty partial, m = -inf and s = 0, adds 0), so no
// exp waits on another.
template <typename T>
__device__ __forceinline__ void merge_max_first(const T* m, const T* s,
                                                int count, int stride,
                                                T& mo, T& so) {
  mo = Num<T>::neg_inf();
  for (int q = 0; q < count; ++q) mo = vmax(mo, m[q * stride]);
  so = T(0);
  if (mo != Num<T>::neg_inf())
    for (int q = 0; q < count; ++q)
      so += s[q * stride] * Num<T>::ex(m[q * stride] - mo);
}

template <typename T>
__device__ __forceinline__ T lse_finish(T m, T s) {
  return m == Num<T>::neg_inf() ? m : m + Num<T>::lg(s);
}

// f = log w - lse(mx, sm), -inf where log w = -inf; the shift is the row max
// where it is finite and 0 elsewhere (an all -inf row gives lse = -inf).
template <typename T>
__device__ __forceinline__ T row_dual(T lw, T mx, T sm) {
  const T lse = isfinite(mx) ? mx + Num<T>::lg(sm) : Num<T>::neg_inf();
  return lw > Num<T>::neg_inf() ? lw - lse : Num<T>::neg_inf();
}

template <typename T>
__device__ __forceinline__ T row_shift(T mx) {
  return isfinite(mx) ? mx : T(0);
}

// ---------------------------------------------------------------------------
// B5: Dykstra half-sweep
// ---------------------------------------------------------------------------

constexpr int DK_STAGES = 2;   // a tile in use and the next one in flight
constexpr int DK_MAX_COLS = MAX_COLS;
constexpr int DK_COLS_A_THREAD = DK_MAX_COLS / THREADS;   // general, r > 256
constexpr int DK_GENERAL_STAGE = 32 * 1024;   // general kernel: tile bytes

// The rows [a, b) that block blk of nblk takes: the N rows of a lane in
// runs of `unit` rows (a whole number of 16-byte vectors of lk), split as
// evenly as whole runs allow.
struct BlockRows {
  int a, b;
  __device__ BlockRows(int blk, int nblk, int n, int unit) {
    const int64_t runs = ((int64_t)n + unit - 1) / unit;
    a = (int)min(runs * blk / nblk * unit, (int64_t)n);
    b = (int)min(runs * (blk + 1) / nblk * unit, (int64_t)n);
  }
};

// The last block of lane b to finish merges the lane's nblk partials of
// every column ([lane][block][column] in part_m, part_s) in a fixed order
// and writes col; then it resets the ticket.  Called by every block after
// it wrote its partials.  Each of `nsub` threads of a column takes every
// nsub-th partial (the max, then the sum rescaled to it), then one thread
// a column merges the nsub results in order: no chain of dependent exp
// runs over the partials.
template <typename T>
__device__ void merge_blocks(const T* __restrict__ part_m,
                             const T* __restrict__ part_s,
                             unsigned* __restrict__ ticket,
                             T* __restrict__ col, int r) {
  __shared__ bool last;
  __shared__ T mk_s[THREADS], sk_s[THREADS];
  const int b = blockIdx.y, nblk = gridDim.x;
  __threadfence();                 // this block's partials, device-wide
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + b, 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();                 // every other block's partials
  const T NEG = Num<T>::neg_inf();
  for (int j0 = 0; j0 < r; j0 += THREADS) {
    const int cw = min(r - j0, THREADS), nsub = THREADS / cw;
    const int t = threadIdx.x % cw, k = threadIdx.x / cw;
    T mk = NEG, sk = T(0);
    if (k < nsub) {
      // partials are [lane][block][column]: a warp's loads are contiguous
      const T* pm = part_m + (int64_t)b * nblk * r + j0 + t;
      const T* ps = part_s + (int64_t)b * nblk * r + j0 + t;
#pragma unroll 8
      for (int q = k; q < nblk; q += nsub)
        mk = vmax(mk, __ldcg(pm + (int64_t)q * r));
      if (mk != NEG) {   // an empty partial (m = -inf, s = 0) adds 0
#pragma unroll 8
        for (int q = k; q < nblk; q += nsub)
          sk += __ldcg(ps + (int64_t)q * r) *
                Num<T>::ex(__ldcg(pm + (int64_t)q * r) - mk);
      }
    }
    mk_s[threadIdx.x] = mk;
    sk_s[threadIdx.x] = sk;
    __syncthreads();
    if (threadIdx.x < cw) {
      T m, s;
      merge_max_first(mk_s + threadIdx.x, sk_s + threadIdx.x, nsub, cw, m, s);
      col[(int64_t)b * r + j0 + threadIdx.x] = lse_finish(m, s);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ticket[b] = 0;
}

// Store this block's partial of column j in part_m/part_s
// [lane][block][column].
template <typename T>
__device__ __forceinline__ void store_partial(T* part_m, T* part_s, int r,
                                              int j, T m, T s) {
  const int64_t o = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * r + j;
  part_m[o] = m;
  part_s[o] = s;
}

// Tier geometry: a lane holds NV 16-byte vectors, K values, of a row; a
// row is G lanes; a tile is RT rows of each of the THREADS / G groups.  A
// thread's tile is RT * NV = 4 vectors in every dtype: f64 takes two
// vectors a row (half the shuffle rounds and logs a value) and two rows.
template <typename LT, int G> struct Tier {
  static constexpr int VEC = Vec16<LT>::VEC;
  static constexpr int NV = sizeof(LT) == 8 ? 2 : 1;
  static constexpr int K = NV * VEC;
  static constexpr int RT = 4 / NV;
  static constexpr int R = G * K;
  static constexpr int RG = THREADS / G;
  static constexpr int TR = RT * RG;
};

// Tier shared memory: (aligned rows) each thread's vectors of a tile and
// each group's log w, [stage][u][vector][thread] and [stage][u][group];
// then the warps' column partials.
template <typename LT, typename T, int G>
constexpr size_t tier_smem_bytes(bool aligned) {
  using TI = Tier<LT, G>;
  return (aligned ? DK_STAGES * TI::RT * (TI::NV * THREADS * sizeof(uint4) +
                                          TI::RG * sizeof(T))
                  : 0) +
         2 * WARPS * TI::R * sizeof(T);
}

// Issue the copies of the tile at row0 (rows below row_b): this thread's
// vectors, and the group's log w spread over its lanes.  The caller
// commits.
template <typename LT, typename T, int G>
__device__ __forceinline__ void tier_issue(int row0, int row_b, int slot,
                                           const LT* lkb, const T* lwb,
                                           uint4* ring, T* lw, int lane,
                                           int grp) {
  using TI = Tier<LT, G>;
  constexpr int VEC = TI::VEC, NV = TI::NV, R = TI::R, RG = TI::RG;
  constexpr int RT = TI::RT;
#pragma unroll
  for (int u = 0; u < RT; ++u) {
    const int row = row0 + u * RG + grp;
    if (row < row_b) {
#pragma unroll
      for (int q = 0; q < NV; ++q)
        cp_async16(ring + ((slot * RT + u) * NV + q) * THREADS + threadIdx.x,
                   lkb + (int64_t)(row0 + u * RG) * R +
                       (threadIdx.x * NV + q) * VEC);
    }
  }
  for (int u = lane; u < RT; u += G) {
    const int row = row0 + u * RG + grp;
    if (row < row_b)
      cp_async_small<sizeof(T)>(lw + (slot * RT + u) * RG + grp, lwb + row);
  }
}

// Value k of a thread's K values of row u (vectors raw[u][0..NV)).
template <typename LT, typename T, int NV, int RT>
__device__ __forceinline__ T value(const uint4 (&raw)[RT][NV], int u, int k) {
  constexpr int VEC = Vec16<LT>::VEC;
  T c[VEC];
  Vec16<LT>::unpack(raw[u][k / VEC], c);
  return c[k % VEC];
}

template <typename LT, typename T, int G, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
dykstra_tier(const LT* __restrict__ lk, const T* __restrict__ gcol,
             const T* __restrict__ logw, T* __restrict__ f,
             T* __restrict__ part_m, T* __restrict__ part_s,
             unsigned* __restrict__ ticket, T* __restrict__ col, int n,
             int unit) {
  using TI = Tier<LT, G>;
  constexpr int NV = TI::NV, K = TI::K, R = TI::R, RG = TI::RG;
  constexpr int RT = TI::RT, TR = TI::TR;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                       // [STAGES][RT][NV][THREADS]
  T* lw = reinterpret_cast<T*>(
      smem + (ALIGNED ? DK_STAGES * RT * NV * THREADS : 0));  // [ST][RT][RG]
  T* ms = lw + (ALIGNED ? DK_STAGES * RT * RG : 0);     // [WARPS][R]
  T* ss = ms + WARPS * R;
  const T NEG = Num<T>::neg_inf();
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const BlockRows rows(blk, nblk, n, unit);
  const LT* lkb = lk + (int64_t)b * n * R;
  const T* lwb = logw + (int64_t)b * n;
  T* fb = f + (int64_t)b * n;
  T gc[K], m[K], s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    gc[k] = gcol[(int64_t)b * R + lane * K + k];
    m[k] = NEG;
    s[k] = T(0);
  }
  const int ntile = (rows.b - rows.a + TR - 1) / TR;
  if (ALIGNED) {
    if (ntile > 0)
      tier_issue<LT, T, G>(rows.a, rows.b, 0, lkb, lwb, ring, lw, lane, grp);
    cp_async_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    const int slot = t % DK_STAGES, row0 = rows.a + t * TR;
    if (ALIGNED) {
      cp_async_wait_all();
      __syncwarp();    // the group's log w is in; the warp is done with t - 1
      if (t + 1 < ntile)
        tier_issue<LT, T, G>(row0 + TR, rows.b, (t + 1) % DK_STAGES, lkb,
                             lwb, ring, lw, lane, grp);
      cp_async_commit();
    }
    uint4 raw[RT][NV];
    T lwu[RT];
    bool valid[RT];
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      const int row = row0 + u * RG + grp;
      valid[u] = row < rows.b;
      lwu[u] = NEG;
#pragma unroll
      for (int q = 0; q < NV; ++q) raw[u][q] = make_uint4(0, 0, 0, 0);
      if (valid[u]) {
        if (ALIGNED) {
#pragma unroll
          for (int q = 0; q < NV; ++q)
            raw[u][q] = ring[((slot * RT + u) * NV + q) * THREADS +
                             threadIdx.x];
          lwu[u] = lw[(slot * RT + u) * RG + grp];
        } else {
#pragma unroll
          for (int q = 0; q < NV; ++q)
            raw[u][q] = Vec16<LT>::load(lkb + (int64_t)row * R + lane * K +
                                        q * TI::VEC);
          lwu[u] = lwb[row];
        }
      }
    }
    // row LSE of the RT rows side by side: the max (the lane's K values,
    // then a shuffle tree over the group), the sum of exp(z - max) (a
    // pairwise tree, then the shuffle tree), then the log
    T mx[RT], sm[RT];
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      T z[K];
#pragma unroll
      for (int k = 0; k < K; ++k) z[k] = gc[k] + value<LT, T>(raw, u, k);
      tree_max<K / 2>(z);
      mx[u] = z[0];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RT; ++u)
        mx[u] = vmax(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], off, G));
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      const T sh = row_shift(mx[u]);
      T z[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        z[k] = Num<T>::ex(gc[k] + value<LT, T>(raw, u, k) - sh);
      tree_sum<K / 2>(z);
      sm[u] = z[0];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RT; ++u)
        sm[u] += __shfl_xor_sync(0xffffffffu, sm[u], off, G);
    // the RT logs spread over the group's lanes (lane l takes rows
    // l, l + G, ... mod RT), then each row's f from the lane that took it
    constexpr int NL = (RT + G - 1) / G;
    T fl[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int uq = (q * G + lane) % RT;
      T lwq = lwu[0], mxq = mx[0], smq = sm[0];
#pragma unroll
      for (int u = 1; u < RT; ++u) {
        lwq = uq == u ? lwu[u] : lwq;
        mxq = uq == u ? mx[u] : mxq;
        smq = uq == u ? sm[u] : smq;
      }
      fl[q] = row_dual(lwq, mxq, smq);
    }
    T fu[RT];
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      const T fi = __shfl_sync(0xffffffffu, fl[u / G], u % G, G);
      fu[u] = valid[u] ? fi : NEG;
      if (valid[u] && lane == 0) fb[row0 + u * RG + grp] = fi;
    }
    // column LSE over the tile's RT rows of each of this thread's columns:
    // the tile's max, one rescale (rare: warp-uniform branch), then one exp
    // a value and a pairwise sum
    T zc[K][RT], tmax[K];
    bool rise = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T t2[RT];
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        zc[k][u] = fu[u] + value<LT, T>(raw, u, k);   // masked: -inf + 0
        t2[u] = zc[k][u];
      }
      tree_max<RT / 2>(t2);
      tmax[k] = t2[0];
      rise |= tmax[k] > m[k];
    }
    if (__any_sync(0xffffffffu, rise)) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (tmax[k] > m[k]) {   // exp(m - m) = 1: skip it otherwise
          if (m[k] != NEG) s[k] *= Num<T>::ex(m[k] - tmax[k]);
          m[k] = tmax[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T sh = row_shift(m[k]);   // m = -inf: every zc is -inf, adds 0
#pragma unroll
      for (int u = 0; u < RT; ++u) zc[k][u] = Num<T>::ex(zc[k][u] - sh);
      tree_sum<RT / 2>(zc[k]);
      s[k] += zc[k][0];
    }
  }
  // the block's partial: the groups of a warp by shuffle trees (the max,
  // then the sums rescaled to it), then the warps in order
  T mw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) mw[k] = m[k];
#pragma unroll
  for (int off = G; off < WARP; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      mw[k] = vmax(mw[k], __shfl_xor_sync(0xffffffffu, mw[k], off));
#pragma unroll
  for (int k = 0; k < K; ++k)
    s[k] = m[k] == NEG ? T(0) : s[k] * Num<T>::ex(m[k] - mw[k]);
#pragma unroll
  for (int off = G; off < WARP; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
  const int warp = threadIdx.x / WARP;
  if (threadIdx.x % WARP < G) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ms[warp * R + lane * K + k] = mw[k];
      ss[warp * R + lane * K + k] = s[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R; j += THREADS) {
    T mj, sj;
    merge_max_first(ms + j, ss + j, WARPS, R, mj, sj);
    store_partial(part_m, part_s, R, j, mj, sj);
  }
  merge_blocks(part_m, part_s, ticket, col, R);
}

// General shared memory: the staged tiles, gcol, the tile's f and the
// column partials of the threads.
template <typename LT, typename T>
size_t general_smem_bytes(int r, int tile_rows) {
  const size_t stage = ((size_t)tile_rows * r * sizeof(LT) + 15) / 16 * 16;
  return DK_STAGES * stage + ((size_t)r + tile_rows + 2 * THREADS) * sizeof(T);
}

// Stage the tile at row0 (rows below row_b) into `dst`: 16-byte copies of
// its one contiguous span when rows are aligned (the last one partial),
// plain loads otherwise.
template <typename LT, bool ALIGNED>
__device__ __forceinline__ void general_issue(int row0, int row_b, int r,
                                              const LT* lkb, LT* dst) {
  const LT* src = lkb + (int64_t)row0 * r;
  const int count = (row_b - row0) * r;
  if (ALIGNED) {
    const int bytes = count * (int)sizeof(LT);
    for (int c = threadIdx.x; c * 16 < bytes; c += THREADS)
      cp_async16_part(reinterpret_cast<char*>(dst) + c * 16,
                      reinterpret_cast<const char*>(src) + c * 16,
                      min(16, bytes - c * 16));
  } else {
    for (int e = threadIdx.x; e < count; e += THREADS) dst[e] = src[e];
  }
}

template <typename LT, typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
dykstra_general(const LT* __restrict__ lk, const T* __restrict__ gcol,
                const T* __restrict__ logw, T* __restrict__ f,
                T* __restrict__ part_m, T* __restrict__ part_s,
                unsigned* __restrict__ ticket, T* __restrict__ col, int n,
                int r, int unit, int tile_rows, int width) {
  extern __shared__ uint4 smem[];
  const int stage = (tile_rows * r * (int)sizeof(LT) + 15) / 16;
  T* gs = reinterpret_cast<T*>(smem + DK_STAGES * stage);   // r
  T* fs = gs + r;                                           // tile_rows
  T* ms = fs + tile_rows;                                   // THREADS
  T* ss = ms + THREADS;
  const T NEG = Num<T>::neg_inf();
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const BlockRows rows(blk, nblk, n, unit);
  const LT* lkb = lk + (int64_t)b * n * r;
  const T* lwb = logw + (int64_t)b * n;
  T* fb = f + (int64_t)b * n;
  for (int j = threadIdx.x; j < r; j += THREADS) gs[j] = gcol[(int64_t)b * r + j];
  // column phase: subsets of the tile's rows, one column a thread (r <=
  // THREADS), or all rows and up to DK_COLS_A_THREAD columns
  const bool narrow = r <= THREADS;
  const int nsub = narrow ? THREADS / r : 1;
  const int sub = narrow ? threadIdx.x / r : 0;
  const bool active = !narrow || threadIdx.x < nsub * r;
  T m[DK_COLS_A_THREAD], s[DK_COLS_A_THREAD];
#pragma unroll
  for (int q = 0; q < DK_COLS_A_THREAD; ++q) { m[q] = NEG; s[q] = T(0); }
  // row phase: a group of `width` lanes a row
  const int lig = threadIdx.x % width, grp = threadIdx.x / width;
  const int ngrp = THREADS / width;
  const int ntile = (rows.b - rows.a + tile_rows - 1) / tile_rows;
  if (ntile > 0)
    general_issue<LT, ALIGNED>(rows.a, min(rows.b, rows.a + tile_rows), r,
                               lkb, reinterpret_cast<LT*>(smem));
  cp_async_commit();
  for (int t = 0; t < ntile; ++t) {
    const int row0 = rows.a + t * tile_rows;
    const int nrow = min(tile_rows, rows.b - row0);
    const LT* tl = reinterpret_cast<const LT*>(smem + (t % DK_STAGES) * stage);
    cp_async_wait_all();
    __syncthreads();   // tile t is in; every thread is done with t - 1
    if (t + 1 < ntile)
      general_issue<LT, ALIGNED>(row0 + tile_rows,
                                 min(rows.b, row0 + 2 * tile_rows), r, lkb,
                                 reinterpret_cast<LT*>(
                                     smem + ((t + 1) % DK_STAGES) * stage));
    cp_async_commit();
    for (int i0 = 0; i0 < nrow; i0 += ngrp) {
      const int i = i0 + grp;
      const bool live = i < nrow;
      T mx = NEG;
      if (live)
        for (int j = lig; j < r; j += width)
          mx = vmax(mx, gs[j] + widen<T>(tl[i * r + j]));
      for (int off = width / 2; off > 0; off >>= 1)
        mx = vmax(mx, __shfl_xor_sync(0xffffffffu, mx, off, width));
      const T sh = row_shift(mx);
      T sm = T(0);
      if (live)
        for (int j = lig; j < r; j += width)
          sm += Num<T>::ex(gs[j] + widen<T>(tl[i * r + j]) - sh);
      for (int off = width / 2; off > 0; off >>= 1)
        sm += __shfl_xor_sync(0xffffffffu, sm, off, width);
      if (live && lig == 0) {
        const T fi = row_dual(lwb[row0 + i], mx, sm);
        fs[i] = fi;
        fb[row0 + i] = fi;
      }
    }
    __syncthreads();   // the tile's f
    if (active) {
#pragma unroll
      for (int q = 0; q < DK_COLS_A_THREAD; ++q) {
        const int j = narrow ? threadIdx.x % r : threadIdx.x + q * THREADS;
        if ((narrow && q > 0) || j >= r) continue;
        T tm = NEG;
        for (int i = sub; i < nrow; i += nsub)
          tm = vmax(tm, fs[i] + widen<T>(tl[i * r + j]));
        if (tm == NEG) continue;            // an all -inf subset adds 0
        if (tm > m[q]) {                    // one rescale a tile
          if (m[q] != NEG) s[q] *= Num<T>::ex(m[q] - tm);
          m[q] = tm;
        }
        T acc = T(0);
        for (int i = sub; i < nrow; i += nsub)
          acc += Num<T>::ex(fs[i] + widen<T>(tl[i * r + j]) - m[q]);
        s[q] += acc;
      }
    }
  }
  if (narrow) {
    ms[threadIdx.x] = m[0];
    ss[threadIdx.x] = s[0];
    __syncthreads();
    for (int j = threadIdx.x; j < r; j += THREADS) {
      T mj, sj;
      merge_max_first(ms + j, ss + j, nsub, r, mj, sj);
      store_partial(part_m, part_s, r, j, mj, sj);
    }
  } else {
#pragma unroll
    for (int q = 0; q < DK_COLS_A_THREAD; ++q) {
      const int j = threadIdx.x + q * THREADS;
      if (j < r) store_partial(part_m, part_s, r, j, m[q], s[q]);
    }
  }
  merge_blocks(part_m, part_s, ticket, col, r);
}

int pow2_at_least(int v, int cap) {
  int w = 1;
  while (w < v && w < cap) w <<= 1;
  return w;
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

// Call fn(kernel, shared-memory bytes) with the tier kernel of rank r, one
// of {8, 16, 32, 64} (`is_tier`).
template <typename LT, typename T, bool ALIGNED, typename F>
cudaError_t with_tier(int r, F&& fn) {
  constexpr int K = Tier<LT, 1>::K;
#define DK_TIER(R_)                                                          \
  case R_:                                                                   \
    return fn(dykstra_tier<LT, T, R_ / K, ALIGNED>,                          \
              tier_smem_bytes<LT, T, R_ / K>(ALIGNED));
  switch (r) {
    DK_TIER(8) DK_TIER(16) DK_TIER(32) DK_TIER(64)
    default: return cudaErrorInvalidValue;
  }
#undef DK_TIER
}

// Whether r takes the tier kernel: r in {8, 16, 32, 64} (the main path's
// ranks), as `dykstra_plan` decides.
bool is_tier(int r) { return r == 8 || r == 16 || r == 32 || r == 64; }

template <typename LT, typename T, bool ALIGNED>
cudaError_t launch_dykstra_al(const void* lk, const void* gcol,
                              const void* logw, void* f, void* col,
                              void* part_m, void* part_s, void* ticket,
                              int lanes, int n, int r, int unit,
                              int blocks, int tile_rows, cudaStream_t st) {
  const dim3 grid(blocks, lanes);
  if (is_tier(r)) {
    if (tile_rows != Tier<LT, 1>::RT * THREADS * Tier<LT, 1>::K / r)
      return cudaErrorInvalidValue;
    return with_tier<LT, T, ALIGNED>(r, [&](auto kern, size_t smem) {
      return launch(kern, grid, smem, st, (const LT*)lk, (const T*)gcol,
                    (const T*)logw, (T*)f, (T*)part_m, (T*)part_s,
                    (unsigned*)ticket, (T*)col, n, unit);
    });
  }
  if ((int64_t)tile_rows * r * sizeof(LT) > DK_GENERAL_STAGE)
    return cudaErrorInvalidValue;
  return launch(dykstra_general<LT, T, ALIGNED>, grid,
                general_smem_bytes<LT, T>(r, tile_rows), st, (const LT*)lk,
                (const T*)gcol, (const T*)logw, (T*)f, (T*)part_m, (T*)part_s,
                (unsigned*)ticket, (T*)col, n, r, unit, tile_rows,
                pow2_at_least(r, WARP));
}

template <typename LT, typename T>
int launch_dykstra(const void* lk, const void* gcol, const void* logw,
                   void* f, void* col, void* part_m, void* part_s,
                   void* ticket, int lanes, int n, int r, int unit,
                   int blocks, int tile_rows, void* stream) {
  if (r < 1 || r > DK_MAX_COLS || tile_rows < 1 || unit < 1 || blocks < 1 ||
      blocks > ((int64_t)n + unit - 1) / unit)
    return (int)cudaErrorInvalidValue;   // no block may be empty
  // every lane's base, block's first row and tile's first row 16-byte
  // aligned: then each tile is whole 16-byte vectors from an aligned start
  const size_t rb = (size_t)r * sizeof(LT);
  const bool al = aligned16(lk) &&
                  (lanes == 1 || ((size_t)n * rb) % 16 == 0) &&
                  ((size_t)unit * rb) % 16 == 0 &&
                  ((size_t)tile_rows * rb) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(al ? launch_dykstra_al<LT, T, true>(
                        lk, gcol, logw, f, col, part_m, part_s, ticket,
                        lanes, n, r, unit, blocks, tile_rows, st)
                  : launch_dykstra_al<LT, T, false>(
                        lk, gcol, logw, f, col, part_m, part_s, ticket,
                        lanes, n, r, unit, blocks, tile_rows, st));
}

// Resident blocks an SM of the kernel (aligned rows) that takes rank r.
template <typename LT, typename T>
int dykstra_residency(int r, int tile_rows, int* out) {
  auto occupancy = [&](auto kern, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, THREADS,
                                                         smem);
  };
  if (is_tier(r)) return (int)with_tier<LT, T, true>(r, occupancy);
  return (int)occupancy(dykstra_general<LT, T, true>,
                        general_smem_bytes<LT, T>(r, tile_rows));
}

// ---------------------------------------------------------------------------
// B6: factor Gram chain, one pass over the rows
// ---------------------------------------------------------------------------

constexpr int GR_KT = 4;            // a thread's outputs: GR_KT columns of X
constexpr int GR_JT = 4;            //   by GR_JT columns of Q
constexpr int GR_MAX_CHAIN = 64;    // rows of one FMA chain
constexpr int GR_STAGES = 3;        // a tile in use and two in flight
constexpr int GR_GROUP = 16;        // blocks of a first-level merge group
constexpr int GR_BATCH = 32;        // partials a merge load batch
constexpr int GR_LEVELS = 7;        // merge cascade: up to 2^7 batches
constexpr int GR_MAX_BLOCKS = GR_GROUP * (GR_BATCH << GR_LEVELS);

// The output tiling of B6 for (c, r): the (K, r) sums X^T Q, K = 2c + 2, in
// GR_KT x GR_JT register tiles; `per_pass` tiles a pass (one a thread),
// `groups` row groups of per_pass threads, `passes` passes over the rows.
struct GramShape {
  int k, nk, nj, tiles, per_pass, groups, passes;
  __host__ __device__ GramShape(int c, int r) {
    k = 2 * c + 2;
    nk = (k + GR_KT - 1) / GR_KT;
    nj = (r + GR_JT - 1) / GR_JT;
    tiles = nk * nj;
    per_pass = tiles < THREADS ? tiles : THREADS;
    groups = THREADS / per_pass;
    passes = (tiles + per_pass - 1) / per_pass;
  }
};

// Values of a staged span of n values at any 16-byte phase: room for the
// phase in front and for the last 16-byte copy's zero fill.
template <typename T>
__host__ __device__ constexpr int span_cap(int n) {
  constexpr int V = 16 / (int)sizeof(T);
  return (n + 2 * (V - 1)) / V * V;
}

// A stage of B6 (values of T): the tile's spans of B, A (tile_rows * c
// each), Q (tile_rows * r) and w (tile_rows), each 16-byte aligned.
template <typename T>
struct GramStage {
  int b, a, q, w, total;
  __host__ __device__ GramStage(int tile_rows, int c, int r) {
    b = 0;
    a = span_cap<T>(tile_rows * c);
    q = 2 * a;
    w = q + span_cap<T>(tile_rows * r);
    total = w + span_cap<T>(tile_rows);
  }
};

// B6's shared memory: a 16-byte slot for the constant 1, then the stages;
// after the rows, the stages hold the row groups' sums for their fold.
template <typename T>
size_t gram_smem_bytes(int c, int r, int tile_rows) {
  const GramShape gs(c, r);
  const size_t stages =
      (size_t)GR_STAGES * GramStage<T>(tile_rows, c, r).total * sizeof(T);
  const size_t fold =
      (size_t)gs.groups * gs.per_pass * GR_KT * GR_JT * sizeof(T);
  return 16 + (stages > fold ? stages : fold);
}

// The 16-byte phase of p, in values of T.
template <typename T>
__device__ __forceinline__ int phase16(const T* p) {
  return (int)(((uintptr_t)p % 16) / sizeof(T));
}

// Stage the n values at src into dst (16-byte aligned) at src's 16-byte
// phase: value e lands at dst[phase16(src) + e].  16-byte copies over the
// aligned body, the values before its first boundary one at a time, the
// last copy partial (zero-filled, nothing read past the span).  Whatever
// the alignment, the staged values are the same.  The caller commits.
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int n) {
  constexpr int V = 16 / (int)sizeof(T);
  const int ph = phase16(src);
  const int head = ph ? min(V - ph, n) : 0;
  if ((int)threadIdx.x < head)
    cp_async_small<sizeof(T)>(dst + ph + threadIdx.x, src + threadIdx.x);
  const int chunks = (n - head + V - 1) / V;
  for (int q = threadIdx.x; q < chunks; q += THREADS) {
    const int e = head + q * V;
    const int bytes = min(V, n - e) * (int)sizeof(T);
    if (bytes == 16)
      cp_async16(dst + ph + e, src + e);
    else
      cp_async16_part(dst + ph + e, src + e, bytes);
  }
}

// Issue the copies of the `rows` rows from row0 into the stage at sl.
template <typename T>
__device__ __forceinline__ void gram_issue(T* sl, const GramStage<T>& st,
                                           const T* ab, const T* bb,
                                           const T* qb, const T* wb, int row0,
                                           int rows, int c, int r) {
  stage_span(sl + st.b, bb + (int64_t)row0 * c, rows * c);
  stage_span(sl + st.a, ab + (int64_t)row0 * c, rows * c);
  stage_span(sl + st.q, qb + (int64_t)row0 * r, rows * r);
  stage_span(sl + st.w, wb + row0, rows);
}

// The sum of count partials p[q * stride] in a fixed pairwise order:
// batches of GR_BATCH loads in flight (each batch a pairwise tree), the
// batch sums merged by a binary-counter cascade (sums of 2^k batches
// combine as a tree), then the cascade's levels lowest first.  Never a
// sequential chain over the partials.
template <typename T>
__device__ T merge_pairwise(const T* p, int64_t stride, int count) {
  T stk[GR_LEVELS];
#pragma unroll
  for (int k = 0; k < GR_LEVELS; ++k) stk[k] = T(0);
  unsigned cnt = 0;
  for (int q0 = 0; q0 < count; q0 += GR_BATCH) {
    T z[GR_BATCH];
#pragma unroll
    for (int u = 0; u < GR_BATCH; ++u)
      z[u] = q0 + u < count ? __ldcg(p + (int64_t)(q0 + u) * stride) : T(0);
    tree_sum<GR_BATCH / 2>(z);
    T v = z[0];
    bool placed = false;
#pragma unroll
    for (int k = 0; k < GR_LEVELS; ++k) {
      if (!placed) {
        if ((cnt >> k) & 1u) {
          v = stk[k] + v;
        } else {
          stk[k] = v;
          placed = true;
        }
      }
    }
    ++cnt;
  }
  T s = T(0);
  bool any = false;
#pragma unroll
  for (int k = 0; k < GR_LEVELS; ++k) {
    if ((cnt >> k) & 1u) {
      s = any ? stk[k] + s : stk[k];
      any = true;
    }
  }
  return s;
}

// QVEC: Q's rows are whole 16-byte vectors from an aligned base and r a
// multiple of GR_JT, so a thread's GR_JT values of a row are whole vectors
// of the staged tile, read as such (the same values as the scalar reads).
template <typename T, bool QVEC>
__global__ void __launch_bounds__(THREADS, 2)
gram_chain(const T* __restrict__ amat, const T* __restrict__ bmat,
           const T* __restrict__ q, const T* __restrict__ w,
           T* __restrict__ part, unsigned* __restrict__ ticket,
           T* __restrict__ sums, T* __restrict__ gram, int n, int c, int r,
           int tile_rows) {
  extern __shared__ uint4 smem[];
  T* sm = reinterpret_cast<T*>(smem);    // [0]: 1; stages from 16 bytes on
  constexpr int ONE = 0, STAGE0 = 16 / (int)sizeof(T);
  const GramShape gs(c, r);
  const GramStage<T> st(tile_rows, c, r);
  const int lane = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int row_a = (int)((int64_t)n * blk / nblk);
  const int row_b = (int)((int64_t)n * (blk + 1) / nblk);
  const T* ab = amat + (int64_t)lane * n * c;
  const T* bb = bmat + (int64_t)lane * n * c;
  const T* qb = q + (int64_t)lane * n * r;
  const T* wb = w + (int64_t)lane * n;
  const int kr = gs.k * r;
  if (threadIdx.x == 0) sm[ONE] = T(1);
  const int ntile = (row_b - row_a + tile_rows - 1) / tile_rows;
  const int g = threadIdx.x / gs.per_pass;
  const int slot_in_pass = threadIdx.x % gs.per_pass;
  for (int pass = 0; pass < gs.passes; ++pass) {
    const int tt = pass * gs.per_pass + slot_in_pass;
    const bool active = g < gs.groups && tt < gs.tiles;
    const int k0 = (tt / gs.nj) * GR_KT, j0 = (tt % gs.nj) * GR_JT;
    int jj[GR_JT];
#pragma unroll
    for (int v = 0; v < GR_JT; ++v) jj[v] = min(j0 + v, r - 1);
    T outer[GR_KT][GR_JT];
#pragma unroll
    for (int u = 0; u < GR_KT; ++u)
#pragma unroll
      for (int v = 0; v < GR_JT; ++v) outer[u][v] = T(0);
    // the ring: tiles 0 .. GR_STAGES - 2 in flight before the first is
    // used, then one more issued (a commit group each, empty past the
    // last tile) as each is taken
    for (int t = 0; t < GR_STAGES - 1; ++t) {
      if (t < ntile)
        gram_issue(sm + STAGE0 + t * st.total, st, ab, bb, qb, wb,
                   row_a + t * tile_rows,
                   min(tile_rows, row_b - row_a - t * tile_rows), c, r);
      cp_async_commit();
    }
    for (int t = 0; t < ntile; ++t) {
      const int row0 = row_a + t * tile_rows;
      const int nrow = min(tile_rows, row_b - row0);
      const int sl = STAGE0 + (t % GR_STAGES) * st.total;
      cp_async_wait_pending<GR_STAGES - 2>();
      __syncthreads();   // tile t is in; every thread is done with t - 1
      const int ahead = t + GR_STAGES - 1;
      if (ahead < ntile)
        gram_issue(sm + STAGE0 + (ahead % GR_STAGES) * st.total, st, ab, bb,
                   qb, wb, row_a + ahead * tile_rows,
                   min(tile_rows, row_b - row_a - ahead * tile_rows), c, r);
      cp_async_commit();
      if (!active) continue;
      // X = [B | A | 1 | w]: each of this thread's columns as a shared
      // offset and a row stride (the constant 1 and padding: stride 0)
      const int pb = sl + st.b + phase16(bb + (int64_t)row0 * c);
      const int pa = sl + st.a + phase16(ab + (int64_t)row0 * c);
      const int pq = sl + st.q + phase16(qb + (int64_t)row0 * r);
      const int pw = sl + st.w + phase16(wb + row0);
      int xo[GR_KT], xs[GR_KT];
#pragma unroll
      for (int u = 0; u < GR_KT; ++u) {
        const int k = k0 + u;
        xo[u] = k < c ? pb + k : k < 2 * c ? pa + k - c
                : k == 2 * c + 1 ? pw : ONE;
        xs[u] = k < 2 * c ? c : k == 2 * c + 1 ? 1 : 0;
      }
      T acc[GR_KT][GR_JT];
#pragma unroll
      for (int u = 0; u < GR_KT; ++u)
#pragma unroll
        for (int v = 0; v < GR_JT; ++v) acc[u][v] = T(0);
      for (int i = g; i < nrow; i += gs.groups) {
        T x[GR_KT], y[GR_JT];
#pragma unroll
        for (int u = 0; u < GR_KT; ++u) x[u] = sm[xo[u] + i * xs[u]];
        const int qi = pq + i * r;
        if constexpr (QVEC) {
          constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
          for (int h = 0; h < GR_JT / V; ++h) {
            T yv[V];
            Vec16<T>::unpack(
                *reinterpret_cast<const uint4*>(sm + qi + j0 + h * V), yv);
#pragma unroll
            for (int v = 0; v < V; ++v) y[h * V + v] = yv[v];
          }
        } else {
#pragma unroll
          for (int v = 0; v < GR_JT; ++v) y[v] = sm[qi + jj[v]];
        }
#pragma unroll
        for (int u = 0; u < GR_KT; ++u)
#pragma unroll
          for (int v = 0; v < GR_JT; ++v)
            acc[u][v] = fma(x[u], y[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < GR_KT; ++u)
#pragma unroll
        for (int v = 0; v < GR_JT; ++v) outer[u][v] += acc[u][v];
    }
    // fold the row groups in a fixed tree, in the stage area:
    // [group][slot in pass][u][v]
    cp_async_wait_all();
    __syncthreads();   // every thread is done with the last tile
    constexpr int TV = GR_KT * GR_JT;
    const int per_group = gs.per_pass * TV;
    T* fold = sm + STAGE0;
    if (g < gs.groups) {
#pragma unroll
      for (int u = 0; u < GR_KT; ++u)
#pragma unroll
        for (int v = 0; v < GR_JT; ++v)
          fold[g * per_group + slot_in_pass * TV + u * GR_JT + v] =
              outer[u][v];
    }
    int half = 1;
    while (2 * half < gs.groups) half *= 2;
    for (; half >= 1; half >>= 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < half * per_group; e += THREADS) {
        const int gg = e / per_group;
        if (gg + half < gs.groups) fold[e] += fold[e + half * per_group];
      }
    }
    __syncthreads();
    // the block's partial of this pass's outputs: [lane][block][k][j]
    T* dst = part + ((int64_t)lane * nblk + blk) * kr;
    for (int e = threadIdx.x; e < per_group; e += THREADS) {
      const int t2 = pass * gs.per_pass + e / TV;
      const int k = (t2 / gs.nj) * GR_KT + (e % TV) / GR_JT;
      const int j = (t2 % gs.nj) * GR_JT + e % GR_JT;
      if (t2 < gs.tiles && k < gs.k && j < r) dst[k * r + j] = fold[e];
    }
    __syncthreads();   // the fold is read before the next pass stages
  }
  // the merge, in two levels of integer tickets ([lane][1 + groups]): the
  // last block of each group of GR_GROUP blocks to finish sums the group's
  // partials (a pairwise tree) into the group's first slot; the last group
  // to finish merges the group sums in a fixed pairwise order, writes the
  // sums and the Gram epilogue.  Each last block resets its ticket.
  __shared__ bool last;
  const int ngrp = (nblk + GR_GROUP - 1) / GR_GROUP, grp = blk / GR_GROUP;
  const int g0 = grp * GR_GROUP, gsize = min(GR_GROUP, nblk - g0);
  unsigned* tk = ticket + (int64_t)lane * (1 + ngrp);
  T* pl = part + (int64_t)lane * nblk * kr;
  __threadfence();   // this block's partials, device-wide
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tk + 1 + grp, 1u) == (unsigned)(gsize - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();   // the group's partials
  for (int e = threadIdx.x; e < kr; e += THREADS) {
    T z[GR_GROUP];
#pragma unroll
    for (int u = 0; u < GR_GROUP; ++u)
      z[u] = u < gsize ? __ldcg(pl + (int64_t)(g0 + u) * kr + e) : T(0);
    tree_sum<GR_GROUP / 2>(z);
    pl[(int64_t)g0 * kr + e] = z[0];
  }
  if (threadIdx.x == 0) tk[1 + grp] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tk, 1u) == (unsigned)(ngrp - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();   // every group's sum
  // the sums also to shared memory (the stages are free) where they fit,
  // for the Gram's reads
  T* sb = sums + (int64_t)lane * kr;
  const bool held = (int64_t)kr <= (int64_t)GR_STAGES * st.total;
  T* hold = sm + STAGE0;
  for (int e = threadIdx.x; e < kr; e += THREADS) {
    const T v = merge_pairwise(pl + e, (int64_t)GR_GROUP * kr, ngrp);
    sb[e] = v;
    if (held) hold[e] = v;
  }
  __syncthreads();
  // gram = P^T bq, P = A^T Q the rows c .. 2c-1 of the sums: a c-long dot
  T* gb = gram + (int64_t)lane * r * r;
  for (int e = threadIdx.x; e < r * r; e += THREADS) {
    const int j = e / r, l = e % r;
    T acc = T(0);
    for (int k = 0; k < c; ++k)
      acc = held ? fma(hold[(c + k) * r + j], hold[k * r + l], acc)
                 : fma(__ldcg(sb + (c + k) * r + j), __ldcg(sb + k * r + l),
                       acc);
    gb[e] = acc;
  }
  if (threadIdx.x == 0) tk[0] = 0;
}

template <typename T>
int launch_gram(const void* a, const void* bm, const void* q, const void* w,
                void* part, void* ticket, void* sums, void* gram, int lanes,
                int n, int c, int r, int tile_rows, int blocks,
                void* stream) {
  const GramShape gs(c, r);
  if (c < 1 || r < 1 || c > MAX_COLS || r > MAX_COLS || tile_rows < 1 ||
      blocks < 1 || blocks > n || blocks > GR_MAX_BLOCKS ||
      tile_rows > GR_MAX_CHAIN * gs.groups)
    return (int)cudaErrorInvalidValue;   // no block may be empty
  // every lane's Q, and so every tile's rows, on a 16-byte boundary
  const size_t rb = (size_t)r * sizeof(T);
  const bool qvec = r % GR_JT == 0 && rb % 16 == 0 && aligned16(q);
  const dim3 grid(blocks, lanes);
  const size_t smem = gram_smem_bytes<T>(c, r, tile_rows);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(qvec ? launch(gram_chain<T, true>, grid, smem, st, (const T*)a,
                             (const T*)bm, (const T*)q, (const T*)w, (T*)part,
                             (unsigned*)ticket, (T*)sums, (T*)gram, n, c, r,
                             tile_rows)
                    : launch(gram_chain<T, false>, grid, smem, st,
                             (const T*)a, (const T*)bm, (const T*)q,
                             (const T*)w, (T*)part, (unsigned*)ticket,
                             (T*)sums, (T*)gram, n, c, r, tile_rows));
}

// Resident blocks an SM of B6 at (c, r, tile_rows) (the vector-load
// instantiation; the scalar one takes the same shared memory).
template <typename T>
int gram_residency(int c, int r, int tile_rows, int* out) {
  const size_t smem = gram_smem_bytes<T>(c, r, tile_rows);
  cudaError_t err = cudaFuncSetAttribute(
      gram_chain<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, gram_chain<T, true>, THREADS, smem);
}

// ---------------------------------------------------------------------------
// B7: gradient assembly
// ---------------------------------------------------------------------------

constexpr int CB_WREG = 8;        // rows of W a thread keeps in registers
constexpr int CB_STAGES = 2;      // a tile of A in use, the next in flight
constexpr int CB_STAGE_BYTES = 8 * 1024;

// VW values of T as one store: 16 bytes, or a scalar (VW = 1).
template <typename T, int VW> struct Pack;
template <> struct Pack<float, 4> {
  __device__ static void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Pack<double, 2> {
  __device__ static void store(double* p, const double (&o)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  }
};
template <typename T> struct Pack<T, 1> {
  __device__ static void store(T* p, const T (&o)[1]) { *p = o[0]; }
};

// B7's geometry for rank r and VW outputs a thread: `per_row` threads a
// row (one VW-wide column slice each, a block's threads at most),
// `rows_blk` rows a block at a time, and a tile of `tile_rows` rows (whole
// rows_blk steps, about CB_STAGE_BYTES of A and d2) a stage.
struct CombineShape {
  int slices, per_row, rows_blk, tile_rows;
  __host__ __device__ CombineShape(int c, int r, int vw, int itemsize) {
    slices = r / vw;
    per_row = slices < THREADS ? slices : THREADS;
    rows_blk = THREADS / per_row;
    const int rows = CB_STAGE_BYTES / ((c + 1) * itemsize);
    tile_rows = rows < rows_blk ? rows_blk : rows / rows_blk * rows_blk;
  }
};

// B7's stage: the tile's spans of A (tile_rows * c) and d2 (tile_rows).
template <typename T>
__host__ __device__ int combine_stage(int c, int tile_rows) {
  return span_cap<T>(tile_rows * c) + span_cap<T>(tile_rows);
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
grad_combine(const T* __restrict__ amat, const T* __restrict__ wm,
             const T* __restrict__ d2, const T* __restrict__ sv,
             const T* __restrict__ tv, const T* __restrict__ iq,
             T* __restrict__ out, int n, int c, int r) {
  extern __shared__ uint4 smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const CombineShape cs(c, r, VW, sizeof(T));
  const int stage = combine_stage<T>(c, cs.tile_rows);
  const int lane = blockIdx.y;
  const int sub = threadIdx.x / cs.per_row;
  const bool row_thread = sub < cs.rows_blk;
  const T* ab = amat + (int64_t)lane * n * c;
  const T* db = d2 + (int64_t)lane * n;
  const T* wb = wm + (int64_t)lane * c * r;
  T* ob = out + (int64_t)lane * n * r;
  const int ntile = (int)(((int64_t)n + cs.tile_rows - 1) / cs.tile_rows);
  for (int s0 = 0; s0 < cs.slices; s0 += cs.per_row) {
    const int sl = s0 + threadIdx.x % cs.per_row;
    const bool active = row_thread && sl < cs.slices;
    const int j0 = (active ? sl : 0) * VW;
    T wr[CB_WREG][VW], s[VW], t[VW], qv[VW];
#pragma unroll
    for (int k = 0; k < CB_WREG; ++k)
#pragma unroll
      for (int v = 0; v < VW; ++v) wr[k][v] = k < c ? wb[k * r + j0 + v] : T(0);
#pragma unroll
    for (int v = 0; v < VW; ++v) {
      s[v] = sv[(int64_t)lane * r + j0 + v];
      t[v] = tv[(int64_t)lane * r + j0 + v];
      qv[v] = iq[(int64_t)lane * r + j0 + v];
    }
    // the block's tiles, blockIdx.x + gridDim.x * it, each staged one
    // ahead with cp.async (A and d2 read from memory once a slice pass)
    int tile = blockIdx.x;
    if (tile < ntile) {
      const int64_t row0 = (int64_t)tile * cs.tile_rows;
      const int rows = (int)min((int64_t)cs.tile_rows, n - row0);
      stage_span(sm, ab + row0 * c, rows * c);
      stage_span(sm + span_cap<T>(cs.tile_rows * c), db + row0, rows);
    }
    cp_async_commit();
    for (int it = 0; tile < ntile; ++it, tile += gridDim.x) {
      const int64_t row0 = (int64_t)tile * cs.tile_rows;
      const int nrow = (int)min((int64_t)cs.tile_rows, n - row0);
      const int so = (it % CB_STAGES) * stage;
      cp_async_wait_all();
      __syncthreads();   // tile `it` is in; every thread is done with it - 1
      const int next = tile + gridDim.x;
      if (next < ntile) {
        const int64_t nrow0 = (int64_t)next * cs.tile_rows;
        const int rows = (int)min((int64_t)cs.tile_rows, n - nrow0);
        T* dst = sm + ((it + 1) % CB_STAGES) * stage;
        stage_span(dst, ab + nrow0 * c, rows * c);
        stage_span(dst + span_cap<T>(cs.tile_rows * c), db + nrow0, rows);
      }
      cp_async_commit();
      if (!active) continue;
      const int pa = so + phase16(ab + row0 * c);
      const int pd = so + span_cap<T>(cs.tile_rows * c) + phase16(db + row0);
      for (int i = sub; i < nrow; i += cs.rows_blk) {
        const int ai = pa + i * c;
        T quad[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) quad[v] = T(0);
#pragma unroll
        for (int k = 0; k < CB_WREG; ++k) {
          if (k < c) {
            const T a = sm[ai + k];
#pragma unroll
            for (int v = 0; v < VW; ++v) quad[v] = fma(a, wr[k][v], quad[v]);
          }
        }
        for (int k = CB_WREG; k < c; ++k) {   // c > CB_WREG: W from L1
          const T a = sm[ai + k];
#pragma unroll
          for (int v = 0; v < VW; ++v)
            quad[v] = fma(a, __ldg(wb + k * r + j0 + v), quad[v]);
        }
        const T di = sm[pd + i];
        T o[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const T lin = Num<T>::add(Num<T>::mul(di, s[v]), t[v]);
          o[v] = Num<T>::mul(Num<T>::sub(Num<T>::mul(T(2), lin),
                                         Num<T>::mul(T(4), quad[v])),
                             qv[v]);
        }
        Pack<T, VW>::store(ob + (row0 + i) * r + j0, o);
      }
    }
    cp_async_wait_all();
    __syncthreads();   // the stages are free before the next slice pass
  }
}

// 16-byte stores when a row is a whole number of them, else scalar.
template <typename T>
constexpr int combine_vec() { return 16 / (int)sizeof(T); }

template <typename T>
bool combine_vector(int r) { return r % combine_vec<T>() == 0; }

template <typename T>
size_t combine_smem_bytes(int c, int r) {
  const int vw = combine_vector<T>(r) ? combine_vec<T>() : 1;
  const CombineShape cs(c, r, vw, sizeof(T));
  return (size_t)CB_STAGES * combine_stage<T>(c, cs.tile_rows) * sizeof(T);
}

// Call fn(kernel) with the B7 instantiation that takes rank r.
template <typename T, typename F>
cudaError_t with_combine(int r, F&& fn) {
  return combine_vector<T>(r) ? fn(grad_combine<T, combine_vec<T>()>)
                              : fn(grad_combine<T, 1>);
}

template <typename T>
int launch_combine(const void* a, const void* wm, const void* d2,
                   const void* sv, const void* tv, const void* iq, void* out,
                   int lanes, int n, int c, int r, int blocks, void* stream) {
  if (c < 1 || r < 1 || c > MAX_COLS || r > MAX_COLS || blocks < 1)
    return (int)cudaErrorInvalidValue;
  return (int)with_combine<T>(r, [&](auto kern) {
    return launch(kern, dim3(blocks, lanes), combine_smem_bytes<T>(c, r),
                  (cudaStream_t)stream, (const T*)a, (const T*)wm,
                  (const T*)d2, (const T*)sv, (const T*)tv, (const T*)iq,
                  (T*)out, n, c, r);
  });
}

// Resident blocks an SM of the B7 instantiation that takes (c, r).
template <typename T>
int combine_residency(int c, int r, int* out) {
  const size_t smem = combine_smem_bytes<T>(c, r);
  return (int)with_combine<T>(r, [&](auto kern) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, THREADS,
                                                         smem);
  });
}

}  // namespace

#define DYKSTRA_ENTRY(TAG, LT, T)                                            \
  extern "C" int lr_dykstra_half_##TAG(                                     \
      const void* lk, const void* gcol, const void* logw, void* f,          \
      void* col, void* part_m, void* part_s, void* ticket, int lanes,       \
      int n, int r, int unit, int blocks, int tile_rows, void* stream) {    \
    return launch_dykstra<LT, T>(lk, gcol, logw, f, col, part_m, part_s,    \
                                 ticket, lanes, n, r, unit, blocks,         \
                                 tile_rows, stream);                        \
  }                                                                         \
  extern "C" int lr_dykstra_residency_##TAG(int r, int tile_rows,           \
                                            int* out) {                     \
    return dykstra_residency<LT, T>(r, tile_rows, out);                     \
  }

DYKSTRA_ENTRY(f32_f32, float, float)
DYKSTRA_ENTRY(f64_f64, double, double)
DYKSTRA_ENTRY(bf16_f32, __nv_bfloat16, float)
DYKSTRA_ENTRY(bf16_f64, __nv_bfloat16, double)

#define GRAM_ENTRY(TAG, T)                                                   \
  extern "C" int lr_gram_chain_##TAG(                                       \
      const void* a, const void* b, const void* q, const void* w,           \
      void* part, void* ticket, void* sums, void* gram, int lanes, int n,   \
      int c, int r, int tile_rows, int blocks, void* stream) {              \
    return launch_gram<T>(a, b, q, w, part, ticket, sums, gram, lanes, n,   \
                          c, r, tile_rows, blocks, stream);                 \
  }                                                                         \
  extern "C" int lr_gram_residency_##TAG(int c, int r, int tile_rows,       \
                                         int* out) {                        \
    return gram_residency<T>(c, r, tile_rows, out);                         \
  }

GRAM_ENTRY(f32, float)
GRAM_ENTRY(f64, double)

#define COMBINE_ENTRY(TAG, T)                                                \
  extern "C" int lr_grad_combine_##TAG(                                     \
      const void* a, const void* wm, const void* d2, const void* sv,        \
      const void* tv, const void* iq, void* out, int lanes, int n, int c,   \
      int r, int blocks, void* stream) {                                    \
    return launch_combine<T>(a, wm, d2, sv, tv, iq, out, lanes, n, c, r,    \
                             blocks, stream);                               \
  }                                                                         \
  extern "C" int lr_grad_combine_residency_##TAG(int c, int r, int* out) { \
    return combine_residency<T>(c, r, out);                                 \
  }

COMBINE_ENTRY(f32, float)
COMBINE_ENTRY(f64, double)
