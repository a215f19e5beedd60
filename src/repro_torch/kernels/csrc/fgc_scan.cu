// FGC moment recursion for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of repro/kernels/fgc_scan.py:
//   fgc_apply_l       <- _fgc_kernel / fgc_apply_l_pallas
//                        y = L x,  L[i,j] = (i-j)^p for i > j  (or L^T x)
//   fgc_apply_dtilde  <- _dtilde_kernel / fgc_apply_dtilde_pallas
//                        y = (L + L^T) x,  D~[i,j] = |i-j|^p
// along axis 0 of a row-major (N, B) array.
//
// Recursion (paper eq. 3.9): with a_i[s] = sum_{j<i} (i-j)^s x_j,
//   y_i = a_i[p],   a_{i+1}[r] = sum_{s<=r} C(r,s) a_i[s] + x_i.
// L^T x is the same recursion run from the last row up (L^T x = flip(L flip x)).
// The moment state is kept in double whatever the element type: the
// recursion's rounding error grows with N (a[p] sums N terms of size up to
// N^p); an f32 state moved the solver's energy, whose three terms cancel, by
// ~6e-3 relative at N = 8192.  Hopper has f64, and p is small.
//
// Bound: the bytes of x read plus y written (p is small, so the (p+1)^2 / 2
// multiply-adds per element and stream are far below the card's rate).
//
// Both are one segmented moment scan (scan_pass, scan_carry) with NS
// streams: B3, the fused D~ apply, takes both (NS = 2), B4, the L apply, the
// forward stream alone (NS = 1).
//   * The reference carries the (p+1)-moment state across a sequential grid
//     axis of 128-row blocks: a_end = P_R a_start + T x_block.  CUDA blocks
//     run in no order, so the rows are cut into segments of S = groups * CH
//     rows (CH = 16 or 32 rows a thread, S a power of two) and each segment's
//     start states are carried to it in a fixed order.  An item is one
//     segment of a tile of tc columns: thread t = g * tc + c takes column c,
//     rows [g * CH, (g + 1) * CH) of the segment, so a warp works on
//     neighbouring columns of a row.  The wrapper's pure launch plan
//     (`fgc_scan.dtilde_plan`) shrinks the segments until there are at
//     least two items an SM, so a narrow x (B = 1 or 16) fills the card
//     too, and takes one segment (no carry) when N fits one.
//   * Shifting a state past L rows is the linear map P_L[r][s] = C(r,s) L^(r-s)
//     (the reference's P_R), computed as D P D^-1 with D = diag(L^r): L is
//     always a power of two, so the scalings are exact, and P is p sweeps of
//     neighbour additions (no coefficients).  A state after rows [a, b) from
//     a start state c is P_(b-a) c plus the state from zero: segments
//     compose.
//   * Pass 1 (scan_pass<..., 1, ...>, with two or more segments): each
//     thread takes its streams over its rows from zero as weighted sums
//     (f[s] = sum_j (CH - j)^s x_j, m[s] = sum_j (j + 1)^s x_j, exact
//     constant weights); the block publishes them, and the last group folds
//     the column's groups in order into the segment's forward state at its
//     bottom, the first group (NS = 2) into its mirrored state at its top:
//     NS (p+1) f64 values a column and segment.
//   * Carry (scan_carry): for each column, the start states of every
//     segment, c_{k+1} = P_S c_k + A_k from the top and (NS = 2) the mirror
//     of that from the bottom.  `lanes` threads share a column, each folding
//     `lane_segs` consecutive segments, then a Hillis-Steele scan over the
//     lanes in shared memory (shift S * lane_segs * d at distance d), then
//     each re-walks its segments from its carry, overwriting the totals with
//     start states in place.
//   * Pass 2 (scan_pass<..., 2, ...>): the same chunk states and publish;
//     each thread folds the groups above its rows onto the segment's forward
//     carry (and, NS = 2, those below onto its mirrored carry).  B4 runs the
//     forward stream down its rows and writes y = T(a[p]) once a row.  B3
//     runs the forward stream down its rows (L x rounded to T, held in
//     registers), then the mirrored stream up them, and writes each y once,
//     rounded as y = T(double(T(Lx)) + L^T x) (the plain version's rounding).
//     So x is read from device memory twice and y written once (x once with
//     a single segment), where the bound counts x once and y once.
//   * B4's L^T x is the forward scan over a row map (`rev`, a run-time
//     flag): row v of the scan is row N - 1 - v of x and of y.  The staged
//     tile holds x's rows bottom up, so nothing is copied or flipped; the
//     flag moves addresses only, and the sums are L's on the mirrored x.
//   * Both passes are one wave of blocks (the plan's grids, from the
//     runtime's occupancy) that walk the items in turn, the next item's
//     tile (and its carries) in flight by cp.async while they work on one:
//     16-byte copies, a warp's covering whole rows of the tile, where every
//     row of x and of the tile starts on a 16-byte boundary; else the
//     scalar-load instantiation, each thread copying its own elements one
//     by one.  Both read the same staged tile in the same order of sums, so
//     an offset view gives the bits of an aligned copy.
//   * Every sum is in a fixed order and no float atomics exist: two launches
//     on the same inputs give the same bits.
//   * Ragged N and B need no padding: rows past N and columns past B are
//     zero-filled in the staged tile (rows past N come after every real
//     forward state, and below N the mirrored state starts at 0), and
//     nothing is stored for them.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int MAX_P = 8;

// Rows of a column a thread takes are the template parameter CH: 32 (f32
// only) where the card still gets two items an SM, else 16.
constexpr int DT_THREADS = 256;   // most threads a block of the passes
constexpr int MAX_TC = 32;        // most columns a tile of the passes
constexpr int CARRY_THREADS = 256;  // most threads a block of the carry
constexpr int CARRY_BATCH = 4;    // segments a carry lane loads at once
// A pass block's ring: the item it works on, the next one in flight, and a
// third slot, so that a slot is refilled only after a barrier that follows
// every read of it.
constexpr int SLOTS = 3;

// a <- Pascal a, a[r] <- sum_{s<=r} C(r,s) a[s], as P sweeps of neighbour
// additions (Pascal's triangle): adds only, no coefficients.
template <int P>
__device__ __forceinline__ void pascal(double (&a)[P + 1]) {
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int r = P; r > k; --r) a[r] += a[r - 1];
}

// One row of the recursion: a <- Pascal a + xi.
template <int P>
__device__ __forceinline__ void absorb(double (&a)[P + 1], double xi) {
  pascal<P>(a);
#pragma unroll
  for (int r = 0; r <= P; ++r) a[r] += xi;
}

// d <- P_len c + d: c shifted past len rows, added to the state d of the
// rows that follow.  P_len = D P D^-1 with D = diag(len^r), and len is a
// power of two (inv = 1 / len), so the scalings are exact and only the
// additions round.
template <int P>
__device__ __forceinline__ void shift_add(double (&d)[P + 1],
                                          const double (&c)[P + 1],
                                          double len, double inv) {
  double t[P + 1], sc = 1.0;
#pragma unroll
  for (int s = 0; s <= P; ++s) {
    t[s] = c[s] * sc;
    sc *= inv;
  }
  pascal<P>(t);
  sc = 1.0;
#pragma unroll
  for (int r = 0; r <= P; ++r) {
    d[r] += t[r] * sc;
    sc *= len;
  }
}

template <int P>
__device__ __forceinline__ void copy(double (&d)[P + 1],
                                     const double (&c)[P + 1]) {
#pragma unroll
  for (int s = 0; s <= P; ++s) d[s] = c[s];
}

template <int P>
__device__ __forceinline__ void zero(double (&d)[P + 1]) {
#pragma unroll
  for (int s = 0; s <= P; ++s) d[s] = 0.0;
}

// The NS states of every thread (f, and m with two streams) into shared
// memory, after a barrier (so no thread still reads what the block
// published before).
template <int P, int NS>
__device__ __forceinline__ void publish(const double (&f)[P + 1],
                                        const double (&m)[P + 1],
                                        double* sh) {
  const int t = threadIdx.x, nt = blockDim.x;
  __syncthreads();
#pragma unroll
  for (int s = 0; s <= P; ++s) {
    sh[s * nt + t] = f[s];
    if constexpr (NS == 2) sh[(P + 1 + s) * nt + t] = m[s];
  }
  __syncthreads();
}

template <int P>
__device__ __forceinline__ void fetch(double (&v)[P + 1], const double* sh,
                                      int at) {
#pragma unroll
  for (int s = 0; s <= P; ++s) v[s] = sh[s * blockDim.x + at];
}

// Inclusive scans over the `groups` groups of a block for each of its `tc`
// columns (thread t = g * tc + c), each group's state covering `len` rows: f
// from group 0 down, m (NS = 2) from the last group up.  Hillis-Steele: at
// distance d the partner's state is shifted past the d * len rows of this
// one's (len a power of two, inv = 1 / len).  The partner at each level is
// fixed, so the order of sums is too.
template <int P, int NS>
__device__ void group_scan(double (&f)[P + 1], double (&m)[P + 1], double* sh,
                           int g, int groups, int tc, double len,
                           double inv) {
  const int t = threadIdx.x;
  for (int d = 1; d < groups; d <<= 1, len *= 2.0, inv *= 0.5) {
    publish<P, NS>(f, m, sh);
    double pf[P + 1], pm[P + 1];
    const bool hf = g >= d, hm = NS == 2 && g + d < groups;
    if (hf) fetch<P>(pf, sh, t - d * tc);
    if (hm) fetch<P>(pm, sh + (P + 1) * blockDim.x, t + d * tc);
    if (hf) shift_add<P>(f, pf, len, inv);
    if (hm) shift_add<P>(m, pm, len, inv);
  }
}

// After group_scan: the states before this group, from the neighbours'
// inclusive ones (the forward state of group g - 1, the mirrored state of
// group g + 1); the first and last groups keep what the caller put there.
template <int P, int NS>
__device__ __forceinline__ void exclusive(const double (&f)[P + 1],
                                          const double (&m)[P + 1],
                                          double* sh, int g, int groups,
                                          int tc, double (&ef)[P + 1],
                                          double (&em)[P + 1]) {
  if (groups == 1) return;
  publish<P, NS>(f, m, sh);
  const int t = threadIdx.x;
  if (g > 0) fetch<P>(ef, sh, t - tc);
  if (NS == 2 && g + 1 < groups)
    fetch<P>(em, sh + (P + 1) * blockDim.x, t + tc);
}

// After publish: a carried down the groups [h0, h1) of this thread's column
// (a <- P_CH a + f_h, in order), and b carried up the groups [h0, h1)
// (b <- P_CH b + m_h, from the last).
template <int P, int CH>
__device__ __forceinline__ void fold_down(double (&a)[P + 1],
                                          const double* sh, int c, int tc,
                                          int h0, int h1) {
  for (int h = h0; h < h1; ++h) {
    double t[P + 1];
    fetch<P>(t, sh, h * tc + c);
    shift_add<P>(t, a, (double)CH, 1.0 / CH);
    copy<P>(a, t);
  }
}

template <int P, int CH>
__device__ __forceinline__ void fold_up(double (&b)[P + 1], const double* sh,
                                        int c, int tc, int h0, int h1) {
  for (int h = h1 - 1; h >= h0; --h) {
    double t[P + 1];
    fetch<P>(t, sh + (P + 1) * blockDim.x, h * tc + c);
    shift_add<P>(t, b, (double)CH, 1.0 / CH);
    copy<P>(b, t);
  }
}

// An element copied from global to shared memory by cp.async (4 or 8
// bytes); with valid false nothing is read and the element is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* smem, const void* gmem,
                                              bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

// Every copy of this thread but its newest group has landed.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Row v of the scan in x and y: v, or n - 1 - v under B4's row map (L^T).
__device__ __forceinline__ int64_t row_at(int64_t v, int n, bool rev) {
  return rev ? (int64_t)n - 1 - v : v;
}

// The work item of a pass: segment item / tiles of column tile
// item % tiles; its first row and column, and this thread's column and
// first row in it (rows of the scan, before the row map).
struct Item {
  int seg, col0, col;
  int64_t top, row0;
  __device__ Item(int item, int tiles, int tc, int groups, int ch) {
    const int c = threadIdx.x % tc, g = threadIdx.x / tc;
    seg = item / tiles;
    col0 = (item % tiles) * tc;
    col = col0 + c;
    top = (int64_t)seg * groups * ch;
    row0 = top + (int64_t)g * ch;
  }
};

// Stage an item's tile (its groups * CH rows of tc columns) into
// shared memory, row-major in the scan's order; rows past N and columns
// past B are zero-filled.  VEC: 16-byte cp.async over the whole tile, a
// warp's copies covering whole rows (rows of x and of the tile 16-byte
// aligned); else each thread copies the CH elements of its own column and
// rows, one by one, and reads only those.
template <typename T, int CH, bool VEC>
__device__ __forceinline__ void stage_tile(T* tile, const T* __restrict__ x,
                                          const Item& it, int n, int cols,
                                          int tc, bool rev) {
  const int nt = blockDim.x;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);              // elements a vector
    const int vpr = tc / E;                        // vectors a tile row
#pragma unroll
    for (int i = 0; i < CH * (int)sizeof(T) / 16; ++i) {
      const int q = threadIdx.x + i * nt;
      const int r = q / vpr, e = (q % vpr) * E;
      const bool ok = it.top + r < n && it.col0 + e < cols;
      cp_async16(tile + r * tc + e,
                 ok ? x + row_at(it.top + r, n, rev) * cols + it.col0 + e
                    : x, ok);
    }
  } else {
    const int c = threadIdx.x % tc, g = threadIdx.x / tc;
    const int64_t rem = it.col < cols ? n - it.row0 : 0;
    const T* src = x + (rem > 0 ? row_at(it.row0, n, rev) * cols + it.col
                                : 0);
    const int64_t step = rev ? -(int64_t)cols : (int64_t)cols;
    T* dst = tile + g * CH * tc + c;
#pragma unroll 4
    for (int j = 0; j < CH; ++j) {
      const bool ok = j < rem;
      cp_async_elem<sizeof(T)>(dst + j * tc, ok ? src : x, ok);
      src += step;
    }
  }
}

// The streams over a staged chunk from zero: f at its bottom and (NS = 2)
// m at its top, as the sums f[s] = sum_j (CH - j)^s x_j and m[s] = sum_j
// (j + 1)^s x_j (j from the chunk's first row; the weights are exact
// constants), so one pass down the chunk takes both.
template <typename T, int P, int CH, int NS>
__device__ __forceinline__ void chunk_states(const T* v, int stride,
                                             double (&f)[P + 1],
                                             double (&m)[P + 1]) {
  zero<P>(f);
  if constexpr (NS == 2) zero<P>(m);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const double xj = (double)v[j * stride];
    double wf = 1.0, wm = 1.0;
#pragma unroll
    for (int s = 0; s <= P; ++s) {
      f[s] += wf * xj;
      if constexpr (NS == 2) m[s] += wm * xj;
      wf *= (double)(CH - j);
      wm *= (double)(j + 1);
    }
  }
}

// st[((seg * NS + stream) * (P + 1) + s) * cols + col], stream 0 forward
template <int NS>
__device__ __forceinline__ int64_t st_at(int seg, int stream, int s, int np1,
                                         int cols, int col) {
  return (((int64_t)seg * NS + stream) * np1 + s) * cols + col;
}

template <int P, int NS>
__device__ __forceinline__ void st_load(double (&v)[P + 1],
                                        const double* __restrict__ st,
                                        int seg, int stream, int cols,
                                        int col) {
#pragma unroll
  for (int s = 0; s <= P; ++s)
    v[s] = st[st_at<NS>(seg, stream, s, P + 1, cols, col)];
}

template <int P, int NS>
__device__ __forceinline__ void st_store(const double (&v)[P + 1],
                                         double* __restrict__ st, int seg,
                                         int stream, int cols, int col) {
#pragma unroll
  for (int s = 0; s <= P; ++s)
    st[st_at<NS>(seg, stream, s, P + 1, cols, col)] = v[s];
}

// Dynamic shared memory of a pass block of tc * groups threads: the
// groups' NS states a thread, in pass 2 SLOTS slots of the tile's carries
// (NS states a column), then SLOTS tiles of CH elements a thread.
template <typename T, int P, int PASS, int CH, int NS>
constexpr size_t pass_smem(int tc, int groups) {
  return (size_t)tc * (NS * (P + 1) * sizeof(double) *
                           (groups + (PASS == 2 ? SLOTS : 0)) +
                       SLOTS * CH * sizeof(T) * groups);
}

// Stage the item's carries for its column's threads ([stream][s][column of
// the tile]): the first group's thread copies the forward state, the last
// group's the mirrored state.
template <int P, int NS>
__device__ __forceinline__ void stage_carry(double* cs,
                                            const double* __restrict__ st,
                                            const Item& it, int g, int groups,
                                            int tc, int cols) {
  const int c = threadIdx.x % tc;
  const bool live = it.col < cols;
#pragma unroll
  for (int w = 0; w < NS; ++w) {
    if (g != (w == 0 ? 0 : groups - 1)) continue;
#pragma unroll
    for (int s = 0; s <= P; ++s)
      cp_async_elem<8>(cs + (w * (P + 1) + s) * tc + c,
                       live ? st + st_at<NS>(it.seg, w, s, P + 1, cols,
                                             it.col)
                            : st, live);
  }
}

// Pass 1: each segment's forward state at its bottom and (NS = 2)
// mirrored state at its top, from zero, into st.  Pass 2: y, from the
// segments' start states in st (null with a single segment: zero).  A
// block walks the items blockIdx.x, + gridDim.x, ..., with the next one's
// tile in flight by cp.async while it works on one.  rev (NS = 1 only):
// the row map of L^T.
template <typename T, int P, int PASS, int CH, bool VEC, int NS>
__global__ void __launch_bounds__(DT_THREADS)
scan_pass(const T* __restrict__ x, double* __restrict__ st,
          T* __restrict__ y, int n, int cols, int tc, int groups, int tiles,
          int items, bool rev) {
  constexpr bool APPLY = PASS == 2;
  extern __shared__ double dyn[];
  const int nt = blockDim.x, g = threadIdx.x / tc, c = threadIdx.x % tc;
  const bool carried = APPLY && st != nullptr;
  rev = NS == 1 && rev;
  constexpr int CS = NS * (P + 1);       // carry values a column and slot
  double* sh = dyn;
  double* cring = dyn + NS * (P + 1) * nt;
  T* ring = reinterpret_cast<T*>(cring + (APPLY ? SLOTS * CS * tc : 0));
  // stage item blockIdx.x + i * gridDim.x into slot i % SLOTS, one cp.async
  // group each (an empty group past the last item).  The item worked on in
  // step k is in slot k % SLOTS and the one staged then in (k - 2) % SLOTS,
  // whose reads all came before step k - 1's barriers.
  auto stage = [&](int i) {
    const int at = blockIdx.x + i * gridDim.x;
    if (at < items) {
      const Item it(at, tiles, tc, groups, CH);
      stage_tile<T, CH, VEC>(ring + (i % SLOTS) * CH * nt, x, it, n, cols,
                             tc, rev);
      if (carried)
        stage_carry<P, NS>(cring + (i % SLOTS) * CS * tc, st, it, g, groups,
                           tc, cols);
    }
    cp_async_commit();
  };
  stage(0);
  int item = blockIdx.x;
  for (int k = 0; item < items; ++k, item += gridDim.x) {
    stage(k + 1);
    cp_async_wait_prev();
    if (VEC) __syncthreads();            // every thread's copies have landed
    const T* v = ring + (k % SLOTS) * CH * nt + g * CH * tc + c;
    const double* cs = cring + (k % SLOTS) * CS * tc + c;
    const Item it(item, tiles, tc, groups, CH);
    const bool live = it.col < cols;
    double f[P + 1], m[P + 1], a[P + 1], b[P + 1];
    chunk_states<T, P, CH, NS>(v, tc, f, m);
    // every group's chunk states to the block; each thread then folds the
    // groups above its chunk onto the segment's forward carry and those
    // below onto the mirrored carry, in order (pass 1: the last group all of
    // them forward, the first all of them mirrored, from zero).  After the
    // barriers in publish every thread's copies of this item have landed.
    publish<P, NS>(f, m, sh);
    zero<P>(a);
    zero<P>(b);
    if (carried) {
#pragma unroll
      for (int s = 0; s <= P; ++s) {
        a[s] = cs[s * tc];
        if constexpr (NS == 2) b[s] = cs[(P + 1 + s) * tc];
      }
    }
    if (!APPLY) {
      if (live && g == groups - 1) {
        zero<P>(a);
        fold_down<P, CH>(a, sh, c, tc, 0, groups);
        st_store<P, NS>(a, st, it.seg, 0, cols, it.col);
      }
      if constexpr (NS == 2) {
        if (live && g == 0) {
          zero<P>(b);
          fold_up<P, CH>(b, sh, c, tc, 0, groups);
          st_store<P, NS>(b, st, it.seg, 1, cols, it.col);
        }
      }
      continue;
    }
    fold_down<P, CH>(a, sh, c, tc, 0, g);
    if constexpr (NS == 1) {
      // the stream down the chunk: y_i = T(a[p]) before row i joins
      const int64_t rem = live ? n - it.row0 : 0;
      T* dst = y + (rem > 0 ? row_at(it.row0, n, rev) * cols + it.col : 0);
      const int64_t step = rev ? -(int64_t)cols : (int64_t)cols;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (j < rem) *dst = (T)a[P];
        absorb<P>(a, (double)v[j * tc]);
        dst += step;
      }
    } else {
      fold_up<P, CH>(b, sh, c, tc, g + 1, groups);
      // the forward stream down the chunk (L x, rounded to T), then the
      // mirrored stream up it: y_i = T(double(T(Lx)_i) + L^T x_i)
      T lo[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        lo[j] = (T)a[P];
        absorb<P>(a, (double)v[j * tc]);
      }
      const int64_t rem = live ? n - it.row0 : 0;
      T* dst = y + (live ? it.row0 * cols + it.col : 0) +
               (int64_t)(CH - 1) * cols;
#pragma unroll
      for (int j = CH - 1; j >= 0; --j) {
        if (j < rem) *dst = (T)((double)lo[j] + b[P]);
        absorb<P>(b, (double)v[j * tc]);
        dst -= cols;
      }
    }
  }
}

// The carry: each segment's start states (forward at its top and, NS = 2,
// mirrored at its bottom), in place of its totals.  Thread t = l * ctc + c
// takes column c of the block's tile and segments [l * lane_segs, (l + 1) *
// lane_segs), CARRY_BATCH of them at a time in registers (loaded once when
// they fit one batch).  seg_rows is a power of two, seg_inv = 1 / seg_rows.
template <int P, int NS>
__global__ void __launch_bounds__(CARRY_THREADS)
scan_carry(double* __restrict__ st, int cols, int segments, int ctc,
           int lanes, int lane_segs, double seg_rows, double seg_inv) {
  __shared__ double sh[NS * (P + 1) * CARRY_THREADS];
  const int c = threadIdx.x % ctc, l = threadIdx.x / ctc;
  const int col = blockIdx.x * ctc + c;
  const bool live = col < cols;
  const int k0 = l * lane_segs;
  const int batches = (lane_segs + CARRY_BATCH - 1) / CARRY_BATCH;
  double fa[CARRY_BATCH][P + 1], ma[CARRY_BATCH][P + 1];
  int held = -1;             // the batch in fa, ma
  // segments past the end, and columns past B, are zero states
  auto load = [&](int bi) {
    if (bi == held) return;
    held = bi;
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      const int j = bi * CARRY_BATCH + q, k = k0 + j;
      if (live && j < lane_segs && k < segments) {
        st_load<P, NS>(fa[q], st, k, 0, cols, col);
        if constexpr (NS == 2) st_load<P, NS>(ma[q], st, k, 1, cols, col);
      } else {
        zero<P>(fa[q]);
        if constexpr (NS == 2) zero<P>(ma[q]);
      }
    }
  };
  // this lane's segments composed: forward from its first, mirrored from
  // its last
  double u[P + 1], w[P + 1], v[P + 1];
  zero<P>(u);
  zero<P>(w);
  for (int bi = 0; bi < batches; ++bi) {
    load(bi);
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      if (bi * CARRY_BATCH + q >= lane_segs) break;
      copy<P>(v, fa[q]);
      shift_add<P>(v, u, seg_rows, seg_inv);
      copy<P>(u, v);
    }
  }
  if constexpr (NS == 2) {
    for (int bi = batches - 1; bi >= 0; --bi) {
      load(bi);
#pragma unroll
      for (int q = CARRY_BATCH - 1; q >= 0; --q) {
        if (bi * CARRY_BATCH + q >= lane_segs) continue;
        copy<P>(v, ma[q]);
        shift_add<P>(v, w, seg_rows, seg_inv);
        copy<P>(w, v);
      }
    }
  }
  group_scan<P, NS>(u, w, sh, l, lanes, ctc, seg_rows * lane_segs,
                    seg_inv / lane_segs);
  double e[P + 1], ew[P + 1];
  zero<P>(e);
  zero<P>(ew);
  exclusive<P, NS>(u, w, sh, l, lanes, ctc, e, ew);
  if (!live) return;
  for (int bi = 0; bi < batches; ++bi) {
    load(bi);
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      const int k = k0 + bi * CARRY_BATCH + q;
      if (bi * CARRY_BATCH + q >= lane_segs || k >= segments) break;
      st_store<P, NS>(e, st, k, 0, cols, col);
      copy<P>(v, fa[q]);
      shift_add<P>(v, e, seg_rows, seg_inv);
      copy<P>(e, v);
    }
  }
  if constexpr (NS == 2) {
    for (int bi = batches - 1; bi >= 0; --bi) {
      load(bi);
#pragma unroll
      for (int q = CARRY_BATCH - 1; q >= 0; --q) {
        const int k = k0 + bi * CARRY_BATCH + q;
        if (bi * CARRY_BATCH + q >= lane_segs || k >= segments) continue;
        st_store<P, NS>(ew, st, k, 1, cols, col);
        copy<P>(v, ma[q]);
        shift_add<P>(v, ew, seg_rows, seg_inv);
        copy<P>(ew, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct ScanPlan {
  int chunk, tc, groups, segments, ctc, lanes, lane_segs, state_blocks,
      blocks, streams;
};

// Lets a pass take its largest dynamic shared memory (a block of
// DT_THREADS threads over MAX_TC columns) and writes the blocks of
// tc * groups threads an SM holds of it (the fewer of its vector and
// scalar instantiations).
template <typename T, int P, int PASS, int CH, int NS>
int residency_pass(int tc, int groups, int* out) {
  *out = 1 << 30;
  for (auto kern : {scan_pass<T, P, PASS, CH, true, NS>,
                    scan_pass<T, P, PASS, CH, false, NS>}) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)pass_smem<T, P, PASS, CH, NS>(MAX_TC, DT_THREADS / MAX_TC));
    int occ = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, kern, tc * groups,
          pass_smem<T, P, PASS, CH, NS>(tc, groups));
    if (err != cudaSuccess) return (int)err;
    *out = occ < *out ? occ : *out;
  }
  return 0;
}

// Chunks of 32 rows are instantiated for f32 only.  residency_p writes
// pass 1's blocks an SM to out[0] and pass 2's to out[1].
template <typename T>
constexpr bool has_chunk(int ch) {
  return ch == 16 || (ch == 32 && sizeof(T) == 4);
}

template <typename T, int P, int NS>
int residency_p(int tc, int groups, int ch, int* out) {
  if (ch == 32) {
    if constexpr (sizeof(T) == 4) {
      const int rc = residency_pass<T, P, 1, 32, NS>(tc, groups, out);
      return rc != 0 ? rc
                     : residency_pass<T, P, 2, 32, NS>(tc, groups, out + 1);
    }
  }
  const int rc = residency_pass<T, P, 1, 16, NS>(tc, groups, out);
  return rc != 0 ? rc : residency_pass<T, P, 2, 16, NS>(tc, groups, out + 1);
}

template <typename T, int P, int CH, bool VEC, int NS>
int launch_scan(const void* x, void* y, double* carry, int n, int cols,
                bool rev, const ScanPlan& pl, cudaStream_t st) {
  const int tiles = (cols + pl.tc - 1) / pl.tc;
  const int items = tiles * pl.segments;
  const int threads = pl.tc * pl.groups;
  if (pl.segments > 1) {
    scan_pass<T, P, 1, CH, VEC, NS>
        <<<pl.state_blocks, threads,
           pass_smem<T, P, 1, CH, NS>(pl.tc, pl.groups), st>>>(
            (const T*)x, carry, nullptr, n, cols, pl.tc, pl.groups, tiles,
            items, rev);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const double seg_rows = (double)(pl.groups * CH);
    scan_carry<P, NS><<<(cols + pl.ctc - 1) / pl.ctc, pl.ctc * pl.lanes, 0,
                        st>>>(carry, cols, pl.segments, pl.ctc, pl.lanes,
                              pl.lane_segs, seg_rows, 1.0 / seg_rows);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  scan_pass<T, P, 2, CH, VEC, NS>
      <<<pl.blocks, threads, pass_smem<T, P, 2, CH, NS>(pl.tc, pl.groups),
         st>>>((const T*)x, pl.segments > 1 ? carry : nullptr, (T*)y, n,
               cols, pl.tc, pl.groups, tiles, items, rev);
  return (int)cudaGetLastError();
}

// The vector instantiation where every row of x and of a tile starts on a
// 16-byte boundary, else the scalar one: the same tiles and order of sums.
template <typename T, int P, int CH, int NS>
int launch_scan(const void* x, void* y, double* carry, int n, int cols,
                bool rev, const ScanPlan& pl, cudaStream_t st) {
  const bool vec = (uintptr_t)x % 16 == 0 && cols * sizeof(T) % 16 == 0 &&
                   pl.tc * sizeof(T) % 16 == 0;
  return vec ? launch_scan<T, P, CH, true, NS>(x, y, carry, n, cols, rev, pl,
                                               st)
             : launch_scan<T, P, CH, false, NS>(x, y, carry, n, cols, rev, pl,
                                                st);
}

template <typename T, int P, int NS>
int launch_scan(const void* x, void* y, double* carry, int n, int cols,
                bool rev, const ScanPlan& pl, cudaStream_t st) {
  if constexpr (sizeof(T) == 4)
    if (pl.chunk == 32)
      return launch_scan<T, P, 32, NS>(x, y, carry, n, cols, rev, pl, st);
  return launch_scan<T, P, 16, NS>(x, y, carry, n, cols, rev, pl, st);
}

template <typename T, int NS>
int launch_ns(const void* x, void* y, double* c, int n, int cols, int p,
              bool rev, const ScanPlan& pl, cudaStream_t st) {
  switch (p) {
    case 0: return launch_scan<T, 0, NS>(x, y, c, n, cols, rev, pl, st);
    case 1: return launch_scan<T, 1, NS>(x, y, c, n, cols, rev, pl, st);
    case 2: return launch_scan<T, 2, NS>(x, y, c, n, cols, rev, pl, st);
    case 3: return launch_scan<T, 3, NS>(x, y, c, n, cols, rev, pl, st);
    case 4: return launch_scan<T, 4, NS>(x, y, c, n, cols, rev, pl, st);
    case 5: return launch_scan<T, 5, NS>(x, y, c, n, cols, rev, pl, st);
    case 6: return launch_scan<T, 6, NS>(x, y, c, n, cols, rev, pl, st);
    case 7: return launch_scan<T, 7, NS>(x, y, c, n, cols, rev, pl, st);
    case 8: return launch_scan<T, 8, NS>(x, y, c, n, cols, rev, pl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The plan's invariants (fgc_scan.dtilde_plan keeps them): one or two
// streams, power-of-two tiles, groups and lanes within a block, every row
// and segment covered, a grid of at most one block an item.
template <typename T>
bool plan_ok(int n, int cols, const ScanPlan& pl, const void* carry) {
  const long long rows = (long long)pl.segments * pl.groups * pl.chunk;
  const long long items = (cols + (long long)pl.tc - 1) / pl.tc * pl.segments;
  return (pl.streams == 1 || pl.streams == 2) && has_chunk<T>(pl.chunk) &&
         pow2(pl.tc) && pl.tc <= MAX_TC && pow2(pl.groups) &&
         pow2(pl.ctc) && pow2(pl.lanes) && pow2(pl.lane_segs) &&
         pl.tc * pl.groups <= DT_THREADS &&
         pl.ctc * pl.lanes <= CARRY_THREADS && rows >= n &&
         rows - (long long)pl.groups * pl.chunk < n &&
         (long long)pl.lanes * pl.lane_segs >= pl.segments &&
         items <= 0x7fffffffLL && pl.blocks >= 1 && pl.blocks <= items &&
         pl.state_blocks >= 1 && pl.state_blocks <= items &&
         (pl.segments == 1 || carry != nullptr);
}

template <typename T>
int launch(const void* x, void* y, void* carry, int n, int cols, int p,
           int reverse, const ScanPlan& pl, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (!plan_ok<T>(n, cols, pl, carry) || (reverse != 0 && pl.streams != 1))
    return (int)cudaErrorInvalidValue;
  double* c = (double*)carry;
  return pl.streams == 1
             ? launch_ns<T, 1>(x, y, c, n, cols, p, reverse != 0, pl, st)
             : launch_ns<T, 2>(x, y, c, n, cols, p, false, pl, st);
}

template <typename T, int NS>
int residency_ns(int p, int tc, int groups, int ch, int* out) {
  switch (p) {
    case 0: return residency_p<T, 0, NS>(tc, groups, ch, out);
    case 1: return residency_p<T, 1, NS>(tc, groups, ch, out);
    case 2: return residency_p<T, 2, NS>(tc, groups, ch, out);
    case 3: return residency_p<T, 3, NS>(tc, groups, ch, out);
    case 4: return residency_p<T, 4, NS>(tc, groups, ch, out);
    case 5: return residency_p<T, 5, NS>(tc, groups, ch, out);
    case 6: return residency_p<T, 6, NS>(tc, groups, ch, out);
    case 7: return residency_p<T, 7, NS>(tc, groups, ch, out);
    case 8: return residency_p<T, 8, NS>(tc, groups, ch, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int residency(int p, int streams, int tc, int groups, int ch, int* out) {
  if (tc < 1 || groups < 1 || tc * groups > DT_THREADS || !has_chunk<T>(ch))
    return (int)cudaErrorInvalidValue;
  if (streams == 1) return residency_ns<T, 1>(p, tc, groups, ch, out);
  if (streams == 2) return residency_ns<T, 2>(p, tc, groups, ch, out);
  return (int)cudaErrorInvalidValue;
}

static_assert(MAX_P == 8, "the switches above cover p = 0..MAX_P");

}  // namespace

// carry: segments * streams * (p+1) * cols doubles (unused with one
// segment); reverse (one stream only): L^T x in place of L x; the plan's
// fields as fgc_scan.dtilde_plan returns them.
#define FGC_SCAN_ENTRY(NAME, RES, T)                                        \
  extern "C" int NAME(const void* x, void* y, void* carry, int n, int cols, \
                      int p, int reverse, int streams, int chunk,           \
                      int col_tile, int groups, int segments,               \
                      int carry_cols, int lanes, int lane_segs,             \
                      int state_blocks, int blocks, void* stream) {         \
    const ScanPlan pl{chunk,     col_tile,     groups, segments, carry_cols, \
                      lanes,     lane_segs,    state_blocks, blocks,        \
                      streams};                                             \
    return launch<T>(x, y, carry, n, cols, p, reverse, pl, stream);         \
  }                                                                         \
  extern "C" int RES(int p, int streams, int col_tile, int groups,          \
                     int chunk, int* out) {                                 \
    return residency<T>(p, streams, col_tile, groups, chunk, out);          \
  }

FGC_SCAN_ENTRY(fgc_scan_f32, fgc_scan_residency_f32, float)
FGC_SCAN_ENTRY(fgc_scan_f64, fgc_scan_residency_f64, double)
