// CUDA kernels of the frontier MJoin executors (sm_90a), plain C interface.
//
// Lanes are the packed uint32 words of the host bitsets: bit i of a
// universe lives in lane i >> 5 at position i & 31 (little-endian).
//
// gather_intersect  replaces src/repro/kernels/gather_intersect.py
//                   gather_intersect_pallas (TPU kernel _gather_intersect_kernel).
//   For each of F frontier rows: gather K rows of the resident matrix
//   (R, W), AND them over the first w32 lanes, popcount.  Only the w32
//   live lanes are read: every constraint row of a level lives in the same
//   universe and resident rows are zero past their width.
//
// intersect         replaces src/repro/kernels/intersect.py intersect_pallas
//                   (TPU kernel _intersect_kernel).
//   The same body over a shipped (F, K, W) slab, its rows addressed
//   directly.
//
//   Both are one memory round trip at the paths' sizes (a few MB), so the
//   design spreads the loads over the whole card and puts them all in
//   flight at once.  A row is cut into chunks of V lanes (16-byte chunks;
//   gather_intersect's are 8-byte ones where w32 % 4 == 2); each row gets
//   a group of g threads, the least power of two (at most the 256-thread
//   block) that gives each thread one chunk, so a short row shares a warp
//   with others and a long one takes a block.  A
//   thread reads its row pointers from idx itself (no shared table, no
//   synchronization), issues all its loads (its chunks of KT rows; KT = K
//   up to 4, else groups of 4 rows ANDed in turn, so K has no limit)
//   before any AND, stores each chunk whole, and the group sums its
//   popcounts by shuffles (g <= 32) or through shared memory (a group of
//   warps), so each count is written once by the launch that owns the
//   whole row: no memset, no atomics, no second pass.
//   Bound: memory.  gather_intersect: each distinct gathered row once
//   (D*w32*4 bytes for D distinct indices) plus the index, the AND rows
//   and the counts, F*(K + w32 + 1)*4 bytes; intersect: F*(K*W + W + 1)*4
//   bytes.  At the paths' largest inputs (3.9 and 3.7 MB) the bytes take
//   about 1.1 us, and a launch alone costs about as much (an empty kernel
//   in a CUDA graph); gather_intersect then waits on two dependent memory
//   round trips (the index, then the rows) and intersect on one, so both
//   take about what a plain copy of the same bytes takes, 3x the bound.
//
// segment_counts + segment_write  replace src/repro/kernels/gather_intersect.py
//                   expand_pairs (plain XLA on the TPU: unpack + nonzero) and,
//                   in gather mode, the whole-graph enumerator's level
//                   src/repro/jaxgm/enumerate.py:65-104 (XLA: gather, AND,
//                   where(alive), popcount, unpack + argsort).
//   Set bits below column n_i of F rows -> the first `size` (row, col)
//   pairs in row-major order, zero-filled past the last pair.  A row is
//   either read directly (expand_pairs: rows (F, w)) or built on the fly
//   (gather_expand: fb_row AND the Kc rows mats[idx[f, 0..Kc)]), and only
//   the first n_alive rows are live (n_alive is read on the device, so no
//   host sync; rows past it count 0 and read nothing).  Each row is cut
//   into segments of kSegLanes lanes, and the unit of work is one warp
//   per (row, segment), so a wide row spreads over many warps:
//   pass 1 (segment_counts) writes one int32 count per segment; the
//   caller's int64 exclusive scan of the counts in row-major order is
//   exactly the pair order; pass 2 (segment_write) visits only segments
//   with bits and with an offset below `size` (a warp looks up 32 items
//   at once, strided over the grid so that a page whose pairs end early
//   still spreads over every warp, and stops at the first batch past
//   `size`), rebuilds the segment's words (re-gathering beats writing and
//   re-reading a (F, W) scratch block; a gathered row is read only where
//   the AND so far has bits), places each thread's words by a warp prefix
//   sum and writes each non-zero word with the whole warp, lane b placing
//   bit b, so rid and cid go out as contiguous runs; the zero fill is a
//   grid-stride loop over the whole grid.  Both passes are persistent
//   grids (a grid-stride loop over the work items), so dead rows cost no
//   block launches.  16-byte loads when the rows allow it,
//   else 4-byte ones.
//   Where the live rows gather the same few rows again (the enumerator's
//   levels gather hundreds of distinct rows for tens of thousands of live
//   rows), pass 1 reads them from L2 once per live row, so L2 bandwidth,
//   not the memory bound below, sets its time.
//   Bound: memory.  expand_pairs: F*live*4 bytes read plus 2*size*4
//   written.  gather_expand: 4*(D*live + n_alive*Kc + 2*size) + 4*live
//   bytes (D distinct rows gathered by the alive rows, each read once;
//   fb_row once) and n_alive*live*(Kc + 1) word operations.

// Every launcher returns cudaGetLastError(); the caller raises if it is
// not 0.  Launches go on the caller's stream and never synchronize.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;            // segment kernels: 8 warps
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMaxK = kWarp;                // row pointers per shared chunk
constexpr unsigned kFull = 0xffffffffu;

// AND-row kernels: 256 threads a block (of 64 to 256 threads, and of 1,
// 2 or 4 chunks a thread, 256 and 1 were among the fastest at every
// launch shape of the paths), and the template bound of K (rows loaded
// before their AND).
constexpr int kAndBlockLog2 = 8;
constexpr int kAndBlock = 1 << kAndBlockLog2;
constexpr int kMaxKT = 4;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// A chunk of V lanes: one 16-byte or one 8-byte access.
template <int V> struct Chunk;
template <> struct Chunk<4> {
  using T = uint4;
  static __device__ __forceinline__ T ones() {
    return make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  static __device__ __forceinline__ T band(T a, T b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  }
  static __device__ __forceinline__ int popc(T a) {
    return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
  }
};
template <> struct Chunk<2> {
  using T = uint2;
  static __device__ __forceinline__ T ones() { return make_uint2(~0u, ~0u); }
  static __device__ __forceinline__ T band(T a, T b) {
    return make_uint2(a.x & b.x, a.y & b.y);
  }
  static __device__ __forceinline__ int popc(T a) {
    return __popc(a.x) + __popc(a.y);
  }
};

// The AND-row body of both kernels.  Row `row` of the output is the AND of
// the k rows src(row, j) over w lanes (V lanes a chunk); the block holds
// kAndBlock >> g_log2 rows, each with a group of g = 1 << g_log2 threads.
// Every thread reaches the count's shuffles and barrier.
template <int KT, int V, typename Src>
__device__ __forceinline__ void and_rows_block(Src src, int64_t f, int k,
                                               int w, int g_log2,
                                               uint32_t* __restrict__ out,
                                               int32_t* __restrict__ counts) {
  using C = Chunk<V>;
  using T = typename C::T;
  const int g = 1 << g_log2;
  const int sub = threadIdx.x & (g - 1);
  const int64_t row = (static_cast<int64_t>(blockIdx.x)
                       << (kAndBlockLog2 - g_log2)) + (threadIdx.x >> g_log2);
  const int chunks = w / V;
  // below the template bound K is KT itself (the launcher's choice), so
  // the loop over groups of rows and its checks fold away
  const int kk = KT < kMaxKT ? KT : k;
  int cnt = 0;
  if (row < f) {
    T* o = reinterpret_cast<T*>(out + row * w);
    for (int c = sub; c < chunks; c += g) {
      T acc = C::ones();
      for (int j0 = 0; j0 < kk; j0 += KT) {
        const T* p[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j)
          p[j] = j0 + j < kk ? reinterpret_cast<const T*>(src(row, j0 + j))
                             : nullptr;
        T v[KT];                            // every load before any AND
#pragma unroll
        for (int j = 0; j < KT; ++j)
          v[j] = j0 + j < kk ? __ldg(p[j] + c) : C::ones();
#pragma unroll
        for (int j = 0; j < KT; ++j) acc = C::band(acc, v[j]);
      }
      o[c] = acc;
      cnt += C::popc(acc);
    }
  }
  if (g_log2 <= 5) {                        // groups inside a warp
    for (int d = g >> 1; d > 0; d >>= 1)
      cnt += __shfl_xor_sync(kFull, cnt, d);
    if (sub == 0 && row < f) counts[row] = cnt;
  } else {                                  // a group of warps
    __shared__ int part[kAndBlock / kWarp];
    const int warp = threadIdx.x / kWarp;
    cnt = warp_sum(cnt);
    if (threadIdx.x % kWarp == 0) part[warp] = cnt;
    __syncthreads();
    if (sub == 0 && row < f) {
      int s = 0;
      for (int i = 0; i < (g >> 5); ++i) s += part[warp + i];
      counts[row] = s;
    }
  }
}

template <int KT, int V>
__global__ void __launch_bounds__(kAndBlock)
gather_intersect_kernel(const uint32_t* __restrict__ matrix,
                        const int32_t* __restrict__ idx,
                        uint32_t* __restrict__ and_rows,
                        int32_t* __restrict__ counts,
                        int64_t w_all, int f, int k, int w32, int g_log2) {
  and_rows_block<KT, V>(
      [=](int64_t row, int j) {
        return matrix + static_cast<int64_t>(__ldg(idx + row * k + j)) * w_all;
      },
      f, k, w32, g_log2, and_rows, counts);
}

template <int KT, int V>
__global__ void __launch_bounds__(kAndBlock)
intersect_kernel(const uint32_t* __restrict__ rows,
                 uint32_t* __restrict__ and_rows,
                 int32_t* __restrict__ counts, int f, int k, int w,
                 int g_log2) {
  and_rows_block<KT, V>(
      [=](int64_t row, int j) {
        return rows + (row * k + j) * static_cast<int64_t>(w);
      },
      f, k, w, g_log2, and_rows, counts);
}

// The floor of a launch in the timing harness: a kernel that does nothing.
__global__ void empty_kernel() {}

// lane t's bits that lie below column n_i
__device__ __forceinline__ uint32_t live_bits(uint32_t v, int t, int n_i) {
  const int rem = n_i - 32 * t;             // > 0 for every live lane
  return rem >= 32 ? v : (v & ((1u << rem) - 1u));
}

constexpr int kSegLanes = 256;              // lanes per segment
constexpr int kSegWords = kSegLanes / kWarp;  // words a thread holds

// Segment word j of a thread (kVec consecutive lanes per load): its lane
// offset in the segment.  Steps of kWarp * kVec lanes; thread order
// inside a step is lane order, so step by step, thread by thread, word by
// word is row-major bit order.
template <int kVec>
__device__ __forceinline__ int seg_offset(int j, int lane) {
  return kWarp * kVec * (j / kVec) + kVec * lane + j % kVec;
}

// The thread's kSegWords words of one row's segment [seg0, seg0 +
// kSegLanes); lanes at or past `live` read nothing and hold 0, bits at or
// past n_i are cleared.
template <int kVec>
__device__ __forceinline__ void load_segment(const uint32_t* __restrict__ row,
                                             int seg0, int live, int n_i,
                                             int lane,
                                             uint32_t (&v)[kSegWords]) {
#pragma unroll
  for (int s = 0; s < kSegWords / kVec; ++s) {
    const int t = seg0 + seg_offset<kVec>(s * kVec, lane);
    if constexpr (kVec == 4) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      // t % 4 == 0 and W % 4 == 0, so t < live keeps all four in the row
      if (t < live) q = __ldg(reinterpret_cast<const uint4*>(row + t));
      v[4 * s] = q.x; v[4 * s + 1] = q.y; v[4 * s + 2] = q.z;
      v[4 * s + 3] = q.w;
    } else {
      v[s] = t < live ? __ldg(row + t) : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kSegWords; ++j) {
    const int t = seg0 + seg_offset<kVec>(j, lane);
    v[j] = t < live ? live_bits(v[j], t, n_i) : 0u;
  }
}

// acc &= the same words of another row, reading only the kVec-lane
// groups where acc still has a bit (the AND can only clear bits).
template <int kVec>
__device__ __forceinline__ void and_segment(const uint32_t* __restrict__ row,
                                            int seg0, int lane,
                                            uint32_t (&acc)[kSegWords]) {
#pragma unroll
  for (int s = 0; s < kSegWords / kVec; ++s) {
    const int t = seg0 + seg_offset<kVec>(s * kVec, lane);
    if constexpr (kVec == 4) {
      if (acc[4 * s] | acc[4 * s + 1] | acc[4 * s + 2] | acc[4 * s + 3]) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + t));
        acc[4 * s] &= q.x; acc[4 * s + 1] &= q.y; acc[4 * s + 2] &= q.z;
        acc[4 * s + 3] &= q.w;
      }
    } else {
      if (acc[s]) acc[s] &= __ldg(row + t);
    }
  }
}

__device__ __forceinline__ bool any_bit(const uint32_t (&acc)[kSegWords]) {
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < kSegWords; ++j) v |= acc[j];
  return __any_sync(kFull, v != 0u);
}

struct SegmentArgs {
  const uint32_t* rows;     // direct: (F, w_all) rows; gather: mats
  const uint32_t* fb;       // gather: the candidate row (W,)
  const int32_t* idx;       // gather: (F, k) row ids into mats
  const int64_t* n_alive;   // gather: live rows (0-d, on the device)
  int64_t w_all;            // row stride of rows / mats, in lanes
  int f, k, live, n_i, nseg;
};

__device__ __forceinline__ int64_t live_rows(const SegmentArgs& a) {
  if (a.n_alive == nullptr) return a.f;
  const int64_t n = *a.n_alive;
  return n < 0 ? 0 : min64(n, a.f);
}

// The words of segment `seg0` of row `row`: the row itself, or fb_row
// AND the row's k gathered rows (their pointers resolved into the warp's
// shared table kMaxK at a time, the AND kept in registers; a gathered row
// is read only where the AND so far has bits, and not at all once the
// segment's AND is empty).
template <bool kGather, int kVec>
__device__ __forceinline__ void segment_words(const SegmentArgs& a,
                                              int64_t row, int seg0,
                                              int lane,
                                              const uint32_t** tab,
                                              uint32_t (&acc)[kSegWords]) {
  if constexpr (!kGather) {
    load_segment<kVec>(a.rows + row * a.w_all, seg0, a.live, a.n_i, lane,
                       acc);
  } else {
    load_segment<kVec>(a.fb, seg0, a.live, a.n_i, lane, acc);
    for (int j0 = 0; j0 < a.k; j0 += kMaxK) {   // uniform across the warp
      if (!any_bit(acc)) return;
      const int kc = min(kMaxK, a.k - j0);
      __syncwarp();                             // last chunk's readers done
      if (lane < kc)
        tab[lane] = a.rows + static_cast<int64_t>(
                                 a.idx[row * a.k + j0 + lane]) * a.w_all;
      __syncwarp();
      for (int j = 0; j < kc; ++j) {
        if (j > 0 && !any_bit(acc)) return;
        and_segment<kVec>(tab[j], seg0, lane, acc);
      }
    }
  }
}

template <bool kGather, int kVec>
__global__ void __launch_bounds__(kThreads)
segment_counts_kernel(SegmentArgs a, int32_t* __restrict__ counts) {
  __shared__ const uint32_t* ptrs[kRowsPerBlock][kMaxK];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t items = static_cast<int64_t>(a.f) * a.nseg;   // < 2^31
  const int64_t alive = live_rows(a) * a.nseg;
  const int nwarps = gridDim.x * kRowsPerBlock;
  const int first = blockIdx.x * kRowsPerBlock + warp;
  // the item's (row, segment), stepped by nwarps items without a division
  int row = first / a.nseg, seg = first % a.nseg;
  const int drow = nwarps / a.nseg, dseg = nwarps % a.nseg;
  for (int64_t it = first; it < alive; it += nwarps) {   // warp-uniform
    uint32_t acc[kSegWords];
    segment_words<kGather, kVec>(a, row, seg * kSegLanes, lane, ptrs[warp],
                                 acc);
    row += drow;
    seg += dseg;
    if (seg >= a.nseg) {
      seg -= a.nseg;
      ++row;
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kSegWords; ++j) cnt += __popc(acc[j]);
    cnt = warp_sum(cnt);
    if (lane == 0) counts[it] = cnt;
  }
  // rows past n_alive count zero
  for (int64_t i = alive + blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x)
    counts[i] = 0;
}

// One step of a segment: the thread's kVec words `w` hold `c` bits, the
// first at slot `first` of the step, whose first slot in the page is
// `base`.  The whole warp writes each non-zero word in turn (thread by
// thread, word by word: row-major order): lane b places bit b at the
// word's slot plus the bits below it, so a dense word goes out as one
// contiguous run; slots at or past `size` are not written.
template <int kVec>
__device__ __forceinline__ void write_step(const uint32_t (&w)[kVec],
                                           int c, int first, int s, int seg0,
                                           int64_t base, int64_t size,
                                           int lane,
                                           int32_t* __restrict__ cid) {
  const uint32_t below = (1u << lane) - 1u;
  unsigned owners = __ballot_sync(kFull, c > 0);
  while (owners != 0u) {                      // uniform across the warp
    const int t = __ffs(owners) - 1;
    owners &= owners - 1u;
    uint32_t v[kVec];                         // the owner's words, at once
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = __shfl_sync(kFull, w[i], t);
    int64_t slot = base + __shfl_sync(kFull, first, t);
    if (slot >= size) return;                 // uniform across the warp
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int64_t q = slot + __popc(v[i] & below);
      const int col = 32 * (seg0 + seg_offset<kVec>(s * kVec + i, t)) + lane;
      if (((v[i] >> lane) & 1u) && q < size) cid[q] = col;
      slot += __popc(v[i]);
    }
  }
}

template <bool kGather, int kVec>
__global__ void __launch_bounds__(kThreads)
segment_write_kernel(SegmentArgs a, const int32_t* __restrict__ counts,
                     const int64_t* __restrict__ incl,
                     int32_t* __restrict__ rid, int32_t* __restrict__ cid,
                     int64_t size) {
  __shared__ const uint32_t* ptrs[kRowsPerBlock][kMaxK];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t items = static_cast<int64_t>(a.f) * a.nseg;
  // zero fill past the last pair, grid-stride over every thread
  const int64_t total = incl[items - 1];
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = total + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < size; p += nthreads) {
    rid[p] = 0;
    cid[p] = 0;
  }
  // a warp's items are gwarp, gwarp + nwarps, ...: 32 of them are looked
  // up at once (lane j the j-th), and the ones with pairs before `size`
  // are written one by one, so that a page whose pairs end early still
  // spreads over every warp
  const int64_t alive = live_rows(a) * a.nseg;   // items < 2^31
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
       g0 < alive; g0 += kWarp * nwarps) {       // uniform across the warp
    const int64_t it = g0 + lane * nwarps;
    int cnt = 0;
    int64_t off = 0;
    if (it < alive) {
      cnt = counts[it];
      off = incl[it] - cnt;
    }
    // offsets grow with the item, so once this batch starts at or past
    // `size`, so do all later batches of this warp
    if (__shfl_sync(kFull, off, 0) >= size) break;
    unsigned todo = __ballot_sync(kFull, it < alive && cnt > 0 && off < size);
    while (todo != 0u) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const unsigned item = static_cast<unsigned>(g0 + src * nwarps);
      const int c_seg = __shfl_sync(kFull, cnt, src);
      const int64_t o = __shfl_sync(kFull, off, src);
      const int row = static_cast<int>(item / a.nseg);
      const int seg0 = static_cast<int>(item % a.nseg) * kSegLanes;
      uint32_t acc[kSegWords];
      segment_words<kGather, kVec>(a, row, seg0, lane, ptrs[warp], acc);
      const int64_t n_out = min64(c_seg, size - o);
      for (int64_t q = lane; q < n_out; q += kWarp)
        rid[o + q] = static_cast<int32_t>(row);
      int64_t base = o;
#pragma unroll
      for (int s = 0; s < kSegWords / kVec; ++s) {
        if (base >= size) continue;             // uniform across the warp
        uint32_t w[kVec];
        int c = 0;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          w[i] = acc[s * kVec + i];
          c += __popc(w[i]);
        }
        int incl_c = c;                         // inclusive warp prefix sum
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const int n = __shfl_up_sync(kFull, incl_c, d);
          if (lane >= d) incl_c += n;
        }
        const int step_total = __shfl_sync(kFull, incl_c, kWarp - 1);
        if (step_total > 0)
          write_step<kVec>(w, c, incl_c - c, s, seg0, base, size, lane, cid);
        base += step_total;
      }
    }
  }
}

unsigned and_blocks(int f, int g_log2) {
  const int rows = kAndBlock >> g_log2;
  return static_cast<unsigned>((static_cast<int64_t>(f) + rows - 1) / rows);
}

// log2 of the threads given to each row of `chunks` chunks: the least
// power of two that gives each thread one chunk, at most a block
int group_log2(int chunks) {
  int lg = 0;
  while (lg < kAndBlockLog2 && (1 << lg) < chunks) ++lg;
  return lg;
}

// Launch `Launch<KT, V>` for K rows: KT = K up to kMaxKT, else kMaxKT.
template <template <int, int> class Launch, int V, typename... Args>
void dispatch_k(int k, Args... args) {
  switch (k < kMaxKT ? k : kMaxKT) {
    case 1: Launch<1, V>::run(args...); break;
    case 2: Launch<2, V>::run(args...); break;
    case 3: Launch<3, V>::run(args...); break;
    default: Launch<4, V>::run(args...);
  }
}

template <int KT, int V>
struct GatherLaunch {
  static void run(const uint32_t* matrix, const int32_t* idx,
                  uint32_t* and_rows, int32_t* counts, int64_t w_all, int f,
                  int k, int w32, cudaStream_t st) {
    const int lg = group_log2(w32 / V);
    gather_intersect_kernel<KT, V><<<and_blocks(f, lg), kAndBlock, 0, st>>>(
        matrix, idx, and_rows, counts, w_all, f, k, w32, lg);
  }
};

template <int KT, int V>
struct IntersectLaunch {
  static void run(const uint32_t* rows, uint32_t* and_rows, int32_t* counts,
                  int f, int k, int w, cudaStream_t st) {
    const int lg = group_log2(w / V);
    intersect_kernel<KT, V><<<and_blocks(f, lg), kAndBlock, 0, st>>>(
        rows, and_rows, counts, f, k, w, lg);
  }
};

// SMs x the blocks of `kernel` an SM holds: a persistent grid
template <typename Kernel>
int occupancy_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return std::max(1, sms * per_sm);
}

template <bool kGather, int kVec>
void launch_counts(const SegmentArgs& a, int32_t* counts, cudaStream_t st) {
  static const int cap = occupancy_blocks(segment_counts_kernel<kGather, kVec>);
  const int64_t want =
      (static_cast<int64_t>(a.f) * a.nseg + kRowsPerBlock - 1) / kRowsPerBlock;
  const unsigned blocks = static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(want, cap)));
  segment_counts_kernel<kGather, kVec><<<blocks, kThreads, 0, st>>>(a, counts);
}

template <bool kGather, int kVec>
void launch_write(const SegmentArgs& a, const int32_t* counts,
                  const int64_t* incl, int32_t* rid, int32_t* cid,
                  int64_t size, cudaStream_t st) {
  static const int cap = occupancy_blocks(segment_write_kernel<kGather, kVec>);
  segment_write_kernel<kGather, kVec><<<cap, kThreads, 0, st>>>(
      a, counts, incl, rid, cid, size);
}

// The launchers' arguments as one struct; nullptr where a mode has none.
SegmentArgs segment_args(const void* rows, const void* fb, const void* idx,
                         const void* n_alive, int64_t w_all, int f, int k,
                         int live, int n_i, int nseg) {
  return SegmentArgs{static_cast<const uint32_t*>(rows),
                     static_cast<const uint32_t*>(fb),
                     static_cast<const int32_t*>(idx),
                     static_cast<const int64_t*>(n_alive),
                     w_all, f, k, live, n_i, nseg};
}

// 16-byte loads need every row (and fb_row) on a 16-byte boundary
bool lanes16(const SegmentArgs& a, bool gather) {
  auto at16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return a.w_all % 4 == 0 && at16(a.rows) && (!gather || at16(a.fb));
}

}  // namespace

extern "C" {

int rt_gather_intersect(const void* matrix, const void* idx, void* and_rows,
                        void* counts, int64_t w_all, int f, int k, int w32,
                        void* stream) {
  if (f < 1 || k < 1 || w32 < 2 || w32 % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the wrapper gives a 16-byte aligned matrix of W % 4 == 0 lanes and a
  // fresh output, so the AND rows' pitch w32 alone picks the chunk
  const auto* m = static_cast<const uint32_t*>(matrix);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* out = static_cast<uint32_t*>(and_rows);
  auto* cnt = static_cast<int32_t*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  if (w32 % 4 == 0)
    dispatch_k<GatherLaunch, 4>(k, m, ix, out, cnt, w_all, f, k, w32, st);
  else
    dispatch_k<GatherLaunch, 2>(k, m, ix, out, cnt, w_all, f, k, w32, st);
  return static_cast<int>(cudaGetLastError());
}

int rt_intersect(const void* rows, void* and_rows, void* counts, int f, int k,
                 int w, void* stream) {
  if (f < 1 || k < 1 || w < 4 || w % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch_k<IntersectLaunch, 4>(
      k, static_cast<const uint32_t*>(rows),
      static_cast<uint32_t*>(and_rows), static_cast<int32_t*>(counts), f, k,
      w, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// one launch of a kernel that does nothing: the timing harness's floor
int rt_empty(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// lanes per segment: the caller sizes the counts (F * nseg) with it
int rt_segment_lanes() { return kSegLanes; }

int rt_segment_counts(const void* rows, const void* fb, const void* idx,
                      const void* n_alive, void* counts, int64_t w_all,
                      int f, int k, int live, int n_i, int nseg, int gather,
                      void* stream) {
  if (nseg != (live + kSegLanes - 1) / kSegLanes ||
      static_cast<int64_t>(f) * nseg >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const SegmentArgs a = segment_args(rows, fb, idx, n_alive, w_all, f, k,
                                     live, n_i, nseg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(counts);
  const bool vec4 = lanes16(a, gather != 0);
  if (gather) {
    if (vec4) launch_counts<true, 4>(a, out, st);
    else launch_counts<true, 1>(a, out, st);
  } else {
    if (vec4) launch_counts<false, 4>(a, out, st);
    else launch_counts<false, 1>(a, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_segment_write(const void* rows, const void* fb, const void* idx,
                     const void* n_alive, const void* counts,
                     const void* incl, void* rid, void* cid, int64_t w_all,
                     int f, int k, int live, int n_i, int nseg, int64_t size,
                     int gather, void* stream) {
  if (nseg != (live + kSegLanes - 1) / kSegLanes ||
      static_cast<int64_t>(f) * nseg >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const SegmentArgs a = segment_args(rows, fb, idx, n_alive, w_all, f, k,
                                     live, n_i, nseg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(counts);
  const int64_t* s = static_cast<const int64_t*>(incl);
  int32_t* r = static_cast<int32_t*>(rid);
  int32_t* o = static_cast<int32_t*>(cid);
  const bool vec4 = lanes16(a, gather != 0);
  if (gather) {
    if (vec4) launch_write<true, 4>(a, c, s, r, o, size, st);
    else launch_write<true, 1>(a, c, s, r, o, size, st);
  } else {
    if (vec4) launch_write<false, 4>(a, c, s, r, o, size, st);
    else launch_write<false, 1>(a, c, s, r, o, size, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
