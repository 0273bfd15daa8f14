// CUDA kernels of the on-device reachability closure (sm_90a), plain C
// interface.
//
// closure_step  replaces src/repro/kernels/closure.py closure_step_pallas
//               (TPU kernel _closure_kernel).
//   R' = R | (R·R > 0) for a square 0/1 matrix R of N rows packed into
//   W = N / 32 little-endian uint32 lanes per row; repeated, it yields the
//   transitive closure.  The TPU kernel multiplies unpacked tiles of R
//   densely on the MXU: N·N·W word operations per step whatever the data
//   (1.39e13 at the epinions graph, N = 76,288).  A reachability matrix of
//   a sparse graph is itself sparse (at most 29 set bits a row there), so
//   this takes the row form of the same function,
//       R'[i] = R[i] | OR_{k : R[i, k] = 1} R[k],
//   in two passes on the caller's stream:
//   1. row_lists_kernel, one warp per row k, reads R[k] once with 16-byte
//      loads and writes cnt[k], its number of set bits, and, when
//      cnt[k] <= kCap (32), its set columns in ascending order into row k
//      of an (N, kCap) table.  A row with more set bits is dense and its
//      table row is not used.  At epinions the table is 9.8 MB: it stays
//      in L2.
//   2. closure_step_kernel, one warp per output row i, builds R'[i] in a
//      W-lane accumulator of its own in shared memory, so no block
//      barrier is needed.  A sparse R[i] is exactly its list: its columns,
//      and those of each listed sparse row k, come from the table (a lane
//      per entry, one shared atomic OR each, two rows' entries in
//      flight).  A listed dense row k is ORed in whole, 16 bytes at a
//      time by the lane that owns those lanes of the accumulator, two
//      rows in flight (four made ptxas spill at 32 registers).  A dense R[i] is copied into the accumulator and
//      scanned from memory 32 lanes at a time.  The row is then written
//      with 16-byte stores.  A block holds as many warps (1 to 8) as fill
//      the SM best, given that each needs (W + 32) words of shared memory.
//   4-byte loads and stores replace the 16-byte ones when W is not a
//   multiple of 4 or a buffer is not 16-byte aligned.
//   Bound: memory.  R read once and R' written once is 2·N·W·4 bytes
//   (1.455 GB, 0.434 ms at 3.35 TB/s at epinions): pass 1 reads R, and
//   while every row is sparse pass 2 reads only the table and cnt.
//   Limit: each listed dense row still costs a read of its W lanes, as a
//   whole-row OR did in the one-pass form this replaces.  A closure that
//   is dense (a giant strongly connected component) makes pass 2 read
//   about N·N·W words, mostly from L2; the int8 tensor-core product would
//   do 2·N³ operations instead.  A row's accumulator must fit one block's
//   shared memory: W up to about 58,000 lanes.
//
// transpose     replaces src/repro/jaxgm/device_graph.py:76-78 (XLA unpack,
//               numpy transpose and XLA repack of the closure: not a Pallas
//               kernel).
//   The transpose of a square packed bit matrix.  A block of 256 threads
//   takes a tile of 8 x 8 bit blocks of 32 x 32 bits.  Each thread reads
//   the tile's 8 lanes of one row, one 32-byte sector; warp b then holds
//   the 8 bit blocks of block row b, one row per lane, and transposes each
//   in registers by five mask-and-shuffle swaps.  The results meet in
//   shared memory (rows padded to 9 words: no bank conflicts), and each
//   thread writes the tile's 8 lanes of one output row, again one sector.
//   Consecutive blocks take consecutive block rows of the input, so that
//   the blocks in flight together fill whole lines of the output rows
//   they share.  Bound: memory, 2·N·W·4 bytes (0.434 ms at epinions); the
//   short runs of a row that a tile reads and writes (32 bytes) keep it
//   well above a plain copy of the same bytes.
//
// Every launcher returns cudaGetLastError(), the error of setting a
// kernel's shared-memory attributes, or cudaErrorInvalidValue for a shape
// it cannot take; the caller raises if it is not 0.  Launches go on the
// caller's stream and never synchronize.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCap = 32;          // table entries per row
constexpr int kListWarps = 8;     // rows per block of row_lists_kernel
constexpr int kMaxStepWarps = 8;  // most rows per block of closure_step_kernel
constexpr int kUnroll = 2;        // rows read at once
constexpr int kTile = 8;          // bit blocks per side of a transpose tile
constexpr int kTileThreads = kWarp * kTile;
constexpr unsigned kFull = 0xffffffffu;

template <bool kVec>
using VecT = typename std::conditional<kVec, uint4, uint32_t>::type;

__device__ __forceinline__ uint32_t word_of(const uint4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word_of(uint32_t v, int) { return v; }

__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

__device__ __forceinline__ void or_into(uint32_t& a, uint32_t b) { a |= b; }

// ------------------------------------------------------------ pass 1
template <bool kVec>
__global__ void __launch_bounds__(kListWarps * kWarp)
row_lists_kernel(const uint32_t* __restrict__ r, int* __restrict__ cnt,
                 int* __restrict__ lists, int n, int w) {
  using Vec = VecT<kVec>;
  constexpr int kPer = sizeof(Vec) / sizeof(uint32_t);
  const int lane = threadIdx.x % kWarp;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kListWarps + threadIdx.x / kWarp;
  if (k >= n) return;                         // whole warps
  const Vec* row = reinterpret_cast<const Vec*>(r + k * w);
  int* list = lists + k * kCap;
  const int nv = w / kPer;
  int base = 0;                               // set bits before this chunk
  Vec next = lane < nv ? __ldg(row + lane) : Vec{};
  for (int g0 = 0; g0 < nv; g0 += kWarp) {    // uniform across the warp
    const int g = g0 + lane;
    const Vec v = next;
    next = g + kWarp < nv ? __ldg(row + g + kWarp) : Vec{};
    int c = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) c += __popc(word_of(v, u));
    int x = c;                                // inclusive prefix sum
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    int at = base + x - c;
    base += __shfl_sync(kFull, x, kWarp - 1);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      for (uint32_t word = word_of(v, u); word && at < kCap;
           word &= word - 1)
        list[at++] = 32 * (g * kPer + u) + __ffs(word) - 1;
  }
  if (lane == 0) cnt[k] = base;
}

// ------------------------------------------------------------ pass 2
// ORs into the warp's accumulator the set columns of each lane's row k
// (k < 0: none).  Every lane of the warp calls it; on return the warp has
// converged and the accumulator is complete.
template <bool kVec>
__device__ __forceinline__ void or_rows(int k, const uint32_t* __restrict__ r,
                                        const int* __restrict__ cnt,
                                        const int* __restrict__ lists,
                                        uint32_t* acc, int* dense_ks, int w,
                                        int lane) {
  using Vec = VecT<kVec>;
  constexpr int kPer = sizeof(Vec) / sizeof(uint32_t);
  const int c = k >= 0 ? __ldg(cnt + k) : 0;
  unsigned sparse = __ballot_sync(kFull, k >= 0 && c <= kCap);
  const unsigned dense = __ballot_sync(kFull, c > kCap);
  while (sparse) {                            // uniform: lane t takes entry t
    int col[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      col[u] = -1;
      if (sparse) {
        const int j = __ffs(static_cast<int>(sparse)) - 1;
        sparse &= sparse - 1;
        const int kj = __shfl_sync(kFull, k, j);
        const int cj = __shfl_sync(kFull, c, j);
        if (lane < cj)
          col[u] = __ldg(lists + static_cast<int64_t>(kj) * kCap + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (col[u] >= 0) atomicOr(acc + (col[u] >> 5), 1u << (col[u] & 31));
  }
  if (dense) {
    if (c > kCap) dense_ks[__popc(dense & ((1u << lane) - 1u))] = k;
    __syncwarp();                             // atomics landed, list written
    const int nd = __popc(dense);
    const int nv = w / kPer;
    Vec* accv = reinterpret_cast<Vec*>(acc);
    for (int g = lane; g < nv; g += kWarp) {  // lane owns these Vecs
      Vec v = accv[g];
      int e = 0;
      for (; e + kUnroll <= nd; e += kUnroll) {
        Vec x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldg(reinterpret_cast<const Vec*>(
                           r + static_cast<int64_t>(dense_ks[e + u]) * w) + g);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) or_into(v, x[u]);
      }
      for (; e < nd; ++e)
        or_into(v, __ldg(reinterpret_cast<const Vec*>(
                             r + static_cast<int64_t>(dense_ks[e]) * w) + g));
      accv[g] = v;
    }
  }
  __syncwarp();
}

// stride: words of shared memory per warp, the accumulator (W rounded up
// to 4) and 32 slots for the dense rows of one batch.
template <bool kVec>
__global__ void __launch_bounds__(kMaxStepWarps * kWarp)
closure_step_kernel(const uint32_t* __restrict__ r,
                                    const int* __restrict__ cnt,
                                    const int* __restrict__ lists,
                                    uint32_t* __restrict__ out, int n, int w,
                                    int stride) {
  using Vec = VecT<kVec>;
  constexpr int kPer = sizeof(Vec) / sizeof(uint32_t);
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (i >= n) return;                         // whole warps
  uint32_t* acc = smem + static_cast<int64_t>(warp) * stride;
  int* dense_ks = reinterpret_cast<int*>(acc + stride - kWarp);
  Vec* accv = reinterpret_cast<Vec*>(acc);
  const uint32_t* row = r + i * w;
  const int nv = w / kPer;
  const int ci = __ldg(cnt + i);
  if (ci <= kCap) {                           // R[i] is its list
    for (int g = lane; g < nv; g += kWarp) accv[g] = Vec{};
    const int k = lane < ci ? __ldg(lists + i * kCap + lane) : -1;
    __syncwarp();
    if (k >= 0) atomicOr(acc + (k >> 5), 1u << (k & 31));
    or_rows<kVec>(k, r, cnt, lists, acc, dense_ks, w, lane);
  } else {                                    // dense R[i]: copy and scan it
    for (int g = lane; g < nv; g += kWarp)
      accv[g] = __ldg(reinterpret_cast<const Vec*>(row) + g);
    __syncwarp();
    for (int c0 = 0; c0 < w; c0 += kWarp) {   // uniform across the warp
      uint32_t word = c0 + lane < w ? __ldg(row + c0 + lane) : 0u;
      while (__any_sync(kFull, word != 0u)) {  // a set bit per lane at once
        int k = -1;
        if (word) {
          k = 32 * (c0 + lane) + __ffs(static_cast<int>(word)) - 1;
          word &= word - 1;
        }
        or_rows<kVec>(k, r, cnt, lists, acc, dense_ks, w, lane);
      }
    }
  }
  Vec* dst = reinterpret_cast<Vec*>(out + i * w);
  for (int g = lane; g < nv; g += kWarp) dst[g] = accv[g];
}

template <bool kVec>
int launch_lists(const uint32_t* r, int* cnt, int* lists, int n, int w,
                 cudaStream_t stream) {
  row_lists_kernel<kVec><<<(n + kListWarps - 1) / kListWarps,
                           kListWarps * kWarp, 0, stream>>>(r, cnt, lists,
                                                            n, w);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_step(const uint32_t* r, uint32_t* out, int* cnt, int* lists,
                int n, int w, cudaStream_t stream) {
  if (const int code = launch_lists<kVec>(r, cnt, lists, n, w, stream))
    return code;
  cudaError_t err;
  const int stride = (w + 3) / 4 * 4 + kWarp;
  const size_t per_warp = sizeof(uint32_t) * stride;
  int dev = 0, block_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &block_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int most = static_cast<int>(
      std::min<size_t>(kMaxStepWarps, block_max / per_warp));
  if (most < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = closure_step_kernel<kVec>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(most * per_warp))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return static_cast<int>(err);
  // rows per block: the most warps resident on an SM, the larger block on
  // a tie
  int warps = 1, resident = 0;
  for (int b = 1; b <= most; ++b) {
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kernel, b * kWarp, b * per_warp)) != cudaSuccess)
      return static_cast<int>(err);
    if (blocks * b >= resident) {
      resident = blocks * b;
      warps = b;
    }
  }
  closure_step_kernel<kVec><<<(n + warps - 1) / warps, warps * kWarp,
                              warps * per_warp, stream>>>(r, cnt, lists, out,
                                                          n, w, stride);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- transpose
// Lane r holds row r of a 32 x 32 bit block (bit c: column c); on return
// lane c holds column c (bit r: row r).  Swap j exchanges bit j of the row
// index with bit j of the column index.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j; j >>= 1) {
    const uint32_t m = j == 16  ? 0x0000ffffu
                       : j == 8 ? 0x00ff00ffu
                       : j == 4 ? 0x0f0f0f0fu
                       : j == 2 ? 0x33333333u
                                : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
  }
  return x;
}

template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
transpose_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int w) {
  __shared__ uint32_t tile[kTileThreads][kTile + 1];
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const int i0 = blockIdx.x * kTile;          // row blocks of the input
  const int j0 = blockIdx.y * kTile;          // lane blocks of the input
  uint32_t x[kTile];
  const bool in_row = i0 + warp < w;          // row 32 i0 + t exists
  const uint32_t* src = in + (static_cast<int64_t>(32) * i0 + t) * w + j0;
  if (kVec && in_row && j0 + kTile <= w) {
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(src) + q);
      x[4 * q] = a.x;
      x[4 * q + 1] = a.y;
      x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      x[u] = in_row && j0 + u < w ? __ldg(src + u) : 0u;
  }
  // x[u]: bit block (i0 + warp, j0 + u); after the swap lane c holds lane
  // i0 + warp of output row 32 (j0 + u) + c
#pragma unroll
  for (int u = 0; u < kTile; ++u)
    tile[kWarp * u + lane][warp] = transpose32(x[u], lane);
  __syncthreads();
  if (j0 + warp >= w) return;                 // output row 32 j0 + t
  uint32_t* dst = out + (static_cast<int64_t>(32) * j0 + t) * w + i0;
  if (kVec && i0 + kTile <= w) {
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(tile[t][4 * q], tile[t][4 * q + 1], tile[t][4 * q + 2],
                     tile[t][4 * q + 3]);
  } else {
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      if (i0 + u < w) dst[u] = tile[t][u];
  }
}

template <bool kVec>
int launch_transpose(const uint32_t* in, uint32_t* out, int w,
                     cudaStream_t stream) {
  const int tiles = (w + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  transpose_kernel<kVec><<<dim3(tiles, tiles), kTileThreads, 0, stream>>>(
      in, out, w);
  return static_cast<int>(cudaGetLastError());
}

bool vec_ok(int w, const void* a, const void* b) {
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

extern "C" {

// r, out: (n, w) uint32 lanes, n = 32 w, out not overlapping r; cnt: (n,)
// int32; lists: (n, cap) int32 scratch, cap the kernel's kCap (32).
int rt_closure_step(const void* r, void* out, void* cnt, void* lists, int n,
                    int w, int cap, void* stream) {
  if (cap != kCap) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const uint32_t*>(r);
  auto* op = static_cast<uint32_t*>(out);
  auto* cp = static_cast<int*>(cnt);
  auto* lp = static_cast<int*>(lists);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec_ok(w, r, out) ? launch_step<true>(rp, op, cp, lp, n, w, s)
                           : launch_step<false>(rp, op, cp, lp, n, w, s);
}

// Pass 1 of closure_step alone: cnt (n,) and the (n, cap) table of r.
int rt_closure_row_lists(const void* r, void* cnt, void* lists, int n, int w,
                         int cap, void* stream) {
  if (cap != kCap) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const uint32_t*>(r);
  auto* cp = static_cast<int*>(cnt);
  auto* lp = static_cast<int*>(lists);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec_ok(w, r, r) ? launch_lists<true>(rp, cp, lp, n, w, s)
                         : launch_lists<false>(rp, cp, lp, n, w, s);
}

// in, out: (32 w, w) uint32 lanes, out not overlapping in.
int rt_transpose(const void* in, void* out, int w, void* stream) {
  const auto* ip = static_cast<const uint32_t*>(in);
  auto* op = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec_ok(w, in, out) ? launch_transpose<true>(ip, op, w, s)
                            : launch_transpose<false>(ip, op, w, s);
}

}  // extern "C"
