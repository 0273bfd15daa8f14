// CUDA kernels of the frontier MJoin executors (sm_90a), plain C interface.
//
// Lanes are the packed uint32 words of the host bitsets: bit i of a
// universe lives in lane i >> 5 at position i & 31 (little-endian).
//
// gather_intersect  replaces src/repro/kernels/gather_intersect.py
//                   gather_intersect_pallas (TPU kernel _gather_intersect_kernel).
//   For each of F frontier rows: gather K rows of the resident matrix
//   (R, W), AND them over the first w32 lanes, popcount.  One warp per
//   frontier row, 16-byte loads across lanes, the AND kept in registers,
//   __popc and a warp-shuffle sum.  Only the w32 live lanes are read:
//   every constraint row of a level lives in the same universe and
//   resident rows are zero past their width.  The warp resolves its row
//   pointers into shared memory kMaxK at a time; a K above kMaxK is ANDed
//   chunk by chunk into the output row, so K has no limit.  Bound: memory,
//   each distinct gathered row once (D*w32*4 bytes for D distinct indices)
//   plus the index, the AND rows and the counts, F*(K + w32 + 1)*4 bytes.
//
// intersect         replaces src/repro/kernels/intersect.py intersect_pallas
//                   (TPU kernel _intersect_kernel).
//   The same body over a shipped (F, K, W) slab, its rows addressed
//   directly (no pointer table, any K).  Bound: memory,
//   F*(K*W + W + 1)*4 bytes.
//
// row_counts + expand_write  replace src/repro/kernels/gather_intersect.py
//                   expand_pairs (plain XLA on the TPU: unpack + nonzero).
//   Set bits below column n_i -> the first `size` (row, col) pairs in
//   row-major order, zero-filled.  Pass 1 counts each row's bits below
//   n_i (bits at >= n_i do not count); the caller takes the inclusive
//   scan of the counts; pass 2 gives each row one warp that walks its
//   lanes 32 at a time, places each lane's bits by a warp prefix sum and
//   stops at `size`.  Unlike torch.nonzero it never syncs with the host
//   and its output size is bounded.  Bound: memory, F*w32*4 bytes read
//   (once per pass) plus 2*size*4 bytes written.
//
// Every launcher returns cudaGetLastError(); the caller raises if it is
// not 0.  Launches go on the caller's stream and never synchronize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;            // one warp per frontier row
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kMaxK = kWarp;                // row pointers per shared chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// AND of the k rows p(0..k) over lanes [0, w), written to out (ANDed into
// what out already holds when `into`: a later chunk of K); returns this
// thread's share of the popcount of out.  Each thread reads back only
// lanes it wrote itself.  Rows are 16-byte aligned, out is 8-byte aligned
// (w even).
template <typename RowPtr>
__device__ __forceinline__ int and_popc_row(RowPtr p, int k, int w,
                                            uint32_t* out, int lane,
                                            bool into) {
  int cnt = 0;
  const int chunks = w >> 2;                // whole 4-lane (16-byte) chunks
  for (int c = lane; c < chunks; c += kWarp) {
    uint2* o = reinterpret_cast<uint2*>(out + 4 * c);
    uint4 acc;
    int j = 0;
    if (into) {
      const uint2 lo = o[0], hi = o[1];
      acc = make_uint4(lo.x, lo.y, hi.x, hi.y);
    } else {
      acc = __ldg(reinterpret_cast<const uint4*>(p(0)) + c);
      j = 1;
    }
    for (; j < k; ++j) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p(j)) + c);
      acc.x &= v.x; acc.y &= v.y; acc.z &= v.z; acc.w &= v.w;
    }
    o[0] = make_uint2(acc.x, acc.y);
    o[1] = make_uint2(acc.z, acc.w);
    cnt += __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
  }
  for (int t = 4 * chunks + lane; t < w; t += kWarp) {   // ragged tail
    uint32_t acc = into ? out[t] : __ldg(p(0) + t);
    for (int j = into ? 0 : 1; j < k; ++j) acc &= __ldg(p(j) + t);
    out[t] = acc;
    cnt += __popc(acc);
  }
  return cnt;
}

__global__ void __launch_bounds__(kThreads)
gather_intersect_kernel(const uint32_t* __restrict__ matrix,
                        const int32_t* __restrict__ idx,
                        uint32_t* __restrict__ and_rows,
                        int32_t* __restrict__ counts,
                        int64_t w_all, int f, int k, int w32) {
  __shared__ const uint32_t* ptrs[kRowsPerBlock][kMaxK];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= f) return;                     // uniform across the warp
  const uint32_t* const* tab = ptrs[warp];
  uint32_t* out = and_rows + row * w32;
  int cnt = 0;
  for (int j0 = 0; j0 < k; j0 += kMaxK) {   // uniform across the warp
    const int kc = min(kMaxK, k - j0);
    __syncwarp();                           // last chunk's readers are done
    if (lane < kc)
      ptrs[warp][lane] =
          matrix + static_cast<int64_t>(idx[row * k + j0 + lane]) * w_all;
    __syncwarp();
    cnt = and_popc_row([tab](int j) { return tab[j]; }, kc, w32, out, lane,
                       j0 > 0);
  }
  cnt = warp_sum(cnt);
  if (lane == 0) counts[row] = cnt;
}

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const uint32_t* __restrict__ rows,
                 uint32_t* __restrict__ and_rows,
                 int32_t* __restrict__ counts, int f, int k, int w) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= f) return;
  const uint32_t* base = rows + row * k * static_cast<int64_t>(w);
  const int cnt = warp_sum(and_popc_row(
      [base, w](int j) { return base + static_cast<int64_t>(j) * w; }, k, w,
      and_rows + row * w, lane, false));
  if (lane == 0) counts[row] = cnt;
}

// lane t's bits that lie below column n_i
__device__ __forceinline__ uint32_t live_bits(uint32_t v, int t, int n_i) {
  const int rem = n_i - 32 * t;             // > 0 for every live lane
  return rem >= 32 ? v : (v & ((1u << rem) - 1u));
}

__global__ void __launch_bounds__(kThreads)
row_counts_kernel(const uint32_t* __restrict__ rows,
                  int32_t* __restrict__ counts, int f, int w, int n_i) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= f) return;
  const uint32_t* r = rows + row * w;
  const int live = min(w, (n_i + 31) / 32);
  int cnt = 0;
  for (int t = lane; t < live; t += kWarp) cnt += __popc(live_bits(r[t], t, n_i));
  cnt = warp_sum(cnt);
  if (lane == 0) counts[row] = cnt;
}

__global__ void __launch_bounds__(kThreads)
expand_write_kernel(const uint32_t* __restrict__ rows,
                    const int32_t* __restrict__ counts,
                    const int64_t* __restrict__ incl,
                    int32_t* __restrict__ rid, int32_t* __restrict__ cid,
                    int f, int w, int n_i, int64_t size) {
  // zero fill past the last pair, grid-stride over every thread
  const int64_t total = incl[f - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = total + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < size; p += stride) {
    rid[p] = 0;
    cid[p] = 0;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= f) return;
  int64_t base = incl[row] - counts[row];   // this row's first pair slot
  if (counts[row] == 0 || base >= size) return;
  const uint32_t* r = rows + row * w;
  const int live = min(w, (n_i + 31) / 32);
  for (int t0 = 0; t0 < live; t0 += kWarp) {  // uniform across the warp
    const int t = t0 + lane;
    uint32_t v = t < live ? live_bits(r[t], t, n_i) : 0u;
    const int c = __popc(v);
    int incl_c = c;                           // inclusive warp prefix sum
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int n = __shfl_up_sync(kFull, incl_c, o);
      if (lane >= o) incl_c += n;
    }
    int64_t pos = base + incl_c - c;
    while (v != 0u && pos < size) {
      const int b = __ffs(v) - 1;
      v &= v - 1u;
      rid[pos] = static_cast<int32_t>(row);
      cid[pos] = 32 * t + b;
      ++pos;
    }
    base += __shfl_sync(kFull, incl_c, kWarp - 1);
    if (base >= size) break;
  }
}

inline unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" {

int rt_gather_intersect(const void* matrix, const void* idx, void* and_rows,
                        void* counts, int64_t w_all, int f, int k, int w32,
                        void* stream) {
  gather_intersect_kernel<<<blocks_for(f), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(matrix), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(and_rows), static_cast<int32_t*>(counts), w_all,
      f, k, w32);
  return static_cast<int>(cudaGetLastError());
}

int rt_intersect(const void* rows, void* and_rows, void* counts, int f, int k,
                 int w, void* stream) {
  intersect_kernel<<<blocks_for(f), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<uint32_t*>(and_rows),
      static_cast<int32_t*>(counts), f, k, w);
  return static_cast<int>(cudaGetLastError());
}

int rt_row_counts(const void* rows, void* counts, int f, int w, int n_i,
                  void* stream) {
  row_counts_kernel<<<blocks_for(f), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(counts), f, w,
      n_i);
  return static_cast<int>(cudaGetLastError());
}

int rt_expand_write(const void* rows, const void* counts, const void* incl,
                    void* rid, void* cid, int f, int w, int n_i, int64_t size,
                    void* stream) {
  expand_write_kernel<<<blocks_for(f), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(incl), static_cast<int32_t*>(rid),
      static_cast<int32_t*>(cid), f, w, n_i, size);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
