// CUDA kernel of the on-device reachability closure (sm_90a), plain C
// interface.
//
// closure_step  replaces src/repro/kernels/closure.py closure_step_pallas
//               (TPU kernel _closure_kernel).
//   R' = R | (R·R > 0) for a square 0/1 matrix R of N rows packed into
//   W = N / 32 little-endian uint32 lanes per row; repeated, it yields the
//   transitive closure.  The TPU kernel unpacks tiles of R and multiplies
//   them densely on the MXU: N·N·W word operations per step whatever the
//   data (1.39e13 at the epinions graph, N = 76,288).  A reachability
//   matrix of a sparse graph is itself sparse (about 14 set bits a row
//   there), so this kernel takes the row-OR form of the same function:
//       R'[i] = R[i] | OR_{k : R[i, k] = 1} R[k]
//   One block per output row i.  Its W-lane accumulator lives in shared
//   memory, initialised to R[i]; each thread owns the same lanes of it
//   throughout, so the accumulator needs no barrier.  The block scans R[i]
//   one chunk of 256 lanes at a time: a chunk with no set bit costs one
//   barrier; otherwise a block-wide prefix sum of the lanes' popcounts
//   places every set bit's column k in a shared list (at most 32 * 256
//   entries, so a dense row cannot overflow it), and the block ORs each
//   listed row R[k] into the accumulator with coalesced 16-byte loads
//   (4-byte loads when W is not a multiple of 4), four rows in flight.
//   The output is a second buffer: other blocks are still reading R[k].
//   Bound: memory.  R read once and R' written once is 2·N·W·4 bytes
//   (1.45 GB, 0.434 ms at 3.35 TB/s at epinions); the listed rows add
//   nnz(R)·W·4 bytes of reads, partly from L2.  Limit: a graph whose
//   closure is dense (a giant strongly connected component) makes it read
//   about N·N·W words, more than the dense product's tensor-core form
//   would cost.
//
// Every launcher returns cudaGetLastError() (or the error of setting the
// kernel's shared-memory limit); the caller raises if it is not 0.
// Launches go on the caller's stream and never synchronize.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kListCap = 32 * kThreads;     // every bit of one lane chunk
constexpr int kUnroll = 4;                  // listed rows loaded at once
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;   // inclusive, per warp
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

__device__ __forceinline__ void or_into(uint32_t& a, const uint32_t& b) {
  a |= b;
}

// kVec: lanes moved as uint4 (W a multiple of 4, both buffers 16-byte
// aligned); else as uint32.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
closure_step_kernel(const uint32_t* __restrict__ r, uint32_t* __restrict__ out,
                    int w) {
  using Vec = typename std::conditional<kVec, uint4, uint32_t>::type;
  constexpr int kPer = kVec ? 4 : 1;        // lanes per Vec
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int warp_sums[kWarps];
  const int wp = (w + 3) / 4 * 4;
  Vec* acc = reinterpret_cast<Vec*>(smem);
  int* list = reinterpret_cast<int*>(smem + wp);
  const int tid = threadIdx.x;
  const int64_t i = blockIdx.x;
  const uint32_t* row = r + i * w;
  const int nv = w / kPer;                  // Vecs per row

  for (int g = tid; g < nv; g += kThreads)
    acc[g] = reinterpret_cast<const Vec*>(row)[g];

  for (int c0 = 0; c0 < w; c0 += kThreads) {  // uniform across the block
    const int j = c0 + tid;
    uint32_t word = j < w ? __ldg(row + j) : 0u;
    if (!__syncthreads_or(word != 0u)) continue;
    int total;
    int at = block_exclusive_scan(__popc(word), warp_sums, &total);
    while (word) {
      list[at++] = 32 * j + __ffs(word) - 1;
      word &= word - 1;
    }
    __syncthreads();
    for (int g = tid; g < nv; g += kThreads) {
      Vec v = acc[g];
      int e = 0;
      for (; e + kUnroll <= total; e += kUnroll) {
        Vec x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldg(reinterpret_cast<const Vec*>(
                           r + static_cast<int64_t>(list[e + u]) * w) + g);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) or_into(v, x[u]);
      }
      for (; e < total; ++e)
        or_into(v, __ldg(reinterpret_cast<const Vec*>(
                             r + static_cast<int64_t>(list[e]) * w) + g));
      acc[g] = v;
    }
    __syncthreads();                        // list and warp_sums reused
  }

  Vec* dst = reinterpret_cast<Vec*>(out + i * w);
  for (int g = tid; g < nv; g += kThreads) dst[g] = acc[g];
}

template <bool kVec>
int launch(const uint32_t* r, uint32_t* out, int n, int w,
           cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * ((w + 3) / 4 * 4 + kListCap);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        closure_step_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  closure_step_kernel<kVec><<<n, kThreads, smem, stream>>>(r, out, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, out: (n, w) uint32 lanes, n = 32 w, out not overlapping r.
int rt_closure_step(const void* r, void* out, int n, int w, void* stream) {
  const auto* rp = static_cast<const uint32_t*>(r);
  auto* op = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<true>(rp, op, n, w, s) : launch<false>(rp, op, n, w, s);
}

}  // extern "C"
