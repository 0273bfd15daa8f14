// CUDA kernel of the whole-graph double simulation (sm_90a), plain C
// interface.
//
// bitmm  replaces src/repro/kernels/bitmm.py bitmm_pallas (TPU kernel
//        _bitmm_kernel).
//   Y = f(unpack(A) @ X) for a bit-packed 0/1 matrix A (M rows of W
//   little-endian uint32 lanes) and a dense 0/1 matrix X (K x B, K at most
//   32 W): f is "> 0" (threshold) or the sum.  The TPU kernel unpacks a
//   tile of A in VMEM and feeds the MXU in float32; here B is the query
//   width (8 per query), so a tensor-core tile would be mostly padding.
//   Instead X^T is packed along K once per call (B rows of W lanes, bits at
//   K and above zero, so A's bits past K never count) and
//       Y[m, b] = OR_w (A[m, w] & Xt[b, w]) != 0       (threshold)
//       Y[m, b] = SUM_w popc(A[m, w] & Xt[b, w])        (sum)
//   which is exact in 32-bit integers; the threshold form needs no popcount
//   at all.  A block stages an 8-column tile of Xt in shared memory, 1,024
//   lanes of K at a time; each warp owns 4 rows of A, reads them with
//   16-byte loads (4-byte loads when W is not a multiple of 4) and keeps
//   4 x 8 accumulators in registers, which a butterfly of 31 warp shuffles
//   reduces so that lane l holds output (row l / 8, column l % 8).
//   Bound: memory, A read once per 8-column tile of B: M*W*4 bytes for
//   B <= 8 (727 MB, 0.22 ms at 3.35 TB/s on the epinions graph), plus X and
//   Y.  The integer work (AND + OR, or AND + popc + add, per lane and
//   column) sits below that at B = 8.
//
// Every launcher returns cudaGetLastError(); the caller raises if it is not
// 0.  Launches go on the caller's stream and never synchronize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kCols = 8;                    // columns of B per block
constexpr int kAcc = kRowsPerWarp * kCols;  // = kWarp: one output per lane
constexpr int kChunk = 1024;                // lanes of K per shared stage
constexpr unsigned kFull = 0xffffffffu;

static_assert(kAcc == kWarp, "one reduced output per lane");

// xt[col * w + j] bit i = (x[(32 j + i) * sk + col * sb] != 0) for
// 32 j + i < k, else 0.  One warp per output lane, built by a ballot.
__global__ void pack_xt_kernel(const uint8_t* __restrict__ x,
                               uint32_t* __restrict__ xt, int64_t k, int b,
                               int w, int64_t sk, int64_t sb) {
  const int lane = threadIdx.x % kWarp;
  const int64_t n = static_cast<int64_t>(b) * w;
  const int64_t step = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  for (int64_t g = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) / kWarp;
       g < n; g += step) {                  // uniform across the warp
    const int64_t col = g / w, j = g % w;
    const int64_t kk = 32 * j + lane;
    const bool bit = kk < k && x[kk * sk + col * sb] != 0;
    const unsigned word = __ballot_sync(kFull, bit);
    if (lane == 0) xt[g] = word;
  }
}

template <bool kSum>
__device__ __forceinline__ uint32_t combine(uint32_t acc, uint32_t v) {
  return kSum ? acc + v : (acc | v);
}

template <bool kSum>
__device__ __forceinline__ uint32_t term(uint32_t a, uint32_t x) {
  return kSum ? static_cast<uint32_t>(__popc(a & x)) : (a & x);
}

// Butterfly reduction of kAcc = 32 per-lane values over the warp: at
// offset o each lane keeps the half of its values whose index has bit o
// equal to its own lane's and combines it with its partner's copy; after
// 16 + 8 + 4 + 2 + 1 shuffles lane l holds in acc[0] the warp-wide total of
// value index l.  Templated on the step so that every index is static and
// acc stays in registers.
template <bool kSum, int kN>
__device__ __forceinline__ void butterfly(uint32_t (&acc)[kAcc], int lane) {
  if constexpr (kN >= 1) {
    const bool upper = (lane & kN) != 0;    // offset kN: kAcc == kWarp
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const uint32_t send = upper ? acc[i] : acc[i + kN];
      const uint32_t keep = upper ? acc[i + kN] : acc[i];
      acc[i] = combine<kSum>(keep, __shfl_xor_sync(kFull, send, kN));
    }
    butterfly<kSum, kN / 2>(acc, lane);
  }
}

template <bool kVec, bool kSum>
__global__ void __launch_bounds__(kThreads)
bitmm_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ xt,
             void* __restrict__ y, int m, int w, int b) {
  __shared__ __align__(16) uint32_t xs[kCols][kChunk];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b0 = blockIdx.y * kCols;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kRowsPerWarp;

  const uint32_t* rp[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    live[r] = row0 + r < m;
    rp[r] = a + (live[r] ? row0 + r : 0) * static_cast<int64_t>(w);
  }
  uint32_t acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0u;

  for (int k0 = 0; k0 < w; k0 += kChunk) {  // uniform across the block
    const int kc = min(kChunk, w - k0);
    __syncthreads();                        // last stage's readers are done
    for (int i = threadIdx.x; i < kCols * kChunk; i += kThreads) {
      const int c = i / kChunk, j = i % kChunk;
      xs[c][j] = (b0 + c < b && j < kc)
                     ? xt[static_cast<int64_t>(b0 + c) * w + k0 + j]
                     : 0u;
    }
    __syncthreads();
    if (kVec) {                             // kc is a multiple of 4
      for (int g = lane; g < kc / 4; g += kWarp) {
        uint4 av[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          av[r] = live[r]
                      ? __ldg(reinterpret_cast<const uint4*>(rp[r] + k0) + g)
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint4 xv = reinterpret_cast<const uint4*>(xs[c])[g];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            uint32_t& s = acc[r * kCols + c];
            s = combine<kSum>(s, term<kSum>(av[r].x, xv.x));
            s = combine<kSum>(s, term<kSum>(av[r].y, xv.y));
            s = combine<kSum>(s, term<kSum>(av[r].z, xv.z));
            s = combine<kSum>(s, term<kSum>(av[r].w, xv.w));
          }
        }
      }
    } else {
      for (int j = lane; j < kc; j += kWarp) {
        uint32_t av[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          av[r] = live[r] ? __ldg(rp[r] + k0 + j) : 0u;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t xv = xs[c][j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            uint32_t& s = acc[r * kCols + c];
            s = combine<kSum>(s, term<kSum>(av[r], xv));
          }
        }
      }
    }
  }

  butterfly<kSum, kAcc / 2>(acc, lane);
  const int r = lane / kCols, c = lane % kCols;
  const int64_t row = row0 + r;
  if (row < m && b0 + c < b) {
    const int64_t at = row * b + b0 + c;
    if (kSum)
      static_cast<float*>(y)[at] = static_cast<float>(acc[0]);
    else
      static_cast<uint8_t*>(y)[at] = acc[0] != 0u;
  }
}

template <bool kVec, bool kSum>
void launch(const uint32_t* a, const uint32_t* xt, void* y, int m, int w,
            int b, cudaStream_t stream) {
  const dim3 grid((m + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp),
                  (b + kCols - 1) / kCols);
  bitmm_kernel<kVec, kSum><<<grid, kThreads, 0, stream>>>(a, xt, y, m, w, b);
}

}  // namespace

extern "C" {

int rt_bitmm_pack(const void* x, void* xt, int64_t k, int b, int w,
                  int64_t sk, int64_t sb, void* stream) {
  const int64_t warps = static_cast<int64_t>(b) * w;
  const int64_t blocks =
      (warps + kWarps - 1) / kWarps < 65535 ? (warps + kWarps - 1) / kWarps
                                            : 65535;
  pack_xt_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint32_t*>(xt), k, b, w, sk,
      sb);
  return static_cast<int>(cudaGetLastError());
}

int rt_bitmm(const void* a, const void* xt, void* y, int m, int w, int b,
             int sum, void* stream) {
  const auto* ap = static_cast<const uint32_t*>(a);
  const auto* xp = static_cast<const uint32_t*>(xt);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (vec && sum) launch<true, true>(ap, xp, y, m, w, b, s);
  else if (vec) launch<true, false>(ap, xp, y, m, w, b, s);
  else if (sum) launch<false, true>(ap, xp, y, m, w, b, s);
  else launch<false, false>(ap, xp, y, m, w, b, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
