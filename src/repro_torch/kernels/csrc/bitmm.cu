// CUDA kernel of the whole-graph double simulation (sm_90a), plain C
// interface.
//
// bitmm  replaces src/repro/kernels/bitmm.py bitmm_pallas (TPU kernel
//        _bitmm_kernel).
//   Y = f(unpack(A) @ X) for a bit-packed 0/1 matrix A (M rows of W
//   little-endian uint32 lanes) and a dense 0/1 matrix X (K x B, K at most
//   32 W): f is "> 0" (threshold) or the sum.  The TPU kernel unpacks a
//   tile of A in VMEM and feeds the MXU in float32; this one unpacks A in
//   registers and feeds Hopper's int8 tensor cores.
//
//   Floors at the serve shape (M = K = 76,288, W = 2,384, B = 64):
//     bytes: A read once plus X and Y, 737 MB          0.220 ms at 3.35 TB/s
//     CUDA cores: M*W*B = 1.16e10 lop3 (AND + OR)      0.70 ms at 132 SMs x
//                 64 results a clock x 1.98 GHz; the sum's popc is 4x slower
//     int8 tensor cores: 2*M*K*B = 7.45e11 ops         0.376 ms at 1,979 TOP/s
//   Only the tensor cores can reach the bytes floor, so the product runs
//   there.  Every sum is at most 128 K (threshold) or K (sum), exact in
//   int32 for the K < 2^24 that the wrapper admits.
//
//   The kernel it replaces staged an 8-column tile of X per block, so A
//   was read from device memory once per 8 columns: 8 times at B = 64
//   (5.82 GB).  Here one block owns a tile of A's rows and every column of
//   B up to 256 (padded to the MMA width N = 32, 64 or 256 with zero
//   columns), so A is read once per call for B <= 256; a larger B takes
//   ceil(B / 256) column tiles (grid.y), each reading A again.
//
//   Design.  A block is two warpgroups; each owns MT tiles of 64 rows
//   (MT = 3 for N <= 64, else 1) with int32 accumulators in registers.  The
//   block walks K in stages of 16 lanes of A (8 for N = 256), through a
//   ring of 3-6 shared-memory stages (as many as fit) whose loads are
//   issued two stages behind the ring's end, so that they overlap the
//   products of the stages before them.  One thread issues each stage as
//   TMA copies that complete on the stage's mbarrier; out-of-range rows,
//   lanes and columns arrive as zeros.  Where W is not a multiple of 4 or
//   A is not 16-byte aligned (no tensor map of A exists), A's stages come
//   instead from 4-byte cp.async copies of every thread.
//     A   stays packed in shared memory, rows of 16 (8) words in the TMA's
//         64-byte (32-byte) swizzle, so that a fragment load of 8 rows hits
//         every bank once.  Each thread expands its own wgmma A fragment in
//         registers, a nibble of a word into four bytes: by a multiply and
//         a mask into 0/1 (sum), or by a byte permute and a mask into the
//         bits in place (threshold: 0 or a power of 2 up to 128 as u8, whose
//         sums are 0 exactly when the 0/1 sums are).  The unpacked A never
//         exists in memory.
//     X   arrives as X^T, K-major 0/1 bytes (B rows of 32 W bytes, zero at
//         columns K and above, so A's bits past K multiply zeros): the
//         simulation's own bool operand, or a copy the wrapper makes.  A
//         stage holds it as blocks of N rows x 128 bytes in the 128-byte
//         swizzle, the layout wgmma reads.
//   wgmma.mma_async m64nNk32 .s32.u8.u8 takes A from registers and X from
//   shared memory in groups of four k-steps (128 columns); two sets of
//   fragments let one group run while the next is built.  The epilogue
//   writes acc > 0 as bool (threshold) or the float32 count (sum).
//
// Every launcher returns cudaGetLastError() (or the error of setting the
// kernel's shared-memory limit, or cudaErrorInvalidValue when a tensor map
// cannot be made); the caller raises if it is not 0.
// Launches go on the caller's stream and never synchronize.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (no link to libcuda)
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // two warpgroups
constexpr int kSteps = 4;                   // k-steps of 32 a wgmma group
constexpr int kSmemCap = 232448;            // shared memory a block can use
constexpr int kMaxStages = 6;
constexpr int kMaxN = 256;
constexpr int kSwizzle = 128;               // bytes of K in a swizzle row
constexpr int kAtom = 8 * kSwizzle;         // one 8-row swizzle atom

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared; bytes past `valid` (0 or 4) are zero.
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Orders this thread's shared-memory writes before wgmma's reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies to complete.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box of `map` at (c0, c1) (innermost first) into shared memory;
// its bytes count towards `bar`.  Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address and the stride between 8-row atoms (1,024 B), in
// 16-byte units; the leading offset is unused in this mode.
__device__ __forceinline__ uint64_t descriptor(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtom >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D(64 x N, int32) += A(64 x 32, u8, registers) * B(32 x N, u8, shared).
__device__ __forceinline__ void mma(uint32_t (&d)[16],
                                    const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void mma(uint32_t (&d)[32],
                                    const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void mma(uint32_t (&d)[128],
                                    const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Keeps the compiler from moving reads or writes of d across this point
// (the wgmma that writes d runs asynchronously).
template <int kN>
__device__ __forceinline__ void hold(uint32_t (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Four bytes from the nibble of w at bit 4 q (q = 0..7), byte i non-zero
// exactly when bit 4 q + i is set.  Sum: the byte is the bit (0 or 1), by
// a multiply and a mask.  Threshold: the byte is the bit in place
// (0 or 2^(4 (q % 2) + i), at most 128 as u8), by a byte permute and a
// mask: a sum of such terms is 0 exactly when the 0/1 sum is.
template <bool kSum>
__device__ __forceinline__ uint32_t expand(uint32_t w, int q) {
  if (kSum) return (((w >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
  return __byte_perm(w, 0u, 0x1111u * (q >> 1)) &
         (0x08040201u << (4 * (q & 1)));
}

template <int N>
struct Tile {
  static constexpr int kMT = N <= 64 ? 3 : 1;        // 64-row tiles a group
  static constexpr int kRows = 2 * 64 * kMT;         // rows of A a block
  static constexpr int kABoxes = (kRows + 255) / 256;  // TMA boxes of A
  static constexpr int kLanes = N <= 64 ? 16 : 8;    // lanes of A a stage
  static constexpr int kKBytes = 32 * kLanes;        // bytes of an X^T row
  static constexpr int kGroups = kLanes / kSteps;    // wgmma groups a stage
  static constexpr int kXBytes = N * kKBytes;        // one X stage
  static constexpr int kAWords = kRows * kLanes;     // one A stage
  static constexpr int kStageBytes = kXBytes + 4 * kAWords;
  // a ring of stages, loads issued kAhead stages ahead: the slot a load
  // fills was last read two stages back, whose wgmma groups are done
  static constexpr int kStages =
      (kSmemCap - 64) / kStageBytes < kMaxStages
          ? (kSmemCap - 64) / kStageBytes
          : kMaxStages;
  static constexpr int kAhead = kStages - 2;
  static constexpr int kSmem = kStages * kStageBytes + 8 * kStages;
  static_assert(kStages >= 3, "a stage does not fit three times");
};

// Word offset of lane j of tile row r in an A stage of kLanes words a row:
// the 16-byte chunks of a row are permuted (XOR) so that the 8 rows a
// fragment load reads at once fill the 128 bytes of the banks once.  This
// is the TMA's 64-byte (kLanes 16) or 32-byte (kLanes 8) swizzle.
template <int kLanes>
__device__ __forceinline__ int a_slot(int r, int j) {
  constexpr int kChunks = kLanes / 4, kRowsPer128 = 128 / (4 * kLanes);
  const int c = (j >> 2) ^ ((r / kRowsPer128) & (kChunks - 1));
  return r * kLanes + (c << 2) + (j & 3);
}

// kVec: A's stages arrive by TMA (W % 4 == 0, A 16-byte aligned); else by
// 4-byte cp.async copies of every thread.  X^T always arrives by TMA.
template <int N, bool kVec, bool kSum>
__global__ void __launch_bounds__(kThreads)
bitmm_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap amap,
             const uint32_t* __restrict__ a, void* __restrict__ y, int m,
             int w, int b) {
  using T = Tile<N>;
  constexpr int kMT = T::kMT, kRows = T::kRows, kStages = T::kStages,
                kAhead = T::kAhead, kLanes = T::kLanes,
                kKBytes = T::kKBytes, kGroups = T::kGroups;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* xs = smem;                                       // [stage][X]
  uint32_t* as = reinterpret_cast<uint32_t*>(smem + kStages * T::kXBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages *
                                               T::kStageBytes);

  const int tid = threadIdx.x;
  const int group = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * N;
  const int cols = min(N, b - col0);          // live columns of this tile
  const int stages = (w + kLanes - 1) / kLanes;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
    bar_init_fence();
  }
  __syncthreads();

  // Stage kt into ring slot `slot`: X^T as kKBytes / 128 boxes of N rows
  // x 128 bytes in the 128-byte swizzle (wgmma's layout), A as kABoxes
  // boxes of rows x kLanes words.  One thread issues the TMA copies.
  auto fetch = [&](int slot, int kt) {
    uint8_t* xd = xs + slot * T::kXBytes;
    bar_expect(&full[slot], kVec ? T::kStageBytes : T::kXBytes);
#pragma unroll
    for (int kb = 0; kb < kKBytes / kSwizzle; ++kb)
      tma_load(xd + kb * N * kSwizzle, &xmap, kt * kKBytes + kb * kSwizzle,
               col0, &full[slot]);
    if (kVec) {
      constexpr int kBoxRows = kRows / T::kABoxes;
#pragma unroll
      for (int i = 0; i < T::kABoxes; ++i)
        tma_load(as + slot * T::kAWords + i * kBoxRows * kLanes, &amap,
                 kt * kLanes, row0 + i * kBoxRows, &full[slot]);
    }
  };
  // A's stage by 4-byte copies (the ragged path), zeros out of range.
  auto copy_a = [&](int slot, int kt) {
    uint32_t* ad = as + slot * T::kAWords;
    for (int i = tid; i < kRows * kLanes; i += kThreads) {
      const int r = i / kLanes, j = i % kLanes, lane_j = kt * kLanes + j;
      const bool ok = row0 + r < m && lane_j < w;
      copy4(ad + a_slot<kLanes>(r, j),
            ok ? a + static_cast<int64_t>(row0 + r) * w + lane_j : a,
            ok ? 4 : 0);
    }
  };

  uint32_t acc[kMT][N / 2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0u;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) hold(acc[mt]);

  // (the ragged path commits one copy group a stage, empty past the end,
  // so that stage kt's group is always kAhead - 1 groups back)
  for (int s = 0; s < kAhead; ++s) {
    if (s < stages) {
      if (tid == 0) fetch(s, s);
      if (!kVec) copy_a(s, s);
    }
    if (!kVec) copy_commit();
  }
  // Two sets of A fragments: one group's wgmmas read one set while the
  // next group's set is built; at most one group is in flight after each
  // wait.
  uint32_t frag[2][kMT][kSteps][4];
  for (int kt = 0; kt < stages; ++kt) {
    if (!kVec) {
      copy_wait<kAhead - 1>();                // stage kt's copies landed
      fence_async_shared();
    }
    __syncthreads();          // every thread is past stage kt - 2's slot
    if (kt + kAhead < stages) {
      if (tid == 0) fetch((kt + kAhead) % kStages, kt + kAhead);
      if (!kVec) copy_a((kt + kAhead) % kStages, kt + kAhead);
    }
    if (!kVec) copy_commit();
    const int slot = kt % kStages;
    bar_wait(&full[slot], (kt / kStages) & 1);

    const uint32_t* at = as + slot * T::kAWords;
    const uint8_t* xb = xs + slot * T::kXBytes;
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      // A fragment of k-step s (lane 4 h + s): rows g and g + 8 of the
      // warp's 16, columns 4t..4t+3 and 16+4t..16+4t+3 of the lane.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = (group * kMT + mt) * 64 + warp * 16 + g;
        const uint4 lo =
            *reinterpret_cast<const uint4*>(at + a_slot<kLanes>(r, 4 * h));
        const uint4 hi = *reinterpret_cast<const uint4*>(
            at + a_slot<kLanes>(r + 8, 4 * h));
        const uint32_t wl[kSteps] = {lo.x, lo.y, lo.z, lo.w};
        const uint32_t wh[kSteps] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          frag[h & 1][mt][s][0] = expand<kSum>(wl[s], t);
          frag[h & 1][mt][s][1] = expand<kSum>(wh[s], t);
          frag[h & 1][mt][s][2] = expand<kSum>(wl[s], 4 + t);
          frag[h & 1][mt][s][3] = expand<kSum>(wh[s], 4 + t);
        }
      }
      mma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int k = 32 * (h * kSteps + s);   // byte of the stage row
        const uint64_t desc = descriptor(xb + k / kSwizzle * N * kSwizzle +
                                         k % kSwizzle);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma(acc[mt], frag[h & 1][mt][s], desc);
      }
      mma_commit();
      mma_wait<1>();
    }
  }
  mma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) hold(acc[mt]);

  // acc[mt][4i + 2e + c]: row g + 8e of the warp's 16, column 8i + 2t + c.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int rbase = row0 + (group * kMT + mt) * 64 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = rbase + 8 * e;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * i + 2 * t + c;
          if (row < m && col < cols) {
            const uint32_t v = acc[mt][4 * i + 2 * e + c];
            const int64_t at_out = static_cast<int64_t>(row) * b + col0 + col;
            if (kSum)
              static_cast<float*>(y)[at_out] = static_cast<float>(v);
            else
              static_cast<uint8_t*>(y)[at_out] = v != 0u;
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tiled tensor map: `inner` x `outer` elements of `elem` bytes,
// rows `stride` bytes apart, boxes of box_inner x box_outer; out-of-range
// elements read as zero.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                uint64_t inner, uint64_t outer, uint64_t stride,
                uint32_t box_inner, uint32_t box_outer,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, bool kVec, bool kSum>
int launch(const uint32_t* a, const uint8_t* xt, void* y, int m, int w,
           int b, int64_t ldx, cudaStream_t stream) {
  using T = Tile<N>;
  CUtensorMap xmap, amap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xt, 32 * w, b, ldx,
                  kSwizzle, N, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  amap = xmap;                      // unused unless A arrives by TMA
  if (kVec && !tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT32, a, w, m,
                          4 * static_cast<uint64_t>(w), T::kLanes,
                          T::kRows / T::kABoxes,
                          T::kLanes == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      bitmm_kernel<N, kVec, kSum>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + T::kRows - 1) / T::kRows, (b + N - 1) / N);
  bitmm_kernel<N, kVec, kSum>
      <<<grid, kThreads, T::kSmem, stream>>>(xmap, amap, a, y, m, w, b);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, bool kSum>
int launch_n(const uint32_t* a, const uint8_t* xt, void* y, int m, int w,
             int b, int64_t ldx, cudaStream_t stream) {
  if (b <= 32) return launch<32, kVec, kSum>(a, xt, y, m, w, b, ldx, stream);
  if (b <= 64) return launch<64, kVec, kSum>(a, xt, y, m, w, b, ldx, stream);
  return launch<kMaxN, kVec, kSum>(a, xt, y, m, w, b, ldx, stream);
}

}  // namespace

extern "C" {

// a: (m, w) uint32 lanes; xt: X^T as 0/1 bytes, b rows of 32 w bytes,
// ldx bytes apart (a multiple of 16, 16-byte aligned start), zero at
// columns k..32w-1; y: (m, b) bool (sum = 0) or float32 (sum = 1).
int rt_bitmm(const void* a, const void* xt, void* y, int m, int w, int b,
             int64_t ldx, int sum, void* stream) {
  const auto* ap = static_cast<const uint32_t*>(a);
  const auto* xp = static_cast<const uint8_t*>(xt);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (vec && sum) return launch_n<true, true>(ap, xp, y, m, w, b, ldx, s);
  if (vec) return launch_n<true, false>(ap, xp, y, m, w, b, ldx, s);
  if (sum) return launch_n<false, true>(ap, xp, y, m, w, b, ldx, s);
  return launch_n<false, false>(ap, xp, y, m, w, b, ldx, s);
}

}  // extern "C"
