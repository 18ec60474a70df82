// Hopper (sm_90a) building blocks shared by the hand-written conv kernels
// (conv3d_bn_relu.cu, conv3d_wgrad.cu): 16-byte cp.async with zero-fill, an mbarrier
// ring between one producer warpgroup and the consumer warpgroups, wgmma operand
// descriptors for 128- and 64-byte swizzled shared-memory tiles, and wgmma
// m64nNk16 (bf16 in, f32 accumulators) for N = 32, 64, 128 and 256.
//
// Shared-memory tiles are written by cp.async, 16 bytes (8 bf16) at a time, each chunk
// at its swizzled address, so that wgmma reads them without bank conflicts. Two tile
// forms are used (bf16 elements; a K-row is one step of the GEMM's reduction):
//   MnTile<ROWS, W, AW>: ROWS K-rows of W elements, the W (M or N) elements contiguous
//     ("MN-major", wgmma's transpose bit set). Stored as swizzle atoms of 8 K-rows x AW
//     elements, AW = 64 (128-byte rows, 128-byte swizzle; the default from W = 64 on)
//     or 32 (64-byte rows, 64-byte swizzle); the atoms of one AW-wide column follow each
//     other along K (stride ATOM: the descriptor's SBO), columns are ATOM_COL apart
//     (the descriptor's LBO).
//   KTile<ROWS>: ROWS M-rows of 64 K elements (128 bytes, "K-major"), 128-byte swizzle,
//     8-row atoms of 1,024 bytes (SBO); a k16 step is a 32-byte advance of the start.
// Both need their base 1,024-byte aligned: the hardware swizzles on address bits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hopper {

// n / d for n < 2^31 by a multiply and a shift (a runtime division costs tens of
// instructions): m = ceil(2^k / d) with k = 31 + ceil(log2 d) is exact over that range,
// since n * (m * d - 2^k) < 2^31 * d <= 2^k.
struct FastDiv {
  uint64_t m;
  int k;
  __host__ explicit FastDiv(uint32_t d = 1) {
    int c = 0;
    while ((1ull << c) < d) ++c;
    k = 31 + c;
    m = ((1ull << k) + d - 1) / d;
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const { return (uint32_t)(((uint64_t)n * m) >> k); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; when !valid, reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// The same, keeping the line in L1 as well: for data that the block copies again soon.
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Named barrier over `threads` threads (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Writes made through the generic proxy (cp.async) become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ring of STAGES shared-memory slots between the producer warps and the consumer
// warpgroups. full[s] completes when the copies into slot s have landed,
// empty[s] when every consumer warp has released it. Iteration `it` uses slot
// it % STAGES in round it / STAGES; a barrier's phase parity counts the rounds. Only
// lane 0 of a warp arrives on a barrier, after __syncwarp: arrivals on one mbarrier
// are serialised, and one per thread (128 per producer step, 128 per consumer
// warpgroup) cost about as much as a step's tensor-core work (measured on the H100).
// So a producer thread cannot hand its cp.async copies to the barrier itself
// (cp.async.mbarrier.arrive); it waits for them LAG steps later instead
// (cp.async.wait_group), when they have long landed, and its warp then arrives.
template <int STAGES>
struct Ring {
  static constexpr int LAG = STAGES - 2;  // steps a producer's copies stay in flight unsignalled
  static_assert(LAG >= 1, "Ring needs at least 3 stages");
  uint64_t full[STAGES], empty[STAGES];

  __device__ void init(uint32_t consumer_warps, uint32_t producer_warps) {
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&full[s])), "r"(producer_warps)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&empty[s])), "r"(consumer_warps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  static __device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
  }
  static __device__ __forceinline__ void arrive_warp(uint64_t* bar) {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
  }
  // producer: wait until slot it % STAGES is free ...
  __device__ __forceinline__ void acquire(int it) {
    if (it >= STAGES) wait(&empty[it % STAGES], (uint32_t)(it / STAGES - 1) & 1u);
  }
  // ... and after issuing its copies: mark step it - LAG full (its copies have landed)
  __device__ __forceinline__ void commit(int it) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (it >= LAG) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(LAG) : "memory");
      arrive_warp(&full[(it - LAG) % STAGES]);
    }
  }
  // after the last step (nk of them): mark the steps still unsignalled full
  __device__ __forceinline__ void drain(int nk) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int it = nk > LAG ? nk - LAG : 0; it < nk; ++it) arrive_warp(&full[it % STAGES]);
  }
  // consumer: wait until slot it % STAGES is full, then release it
  __device__ __forceinline__ void consume(int it) { wait(&full[it % STAGES], (uint32_t)(it / STAGES) & 1u); }
  __device__ __forceinline__ void release(int it) { arrive_warp(&empty[it % STAGES]); }
};

// wgmma shared-memory descriptor: start address, leading and stride byte offsets
// (16-byte units) and the swizzle mode (1: 128 bytes, 2: 64 bytes, 3: 32 bytes). The
// hardware swizzles on the address bits themselves, so an operand may start at any
// 128-byte row of a tile written with the pattern of its aligned base, with a base
// offset (bits 49-51) of 0 (measured on the H100: such operands read exactly with 0
// and wrongly with (addr >> 7) & 7).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) | ((uint64_t)mode << 62);
}

// The swizzle of mode MODE on a byte offset from a 1,024-byte aligned base: the
// 16-byte chunk index (bits 4..) XOR the 128-byte row index (bits 7..), over 3, 2 or
// 1 bits for the 128-, 64- and 32-byte modes.
template <uint32_t MODE>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = MODE == 1 ? 7u : MODE == 2 ? 3u : 1u;
  return off ^ (((off >> 7) & mask) << 4);
}

template <int ROWS, int W, int AW_ = (W < 64 ? W : 64)>
struct MnTile {
  static_assert(ROWS % 16 == 0 && (AW_ == 32 || AW_ == 64) && W % AW_ == 0, "MnTile shape");
  static constexpr int AW = AW_;                      // swizzle-atom width, elements
  static constexpr int ROW_BYTES = 2 * AW;            // 128 or 64
  static constexpr int ATOM = 8 * ROW_BYTES;          // 8 K-rows: SBO
  static constexpr int ATOM_COL = ROWS / 8 * ATOM;    // one AW-wide column: LBO
  static constexpr int BYTES = ROWS * W * 2;
  static constexpr uint32_t MODE = ROW_BYTES == 128 ? 1u : 2u;
  // offset of the chunk of elements [8c, 8c + 8) of K-row k
  static __device__ __forceinline__ uint32_t chunk(int k, int c) {
    constexpr int CPR = AW / 8;  // chunks per atom row
    return swizzle<MODE>((uint32_t)((c / CPR) * ATOM_COL + (k / 8) * ATOM + (k % 8) * ROW_BYTES + (c % CPR) * 16));
  }
  // operand of K-rows [16t, 16t + 16), from atom column j0 on
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int t, int j0) {
    return make_desc(base + (uint32_t)(j0 * ATOM_COL + 2 * t * ATOM), ATOM_COL, ATOM, MODE);
  }
};

template <int ROWS>
struct KTile {
  static constexpr int BYTES = ROWS * 128;
  static __device__ __forceinline__ uint32_t chunk(int r, int c) { return swizzle<1>((uint32_t)(r * 128 + c * 16)); }
  // operand of rows [r0, r0 + 64), K elements [16t, 16t + 16)
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int t, int r0) {
    return make_desc(base + (uint32_t)(r0 * 128 + 32 * t), 16, 1024, 1);
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across the
// asynchronous wgmma region (the asm statements above do not name them).
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 operands from shared memory, f32 D in
// N / 2 registers per thread of the warpgroup; scale_d = 0 ignores D's old value.
// TA / TB: 1 when A / B is MN-major (MnTile), 0 when K-major (KTile). Element i of d
// sits at row 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n96(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32)
    wgmma_n32<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_n64<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 96)
    wgmma_n96<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_n128<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 192)
    wgmma_n192<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n256<TA, TB>(d, da, db, scale_d);
}

// Row and column, in the warpgroup's 64 x N tile, of accumulator element i of thread t.
__device__ __forceinline__ int acc_row(int t, int i) { return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i / 4) + 2 * (t % 4) + i % 2; }

}  // namespace hopper
