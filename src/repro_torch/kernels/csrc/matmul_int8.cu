// matmul_int8: (M, K) s8 @ (K, N) s8 -> (M, N) int32, plus an optional
// int32 accumulator init (the add-fold of the LM residual stream, and the
// bias broadcast over the rows).
//
// Replaces the TPU kernel src/repro/kernels/matmul_int8/matmul_int8.py:
// matmul_int8 (body _kernel; wrapper ops.py:matmul_int8_op).
//
// What bounds it on an H100 (3.35 TB/s, 1,979 TOP/s int8 dense), at the
// LM's shapes with M = 2048 (bucket 4 x 512 tokens):
// - The wide projections (gemma-2b up/down, falcon-mamba-7b wu/wz/wdt/wo,
//   137 G operations each) are bound by operations: 69 us each.  With
//   acc_init as the main path passes it (the bias, N x 4 bytes) they move
//   38-84 MB, 11-25 us.
// - gemma-2b wq/wo (17 G operations) are bound by operations, 8.7 us.
// - The narrow ones (gemma-2b wk/wv, N = 256; falcon-mamba-7b wb/wc,
//   N = 16) are bound by bytes (A alone is 4-8 MB): 1.4-2.6 us.  What
//   limits them in practice is how many SMs get work.
//
// Two paths, chosen by shape before launch (ops.py:matmul_path); each has
// its own launch count in the wrapper.
//
// 1. matmul_int8_wgmma, for K and N multiples of 16 and 16-byte aligned
//    operands (every LM projection).  B comes pre-packed as (N, K), K-major:
//    for 8-bit types wgmma.mma_async takes both operands K-major from shared
//    memory and has no transpose flag, so the LM lowering transposes each
//    weight once (compile/backends.py) instead of every thread block
//    byte-transposing B on every K step.  One persistent thread block an SM
//    walks output tiles of 128 x BN (BN in {16, ..., 256}, chosen by shape in
//    ops.py:matmul_tiles) and, for the narrow shapes, K ranges (split-K).
//    Warpgroup 0 is the producer: one thread issues cp.async.bulk.tensor
//    (TMA) loads of a 128 x 128 tile of A and a BN x 128 tile of B, 128-byte
//    swizzled, into a ring of 3-8 stages in dynamic shared memory (what the
//    epilogue staging leaves of 227 KB); each
//    stage has a full and an empty mbarrier.  Warpgroups 1 and 2 are the
//    consumers: each runs wgmma m64nBNk32 (4 a stage) on its 64 rows as the
//    stage lands, keeps one wgmma group in flight, and releases the stage
//    when its group retires.  setmaxnreg moves registers from the producer
//    (40) to the consumers (232): BN = 256 keeps 128 int32 accumulators a
//    thread.  While the consumers finish one tile the producer already fills
//    the ring for the next.  The tensor maps come from
//    cuTensorMapEncodeTiled (the library links -lcuda); B's is encoded once
//    per packed weight by the wrapper and passed by value, A's and the
//    output's per call.
//    Epilogue (BN >= 32, no split): each consumer warpgroup writes its 64
//    rows in chunks of 64 columns into swizzled shared memory,
//    double-buffered, and TMA stores drain each chunk while the warpgroup
//    goes on to the next chunk and the next tile.  The main path's bias row
//    is fetched into registers when the tile starts and staged in shared
//    memory; a full M x N init chunk is TMA-loaded into the staging buffer
//    first and added in place.  Split-K and BN = 16 store directly from
//    registers.
//    Split-K: every split adds its partial sums into a zeroed output with
//    red.global.add.s32, and split 0 adds acc_init, so acc_init is added
//    exactly once.  int32 addition wraps modulo 2^32, and wrap-around
//    addition is associative and commutative, so the result is bitwise the
//    same whatever order the partials arrive in: deterministic.
// 2. matmul_int8_mma_sync, for the rest (K or N not a multiple of 16, or a
//    misaligned operand): tensor cores through mma.sync m16n8k32 .s8.s8 on
//    B as (K, N) row-major.  A thread block of 8 warps owns a 128 x 128
//    output tile, each warp 64 x 32.  The K loop stages a 128 x 64 tile of
//    A and a 64 x 128 tile of B in shared memory, B byte-transposed to
//    [n][k] by __byte_perm so each mma B fragment is one 32-bit load; rows
//    padded to 80 bytes.  Ragged edges are masked; K or N not a multiple of
//    4 (or a misaligned operand) stage byte by byte.
//
// Both: the int32 accumulator cannot overflow from the product (|sum| <=
// K * 2^14, 2.7e8 at K = 16384); acc_init is added at the end in unsigned
// arithmetic, which wraps modulo 2^32 as the reference's int32 add does.
// acc_init is read with a row stride (init_ld elements): 0 for the main
// path's bias broadcast over the rows (a stride-0 expand, never copied to
// M x N), N for a full tensor.
//
// What this does about the faults of the first version (mma.sync only):
// the old tensor-core path (wgmma now); staging by every thread with
// 32-bit loads and a byte transpose of B each K step (TMA, weights packed
// once); no pipelining (a TMA/mbarrier ring, one wgmma group in flight);
// one fixed 128 x 128 tile (BN and split-K by shape, a persistent grid);
// the bias copied to M x N on every call (read with row stride 0).
#include <cuda.h>

#include <cstring>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Path 1: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;            // rows of an output tile (2 x 64)
constexpr int kWgBK = 128;            // K bytes a stage: one 128-byte swizzle row
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr long long kSpinLimit = 1ll << 31;   // an mbarrier wait this long is a fault

template <int BN>
struct WgCfg {
  static constexpr int kStageA = kWgBM * kWgBK;
  static constexpr int kStageB = BN * kWgBK;
  static constexpr int kStageBytes = kStageA + kStageB;
  // Output staging of the TMA-store epilogue (BN >= 32): each consumer
  // warpgroup writes its 64 rows in chunks of up to 64 columns, in boxes
  // of 64 rows x 32 int32 (128 bytes, swizzled), double-buffered when a
  // tile has several chunks; plus the tile's bias row.
  static constexpr bool kStoreTma = BN >= 32;
  static constexpr int kChunkCols = BN < 64 ? BN : 64;
  static constexpr int kChunks = BN / kChunkCols;
  static constexpr int kBufs = kChunks > 1 ? 2 : 1;
  static constexpr int kChunkBytes = 64 * kChunkCols * 4;
  static constexpr int kStageOut = kStoreTma ? kBufs * kChunkBytes : 0;
  static constexpr int kBias = kStoreTma ? BN * 4 : 0;
  // the ring takes what the staging leaves, at most 8 stages; 1 KB aligns
  // it to the 128-byte swizzle's 1024-byte atom
  // mbarriers: a full and an empty one a stage, and one a staging buffer
  // for the TMA loads of a full init
  static constexpr int kFree = repro::kMaxSmemBytes - 1024 - 2 * (kStageOut + kBias) - 8 * (2 * 8 + 4);
  static constexpr int kStages = kFree / kStageBytes < 8 ? kFree / kStageBytes : 8;
  static constexpr int kSmem =
      kStages * kStageBytes + 2 * (kStageOut + kBias) + 1024 + 8 * (2 * kStages + 4);
  static_assert(kStages >= 3, "ring too shallow");
  static_assert(kSmem <= repro::kMaxSmemBytes, "ring exceeds shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait that never
// ends is a fault of the kernel: trap (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store of one staged box (bulk group of the issuing thread).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until all but the newest N of this thread's bulk store groups have
// read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// makes this thread's shared-memory writes visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of one warpgroup (named barrier id, 128 threads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void st_shared_v2(uint32_t addr, unsigned a, unsigned b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, int a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}
__device__ __forceinline__ int2 ld_shared_v2(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is
// unused for swizzled K-major layouts.  Advancing K by 32 bytes inside the
// swizzle row adds 32 to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32 .s32.s8.s8, A and B from shared memory through
// descriptors; scale_d = 0 overwrites the accumulators, 1 adds to them.
template <int N>
struct Wgmma;

template <> struct Wgmma<16> {
  __device__ __forceinline__ static void run(int (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void run(int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void run(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void run(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void run(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// One output tile of 128 x BN a step of the persistent loop; a work unit is
// (m tile, n tile, K split), m fastest so that neighbouring blocks share a
// B tile in L2.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
matmul_int8_wgmma(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_out,
                  const __grid_constant__ CUtensorMap map_init,
                  const int32_t* __restrict__ init, long long init_ld,
                  int32_t* __restrict__ out, int m, int n, int k, int split_k) {
  using C = WgCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t staging = ring + C::kStages * C::kStageBytes;
  const uint32_t bias_s = staging + 2 * C::kStageOut;
  const uint32_t bars = bias_s + 2 * C::kBias;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  auto init_bar = [&](int w, int b) { return bars + 8u * (2 * C::kStages + 2 * w + b); };

  const int mt = (m + kWgBM - 1) / kWgBM, nt = (n + BN - 1) / BN;
  // the TMA-store epilogue (no split, BN >= 32) takes no init, a broadcast
  // bias row or a full M x N init (loaded by TMA into the staging buffer)
  const bool tma_epilogue = C::kStoreTma && split_k == 1;
  const bool full_init = tma_epilogue && init != nullptr && init_ld != 0;
  const int kper = (k + kWgBK - 1) / kWgBK / split_k;   // split_k divides the K tiles
  const int units = mt * nt * split_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    for (int i = 0; i < 4; ++i) mbar_init(init_bar(i / 2, i % 2), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int mb = u % mt, nb = (u / mt) % nt, sp = u / mt / nt;
      for (int kb = sp * kper; kb < (sp + 1) * kper; ++kb, ++it) {
        const int s = it % C::kStages;
        mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::kStageBytes);
        const uint32_t sa = ring + s * C::kStageBytes;
        tma_load_2d(sa, &map_a, full(s), kb * kWgBK, mb * kWgBM);
        tma_load_2d(sa + C::kStageA, &map_b, full(s), kb * kWgBK, nb * BN);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int it = 0;
  uint32_t init_phase = 0;   // bit b: parity of staging buffer b's next init load
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int mb = u % mt, nb = (u / mt) % nt, sp = u / mt / nt;
    const int k0 = sp * kper, k1 = k0 + kper;
    // the tile's bias row (acc_init broadcast over the rows), fetched now
    // and staged in shared memory by the epilogue
    constexpr int kBiasPer = (BN + 127) / 128;
    const bool bias_row = tma_epilogue && init != nullptr && init_ld == 0;
    int bias_pre[kBiasPer];
#pragma unroll
    for (int i = 0; i < kBiasPer; ++i) {
      const int c = t + 128 * i, col = nb * BN + c;
      bias_pre[i] = bias_row && c < BN && col < n ? init[col] : 0;
    }
    for (int kb = k0; kb < k1; ++kb, ++it) {
      const int s = it % C::kStages;
      mbar_wait(full(s), (it / C::kStages) & 1);
      const uint32_t sa = ring + s * C::kStageBytes + cw * 64 * kWgBK;
      const uint32_t sb = ring + s * C::kStageBytes + C::kStageA;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 32; ++kk)
        Wgmma<BN>::run(acc, smem_desc(sa + 32 * kk), smem_desc(sb + 32 * kk),
                       (kb > k0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's group has retired
      fence_acc(acc);
      if (kb > k0 && t == 0) mbar_arrive(empty((it + C::kStages - 1) % C::kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (t == 0) mbar_arrive(empty((it + C::kStages - 1) % C::kStages));

    // epilogue: thread (warp, lane) holds rows warp*16 + lane/4 (+8) and
    // columns 8j + 2(lane%4) (+1) of its warpgroup's 64 x BN
    const int r0 = warp * 16 + lane / 4;
    const int row0 = mb * kWgBM + cw * 64 + r0;
    const int col0 = nb * BN + 2 * (lane % 4);
    const bool add_init = init != nullptr && sp == 0;
    if (tma_epilogue) {
      // Through shared memory and TMA stores, which drain while the
      // warpgroup goes on (to the next chunk, or the next tile): chunks of
      // 64 x kChunkCols in boxes of 64 x 32 int32 with the 128-byte swizzle
      // (conflict-free writes), two buffers; rows and columns past the
      // output are clipped by the TMA.  A full init chunk is first loaded by
      // TMA into the same buffer, in the same layout, and added in place.
      const uint32_t out_s = staging + cw * C::kStageOut;
      const uint32_t brow = bias_s + cw * C::kBias;
      if (bias_row) {
#pragma unroll
        for (int i = 0; i < kBiasPer; ++i)
          if (t + 128 * i < BN) st_shared(brow + 4 * (t + 128 * i), bias_pre[i]);
      }
#pragma unroll
      for (int q = 0; q < C::kChunks; ++q) {
        const int b = q % C::kBufs;
        const uint32_t buf = out_s + b * C::kChunkBytes;
        if (t == 0) {
          // the buffer's previous chunk has been read by its TMA store
          bulk_wait_read<C::kBufs - 1>();
          if (full_init) {
            mbar_expect_tx(init_bar(cw, b), C::kChunkBytes);
#pragma unroll
            for (int box = 0; box < C::kChunkCols / 32; ++box)
              tma_load_2d(buf + box * 8192, &map_init, init_bar(cw, b),
                          nb * BN + q * C::kChunkCols + box * 32, mb * kWgBM + cw * 64);
          }
        }
        if (full_init) {
          mbar_wait(init_bar(cw, b), (init_phase >> b) & 1);
          init_phase ^= 1u << b;
        }
        wg_sync(1 + cw);
#pragma unroll
        for (int jj = 0; jj < C::kChunkCols / 8; ++jj) {
          const int j = q * (C::kChunkCols / 8) + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned v0 = static_cast<unsigned>(acc[4 * j + 2 * h]);
            unsigned v1 = static_cast<unsigned>(acc[4 * j + 2 * h + 1]);
            const int r = r0 + 8 * h, c = 8 * jj + 2 * (lane % 4);
            const int cb = c % 32;
            const uint32_t addr =
                buf + (c / 32) * 8192 + r * 128 + (((cb / 4) ^ (r % 8)) * 16) + (cb % 4) * 4;
            if (full_init || bias_row) {
              const int2 iv = full_init ? ld_shared_v2(addr)
                                        : ld_shared_v2(brow + 4 * (8 * j + 2 * (lane % 4)));
              v0 += static_cast<unsigned>(iv.x);
              v1 += static_cast<unsigned>(iv.y);
            }
            st_shared_v2(addr, v0, v1);
          }
        }
        fence_async_smem();
        wg_sync(1 + cw);
        if (t == 0) {
#pragma unroll
          for (int box = 0; box < C::kChunkCols / 32; ++box)
            tma_store_2d(&map_out, buf + box * 8192,
                         nb * BN + q * C::kChunkCols + box * 32, mb * kWgBM + cw * 64);
          bulk_commit();
        }
      }
      continue;
    }
    // split-K or BN = 16: direct stores, red.global.add for the splits
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = col0 + 8 * j;
        if (row >= m || col >= n) continue;   // n is even: col + 1 < n too
        unsigned v0 = static_cast<unsigned>(acc[4 * j + 2 * h]);
        unsigned v1 = static_cast<unsigned>(acc[4 * j + 2 * h + 1]);
        if (add_init) {
          const int2 iv = *reinterpret_cast<const int2*>(
              init + static_cast<long long>(row) * init_ld + col);
          v0 += static_cast<unsigned>(iv.x);
          v1 += static_cast<unsigned>(iv.y);
        }
        int32_t* o = out + static_cast<long long>(row) * n + col;
        if (split_k == 1) {
          *reinterpret_cast<int2*>(o) = make_int2(static_cast<int>(v0), static_cast<int>(v1));
        } else {
          atomicAdd(o, static_cast<int>(v0));
          atomicAdd(o + 1, static_cast<int>(v1));
        }
      }
    }
  }
  if (t == 0) bulk_wait();   // the last tile's stores have landed
}

// ---------------------------------------------------------------------------
// Path 2: mma.sync m16n8k32 on B as (K, N)
// ---------------------------------------------------------------------------


constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;   // padded shared row, bytes
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned load_a_word(const int8_t* a, int m, int k,
                                                int row, int col, bool vec) {
  if (row >= m) return 0u;
  const int8_t* p = a + static_cast<long long>(row) * k;
  if (vec) return col < k ? *reinterpret_cast<const unsigned*>(p + col) : 0u;
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < k) w |= static_cast<unsigned>(static_cast<uint8_t>(p[col + j])) << (8 * j);
  return w;
}

// Four words, one per column n0..n0+3, each packing rows k0..k0+3 of B
// (the [n][k] order of an mma B fragment).
__device__ __forceinline__ void load_b_cols(const int8_t* b, int k, int n,
                                            int k0, int n0, bool vec,
                                            unsigned out[4]) {
  if (vec) {
    unsigned w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = (k0 + r < k && n0 < n)
                 ? *reinterpret_cast<const unsigned*>(b + static_cast<long long>(k0 + r) * n + n0)
                 : 0u;
    const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
    const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
    const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
    const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
    out[0] = __byte_perm(t0, t1, 0x5410);
    out[1] = __byte_perm(t0, t1, 0x7632);
    out[2] = __byte_perm(t2, t3, 0x5410);
    out[3] = __byte_perm(t2, t3, 0x7632);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[c] = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (k0 + r < k && n0 + c < n)
        out[c] |= static_cast<unsigned>(static_cast<uint8_t>(
                      b[static_cast<long long>(k0 + r) * n + n0 + c])) << (8 * r);
  }
}

__device__ __forceinline__ void mma_s8(int c[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
matmul_int8_mma_sync(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const int32_t* __restrict__ init, long long init_ld,
                   int32_t* __restrict__ out, int m, int n, int k, bool vec_a,
                   bool vec_b) {
  __shared__ __align__(16) uint8_t sa[kBM * kLds];
  __shared__ __align__(16) uint8_t sb[kBN * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;        // mma groupID, thread in group
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A: 128 rows x 16 words, 8 words a thread, a row's 64 bytes per
    // half-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 4, kw = idx & 15;
      *reinterpret_cast<unsigned*>(sa + r * kLds + kw * 4) =
          load_a_word(a, m, k, m0 + r, k0 + kw * 4, vec_a);
    }
    // B: 16 row quads x 32 column quads; a warp reads 32 contiguous bytes
    // of each of 4 row quads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int nq = (idx & 7) + 8 * ((idx >> 5) & 3);
      const int kq = ((idx >> 3) & 3) + 4 * (idx >> 7);
      unsigned cols[4];
      load_b_cols(b, k, n, k0 + kq * 4, n0 + nq * 4, vec_b, cols);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<unsigned*>(sb + (nq * 4 + c) * kLds + kq * 4) = cols[c];
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = sa + (wm * 64 + i * 16 + g) * kLds + ks + tg * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kLds);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = sb + (wn * 32 + j * 8 + g) * kLds + ks + tg * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0],
                 bf[j][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm * 64 + i * 16 + g + (q >> 1) * 8;
        const int col = n0 + wn * 32 + j * 8 + tg * 2 + (q & 1);
        if (row >= m || col >= n) continue;
        const long long o = static_cast<long long>(row) * n + col;
        unsigned v = static_cast<unsigned>(acc[i][j][q]);
        if (init != nullptr)
          v += static_cast<unsigned>(init[static_cast<long long>(row) * init_ld + col]);
        out[o] = static_cast<int>(v);
      }
}


// 2-D tensor map of a row-major (rows, k) int8 matrix, read in boxes of
// box_rows x 128 bytes with the 128-byte swizzle; rows and K past the end
// read as zeros.
CUresult encode_kmajor(CUtensorMap* map, const void* ptr, int rows, int k,
                       int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWgBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 2-D tensor map of a row-major (m, n) int32 matrix (the output, or a full
// acc_init), in boxes of 64 rows x 32 int32 with the 128-byte swizzle; the
// TMA clips a store at the edges and zero-fills a load.
CUresult encode_out(CUtensorMap* map, void* out, int m, int n) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, out, dims, strides, box,
                                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& map_a, const CUtensorMap& map_b,
                         const int32_t* init, long long init_ld, int32_t* out, int m,
                         int n, int k, int split_k, cudaStream_t stream) {
  // unread unless the epilogue goes through TMA (and, for map_init, the
  // init is a full M x N tensor)
  CUtensorMap map_out, map_init;
  std::memset(&map_out, 0, sizeof map_out);
  std::memset(&map_init, 0, sizeof map_init);
  if (WgCfg<BN>::kStoreTma && split_k == 1) {
    if (encode_out(&map_out, out, m, n) != CUDA_SUCCESS) return cudaErrorInvalidValue;
    if (init != nullptr && init_ld != 0 &&
        encode_out(&map_init, const_cast<int32_t*>(init), m, n) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  static bool configured = false;   // the attribute is set once per BN
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_int8_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, WgCfg<BN>::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long units = static_cast<long long>((m + kWgBM - 1) / kWgBM) *
                          ((n + BN - 1) / BN) * split_k;
  const int grid = static_cast<int>(units < sms ? units : sms);
  matmul_int8_wgmma<BN><<<grid, kWgThreads, WgCfg<BN>::kSmem, stream>>>(
      map_a, map_b, map_out, map_init, init, init_ld, out, m, n, k, split_k);
  return cudaGetLastError();
}

}  // namespace

// The tensor map of a packed weight b_nk: (n, k) int8, K-major, read in
// boxes of bn x 128 bytes.  Written to map_out (128 bytes, the caller's
// host buffer), which matmul_int8_wgmma_launch takes on every call: the
// wrapper encodes it once per packed weight.  Returns a cudaError_t.
REPRO_EXPORT int matmul_int8_encode_b(const void* b_nk, int n, int k, int bn,
                                      void* map_out) {
  static_assert(sizeof(CUtensorMap) == 128, "CUtensorMap is 128 bytes");
  CUtensorMap map;   // 64-byte aligned here; the caller's buffer need not be
  if (encode_kmajor(&map, b_nk, n, k, bn) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(map_out, &map, sizeof map);
  return 0;
}

// Path 1.  a: (m, k) s8 row-major; map_b: the packed weight's tensor map
// (matmul_int8_encode_b with the same bn); init: s32 rows init_ld elements
// apart (0: one row broadcast) or null; out: (m, n) s32 row-major.  k and n
// multiples of 16, a, init and out 16-byte aligned, init_ld 0 or n; bn in {16, 32,
// 64, 128, 256}; split_k divides ceil(k / 128).  Returns the cudaError_t
// of the launch.
REPRO_EXPORT int matmul_int8_wgmma_launch(const void* a, const void* map_b,
                                          const void* init, long long init_ld,
                                          void* out, int m, int n, int k, int bn,
                                          int split_k, void* stream) {
  const int ktiles = (k + kWgBK - 1) / kWgBK;
  if (k % 16 != 0 || n % 16 != 0 || split_k < 1 || ktiles % split_k != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(init) % 16 != 0 || (init_ld != 0 && init_ld != n))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a;
  if (encode_kmajor(&map_a, a, m, k, kWgBM) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mb;
  std::memcpy(&mb, map_b, sizeof mb);
  auto* o = static_cast<int32_t*>(out);
  auto* in = static_cast<const int32_t*>(init);
  auto st = static_cast<cudaStream_t>(stream);
  if (split_k > 1) {
    // the splits add into a zeroed output
    const cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(m) * n * 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e;
  switch (bn) {
    case 16: e = launch_wgmma<16>(map_a, mb, in, init_ld, o, m, n, k, split_k, st); break;
    case 32: e = launch_wgmma<32>(map_a, mb, in, init_ld, o, m, n, k, split_k, st); break;
    case 64: e = launch_wgmma<64>(map_a, mb, in, init_ld, o, m, n, k, split_k, st); break;
    case 128: e = launch_wgmma<128>(map_a, mb, in, init_ld, o, m, n, k, split_k, st); break;
    case 256: e = launch_wgmma<256>(map_a, mb, in, init_ld, o, m, n, k, split_k, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Path 2.  a: (m, k) s8; b: (k, n) s8, both row-major and contiguous; init:
// s32 rows init_ld elements apart (0: one row broadcast) or null; out: (m,
// n) s32.  Returns the cudaError_t of the launch.
REPRO_EXPORT int matmul_int8_mma_sync_launch(const void* a, const void* b,
                                             const void* init, long long init_ld,
                                             void* out, int m, int n, int k,
                                             void* stream) {
  const bool vec_a = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  const bool vec_b = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_int8_mma_sync<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(init), init_ld, static_cast<int32_t*>(out), m, n, k,
      vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
