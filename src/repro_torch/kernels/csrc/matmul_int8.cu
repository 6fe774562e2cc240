// matmul_int8: (M, K) s8 @ (K, N) s8 -> (M, N) int32, plus an optional
// int32 accumulator init (the add-fold of the LM residual stream, and the
// bias broadcast over the rows).
//
// Replaces the TPU kernel src/repro/kernels/matmul_int8/matmul_int8.py:
// matmul_int8 (body _kernel; wrapper ops.py:matmul_int8_op).
//
// What bounds it on an H100: bytes at most of the LM's shapes, because
// the int32 accumulator init and the int32 output move 8 bytes an output.
// gemma-2b's MLP up-projection at bucket 4 (M = 2048, K = 2048, N = 16384)
// moves 306 MB (91 us at 3.35 TB/s) for 137 G int8 operations (69 us at
// the 1,979 TOP/s int8 tensor-core peak); the deep projections (K = 8192
// and 16384) are bound by operations.
//
// Design: tensor cores through mma.sync m16n8k32 .s8.s8 (the LM's
// activations are signed).  A thread block of 8 warps owns a 128 x 128
// output tile, each warp 64 x 32 (4 x 4 mma tiles, 64 int32 accumulators a
// thread).  The K loop stages a 128 x 64 tile of A and a 64 x 128 tile of B
// in shared memory.  B arrives row-major (K, N), as the weights are stored;
// the staging transposes it to [n][k] with a 4 x 4 byte transpose of four
// 32-bit row words (__byte_perm), so each mma B fragment is one 32-bit load
// and the caller never makes a transposed copy.  Shared rows are padded to
// 80 bytes, so the fragment loads of a warp hit 32 distinct banks.
// Ragged edges are masked, not snapped: rows past M, columns past N and
// depth past K stage as zeros and are not stored.  K or N not a multiple of
// 4 (or a misaligned operand) takes a byte-wise staging path.  The int32
// accumulator cannot overflow from the product (|sum| <= K * 2^14, 2.7e8 at
// K = 16384); acc_init is added at the end in unsigned arithmetic, which
// wraps modulo 2^32 as the reference's int32 add does.  No software
// pipelining yet: the speed work is a later change.
#include "common.cuh"

namespace {

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
matmul_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const int32_t* __restrict__ init, int32_t* __restrict__ out,
                   int m, int n, int k, bool vec_a, bool vec_b) {
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
        if (init != nullptr) v += static_cast<unsigned>(init[o]);
        out[o] = static_cast<int>(v);
      }
}

}  // namespace

// a: (m, k) s8; b: (k, n) s8; init: (m, n) s32 or null; out: (m, n) s32,
// all row-major and contiguous.  Returns the cudaError_t of the launch.
REPRO_EXPORT int matmul_int8_launch(const void* a, const void* b,
                                    const void* init, void* out, int m, int n,
                                    int k, void* stream) {
  const bool vec_a = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  const bool vec_b = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(init), static_cast<int32_t*>(out), m, n, k,
      vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
