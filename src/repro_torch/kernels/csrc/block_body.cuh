// The residual block's arithmetic as device functions shared by the fused
// block kernel (resblock_fused.cu) and the block-chain kernel
// (block_chain.cu), so that the block body is written once.
//
//   conv3x3_mma:  out = requant_u8(bias + conv3x3(in), shift)
//                 (conv0 of a block, stride 1 or 2)
//   residual_mma: out = requant_u8(skip + b1 + conv3x3(y0), shift1)
//                 skip = shift_align(x, skip_shift), or
//                      = shift_align(x *1x1 wd + bd, skip_shift)
//
// Both are implicit GEMMs on the int8 tensor cores
// (mma.sync.aligned.m16n8k32 / m16n8k16 .row.col.s32.u8.s8.s32: u8
// activations times s8 weights, int32 accumulators):
//   M = output pixels, in tiles of 16 (any run of pixels of the band, row
//       after row; a ragged last tile repeats its last pixel and does not
//       store it);
//   N = output channels, in pairs of n8 tiles (16 channels a warp item);
//   K = the input channels of one tap, summed over the taps.
// A fragments come from ldmatrix on per-lane row addresses in a
// zero-ringed plane: the row of lane l is the tap-shifted input pixel of
// output pixel l, so the im2col is implicit.  B fragments come from the
// block's packed weights (pack layout below), one 8- or 16-byte shared load
// a lane.  The add-fold stays an accumulator init: conv0's C starts at the
// bias; conv1's at shift_align(skip, skip_shift) + b1, where the 1x1
// downsample is its own product (K = cin, on the strided input pixel) into
// a separate accumulator that starts at bd and is shift-aligned before it
// joins conv1's init.  Integer accumulation is exact in any order, so the
// result is bitwise the plain version's.
//
// Packed block (pack_block in kernels/resblock_fused/ops.py writes it;
// packed_block_bytes is its size): with kp = cin and np = cout rounded up
// to 16 (zero filled), two parts, one a conv phase:
//   part A:  b0 (np int32) | w0 [9][kp / ks][np / 16][32 lanes] of ks / 4 words
//   part B:  b1, bd (np int32 each; bd zero without a downsample) |
//            w1 [9][np / ks1][np / 16][32 lanes] of ks1 / 4 words |
//            wd [1][kp / ks][np / 16][32 lanes] of ks / 4 words
// ks = 32 when the K of the product is a multiple of 32, else 16.  Lane
// 4g + t holds, for n8 tiles nt = 0, 1 of the pair and k halves j < ks / 16,
// the word of k = 16 j + 4 t .. + 3 of output channel 16 np + 8 nt + g:
// the mma's B fragment as it is, so a warp reads 512 (or 256) contiguous
// bytes.  block_chain streams the parts through two buffers, one phase
// ahead.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Bytes a stored pixel of a c-channel map takes in shared memory: the
// channels rounded up to 16-byte chunks, then to an odd count of chunks,
// so that the 8 rows of one ldmatrix phase (8 pixels one pixel apart) fall
// on 8 different 16-byte bank groups.
__host__ __device__ inline int pixel_pitch(int c) {
  const int p = round16(c);
  return (p / 16) % 2 ? p : p + 16;
}

// Bytes of part A (part = 0: b0, w0) or part B (part = 1: b1, bd, w1, wd)
// of a packed block.
__host__ __device__ inline int packed_part_bytes(int cin, int cout, int has_ds,
                                                 int part) {
  const int kp = round16(cin), np = round16(cout);
  return part == 0 ? 4 * np + 9 * kp * np
                   : 8 * np + 9 * np * np + (has_ds ? kp * np : 0);
}

__host__ __device__ inline int packed_block_bytes(int cin, int cout, int has_ds) {
  return packed_part_bytes(cin, cout, has_ds, 0) +
         packed_part_bytes(cin, cout, has_ds, 1);
}

// Views into one packed block in shared memory: part A at pa, part B at pb.
struct Packed {
  const int32_t *b0, *b1, *bd;
  const uint8_t *w0, *w1, *wd;
  __device__ Packed(const unsigned char* pa, const unsigned char* pb, int cin,
                    int cout) {
    const int np = round16(cout);
    b0 = reinterpret_cast<const int32_t*>(pa);
    w0 = pa + 4 * np;
    b1 = reinterpret_cast<const int32_t*>(pb);
    bd = b1 + np;
    w1 = pb + 8 * np;
    wd = w1 + 9 * np * np;
  }
};

// One image's u8 HWC map (or a band of it) in shared or device memory.
// Coordinate (y, x) is stored at  p + ((y + oy) * pitch + x + ox) * c.
// A conv reads through a Map in the coordinates of its padded input; an
// epilogue writes through one in output coordinates.
struct Map {
  uint8_t* p;
  int pitch;   // stored pixels per row
  int oy, ox;  // stored row and column of coordinate 0 (oy may be negative
               // for a band: coordinate y of rows [r0, r1) at y + oy)
  int c;       // bytes per pixel (pixel_pitch of the channels in shared
               // memory, the channel count in device memory)

  __device__ __forceinline__ uint8_t* at(int y, int x) const {
    return p + ((y + oy) * pitch + x + ox) * c;
  }
};

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[0..bytes) = src[0..bytes) by cp.async, 16 bytes a thread at a time
// (both 16-byte aligned, bytes a multiple of 16); the caller commits.
__device__ __forceinline__ void copy_async(unsigned char* dst,
                                           const unsigned char* src, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    cp_async16(dst + i, src + i);
}

// dst[0..n) = src[0..n), or zeros where src is null.
__device__ inline void stage_bias(const int32_t* __restrict__ src,
                                  int32_t* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src ? src[i] : 0;
}

// Stage rows [y0, y0 + rows) of an h x w x c u8 image (device memory,
// c a multiple of 4, or c < 4 for the RGB image) into stored rows
// 0 .. rows - 1 of a plane of wp pixels of `pitch` bytes, image column x at
// stored column x + pad.  Rows outside [0, h) and columns outside [0, w)
// are zero.  Only the first round-up-to-4 bytes of a pixel are written.
__device__ inline void stage_rows(const uint8_t* __restrict__ img, int h,
                                  int w, int c, uint8_t* dst, int pitch,
                                  int wp, int pad, int y0, int rows) {
  const int c4 = (c + 3) / 4;
  for (int i = threadIdx.x; i < rows * wp * c4; i += blockDim.x) {
    const int pos = i / c4, q = i - pos * c4;
    const int r = pos / wp, xs = pos - r * wp;
    const int y = y0 + r, x = xs - pad;
    unsigned v = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const uint8_t* px = img + (static_cast<size_t>(y) * w + x) * c + 4 * q;
      if (c % 4 == 0) {
        v = *reinterpret_cast<const unsigned*>(px);
      } else {  // the RGB image: 3 bytes a pixel, not word aligned
        for (int j = 0; j < 4 && 4 * q + j < c; ++j)
          v |= static_cast<unsigned>(px[j]) << (8 * j);
      }
    }
    *reinterpret_cast<unsigned*>(dst + (r * wp + xs) * pitch + 4 * q) = v;
  }
}

// Zero stored rows [r_lo, r_hi) of a plane of wp pixels of `pitch` bytes.
__device__ inline void zero_rows(uint8_t* p, int wp, int pitch, int r_lo,
                                 int r_hi) {
  const int n16 = (r_hi - r_lo) * wp * pitch / 16;
  uint4* d = reinterpret_cast<uint4*>(p + r_lo * wp * pitch);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) d[i] = make_uint4(0, 0, 0, 0);
}

// Zero the two ring columns (stored columns 0 and w + 1) of stored rows
// [r_lo, r_hi) of a plane of (w + 2) pixels of `pitch` bytes.
__device__ inline void zero_ring_cols(uint8_t* p, int w, int pitch, int r_lo,
                                      int r_hi) {
  const int q16 = pitch / 16, per_row = 2 * q16;
  for (int i = threadIdx.x; i < (r_hi - r_lo) * per_row; i += blockDim.x) {
    const int r = r_lo + i / per_row, k = i % per_row;
    const int x = k < q16 ? 0 : w + 1;
    reinterpret_cast<uint4*>(p + (r * (w + 2) + x) * pitch)[k % q16] =
        make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}
__device__ __forceinline__ void ldsm_x2(unsigned r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

// c += a (16 x 32 u8, row) * b (32 x 8 s8, col)
__device__ __forceinline__ void mma_k32(int c[4], const unsigned a[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16 x 16 u8, row) * b (16 x 8 s8, col)
__device__ __forceinline__ void mma_k16(int c[4], const unsigned a[2],
                                        unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// acc[nt] += the product of one warp item over TAPS taps (3 x 3 or 1 x 1)
// and K = KTS * KS bytes a tap: STEPS = TAPS * KTS mma steps, fully
// unrolled so that every fragment address is a constant offset, with the
// fragments of step s + 2 loaded while the mmas of step s issue.  arow:
// this lane's ldmatrix row at tap (0, 0) (its k offset included);
// row_step / px_step: bytes between input rows / pixels of the plane; wp:
// the packed weights of the product at n-pair np of nps.
template <int KS, int TAPS, int KTS>
__device__ __forceinline__ void mma_taps(int acc[2][4], const uint8_t* arow,
                                         int row_step, int px_step,
                                         const uint8_t* wp, int np, int nps) {
  using B = typename std::conditional<KS == 32, uint4, uint2>::type;
  constexpr int AR = KS / 8;  // A registers: 4 for k32, 2 for k16
  constexpr int STEPS = TAPS * KTS, P = STEPS < 2 ? STEPS : 2;
  const B* wb = reinterpret_cast<const B*>(wp) + np * 32 + (threadIdx.x & 31);
  const int wstep = nps * 32;  // B fragments between consecutive steps
  unsigned af[P + 1][AR];
  B bf[P + 1];
  auto load = [&](int s) {
    const int tap = s / KTS, kt = s % KTS;
    const uint8_t* a = arow + (tap / 3) * row_step + (tap % 3) * px_step + kt * KS;
    if constexpr (KS == 32) ldsm_x4(af[s % (P + 1)], a);
    else ldsm_x2(af[s % (P + 1)], a);
    bf[s % (P + 1)] = wb[s * wstep];
  };
#pragma unroll
  for (int s = 0; s < P; ++s) load(s);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (s + P < STEPS) load(s + P);
    const int i = s % (P + 1);
    if constexpr (KS == 32) {
      mma_k32(acc[0], af[i], bf[i].x, bf[i].y);
      mma_k32(acc[1], af[i], bf[i].z, bf[i].w);
    } else {
      mma_k16(acc[0], af[i], bf[i].x);
      mma_k16(acc[1], af[i], bf[i].y);
    }
  }
}

// The product at depth kp (16 .. kMaxK, a multiple of 16): m16n8k32 steps
// when kp is a multiple of 32, else m16n8k16.
constexpr int kMaxK = 128;

template <int TAPS>
__device__ __forceinline__ void mma_product(int acc[2][4], const uint8_t* arow,
                                            int row_step, int px_step,
                                            const uint8_t* wp, int kp, int np,
                                            int nps) {
  switch (kp) {
    case 16: return mma_taps<16, TAPS, 1>(acc, arow, row_step, px_step, wp, np, nps);
    case 32: return mma_taps<32, TAPS, 1>(acc, arow, row_step, px_step, wp, np, nps);
    case 48: return mma_taps<16, TAPS, 3>(acc, arow, row_step, px_step, wp, np, nps);
    case 64: return mma_taps<32, TAPS, 2>(acc, arow, row_step, px_step, wp, np, nps);
    case 80: return mma_taps<16, TAPS, 5>(acc, arow, row_step, px_step, wp, np, nps);
    case 96: return mma_taps<32, TAPS, 3>(acc, arow, row_step, px_step, wp, np, nps);
    case 112: return mma_taps<16, TAPS, 7>(acc, arow, row_step, px_step, wp, np, nps);
    default: return mma_taps<32, TAPS, 4>(acc, arow, row_step, px_step, wp, np, nps);
  }
}

// Output pixel q of a band of `rows` rows from row oy0, ow wide, clamped to
// the band's last pixel (a ragged tile's spare rows repeat it).
struct Pix {
  int y, x;
  __device__ __forceinline__ Pix(int q, int n_pix, int oy0, int ow) {
    q = min(q, n_pix - 1);
    y = oy0 + q / ow;
    x = q - (q / ow) * ow;
  }
};

// The ldmatrix row of this lane within an m16 tile and its byte offset
// within a 32-byte K step: lanes 8i..8i+7 address matrix i (rows 0-7, 8-15,
// 0-7, 8-15; bytes 0-15, 0-15, 16-31, 16-31).
__device__ __forceinline__ int lane_row() {
  const int lane = threadIdx.x & 31;
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int lane_koff(int kp) {
  return kp % 32 ? 0 : 16 * ((threadIdx.x & 31) >> 4);
}

// Store one accumulator row (C rows g or g + 8) of a warp item: channels
// 16 np + 8 nt + 2t, + 1 of pixel (y, x), requantized, as 16-bit stores;
// channels at or past cout (the zero-padded n tiles) are not stored.
__device__ __forceinline__ void store_row(const Map out, int y, int x,
                                          const int acc[2][4], int half,
                                          int np, int cout, int shift) {
  const int t = threadIdx.x & 3;
  uint8_t* px = out.at(y, x);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int co = 16 * np + 8 * nt + 2 * t;
    if (co < cout) {
      const unsigned v = requant_u8(acc[nt][2 * half], shift) |
                         requant_u8(acc[nt][2 * half + 1], shift) << 8;
      *reinterpret_cast<uint16_t*>(px + co) = static_cast<uint16_t>(v);
    }
  }
}

// out(oy, ox) = requant_u8(bias + sum over taps of in(oy * stride + kh,
// ox * stride + kw) . w) for output rows [oy0, oy0 + rows), ox < ow.
// w: the packed conv (w0 of a Packed), bias: np int32.
__device__ inline void conv3x3_mma(const Map in, int cin, const uint8_t* w,
                                   const int32_t* bias, int stride, int oy0,
                                   int rows, int ow, int cout, int shift,
                                   const Map out) {
  const int kp = round16(cin), nps = round16(cout) / 16;
  const int n_pix = rows * ow, items = (n_pix + 15) / 16 * nps;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int mt = it / nps, np = it - mt * nps;
    const Pix a(16 * mt + lane_row(), n_pix, oy0, ow);
    const uint8_t* arow = in.at(a.y * stride, a.x * stride) + lane_koff(kp);
    int acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = 16 * np + 8 * nt + 2 * t;
      acc[nt][0] = acc[nt][2] = bias[co];
      acc[nt][1] = acc[nt][3] = bias[co + 1];
    }
    mma_product<9>(acc, arow, in.pitch * in.c, in.c, w, kp, np, nps);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 16 * mt + g + 8 * half;
      if (q < n_pix) {
        const Pix o(q, n_pix, oy0, ow);
        store_row(out, o.y, o.x, acc, half, np, cout, shift);
      }
    }
  }
}

// The second half of a residual block for output rows [oy0, oy0 + rows):
// the skip (identity, or the fused 1x1 downsample of the packed block) read
// from x at (pad_lo + o * stride), shift-aligned, plus b1, starts conv1's
// accumulator (the add-fold); conv1 runs over y0 (a Map in the coordinates
// of its (1, 1)-padded input), then requant_u8.
__device__ inline void residual_mma(const Map x, int cin, int pad_lo,
                                    int stride, const Packed& pk, bool has_ds,
                                    int skip_shift, const Map y0, int oy0,
                                    int rows, int ow, int cout, int shift1,
                                    const Map out) {
  const int kp = round16(cin), np1 = round16(cout), nps = np1 / 16;
  const int n_pix = rows * ow, items = (n_pix + 15) / 16 * nps;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int mt = it / nps, np = it - mt * nps;
    const Pix a(16 * mt + lane_row(), n_pix, oy0, ow);
    int acc[2][4];
    if (has_ds) {
      int accd[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int co = 16 * np + 8 * nt + 2 * t;
        accd[nt][0] = accd[nt][2] = pk.bd[co];
        accd[nt][1] = accd[nt][3] = pk.bd[co + 1];
      }
      const uint8_t* xrow = x.at(pad_lo + a.y * stride, pad_lo + a.x * stride) +
                            lane_koff(kp);
      mma_product<1>(accd, xrow, 0, 0, pk.wd, kp, np, nps);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = shift_align(accd[nt][i], skip_shift);
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const Pix o(16 * mt + g + 8 * half, n_pix, oy0, ow);
        const uint8_t* xc = x.at(pad_lo + o.y * stride, pad_lo + o.x * stride);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int co = 16 * np + 8 * nt + 2 * t;
          acc[nt][2 * half] = shift_align(xc[co], skip_shift);
          acc[nt][2 * half + 1] = shift_align(xc[co + 1], skip_shift);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = 16 * np + 8 * nt + 2 * t;
      acc[nt][0] += pk.b1[co];
      acc[nt][2] += pk.b1[co];
      acc[nt][1] += pk.b1[co + 1];
      acc[nt][3] += pk.b1[co + 1];
    }
    const uint8_t* yrow = y0.at(a.y, a.x) + lane_koff(np1);
    mma_product<9>(acc, yrow, y0.pitch * y0.c, y0.c, pk.w1, np1, np, nps);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 16 * mt + g + 8 * half;
      if (q < n_pix) {
        const Pix o(q, n_pix, oy0, ow);
        store_row(out, o.y, o.x, acc, half, np, cout, shift1);
      }
    }
  }
}

}  // namespace repro
