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
//   N = output channels, in pairs of n8 tiles (16 channels);
//   K = the input channels of one tap, summed over the taps.
// A warp item is a register tile of MT pixel tiles by NT channel pairs
// (Tile<MT, NT>, MT * NT <= 4, from a fixed set of six): each K step loads
// MT A fragments and NT B fragments and issues 2 MT NT mmas into as many
// independent accumulators, each A fragment feeding NT pairs and each B
// fragment MT tiles.  The items of a phase are its pixel-tile groups
// times its channel-pair groups; a whole pixel tile past the band issues
// no loads and no mmas.  Each conv phase takes the tile of its shape:
// tune/space.py:warp_tile picks the largest that leaves every warp of the
// thread block an item without lengthening the busiest warp's run, so a
// phase with items to spare (a whole map a thread block) takes a large
// tile and a short band keeps (1, 1).  Bias, skip and epilogue are the
// (1, 1) item's, tile by tile.
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

// The shared-memory address of p, as ldmatrix takes it.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// ldmatrix of four / two 8x8 b16 matrices at a shared-memory address, or
// at a generic pointer into shared memory.
__device__ __forceinline__ void ldsm_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  ldsm_x4(r, smem_u32(p));
}
__device__ __forceinline__ void ldsm_x2(unsigned r[2], const void* p) {
  ldsm_x2(r, smem_u32(p));
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

// A warp item's register tile: MT pixel tiles (16 output pixels each) by
// NT channel pairs (16 output channels each).
template <int MT_, int NT_>
struct Tile {
  static constexpr int MT = MT_, NT = NT_;
};

// The fixed set of tiles, MT * NT <= 4, with MT and NT at most kSide:
// resblock_fused instantiates the whole set (kSide 4, tune/space.py:TILES)
// and block_chain the tiles of sides up to 2 (CHAIN_TILES), the ones that
// fit its 128 registers a thread beside the chain's own state.
template <int kSide>
__host__ __device__ constexpr bool tile_ok(int mt, int nt) {
  return mt <= kSide && nt <= kSide &&
         ((mt == 1 && (nt == 1 || nt == 2 || nt == 4)) ||
          (mt == 2 && (nt == 1 || nt == 2)) || (mt == 4 && nt == 1));
}

// f(Tile<mt, nt>{}) for a tile of tile_ok<kSide>'s set; nothing for any
// other.
template <int kSide, class F>
__device__ __forceinline__ void with_tile(int mt, int nt, F&& f) {
  switch (4 * mt + nt) {
    case 5: f(Tile<1, 1>{}); break;
    case 6: f(Tile<1, 2>{}); break;
    case 9: f(Tile<2, 1>{}); break;
    case 10: f(Tile<2, 2>{}); break;
    case 8: if constexpr (kSide >= 4) f(Tile<1, 4>{}); break;
    case 17: if constexpr (kSide >= 4) f(Tile<4, 1>{}); break;
    default: break;
  }
}

// acc[i][j] += the product of pixel tile i and channel pair np0 + j of one
// warp item over TAPS taps (3 x 3 or 1 x 1) and K = kts * KS bytes a tap,
// for the first mv of the MT pixel tiles (a tile past the band issues no
// loads and no mmas).  The steps run K slice by K slice (KS bytes of every
// tap), the TAPS steps of a slice fully unrolled.  A (1, 1) tile loads the
// fragments of step s + 2 while the mmas of step s issue (three register
// stages); a larger tile loads each step's fragments just before its
// 2 MT NT independent mmas, which hide one another's latency, so that its
// accumulators fit two thread blocks an SM without spilling.
// The loads walk the steps with one running A offset and one B pointer.
// arow[i]: this lane's ldmatrix row of tile i at tap (0, 0), k offset
// included, as a shared-memory address; row_step / px_step: bytes between
// input rows / pixels of the plane; wp: the packed weights of the product,
// nps channel pairs wide.
template <int KS, int TAPS, int MT, int NT>
__device__ __forceinline__ void mma_taps(int (&acc)[MT][NT][2][4],
                                         const unsigned (&arow)[MT], int mv,
                                         int row_step, int px_step,
                                         const uint8_t* wp, int kts, int np0,
                                         int nps) {
  using B = typename std::conditional<KS == 32, uint4, uint2>::type;
  constexpr int AR = KS / 8;  // A registers: 4 for k32, 2 for k16
  constexpr int S = TAPS == 1 || MT * NT > 1 ? 1 : 3;  // register stages
  const int tstep = kts * nps * 32;  // B fragments between taps of a slice
  unsigned af[S][MT][AR];
  B bf[S][NT];
  // the next step to load: its A offset and B fragments
  unsigned aoff = 0;
  const B* wn = reinterpret_cast<const B*>(wp) + np0 * 32 + (threadIdx.x & 31);
  auto load = [&](int st, int tap) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i > 0 && i >= mv) continue;
      if constexpr (KS == 32) ldsm_x4(af[st][i], arow[i] + aoff);
      else ldsm_x2(af[st][i], arow[i] + aoff);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) bf[st][j] = wn[32 * j];
    if (tap + 1 < TAPS) {  // the next tap of the slice
      aoff += tap % 3 == 2 ? row_step - 2 * px_step : px_step;
      wn += tstep;
    }
  };
  auto mma = [&](int st) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i > 0 && i >= mv) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (KS == 32) {
          mma_k32(acc[i][j][0], af[st][i], bf[st][j].x, bf[st][j].y);
          mma_k32(acc[i][j][1], af[st][i], bf[st][j].z, bf[st][j].w);
        } else {
          mma_k16(acc[i][j][0], af[st][i], bf[st][j].x);
          mma_k16(acc[i][j][1], af[st][i], bf[st][j].y);
        }
      }
    }
  };
  const B* w0 = wn;
  for (int kt = 0; kt < kts; ++kt) {
    aoff = kt * KS;
    wn = w0 + kt * nps * 32;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) load(s, s);
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      if (tap + S - 1 < TAPS) load((tap + S - 1) % S, tap + S - 1);
      mma(tap % S);
    }
  }
}

// The product at depth kp (16 .. kMaxK, a multiple of 16): m16n8k32 steps
// when kp is a multiple of 32, else m16n8k16.
constexpr int kMaxK = 128;

template <int TAPS, int MT, int NT>
__device__ __forceinline__ void mma_product(int (&acc)[MT][NT][2][4],
                                            const unsigned (&arow)[MT],
                                            int mv, int row_step, int px_step,
                                            const uint8_t* wp, int kp, int np0,
                                            int nps) {
  if (kp % 32 == 0)
    mma_taps<32, TAPS>(acc, arow, mv, row_step, px_step, wp, kp / 32, np0, nps);
  else
    mma_taps<16, TAPS>(acc, arow, mv, row_step, px_step, wp, kp / 16, np0, nps);
}

// The output pixels of a band of `rows` rows from row oy0, ow wide, in
// row-major order.  inv = ceil(2^32 / ow) (0 for ow = 1), so that q / ow
// is the high word of q * inv, exactly for every q with q * ow < 2^32.
struct Band {
  int n_pix, oy0, ow;
  unsigned inv;
  __device__ __forceinline__ Band(int rows, int oy0_, int ow_)
      : n_pix(rows * ow_), oy0(oy0_), ow(ow_), inv(0xffffffffu / ow_ + 1) {}
};

// Output pixel q of a band, clamped to the band's last pixel (a ragged
// tile's spare rows repeat it).
struct Pix {
  int y, x;
  __device__ __forceinline__ Pix(int q, const Band& b) {
    q = min(q, b.n_pix - 1);
    const int r = b.inv ? static_cast<int>(__umulhi(q, b.inv)) : q;
    y = b.oy0 + r;
    x = q - r * b.ow;
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

// Store one accumulator row (C rows g or g + 8) of a pixel tile: channels
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

// The epilogue of a warp item: every pixel of its first mv pixel tiles
// (from tile m0) that lies in the band, each channel pair np0 + j.
template <int MT, int NT>
__device__ __forceinline__ void store_tile(const Map out,
                                           const int (&acc)[MT][NT][2][4],
                                           int m0, int mv, const Band& b,
                                           int np0, int cout, int shift) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mv) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 16 * (m0 + i) + g + 8 * half;
      if (q < b.n_pix) {
        const Pix o(q, b);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store_row(out, o.y, o.x, acc[i][j], half, np0 + j, cout, shift);
      }
    }
  }
}

// acc[i][j] = v[channel pair np0 + j] in every row of every tile: the
// accumulator init from a bias (np int32).
template <int MT, int NT>
__device__ __forceinline__ void init_bias(int (&acc)[MT][NT][2][4],
                                          const int32_t* v, int np0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = 16 * (np0 + j) + 8 * nt + 2 * t;
      const int v0 = v[co], v1 = v[co + 1];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][j][nt][0] = acc[i][j][nt][2] = v0;
        acc[i][j][nt][1] = acc[i][j][nt][3] = v1;
      }
    }
}

// out(oy, ox) = requant_u8(bias + sum over taps of in(oy * stride + kh,
// ox * stride + kw) . w) for output rows [oy0, oy0 + rows), ox < ow, in
// warp items of Tile<MT, NT>.  w: the packed conv (w0 of a Packed), bias:
// np int32.
template <int MT, int NT>
__device__ inline void conv3x3_mma(const Map in, int cin, const uint8_t* w,
                                   const int32_t* bias, int stride, int oy0,
                                   int rows, int ow, int cout, int shift,
                                   const Map out) {
  const int kp = round16(cin), nps = round16(cout) / 16, ngs = nps / NT;
  const Band band(rows, oy0, ow);
  const int mts = (band.n_pix + 15) / 16, items = (mts + MT - 1) / MT * ngs;
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int m0 = it / ngs * MT, np0 = it % ngs * NT;
    const int mv = min(MT, mts - m0);
    unsigned arow[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const Pix a(16 * (m0 + i) + lane_row(), band);
      arow[i] = smem_u32(in.at(a.y * stride, a.x * stride)) + lane_koff(kp);
    }
    int acc[MT][NT][2][4];
    init_bias(acc, bias, np0);
    mma_product<9>(acc, arow, mv, in.pitch * in.c, in.c, w, kp, np0, nps);
    store_tile(out, acc, m0, mv, band, np0, cout, shift);
  }
}

// The second half of a residual block for output rows [oy0, oy0 + rows),
// in warp items of Tile<MT, NT>: the skip (identity, or the fused 1x1
// downsample of the packed block) read from x at (pad_lo + o * stride),
// shift-aligned, plus b1, starts conv1's accumulator (the add-fold); conv1
// runs over y0 (a Map in the coordinates of its (1, 1)-padded input), then
// requant_u8.
template <int MT, int NT>
__device__ inline void residual_mma(const Map x, int cin, int pad_lo,
                                    int stride, const Packed& pk, bool has_ds,
                                    int skip_shift, const Map y0, int oy0,
                                    int rows, int ow, int cout, int shift1,
                                    const Map out) {
  const int kp = round16(cin), np1 = round16(cout), nps = np1 / 16;
  const int ngs = nps / NT;
  const Band band(rows, oy0, ow);
  const int mts = (band.n_pix + 15) / 16, items = (mts + MT - 1) / MT * ngs;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int m0 = it / ngs * MT, np0 = it % ngs * NT;
    const int mv = min(MT, mts - m0);
    int acc[MT][NT][2][4];
    if (has_ds) {
      unsigned xrow[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const Pix a(16 * (m0 + i) + lane_row(), band);
        xrow[i] = smem_u32(x.at(pad_lo + a.y * stride, pad_lo + a.x * stride)) +
                  lane_koff(kp);
      }
      int accd[MT][NT][2][4];
      init_bias(accd, pk.bd, np0);
      mma_product<1>(accd, xrow, mv, 0, 0, pk.wd, kp, np0, nps);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][nt][e] = shift_align(accd[i][j][nt][e], skip_shift);
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Pix o(16 * (m0 + i) + g + 8 * half, band);
          const uint8_t* xc = x.at(pad_lo + o.y * stride, pad_lo + o.x * stride);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int co = 16 * (np0 + j) + 8 * nt + 2 * t;
              acc[i][j][nt][2 * half] = shift_align(xc[co], skip_shift);
              acc[i][j][nt][2 * half + 1] = shift_align(xc[co + 1], skip_shift);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int co = 16 * (np0 + j) + 8 * nt + 2 * t;
        const int b0 = pk.b1[co], b1 = pk.b1[co + 1];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          acc[i][j][nt][0] += b0;
          acc[i][j][nt][2] += b0;
          acc[i][j][nt][1] += b1;
          acc[i][j][nt][3] += b1;
        }
      }
    unsigned yrow[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const Pix a(16 * (m0 + i) + lane_row(), band);
      yrow[i] = smem_u32(y0.at(a.y, a.x)) + lane_koff(np1);
    }
    mma_product<9>(acc, yrow, mv, y0.pitch * y0.c, y0.c, pk.w1, np1, np0, nps);
    store_tile(out, acc, m0, mv, band, np0, cout, shift1);
  }
}

}  // namespace repro
