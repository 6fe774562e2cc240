// The residual block's arithmetic as device functions shared by the fused
// block kernel (resblock_fused.cu) and the block-chain kernel
// (block_chain.cu), so that the block body is written once.
//
//   conv3x3_requant:  out = requant_u8(bias + conv3x3(in), shift)
//                     (conv0 of a block, stride 1 or 2, and the stem)
//   residual_requant: out = requant_u8(skip + b1 + conv3x3(y0), shift1)
//                     skip = shift_align(x, skip_shift), or
//                          = shift_align(x *1x1 wd + bd, skip_shift)
//
// Both walk every output item of one image with all the threads of the
// block: an item is one output pixel times four consecutive output
// channels.  Weights are staged transposed from HWIO to [tap][cout][cin]
// so that four input channels of one output channel are one 32-bit word,
// the operand dp4a takes.
#pragma once

#include "common.cuh"

namespace repro {

// One image's u8 HWC map, in shared or device memory.  Coordinate (y, x)
// is stored at  p + ((y + off) * pitch + x + off) * c.  A conv reads
// through a Map in the coordinates of its padded input; an epilogue writes
// through one in output coordinates.
struct Map {
  uint8_t* p;
  int pitch;  // stored pixels per row
  int off;    // stored row and column of coordinate 0
  int c;      // bytes per pixel, a multiple of 4

  __device__ __forceinline__ uint8_t* at(int y, int x) const {
    return p + ((y + off) * pitch + x + off) * c;
  }
};

// HWIO (taps, cin, cout) s8 -> [tap][cout][cin] in shared memory, one
// 32-bit word of four input channels at a time; cin a multiple of 4.
__device__ inline void stage_transposed(const int8_t* __restrict__ src,
                                        int8_t* dst, int taps, int cin,
                                        int cout) {
  const int cin4 = cin / 4;
  for (int row = threadIdx.x; row < taps * cout; row += blockDim.x) {
    const int tap = row / cout;
    const int co = row - tap * cout;
    const int8_t* s = src + tap * cin * cout + co;
    unsigned* d = reinterpret_cast<unsigned*>(dst + row * cin);
    for (int c4 = 0; c4 < cin4; ++c4) {
      const int8_t* q = s + 4 * c4 * cout;
      d[c4] = static_cast<uint8_t>(q[0]) |
              static_cast<unsigned>(static_cast<uint8_t>(q[cout])) << 8 |
              static_cast<unsigned>(static_cast<uint8_t>(q[2 * cout])) << 16 |
              static_cast<unsigned>(static_cast<uint8_t>(q[3 * cout])) << 24;
    }
  }
}

// dst[0..n) = src[0..n), or zeros where src is null.
__device__ inline void stage_bias(const int32_t* __restrict__ src,
                                  int32_t* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src ? src[i] : 0;
}

// Zero the one-pixel ring around an h x w map of c bytes per pixel (stored
// as (h + 2) x (w + 2)).
__device__ inline void zero_ring(uint8_t* p, int h, int w, int c) {
  const int c4 = c / 4, ring = 2 * (w + 2) + 2 * h;
  for (int i = threadIdx.x; i < ring * c4; i += blockDim.x) {
    const int r = i / c4;
    const int q = i - r * c4;
    int y, x;
    if (r < w + 2) {
      y = 0, x = r;
    } else if (r < 2 * (w + 2)) {
      y = h + 1, x = r - (w + 2);
    } else {
      const int k = r - 2 * (w + 2);
      y = 1 + k / 2, x = (k & 1) ? w + 1 : 0;
    }
    reinterpret_cast<unsigned*>(p + (y * (w + 2) + x) * c)[q] = 0;
  }
}

// acc[j] += sum over the words of act (n4 words) times the weight row of
// output channel co + j (rows of n4 words, consecutive).
__device__ __forceinline__ void dot4(const unsigned* __restrict__ act,
                                     const int* __restrict__ wrow, int n4,
                                     int acc[4]) {
  for (int c4 = 0; c4 < n4; ++c4) {
    const unsigned v = act[c4];
    acc[0] = dp4a_us(v, wrow[c4], acc[0]);
    acc[1] = dp4a_us(v, wrow[n4 + c4], acc[1]);
    acc[2] = dp4a_us(v, wrow[2 * n4 + c4], acc[2]);
    acc[3] = dp4a_us(v, wrow[3 * n4 + c4], acc[3]);
  }
}

__device__ __forceinline__ unsigned pack_u8(const int acc[4], int shift) {
  return requant_u8(acc[0], shift) | requant_u8(acc[1], shift) << 8 |
         requant_u8(acc[2], shift) << 16 | requant_u8(acc[3], shift) << 24;
}

// out(oy, ox) = requant_u8(bias + sum over taps of in(oy * stride + kh,
// ox * stride + kw) . wt) for oy < oh, ox < ow.  wt: [9][cout][in.c].
__device__ __forceinline__ void conv3x3_requant(
    const Map in, const int8_t* wt, const int32_t* bias, int stride, int oh,
    int ow, int cout, int shift, const Map out) {
  const int cin4 = in.c / 4, cout4 = cout / 4;
  for (int it = threadIdx.x; it < oh * ow * cout4; it += blockDim.x) {
    const int pix = it / cout4;
    const int co = 4 * (it - pix * cout4);
    const int oy = pix / ow, ox = pix - oy * ow;
    int acc[4] = {bias[co], bias[co + 1], bias[co + 2], bias[co + 3]};
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw)
        dot4(reinterpret_cast<const unsigned*>(in.at(oy * stride + kh, ox * stride + kw)),
             reinterpret_cast<const int*>(wt + ((kh * 3 + kw) * cout + co) * in.c),
             cin4, acc);
    *reinterpret_cast<unsigned*>(out.at(oy, ox) + co) = pack_u8(acc, shift);
  }
}

// The second half of a residual block: the skip (identity, or the fused
// 1x1 downsample wdt: [cout][x.c] with bias bd) read from x at
// (pad_lo + o * stride), shift-aligned, plus b1, starts conv1's
// accumulator (the add-fold); conv1 runs over y0 (a Map in the
// coordinates of its (1, 1)-padded input), then requant_u8.
__device__ __forceinline__ void residual_requant(
    const Map x, int pad_lo, int stride, const int8_t* wdt,
    const int32_t* bd, bool has_ds, int skip_shift, const Map y0,
    const int8_t* w1t, const int32_t* b1, int oh, int ow, int cout,
    int shift1, const Map out) {
  const int cin4 = x.c / 4, cout4 = cout / 4;
  for (int it = threadIdx.x; it < oh * ow * cout4; it += blockDim.x) {
    const int pix = it / cout4;
    const int co = 4 * (it - pix * cout4);
    const int oy = pix / ow, ox = pix - oy * ow;
    // SAME padding of a 1x1 conv (or of the identity) is zero
    const uint8_t* xc = x.at(pad_lo + oy * stride, pad_lo + ox * stride);
    int acc[4];
    if (has_ds) {
      int accd[4] = {bd[co], bd[co + 1], bd[co + 2], bd[co + 3]};
      dot4(reinterpret_cast<const unsigned*>(xc),
           reinterpret_cast<const int*>(wdt + co * x.c), cin4, accd);
      for (int j = 0; j < 4; ++j) acc[j] = shift_align(accd[j], skip_shift);
    } else {
      for (int j = 0; j < 4; ++j) acc[j] = shift_align(xc[co + j], skip_shift);
    }
    for (int j = 0; j < 4; ++j) acc[j] += b1[co + j];
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw)
        dot4(reinterpret_cast<const unsigned*>(y0.at(oy + kh, ox + kw)),
             reinterpret_cast<const int*>(w1t + ((kh * 3 + kw) * cout + co) * cout),
             cout4, acc);
    *reinterpret_cast<unsigned*>(out.at(oy, ox) + co) = pack_u8(acc, shift1);
  }
}

}  // namespace repro
