// conv2d_int8: general fh x fw strided conv of an int8 (or uint8) NHWC map
// with s8 HWIO weights.  The int32 accumulator is bias + skip + sum x.w;
// then optional ReLU; then either the int32 map itself or, with a shift s,
// the rounding shift (acc + 2^(s-1)) >> s (only when s > 0: a negative
// shift is a plain clip) and a clip to u8 (ReLU) or s8.
//
// Replaces the TPU kernel src/repro/kernels/conv2d_int8/conv2d_int8.py:
// conv2d_int8 (body _kernel; wrapper ops.py:conv2d_int8_op, which zero
// pads ((f-1)//2, f-1-(f-1)//2) on each spatial dim at every stride).
//
// What bounds it on an H100: bytes.  At ResNet20's shapes at batch 32 a
// 3x3 conv does 9 C multiply-adds an output byte and reads C input bytes
// an output pixel (about 300 int8 operations a byte moved at C = 16 to
// 64), far below the ~590 a byte at which the int8 tensor cores (1,979
// TOP/s) would outrun HBM (3.35 TB/s).  No PyTorch call computes it: on
// CUDA F.conv2d refuses int8, and a float conv has no integer epilogue.
//
// Design: one thread per (output pixel, group of 4 output channels);
// consecutive threads take consecutive channel groups, so a warp's filter
// words and output stores are contiguous and its input words are shared.
// The zero pad is applied by bounds checks on the unpadded input, so the
// wrapper copies nothing.  With C and O multiples of 4, each filter tap
// reads one input word (4 channels) and four filter words (4 output
// channels of 4 input channels), transposes the 4 x 4 filter bytes with
// __byte_perm and issues 4 dp4a (s8 x s8, or u8 x s8 for a uint8 input);
// otherwise a byte loop.  Every add wraps modulo 2^32, as the reference's
// int32 adds do: dp4a's own add wraps, and the byte loop adds unsigned.
// No shared-memory staging: the input and filter are read through L1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOutI32 = 0, kOutU8 = 1, kOutS8 = 2;

// out[j] packs rows 0..3 of column j of the 4 x 4 byte matrix whose row i
// is the word w[i] (byte j of w[i] = element (i, j)).
__device__ __forceinline__ void transpose4x4(const unsigned w[4],
                                             unsigned out[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

template <bool kUnsignedX>
__device__ __forceinline__ int dp4a(unsigned x, unsigned w, int acc) {
  if (kUnsignedX) return repro::dp4a_us(x, static_cast<int>(w), acc);
  return __dp4a(static_cast<int>(x), static_cast<int>(w), acc);
}

template <bool kUnsignedX>
__global__ void __launch_bounds__(kThreads)
conv2d_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int32_t* __restrict__ b,
                   const int32_t* __restrict__ skip, void* __restrict__ out,
                   int n_img, int h, int w_img, int c, int fh, int fw, int o,
                   int stride, int oh, int ow, bool relu, int shift,
                   int out_kind, bool vec_in, bool vec_out) {
  const int og = (o + 3) / 4;
  const long long total = static_cast<long long>(n_img) * oh * ow * og;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int g = static_cast<int>(t % og);
  const long long pix = t / og;   // (n * oh + oy) * ow + ox
  const int ox = static_cast<int>(pix % ow);
  const long long row = pix / ow;
  const int oy = static_cast<int>(row % oh);
  const int n = static_cast<int>(row / oh);
  const int o0 = 4 * g;
  const int nj = min(4, o - o0);
  const int pt = (fh - 1) / 2, pl = (fw - 1) / 2;

  int acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned a = 0u;
    if (j < nj) {
      a = static_cast<unsigned>(b[o0 + j]);
      if (skip != nullptr) a += static_cast<unsigned>(skip[pix * o + o0 + j]);
    }
    acc[j] = static_cast<int>(a);
  }

  for (int kh = 0; kh < fh; ++kh) {
    const int iy = oy * stride - pt + kh;
    if (iy < 0 || iy >= h) continue;
    for (int kw = 0; kw < fw; ++kw) {
      const int ix = ox * stride - pl + kw;
      if (ix < 0 || ix >= w_img) continue;
      const int8_t* px = x + ((static_cast<long long>(n) * h + iy) * w_img + ix) * c;
      const int8_t* pw = w + static_cast<long long>(kh * fw + kw) * c * o + o0;
      if (vec_in) {
        for (int ci = 0; ci < c; ci += 4) {
          const unsigned xv = __ldg(reinterpret_cast<const unsigned*>(px + ci));
          unsigned rows[4], cols[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rows[i] = __ldg(reinterpret_cast<const unsigned*>(
                pw + static_cast<long long>(ci + i) * o));
          transpose4x4(rows, cols);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = dp4a<kUnsignedX>(xv, cols[j], acc[j]);
        }
      } else {
        for (int ci = 0; ci < c; ++ci) {
          const int xv = kUnsignedX ? static_cast<int>(static_cast<uint8_t>(px[ci]))
                                    : static_cast<int>(px[ci]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nj)
              acc[j] = static_cast<int>(
                  static_cast<unsigned>(acc[j]) +
                  static_cast<unsigned>(xv * static_cast<int>(pw[static_cast<long long>(ci) * o + j])));
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (relu) acc[j] = max(acc[j], 0);
    if (out_kind != kOutI32) {
      if (shift > 0)
        acc[j] = static_cast<int>(static_cast<unsigned>(acc[j]) + (1u << (shift - 1))) >> shift;
      acc[j] = out_kind == kOutU8 ? min(max(acc[j], 0), 255) : min(max(acc[j], -128), 127);
    }
  }
  const long long base = pix * o + o0;
  if (out_kind == kOutI32) {
    int32_t* op = static_cast<int32_t*>(out) + base;
    if (vec_out) {
      *reinterpret_cast<int4*>(op) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj) op[j] = acc[j];
    }
    return;
  }
  uint8_t* op = static_cast<uint8_t*>(out) + base;
  if (vec_out) {
    unsigned word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) word |= (static_cast<unsigned>(acc[j]) & 0xffu) << (8 * j);
    *reinterpret_cast<unsigned*>(op) = word;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nj) op[j] = static_cast<uint8_t>(acc[j] & 0xff);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// x: (n, h, w_img, c) int8 (x_unsigned = 0) or uint8; w: (fh, fw, c, o)
// int8; b: (o,) int32; skip: (n, oh, ow, o) int32 or null; out: (n, oh,
// ow, o) int32 (out_kind 0), uint8 (1) or int8 (2), with oh = (h - 1) /
// stride + 1 and ow likewise.  All contiguous.  Returns the cudaError_t of
// the launch.
REPRO_EXPORT int conv2d_int8_launch(const void* x, const void* w,
                                    const void* b, const void* skip,
                                    void* out, int n, int h, int w_img,
                                    int c, int fh, int fw, int o, int stride,
                                    int x_unsigned, int relu, int shift,
                                    int out_kind, void* stream) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || fh <= 0 || fw <= 0 ||
      o <= 0 || stride <= 0 || shift < -31 || shift > 31 || out_kind < kOutI32 ||
      out_kind > kOutS8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int oh = (h - 1) / stride + 1, ow = (w_img - 1) / stride + 1;
  const long long total = static_cast<long long>(n) * oh * ow * ((o + 3) / 4);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = c % 4 == 0 && o % 4 == 0 && aligned(x, 4) && aligned(w, 4);
  const bool vec_out = o % 4 == 0 && aligned(out, out_kind == kOutI32 ? 16 : 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int32_t*>(b);
  const auto* sp = static_cast<const int32_t*>(skip);
  if (x_unsigned)
    conv2d_int8_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, wp, bp, sp, out, n, h, w_img, c, fh, fw, o, stride, oh, ow,
        relu != 0, shift, out_kind, vec_in, vec_out);
  else
    conv2d_int8_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, wp, bp, sp, out, n, h, w_img, c, fh, fw, o, stride, oh, ow,
        relu != 0, shift, out_kind, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
