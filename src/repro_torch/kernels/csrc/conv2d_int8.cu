// conv2d_int8: general fh x fw strided conv of an int8 (or uint8) NHWC map
// with s8 HWIO weights.  The int32 accumulator is bias + skip + sum x.w;
// then optional ReLU; then either the int32 map itself or, with a shift s,
// the rounding shift (acc + 2^(s-1)) >> s (only when s > 0: a negative
// shift is a plain clip, NOT the left shift of requant_u8 in common.cuh,
// so this kernel keeps its own epilogue) and a clip to u8 (ReLU) or s8.
//
// Replaces the TPU kernel src/repro/kernels/conv2d_int8/conv2d_int8.py:
// conv2d_int8 (body _kernel; wrapper ops.py:conv2d_int8_op, which zero
// pads ((f-1)//2, f-1-(f-1)//2) on each spatial dim at EVERY stride: a
// 3x3 stride-2 conv pads 1 on top and left, unlike the (0, 1) of jax.lax
// SAME that the block kernels use, block_chain.cu:pad_lo_of).
//
// What bounds it on an H100: bytes.  At ResNet20's shapes at batch 32 a
// 3x3 conv does 9 C multiply-adds an output byte and reads C input bytes
// an output pixel (about 300 int8 operations a byte moved at C = 16 to
// 64), far below the ~590 a byte at which the int8 tensor cores (1,979
// TOP/s) would outrun HBM (3.35 TB/s).  At these sizes a layer is a few
// microseconds of work, so latency bounds it in practice: the launch, one
// round trip to device memory, and a warp's chain of dependent mma steps.
// No PyTorch call computes it: on CUDA F.conv2d refuses int8, and a float
// conv has no integer epilogue.
//
// Two paths, chosen by shape in ops.py:conv_path and counted in
// conv2d_int8_op.launches_by_path:
//
// mma (C a multiple of 16 up to 128, O a multiple of 8, a 3x3 or 1x1
// filter, aligned operands, shared memory enough): an implicit GEMM on the
// int8 tensor cores, mma.sync m16n8k32 (or m16n8k16 steps where C is not a
// multiple of 32), .s8.s8 for an int8 input and .u8.s8 for a uint8 one.
//   M = output pixels of a band of output rows of one image, in tiles of
//       16 (a ragged last tile repeats its last pixel and does not store
//       it); N = output channels in pairs of n8 tiles (16 a warp item, the
//       filter zero past O); K = the C input channels of one tap, summed
//       over the taps.
// A thread block (ops.py:conv_tiles sizes its band of output rows and its
// group of output channels from the shape and the card's SM count) copies
// the input rows its band reads, stride and filter halo included, in the
// wrapper's padded coordinates, into a plane with a zero ring by 16-byte
// cp.async, each pixel at block_body.cuh's pixel_pitch (an odd count of
// 16-byte chunks, so the 8 rows of an ldmatrix phase at stride 1 fall on 8
// bank groups).  While those copies fly it stages its slice of the bias
// and of the HWIO filter (at most 4,608 filter bytes, or 16 channels)
// itself into the mma B-fragment order of block_body.cuh's packed weights
// (4 x 4 byte blocks read as words and transposed with __byte_perm).  A
// fragments come by ldmatrix from per-lane row addresses (the implicit
// im2col), B fragments by one 8- or 16-byte shared load a lane.
// The epilogue follows the accumulator: C starts at bias + skip (the
// int32 skip map read straight into the accumulator fragments: the
// add-fold), then the products, then ReLU, then the int32 store or the
// shift and clip.  No .satfinite: the integer sums wrap modulo 2^32, as
// the reference's int32 adds do, in any order.
//
// general (every other shape): one thread per (output pixel, group of 4
// output channels); consecutive threads take consecutive channel groups,
// so a warp's filter words and output stores are contiguous and its input
// words are shared.  The zero pad is applied by bounds checks on the
// unpadded input.  With C and O multiples of 4, each filter tap reads one
// input word (4 channels) and four filter words (4 output channels of 4
// input channels), transposes the 4 x 4 filter bytes with __byte_perm and
// issues 4 dp4a (s8 x s8, or u8 x s8 for a uint8 input); otherwise a byte
// loop.  Every add wraps modulo 2^32: dp4a's own add wraps, and the byte
// loop adds unsigned.  No shared-memory staging.
#include "block_body.cuh"

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
conv2d_int8_general(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
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

// ---------------------------------------------------------------------------
// The tensor-core path
// ---------------------------------------------------------------------------

// c += a (16 x 32, row) * b (32 x 8 s8, col); a u8 (kU) or s8
template <bool kU>
__device__ __forceinline__ void mma32(int c[4], const unsigned a[4], unsigned b0,
                                      unsigned b1) {
  if constexpr (kU) {
    repro::mma_k32(c, a, b0, b1);
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}
// c += a (16 x 16, row) * b (16 x 8 s8, col); a u8 (kU) or s8
template <bool kU>
__device__ __forceinline__ void mma16(int c[4], const unsigned a[2], unsigned b0) {
  if constexpr (kU) {
    repro::mma_k16(c, a, b0);
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b0));
  }
}

// acc[nt] += the product of one warp item over the FH x FW taps and K =
// KTS * KS bytes a tap: block_body.cuh's mma_taps for any filter and either
// input sign.  Fully unrolled, the fragments of step s + 2 loaded while the
// mmas of step s issue.  arow: this lane's ldmatrix row at tap (0, 0);
// row_step / px_step: bytes between stored input rows / pixels; wp: the
// fragment-ordered filter, at n-pair np of nps.
template <bool kU, int KS, int FH, int FW, int KTS>
__device__ __forceinline__ void conv_taps(int acc[2][4], const uint8_t* arow,
                                          int row_step, int px_step,
                                          const uint8_t* wp, int np, int nps) {
  using B = typename std::conditional<KS == 32, uint4, uint2>::type;
  constexpr int AR = KS / 8;
  constexpr int STEPS = FH * FW * KTS, P = STEPS < 2 ? STEPS : 2;
  const B* wb = reinterpret_cast<const B*>(wp) + np * 32 + (threadIdx.x & 31);
  const int wstep = nps * 32;
  unsigned af[P + 1][AR];
  B bf[P + 1];
  auto load = [&](int s) {
    const int tap = s / KTS, kt = s % KTS;
    const uint8_t* a = arow + (tap / FW) * row_step + (tap % FW) * px_step + kt * KS;
    if constexpr (KS == 32) repro::ldsm_x4(af[s % (P + 1)], a);
    else repro::ldsm_x2(af[s % (P + 1)], a);
    bf[s % (P + 1)] = wb[s * wstep];
  };
#pragma unroll
  for (int s = 0; s < P; ++s) load(s);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (s + P < STEPS) load(s + P);
    const int i = s % (P + 1);
    if constexpr (KS == 32) {
      mma32<kU>(acc[0], af[i], bf[i].x, bf[i].y);
      mma32<kU>(acc[1], af[i], bf[i].z, bf[i].w);
    } else {
      mma16<kU>(acc[0], af[i], bf[i].x);
      mma16<kU>(acc[1], af[i], bf[i].y);
    }
  }
}

// The product at depth kp = C (16 .. 128, a multiple of 16): m16n8k32
// steps when kp is a multiple of 32, else m16n8k16.
template <bool kU, int FH, int FW>
__device__ __forceinline__ void conv_product(int acc[2][4], const uint8_t* arow,
                                             int row_step, int px_step,
                                             const uint8_t* wp, int kp, int np,
                                             int nps) {
  switch (kp) {
    case 16: return conv_taps<kU, 16, FH, FW, 1>(acc, arow, row_step, px_step, wp, np, nps);
    case 32: return conv_taps<kU, 32, FH, FW, 1>(acc, arow, row_step, px_step, wp, np, nps);
    case 48: return conv_taps<kU, 16, FH, FW, 3>(acc, arow, row_step, px_step, wp, np, nps);
    case 64: return conv_taps<kU, 32, FH, FW, 2>(acc, arow, row_step, px_step, wp, np, nps);
    case 80: return conv_taps<kU, 16, FH, FW, 5>(acc, arow, row_step, px_step, wp, np, nps);
    case 96: return conv_taps<kU, 32, FH, FW, 3>(acc, arow, row_step, px_step, wp, np, nps);
    case 112: return conv_taps<kU, 16, FH, FW, 7>(acc, arow, row_step, px_step, wp, np, nps);
    default: return conv_taps<kU, 32, FH, FW, 4>(acc, arow, row_step, px_step, wp, np, nps);
  }
}

// Shared-memory layout of an mma thread block that takes ng output channels
// (a multiple of 16): bias (ng int32) | its filter slice in fragment order
// (fh * fw * c * ng bytes) | input plane of (band - 1) * stride + fh rows
// of the padded width w + fw - 1, pixel_pitch bytes a pixel.
struct MmaLayout {
  int w_off, plane_off, wp, pitch, bytes;
};

__host__ __device__ inline MmaLayout mma_layout(int w_img, int c, int ng, int fh,
                                                int fw, int stride, int band) {
  MmaLayout l;
  l.w_off = 4 * ng;
  l.plane_off = l.w_off + fh * fw * c * ng;
  l.wp = w_img + fw - 1;
  l.pitch = repro::pixel_pitch(c);
  l.bytes = l.plane_off + ((band - 1) * stride + fh) * l.wp * l.pitch;
  return l;
}

// Thread block (image n, band r, channel group q): output rows [r * band,
// r * band + nb) of image n, output channels [q * ng, q * ng + ng).  c a
// multiple of 16 (at most 128), o a multiple of 8, ng a multiple of 16; x
// 16-byte, w 4-byte, skip and out 8-byte aligned.
template <bool kU, int FH, int FW>
__global__ void __launch_bounds__(kThreads)
conv2d_int8_mma(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                const int32_t* __restrict__ b, const int32_t* __restrict__ skip,
                void* __restrict__ out, int h, int w_img, int c, int o,
                int stride, int oh, int ow, int band, int bands, int ng,
                int groups, bool relu, int shift, int out_kind) {
  constexpr int PT = (FH - 1) / 2, PL = (FW - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout l = mma_layout(w_img, c, ng, FH, FW, stride, band);
  int32_t* sb = reinterpret_cast<int32_t*>(smem);
  unsigned* sw = reinterpret_cast<unsigned*>(smem + l.w_off);
  uint8_t* plane = smem + l.plane_off;
  const int grp = blockIdx.x % groups, rest = blockIdx.x / groups;
  const int img = rest / bands;
  const int r0 = (rest - img * bands) * band, nb = min(band, oh - r0);
  const int n_lo = grp * ng, nps = ng / 16;  // channels [n_lo, n_lo + ng)

  // ---- the input rows of the band by cp.async: stored row r, column xs =
  // padded row r0 * stride + r, padded column xs; zero outside the image
  // (the wrapper's pad) ----
  const int c16 = c / 16, rows = (nb - 1) * stride + FH, y0 = r0 * stride - PT;
  for (int i = threadIdx.x; i < rows * l.wp * c16; i += kThreads) {
    const int pos = i / c16, q = i - pos * c16;
    const int r = pos / l.wp, xs = pos - r * l.wp;
    const int y = y0 + r, xi = xs - PL;
    uint8_t* dst = plane + (r * l.wp + xs) * l.pitch + 16 * q;
    if (y >= 0 && y < h && xi >= 0 && xi < w_img)
      repro::cp_async16(dst, x + ((static_cast<size_t>(img) * h + y) * w_img + xi) * c + 16 * q);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  repro::cp_async_commit();

  // ---- meanwhile the bias and filter slices (zero past o), the filter in
  // fragment order: word (tap, k .. k + 3, n) of the K x N product at
  //   [tap][k / ks][n / 16][lane 4 (n % 8) + (k % 16) / 4][(n % 16) / 8][(k % ks) / 16]
  // (block_body.cuh's packed layout), from 4 x 4 byte blocks of the HWIO
  // filter read as 4 words of 4 output channels and transposed ----
  for (int i = threadIdx.x; i < ng; i += kThreads) sb[i] = n_lo + i < o ? __ldg(b + n_lo + i) : 0;
  const int ks = c % 32 ? 16 : 32, J = ks / 16, kts = c / ks;
  const int k4s = c / 4, n4s = ng / 4;
  for (int i = threadIdx.x; i < FH * FW * k4s * n4s; i += kThreads) {
    const int n4 = i % n4s, kq = i / n4s;
    const int k4 = kq % k4s, tap = kq / k4s;
    const int n0 = 4 * n4, k0 = 4 * k4;
    unsigned rw[4], cols[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rw[r] = n_lo + n0 < o ? __ldg(reinterpret_cast<const unsigned*>(
                           w + (static_cast<size_t>(tap) * c + k0 + r) * o + n_lo + n0))
                     : 0u;
    transpose4x4(rw, cols);
    const int kt = k0 / ks, kk = k0 - kt * ks, j = kk / 16, t = (kk % 16) / 4;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = n0 + jn;
      const int lane = 4 * (n % 8) + t;
      sw[((((tap * kts + kt) * nps + n / 16) * 32 + lane) * 2 + (n % 16) / 8) * J + j] =
          cols[jn];
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // ---- warp items: 16 output pixels x 16 output channels ----
  const int n_pix = nb * ow, items = (n_pix + 15) / 16 * nps;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_step = l.wp * l.pitch;
  const size_t pix0 = (static_cast<size_t>(img) * oh + r0) * ow;
  const int o_here = o - n_lo;  // channels of o at or past n_lo
  for (int it = threadIdx.x >> 5; it < items; it += kThreads / 32) {
    const int mt = it / nps, np = it - mt * nps;
    const int qa = min(16 * mt + repro::lane_row(), n_pix - 1);
    const int ay = qa / ow, ax = qa - ay * ow;
    const uint8_t* arow = plane + (ay * stride * l.wp + ax * stride) * l.pitch +
                          repro::lane_koff(c);
    // C starts at bias + skip, added unsigned (wrapping as int32 adds do)
    int acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = 16 * np + 8 * nt + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned a0 = static_cast<unsigned>(sb[co]), a1 = static_cast<unsigned>(sb[co + 1]);
        if (skip != nullptr && co < o_here) {
          const int qs = min(16 * mt + g + 8 * half, n_pix - 1);
          const int2 sk = __ldg(reinterpret_cast<const int2*>(
              skip + (pix0 + qs) * o + n_lo + co));
          a0 += static_cast<unsigned>(sk.x);
          a1 += static_cast<unsigned>(sk.y);
        }
        acc[nt][2 * half] = static_cast<int>(a0);
        acc[nt][2 * half + 1] = static_cast<int>(a1);
      }
    }
    conv_product<kU, FH, FW>(acc, arow, row_step, l.pitch,
                             reinterpret_cast<const uint8_t*>(sw), c, np, nps);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int co = 16 * np + 8 * nt + 2 * t;
      if (co >= o_here) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qo = 16 * mt + g + 8 * half;
        if (qo >= n_pix) continue;
        const size_t at = (pix0 + qo) * o + n_lo + co;
        int v[2] = {acc[nt][2 * half], acc[nt][2 * half + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (relu) v[e] = max(v[e], 0);
          if (out_kind != kOutI32) {
            if (shift > 0)
              v[e] = static_cast<int>(static_cast<unsigned>(v[e]) + (1u << (shift - 1))) >> shift;
            v[e] = out_kind == kOutU8 ? min(max(v[e], 0), 255) : min(max(v[e], -128), 127);
          }
        }
        if (out_kind == kOutI32) {
          *reinterpret_cast<int2*>(static_cast<int32_t*>(out) + at) = make_int2(v[0], v[1]);
        } else {
          *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(out) + at) =
              static_cast<uint16_t>((v[0] & 0xff) | (v[1] & 0xff) << 8);
        }
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// Dynamic shared memory of an mma-path thread block.
REPRO_EXPORT int conv2d_int8_mma_smem_bytes(int w_img, int c, int ng, int fh,
                                            int fw, int stride, int band) {
  return mma_layout(w_img, c, ng, fh, fw, stride, band).bytes;
}

// x: (n, h, w_img, c) int8 (x_unsigned = 0) or uint8; w: (fh, fw, c, o)
// int8; b: (o,) int32; skip: (n, oh, ow, o) int32 or null; out: (n, oh,
// ow, o) int32 (out_kind 0), uint8 (1) or int8 (2), with oh = (h - 1) /
// stride + 1 and ow likewise.  All contiguous.  path 0: general; 1: mma
// (the shapes and alignments of conv2d_int8_mma; band: output rows a
// thread block takes, 1 .. oh; ng: output channels a thread block takes, a
// multiple of 16 that divides o rounded up to 16).  Returns the
// cudaError_t of the launch;
// cudaErrorInvalidValue for arguments the path does not take.
REPRO_EXPORT int conv2d_int8_launch(const void* x, const void* w,
                                    const void* b, const void* skip,
                                    void* out, int n, int h, int w_img,
                                    int c, int fh, int fw, int o, int stride,
                                    int x_unsigned, int relu, int shift,
                                    int out_kind, int band, int ng, int path,
                                    void* stream) {
  if (n <= 0 || h <= 0 || w_img <= 0 || c <= 0 || fh <= 0 || fw <= 0 ||
      o <= 0 || stride <= 0 || shift < -31 || shift > 31 || out_kind < kOutI32 ||
      out_kind > kOutS8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int oh = (h - 1) / stride + 1, ow = (w_img - 1) / stride + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const int32_t*>(b);
  const auto* sp = static_cast<const int32_t*>(skip);
  if (path == 1) {
    const bool f33 = fh == 3 && fw == 3, f11 = fh == 1 && fw == 1;
    const int np16 = repro::round16(o);
    if (c % 16 || c > repro::kMaxK || o % 8 || !(f33 || f11) || band < 1 ||
        band > oh || ng < 16 || ng % 16 || np16 % ng || !aligned(x, 16) ||
        !aligned(w, 4) || !aligned(skip, 8) || !aligned(out, 8))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = mma_layout(w_img, c, ng, fh, fw, stride, band).bytes;
    const int bands = (oh + band - 1) / band, groups = np16 / ng;
    const long long blocks = static_cast<long long>(n) * bands * groups;
    if (smem > repro::kMaxSmemBytes || blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    using Kern = void (*)(const uint8_t*, const int8_t*, const int32_t*, const int32_t*,
                          void*, int, int, int, int, int, int, int, int, int, int,
                          int, bool, int, int);
    Kern kern = conv2d_int8_mma<false, 1, 1>;
    if (x_unsigned && f33) kern = conv2d_int8_mma<true, 3, 3>;
    else if (x_unsigned) kern = conv2d_int8_mma<true, 1, 1>;
    else if (f33) kern = conv2d_int8_mma<false, 3, 3>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w), bp, sp, out,
        h, w_img, c, o, stride, oh, ow, band, bands, ng, groups, relu != 0, shift,
        out_kind);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * oh * ow * ((o + 3) / 4);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = c % 4 == 0 && o % 4 == 0 && aligned(x, 4) && aligned(w, 4);
  const bool vec_out = o % 4 == 0 && aligned(out, out_kind == kOutI32 ? 16 : 4);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  if (x_unsigned)
    conv2d_int8_general<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, wp, bp, sp, out, n, h, w_img, c, fh, fw, o, stride, oh, ow,
        relu != 0, shift, out_kind, vec_in, vec_out);
  else
    conv2d_int8_general<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, wp, bp, sp, out, n, h, w_img, c, fh, fw, o, stride, oh, ow,
        relu != 0, shift, out_kind, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
