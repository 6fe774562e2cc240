// conv_stem: 3x3 stride-1 SAME conv of the u8 image with s8 weights, int32
// accumulator started at the bias, then requant_u8 (ReLU, pow2 rounding
// shift, clip to [0, 255]) into the u8 activation grid.
//
// Replaces the TPU kernel src/repro/kernels/conv_stem/conv_stem.py:conv_stem
// (body _kernel; wrapper ops.py:conv_stem_op, which pads the image (1, 1)).
//
// What bounds it on an H100: bytes.  Per pixel it reads 3 input bytes and
// writes Cout = 16 output bytes for 27 * 16 multiply-adds, about 45 int8
// operations per byte, far below the ~590 per byte at which int8 tensor
// cores (1,979 TOP/s) would outrun HBM (3.35 TB/s).  At the serving batch
// sizes (0.6 MB at batch 32: 0.19 us at 3.35 TB/s) latency bounds it in
// practice: the launch, one round trip to device memory, and the chain of
// dependent instructions of the slowest thread.
//
// Two paths, chosen by shape in ops.py:stem_path and counted in
// conv_stem_op.launches_by_path:
//
// banded (cin <= 4, cout a multiple of 16: the RGB stem).  A thread block
// takes a band of output rows of one image: ops.py:stem_band_rows sizes it
// from the card's SM count so that batch 32 gives two thread blocks an SM
// (bands of 4 rows, 256 thread blocks on an H100).  It copies the band's
// input rows plus one halo row either side, which are contiguous in device
// memory, into shared memory with 16-byte cp.async, from the 16-byte
// boundary at or below the band's first byte; the last copy zero-fills
// past the band's last byte, so nothing past it is read.  While those
// copies fly, it stages the HWIO filter as [tap][cout] words of 4 input
// channels (a dp4a word; channels past cin zero) and the bias, its channel
// loops unrolled and predicated (cin <= 4) so that a thread's loads are in
// flight together.  Then it spreads the raw rows into a plane of one
// 4-byte word a pixel with an explicit zero ring, so that the inner loop
// has no bounds checks.  One thread computes 16 output channels of one
// pixel: the 9 taps fully unrolled, one shared word of input and four
// 16-byte weight vectors (the same for every thread of the warp: a
// broadcast) a tap, 16 dp4a, and one 16-byte store, so that a warp writes
// 512 contiguous bytes.  An int8 tensor-core version (K = 9 taps x 4 bytes
// as one m16n8k32 and one m16n8k16 step, .u8.s8) was built and held
// bitwise too, and measured slower at every batch: the product is a small
// share of the time here.
//
// general (any other cin, cout).  One thread per output pixel computes the
// output channels 16 at a time in registers, with the filter and bias in
// shared memory, reading its input bytes straight from device memory
// behind bounds checks (the first design of this kernel).
#include "block_body.cuh"

namespace {

constexpr int kThreads = 128;      // general path
constexpr int kBandThreads = 256;  // banded path (ops.py:BAND_THREADS)
constexpr int kGroup = 16;  // output channels held in registers at a time

__global__ void __launch_bounds__(kThreads)
conv_stem_general(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ b, uint8_t* __restrict__ out,
                  int n_img, int h, int w_img, int cin, int cout, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sb = reinterpret_cast<int32_t*>(smem);
  int8_t* sw = reinterpret_cast<int8_t*>(smem + 4 * cout);
  for (int i = threadIdx.x; i < cout; i += blockDim.x) sb[i] = b[i];
  for (int i = threadIdx.x; i < 9 * cin * cout; i += blockDim.x) sw[i] = w[i];
  __syncthreads();

  const long long hw = static_cast<long long>(h) * w_img;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_img * hw) return;
  const long long n = p / hw;
  const int r = static_cast<int>(p - n * hw);
  const int oy = r / w_img, ox = r - (r / w_img) * w_img;
  const uint8_t* xn = x + n * hw * cin;
  uint8_t* op = out + p * cout;

  for (int c0 = 0; c0 < cout; c0 += kGroup) {
    int acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = (c0 + j < cout) ? sb[c0 + j] : 0;
    for (int kh = 0; kh < 3; ++kh) {
      const int iy = oy + kh - 1;
      if (iy < 0 || iy >= h) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int ix = ox + kw - 1;
        if (ix < 0 || ix >= w_img) continue;
        const uint8_t* px = xn + (static_cast<long long>(iy) * w_img + ix) * cin;
        const int8_t* wt = sw + (kh * 3 + kw) * cin * cout + c0;
        for (int ci = 0; ci < cin; ++ci) {
          const int v = px[ci];
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            if (c0 + j < cout) acc[j] += v * wt[ci * cout + j];
        }
      }
    }
    unsigned packed[kGroup / 4];
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      packed[q] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed[q] |= repro::requant_u8(acc[4 * q + j], shift) << (8 * j);
    }
    if (cout % kGroup == 0) {
      // op + c0 is 16-byte aligned: the wrapper passes a 16-byte aligned
      // output and every pixel's row is a multiple of 16 bytes
      *reinterpret_cast<uint4*>(op + c0) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (c0 + j < cout) op[c0 + j] = static_cast<uint8_t>(packed[j / 4] >> (8 * (j % 4)));
    }
  }
}

// Shared-memory layout of the banded path: bias (cout int32) | filter
// [9][cout] words | plane (band + 2) x (w + 2) words | raw input rows.
struct BandLayout {
  int wt_off, plane_off, raw_off, bytes;
};

__host__ __device__ inline BandLayout band_layout(int band, int w_img, int cin,
                                                  int cout) {
  BandLayout l;
  l.wt_off = 4 * cout;
  l.plane_off = l.wt_off + 36 * cout;
  l.raw_off = l.plane_off + (band + 2) * (w_img + 2) * 4;
  l.raw_off = (l.raw_off + 15) / 16 * 16;
  // the raw rows start up to 15 bytes past the 16-byte boundary they are
  // copied from, and the copies end on one
  l.bytes = l.raw_off + ((band + 2) * w_img * cin + 15 + 15) / 16 * 16;
  return l;
}

// cp.async of the `bytes` (0 .. 16) at gmem into 16 bytes at smem, the rest
// zero-filled; gmem is 16-byte aligned.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(bytes));
}

// Thread block (band r, image n) of the banded path: output rows
// [r * band, r * band + nb) of image n.
__global__ void __launch_bounds__(kBandThreads)
conv_stem_banded(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ b, uint8_t* __restrict__ out,
                 int h, int w_img, int cin, int cout, int shift, int band,
                 int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BandLayout l = band_layout(band, w_img, cin, cout);
  int32_t* sb = reinterpret_cast<int32_t*>(smem);
  unsigned* wt = reinterpret_cast<unsigned*>(smem + l.wt_off);
  unsigned* plane = reinterpret_cast<unsigned*>(smem + l.plane_off);
  unsigned char* raw = smem + l.raw_off;
  const int img = blockIdx.x / bands;
  const int r0 = (blockIdx.x - img * bands) * band, nb = min(band, h - r0);
  const int wp = w_img + 2;

  // ---- the band's input rows [ylo, yhi), contiguous in device memory,
  // by 16-byte cp.async from the 16-byte boundary at or below their start
  const int ylo = max(r0 - 1, 0), yhi = min(r0 + nb + 1, h);
  const uint8_t* src = x + (static_cast<size_t>(img) * h + ylo) * w_img * cin;
  const int len = (yhi - ylo) * w_img * cin;
  const uint8_t* base = reinterpret_cast<const uint8_t*>(
      reinterpret_cast<uintptr_t>(src) & ~static_cast<uintptr_t>(15));
  const int lead = static_cast<int>(src - base);
  for (int i = threadIdx.x; 16 * i < lead + len; i += kBandThreads)
    cp_async16_zfill(raw + 16 * i, base + 16 * i, min(16, lead + len - 16 * i));
  repro::cp_async_commit();

  // ---- meanwhile the filter, [tap][cout] dp4a words, and the bias (the
  // channel loops unrolled and predicated, so that a thread's loads are in
  // flight together) ----
  for (int row = threadIdx.x; row < 9 * cout; row += kBandThreads) {
    const int tap = row / cout;
    const int8_t* s = w + tap * cin * cout + (row - tap * cout);
    unsigned v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < cin)
        v |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(s + c * cout))) << (8 * c);
    wt[row] = v;
  }
  for (int i = threadIdx.x; i < cout; i += kBandThreads) sb[i] = __ldg(b + i);
  repro::cp_async_wait<0>();
  __syncthreads();

  // ---- spread into the plane: stored (r, xs) = image (r0 - 1 + r, xs - 1),
  // one word a pixel, zero outside the image (the SAME pad) ----
  for (int i = threadIdx.x; i < (nb + 2) * wp; i += kBandThreads) {
    const int r = i / wp, xs = i - r * wp;
    const int y = r0 - 1 + r, xi = xs - 1;
    unsigned v = 0;
    if (y >= 0 && y < h && xi >= 0 && xi < w_img) {
      const unsigned char* p = raw + lead + ((y - ylo) * w_img + xi) * cin;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < cin) v |= static_cast<unsigned>(p[c]) << (8 * c);
    }
    plane[i] = v;
  }
  __syncthreads();

  // ---- one item: one pixel x 16 output channels; consecutive threads
  // take consecutive items, so a warp's stores are contiguous ----
  const int n_pix = nb * w_img, groups = cout / kGroup;
  uint8_t* ob = out + (static_cast<size_t>(img) * h + r0) * w_img * cout;
  for (int it = threadIdx.x; it < n_pix * groups; it += kBandThreads) {
    const int pix = it / groups, co = kGroup * (it - pix * groups);
    const int oy = pix / w_img, ox = pix - oy * w_img;
    int acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = sb[co + j];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned v = plane[(oy + tap / 3) * wp + ox + tap % 3];
      const uint4* wv = reinterpret_cast<const uint4*>(wt + tap * cout + co);
#pragma unroll
      for (int q = 0; q < kGroup / 4; ++q) {
        const uint4 u = wv[q];
        acc[4 * q] = repro::dp4a_us(v, static_cast<int>(u.x), acc[4 * q]);
        acc[4 * q + 1] = repro::dp4a_us(v, static_cast<int>(u.y), acc[4 * q + 1]);
        acc[4 * q + 2] = repro::dp4a_us(v, static_cast<int>(u.z), acc[4 * q + 2]);
        acc[4 * q + 3] = repro::dp4a_us(v, static_cast<int>(u.w), acc[4 * q + 3]);
      }
    }
    unsigned pk[kGroup / 4];
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q)
      pk[q] = repro::requant_u8(acc[4 * q], shift) |
              repro::requant_u8(acc[4 * q + 1], shift) << 8 |
              repro::requant_u8(acc[4 * q + 2], shift) << 16 |
              repro::requant_u8(acc[4 * q + 3], shift) << 24;
    uint8_t* op = ob + static_cast<size_t>(pix) * cout + co;
    *reinterpret_cast<uint4*>(op) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Dynamic shared memory of a banded-path thread block.
REPRO_EXPORT int conv_stem_band_smem_bytes(int band, int w_img, int cin, int cout) {
  return band_layout(band, w_img, cin, cout).bytes;
}

// x: (n, h, w, cin) u8 unpadded; w: (3, 3, cin, cout) s8; b: (cout,) s32;
// out: (n, h, w, cout) u8, 16-byte aligned.  path 0: general; 1: banded
// (cin 1 .. 4, cout a multiple of 16, band: output rows a thread block
// takes, 1 .. h).  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for arguments the path does not take.
REPRO_EXPORT int conv_stem_launch(const void* x, const void* w, const void* b,
                                  void* out, int n, int h, int w_img, int cin,
                                  int cout, int shift, int band, int path,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int32_t*>(b);
  auto* op = static_cast<uint8_t*>(out);
  if (path == 1) {
    if (cin < 1 || cin > 4 || cout % 16 || cout <= 0 || band < 1 || band > h ||
        reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = band_layout(band, w_img, cin, cout).bytes;
    const int bands = (h + band - 1) / band;
    const long long blocks = static_cast<long long>(n) * bands;
    if (smem > repro::kMaxSmemBytes || blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv_stem_banded, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    conv_stem_banded<<<static_cast<unsigned>(blocks), kBandThreads, smem, s>>>(
        xp, wp, bp, op, h, w_img, cin, cout, shift, band, bands);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * cout + 9 * cin * cout;
  if (smem > repro::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_stem_general, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long npix = static_cast<long long>(n) * h * w_img;
  const unsigned blocks = static_cast<unsigned>((npix + kThreads - 1) / kThreads);
  conv_stem_general<<<blocks, kThreads, smem, s>>>(xp, wp, bp, op, n, h, w_img,
                                                    cin, cout, shift);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `blocks` thread blocks of `threads` threads: the
// launch floor that conv_stem's time is read against.
REPRO_EXPORT int conv_stem_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
