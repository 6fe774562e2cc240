// resblock_fused: one whole residual block of the integer ResNet in one
// launch — the paper's add-fold (Fig. 13).
//
//   y0   = requant_u8(conv0(x) + b0, shift0)            3x3, stride 1 or 2
//   skip = shift_align(x, skip_shift)                   identity block, or
//        = shift_align(x *1x1 wd + bd, skip_shift)      downsample block
//   out  = requant_u8(skip + b1 + conv1(y0), shift1)    3x3, stride 1
//
// Replaces the TPU kernel
// src/repro/kernels/resblock_fused/resblock_fused.py:resblock_fused (body
// _kernel -> block_body -> _conv_tap_acc; wrapper ops.py:resblock_fused_op).
// SAME padding follows jax.lax: (1, 1) at stride 1, (0, 1) at stride 2.
//
// What bounds it on an H100: at the tensor-core roofline (1,979 int8 TOP/s
// over 3.35 TB/s, ~590 ops per byte) the 16- and 32-channel blocks are
// bound by bytes (about 290-580 ops per byte of x read and out written) and
// the 64-channel blocks by operations (about 600-1,150).  At ResNet sizes
// one block is a few microseconds of work spread over the card, so in
// practice latency bounds it: the dependent mma chain of a warp item, the
// staging, and the launch.
//
// Design: a grid of (row band, image) thread blocks, so that at the serving
// buckets the card fills (block_band_rows in tune/space.py picks the band
// height from the map height, the batch and the card's SM count: at bucket
// 32 on an H100, 4 bands an image).
// Each thread block
//   - copies the packed block (biases and the mma-fragment-ordered filters,
//     block_body.cuh) from L2 by cp.async, and stages its band of x plus
//     the halo rows conv0 and conv1 need, zero-padded;
//   - phase A: conv0 for its band of y0 plus one row either side
//     (recomputed by the neighbouring bands too), kept in shared memory;
//   - phase B: skip (identity, or the fused 1x1 downsample) + b1 start
//     conv1's accumulator (the add-fold); conv1 over y0; requant_u8; its
//     band of out goes to device memory.
// Both phases are block_body.cuh's implicit GEMMs on the int8 tensor cores
// (mma.sync m16n8k32 / m16n8k16 .u8.s8), so device memory sees x read
// once (plus the halo rows) and out written once.
#include "block_body.cuh"

namespace {

constexpr int kThreads = 256;

struct Layout {
  int pad_lo, wp, oh, ow, xrows, x_off, y_off, bytes;
};

// Shared-memory layout: packed block | x band (padded coordinates, rows
// (r0 - 1) * stride .. (r0 + band) * stride + 2) | y0 band (rows r0 - 1 ..
// r0 + band, zero ring columns).
__host__ __device__ inline Layout layout(int h, int w, int cin, int cout,
                                         int stride, bool has_ds, int band) {
  Layout l;
  l.pad_lo = stride == 1 ? 1 : 0;
  l.wp = w + l.pad_lo + 1;
  l.oh = (h + l.pad_lo + 1 - 3) / stride + 1;
  l.ow = (l.wp - 3) / stride + 1;
  l.xrows = (band + 1) * stride + 3;
  l.x_off = repro::packed_block_bytes(cin, cout, has_ds);
  l.y_off = l.x_off + l.xrows * l.wp * repro::pixel_pitch(cin);
  l.bytes = l.y_off + (band + 2) * (l.ow + 2) * repro::pixel_pitch(cout);
  return l;
}

__global__ void __launch_bounds__(kThreads)
resblock_fused_kernel(const uint8_t* __restrict__ x,
                      const unsigned char* __restrict__ packed,
                      uint8_t* __restrict__ out, int h, int w, int cin,
                      int cout, int stride, int has_ds, int shift0, int shift1,
                      int skip_shift, int band, int* __restrict__ sm_ids) {
  using repro::Map;
  if (sm_ids != nullptr && threadIdx.x == 0)
    sm_ids[blockIdx.y * gridDim.x + blockIdx.x] = repro::sm_id();
  const Layout l = layout(h, w, cin, cout, stride, has_ds != 0, band);
  const int pin = repro::pixel_pitch(cin), pout = repro::pixel_pitch(cout);
  const int r0 = blockIdx.x * band, nb = min(band, l.oh - r0);
  const int img = blockIdx.y;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* xs = smem + l.x_off;
  uint8_t* ys = smem + l.y_off;

  // ---- stage the packed block, the x band and y0's zero ring ----
  repro::copy_async(smem, packed, l.x_off);
  repro::cp_async_commit();
  const int xr0 = (r0 - 1) * stride;  // first padded row of the band
  repro::stage_rows(x + static_cast<size_t>(img) * h * w * cin, h, w, cin, xs,
                    pin, l.wp, l.pad_lo, xr0 - l.pad_lo, l.xrows);
  if (r0 == 0) repro::zero_rows(ys, l.ow + 2, pout, 0, 1);
  if (r0 + nb == l.oh) repro::zero_rows(ys, l.ow + 2, pout, nb + 1, nb + 2);
  repro::zero_ring_cols(ys, l.ow, pout, 0, nb + 2);
  repro::cp_async_wait<0>();
  __syncthreads();
  const repro::Packed pk(smem, smem + repro::packed_part_bytes(cin, cout, has_ds, 0),
                         cin, cout);

  // x in its padded coordinates: padded row xr0 is stored row 0
  const Map xm{xs, l.wp, -xr0, 0, pin};

  // ---- phase A: conv0 (strided) for y0 rows [r0 - 1, r0 + nb + 1) of
  // the map -> requant_u8 -> y0 stays on chip, stored row y - r0 + 1 ----
  const int ylo = max(r0 - 1, 0), yhi = min(r0 + nb + 1, l.oh);
  repro::conv3x3_mma(xm, cin, pk.w0, pk.b0, stride, ylo, yhi - ylo, l.ow, cout,
                     shift0, Map{ys, l.ow + 2, 1 - r0, 1, pout});
  __syncthreads();

  // ---- phase B: skip + b1 initialize conv1's accumulator (add-fold);
  // conv1 reads y0 in its (1, 1)-padded coordinates ----
  uint8_t* on = out + static_cast<size_t>(img) * l.oh * l.ow * cout;
  repro::residual_mma(xm, cin, l.pad_lo, stride, pk, has_ds != 0, skip_shift,
                      Map{ys, l.ow + 2, -r0, 0, pout}, r0, nb, l.ow, cout,
                      shift1, Map{on, l.ow, 0, 0, cout});
}

}  // namespace

// Dynamic shared memory one thread block needs at this shape and band
// height (output rows a thread block takes).
REPRO_EXPORT int resblock_fused_smem_bytes(int h, int w, int cin, int cout,
                                           int stride, int has_ds, int band) {
  return layout(h, w, cin, cout, stride, has_ds != 0, band).bytes;
}

// Bytes of the packed block (pack_block in ops.py) at these channels.
REPRO_EXPORT int resblock_packed_bytes(int cin, int cout, int has_ds) {
  return repro::packed_block_bytes(cin, cout, has_ds);
}

// x: (n, h, w, cin) u8 unpadded; packed: the block's biases and filters in
// the packed layout of block_body.cuh (16-byte aligned); out: (n, oh, ow,
// cout) u8.  cin and cout must be multiples of 4 and at most 128, x and out
// 4-byte aligned;
// band: output rows a thread block takes (1 .. oh).  sm_ids: null, or
// n * ceil(oh / band) ints that receive the SM of each thread block (image
// major).  Returns the cudaError_t of the launch.
REPRO_EXPORT int resblock_fused_launch(const void* x, const void* packed,
                                       void* out, int n, int h, int w, int cin,
                                       int cout, int stride, int has_ds,
                                       int shift0, int shift1, int skip_shift,
                                       int band, int* sm_ids, void* stream) {
  const Layout l = layout(h, w, cin, cout, stride, has_ds != 0, band);
  if (band < 1 || band > l.oh || cin % 4 || cout % 4 || n > 65535 ||
      repro::round16(cin) > repro::kMaxK || repro::round16(cout) > repro::kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.bytes > repro::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (l.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resblock_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((l.oh + band - 1) / band, n);
  resblock_fused_kernel<<<grid, kThreads, l.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const unsigned char*>(packed),
      static_cast<uint8_t*>(out), h, w, cin, cout, stride, has_ds, shift0, shift1,
      skip_shift, band, sm_ids);
  return static_cast<int>(cudaGetLastError());
}
