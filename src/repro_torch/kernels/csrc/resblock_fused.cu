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
// the 64-channel blocks by operations (about 600-1,150).  This kernel runs
// its products on the CUDA cores with dp4a (4 u8 x s8 products per
// instruction), well below the tensor-core rate, so in practice it is
// bound by operations: the dp4a issue rate and the shared-memory loads
// that feed it.
//
// Design: one thread block per image, the direct counterpart of the TPU
// kernel's "y0 and the skip never leave VMEM".  Dynamic shared memory holds
// the zero-haloed input tile, the zero-haloed y0, w0, w1 and (if present)
// wd, so device memory sees x read once and out written once.  Weights are
// staged transposed from HWIO to [tap][cout][cin] so four input channels of
// one output channel are one 32-bit word, the operand dp4a takes.
//   Phase A: conv0 (strided) -> requant_u8 -> y0 in shared memory.
//   Phase B: skip (identity, or the fused 1x1 downsample) + b1 + conv1 over
//            y0 -> requant_u8 -> device memory.
// The two phases are the shared block body of block_body.cuh; each work
// item is one output pixel times four consecutive output channels.  At
// ResNet20's shapes the block needs 41.6-87.3 KB of shared memory, above
// the 48 KB default, so the launch raises the limit first.  Tensor cores
// (mma.sync m16n8k32 takes .u8.s8), several blocks per image and
// cp.async/TMA staging are later work.
#include "block_body.cuh"

namespace {

constexpr int kThreads = 256;
// One thread block per image: at the serving buckets (up to 32 images) no
// SM holds more than one block, so the bound lets ptxas spend registers
// freely (about 100; at its default target of 64 the block body spills).
constexpr int kMinBlocks = 1;

struct Layout {
  int pad_lo, hp, wp, oh, ow, bytes;
  int w0_off, w1_off, wd_off, x_off, y_off;
};

// Shared-memory layout: b0 | b1 | bd (int32) | w0t | w1t | wdt | x tile | y0.
// Every size is a multiple of 4 bytes when cin and cout are.
__host__ __device__ inline Layout layout(int h, int w, int cin, int cout,
                                         int stride, bool has_ds) {
  Layout l;
  l.pad_lo = stride == 1 ? 1 : 0;
  l.hp = h + l.pad_lo + 1;
  l.wp = w + l.pad_lo + 1;
  l.oh = (l.hp - 3) / stride + 1;
  l.ow = (l.wp - 3) / stride + 1;
  l.w0_off = 3 * 4 * cout;
  l.w1_off = l.w0_off + 9 * cout * cin;
  l.wd_off = l.w1_off + 9 * cout * cout;
  l.x_off = l.wd_off + (has_ds ? cout * cin : 0);
  l.y_off = l.x_off + l.hp * l.wp * cin;
  l.bytes = l.y_off + (l.oh + 2) * (l.ow + 2) * cout;
  return l;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
resblock_fused_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w0,
                      const int32_t* __restrict__ b0, const int8_t* __restrict__ w1,
                      const int32_t* __restrict__ b1, const int8_t* __restrict__ wd,
                      const int32_t* __restrict__ bd, uint8_t* __restrict__ out,
                      int h, int w, int cin, int cout, int stride, int shift0,
                      int shift1, int skip_shift) {
  using repro::Map;
  const bool has_ds = wd != nullptr;
  const Layout l = layout(h, w, cin, cout, stride, has_ds);
  const int cin4 = cin / 4;

  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sb0 = reinterpret_cast<int32_t*>(smem);
  int32_t* sb1 = sb0 + cout;
  int32_t* sbd = sb1 + cout;
  int8_t* w0t = reinterpret_cast<int8_t*>(smem + l.w0_off);
  int8_t* w1t = reinterpret_cast<int8_t*>(smem + l.w1_off);
  int8_t* wdt = reinterpret_cast<int8_t*>(smem + l.wd_off);
  uint8_t* xs = smem + l.x_off;
  uint8_t* ys = smem + l.y_off;

  // ---- stage biases, weights and the zero-haloed input tile ----
  repro::stage_bias(b0, sb0, cout);
  repro::stage_bias(b1, sb1, cout);
  repro::stage_bias(bd, sbd, cout);
  repro::stage_transposed(w0, w0t, 9, cin, cout);
  repro::stage_transposed(w1, w1t, 9, cout, cout);
  if (has_ds) repro::stage_transposed(wd, wdt, 1, cin, cout);
  const uint8_t* xn = x + static_cast<size_t>(blockIdx.x) * h * w * cin;
  for (int i = threadIdx.x; i < l.hp * l.wp * cin4; i += blockDim.x) {
    const int pos = i / cin4;
    const int c4 = i - pos * cin4;
    const int iy = pos / l.wp - l.pad_lo;
    const int ix = pos - (pos / l.wp) * l.wp - l.pad_lo;
    unsigned v = 0;
    if (iy >= 0 && iy < h && ix >= 0 && ix < w)
      v = *reinterpret_cast<const unsigned*>(xn + (static_cast<size_t>(iy) * w + ix) * cin + 4 * c4);
    reinterpret_cast<unsigned*>(xs)[i] = v;
  }
  repro::zero_ring(ys, l.oh, l.ow, cout);  // y0's zero halo for conv1
  __syncthreads();

  // the x tile holds the padded input as stored (off 0); y0 is stored with
  // a one-pixel ring: written at off 1, read by conv1 as its padded input
  const Map xm{xs, l.wp, 0, cin};
  const int owp = l.ow + 2;

  // ---- phase A: conv0 (strided) -> requant_u8 -> y0 stays on chip ----
  repro::conv3x3_requant(xm, w0t, sb0, stride, l.oh, l.ow, cout, shift0,
                         Map{ys, owp, 1, cout});
  __syncthreads();

  // ---- phase B: skip + b1 initialize conv1's accumulator (add-fold) ----
  uint8_t* on = out + static_cast<size_t>(blockIdx.x) * l.oh * l.ow * cout;
  repro::residual_requant(xm, l.pad_lo, stride, wdt, sbd, has_ds, skip_shift,
                          Map{ys, owp, 0, cout}, w1t, sb1, l.oh, l.ow, cout,
                          shift1, Map{on, l.ow, 0, cout});
}

}  // namespace

// Dynamic shared memory one block needs at this shape.
REPRO_EXPORT int resblock_fused_smem_bytes(int h, int w, int cin, int cout,
                                           int stride, int has_ds) {
  return layout(h, w, cin, cout, stride, has_ds != 0).bytes;
}

// x: (n, h, w, cin) u8 unpadded; w0: (3, 3, cin, cout), w1: (3, 3, cout,
// cout), wd: (1, 1, cin, cout) s8 or null; b0, b1, bd: (cout,) s32 (bd null
// with wd); out: (n, oh, ow, cout) u8.  cin and cout must be multiples of 4
// and every pointer 4-byte aligned.  Returns the cudaError_t of the launch.
REPRO_EXPORT int resblock_fused_launch(const void* x, const void* w0,
                                       const void* b0, const void* w1,
                                       const void* b1, const void* wd,
                                       const void* bd, void* out, int n, int h,
                                       int w, int cin, int cout, int stride,
                                       int shift0, int shift1, int skip_shift,
                                       void* stream) {
  const int smem = layout(h, w, cin, cout, stride, wd != nullptr).bytes;
  if (smem > repro::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resblock_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resblock_fused_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w0),
      static_cast<const int32_t*>(b0), static_cast<const int8_t*>(w1),
      static_cast<const int32_t*>(b1), static_cast<const int8_t*>(wd),
      static_cast<const int32_t*>(bd), static_cast<uint8_t*>(out), h, w, cin,
      cout, stride, shift0, shift1, skip_shift);
  return static_cast<int>(cudaGetLastError());
}
