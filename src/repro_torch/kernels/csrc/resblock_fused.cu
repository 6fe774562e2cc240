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
// Each work item is one output pixel times four consecutive output
// channels.  At ResNet20's shapes the block needs 41.6-87.3 KB of shared
// memory, above the 48 KB default, so the launch raises the limit first.
// Tensor cores (mma.sync m16n8k32 takes .u8.s8), several blocks per image
// and cp.async/TMA staging are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// HWIO (taps, cin, cout) s8 in device memory -> [tap][cout][cin] in shared
// memory, one 32-bit word of four input channels at a time.
__device__ void stage_transposed(const int8_t* __restrict__ src, int8_t* dst,
                                 int taps, int cin, int cout) {
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

// acc[j] += sum over the words of act (n4 words) times the weight row of
// output channel co + j (rows of n4 words, consecutive).
__device__ __forceinline__ void dot4(const unsigned* __restrict__ act,
                                     const int* __restrict__ wrow, int n4,
                                     int acc[4]) {
  for (int c4 = 0; c4 < n4; ++c4) {
    const unsigned v = act[c4];
    acc[0] = repro::dp4a_us(v, wrow[c4], acc[0]);
    acc[1] = repro::dp4a_us(v, wrow[n4 + c4], acc[1]);
    acc[2] = repro::dp4a_us(v, wrow[2 * n4 + c4], acc[2]);
    acc[3] = repro::dp4a_us(v, wrow[3 * n4 + c4], acc[3]);
  }
}

__device__ __forceinline__ unsigned pack_u8(const int acc[4], int shift) {
  return repro::requant_u8(acc[0], shift) | repro::requant_u8(acc[1], shift) << 8 |
         repro::requant_u8(acc[2], shift) << 16 | repro::requant_u8(acc[3], shift) << 24;
}

__global__ void __launch_bounds__(kThreads)
resblock_fused_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w0,
                      const int32_t* __restrict__ b0, const int8_t* __restrict__ w1,
                      const int32_t* __restrict__ b1, const int8_t* __restrict__ wd,
                      const int32_t* __restrict__ bd, uint8_t* __restrict__ out,
                      int h, int w, int cin, int cout, int stride, int shift0,
                      int shift1, int skip_shift) {
  const bool has_ds = wd != nullptr;
  const Layout l = layout(h, w, cin, cout, stride, has_ds);
  const int cin4 = cin / 4, cout4 = cout / 4;
  const int ohp = l.oh + 2, owp = l.ow + 2;

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
  for (int i = threadIdx.x; i < cout; i += blockDim.x) {
    sb0[i] = b0[i];
    sb1[i] = b1[i];
    sbd[i] = has_ds ? bd[i] : 0;
  }
  stage_transposed(w0, w0t, 9, cin, cout);
  stage_transposed(w1, w1t, 9, cout, cout);
  if (has_ds) stage_transposed(wd, wdt, 1, cin, cout);
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
  for (int i = threadIdx.x; i < ohp * owp * cout4; i += blockDim.x) {
    const int pos = i / cout4;
    const int py = pos / owp, px = pos - (pos / owp) * owp;
    if (py == 0 || py == ohp - 1 || px == 0 || px == owp - 1)
      reinterpret_cast<unsigned*>(ys)[i] = 0;  // y0's zero halo for conv1
  }
  __syncthreads();

  const int items = l.oh * l.ow * cout4;

  // ---- phase A: conv0 (strided) -> requant_u8 -> y0 stays on chip ----
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int pix = it / cout4;
    const int co = 4 * (it - pix * cout4);
    const int oy = pix / l.ow, ox = pix - (pix / l.ow) * l.ow;
    int acc[4] = {sb0[co], sb0[co + 1], sb0[co + 2], sb0[co + 3]};
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw)
        dot4(reinterpret_cast<const unsigned*>(
                 xs + ((oy * stride + kh) * l.wp + ox * stride + kw) * cin),
             reinterpret_cast<const int*>(w0t + ((kh * 3 + kw) * cout + co) * cin),
             cin4, acc);
    *reinterpret_cast<unsigned*>(ys + ((oy + 1) * owp + ox + 1) * cout + co) =
        pack_u8(acc, shift0);
  }
  __syncthreads();

  // ---- phase B: skip + b1 initialize conv1's accumulator (add-fold) ----
  uint8_t* on = out + static_cast<size_t>(blockIdx.x) * l.oh * l.ow * cout;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int pix = it / cout4;
    const int co = 4 * (it - pix * cout4);
    const int oy = pix / l.ow, ox = pix - (pix / l.ow) * l.ow;
    // the skip reads x at (pad_lo + o * stride): SAME padding of a 1x1 conv
    // (or of the identity) is zero
    const uint8_t* xc = xs + ((l.pad_lo + oy * stride) * l.wp + l.pad_lo + ox * stride) * cin;
    int acc[4];
    if (has_ds) {
      int accd[4] = {sbd[co], sbd[co + 1], sbd[co + 2], sbd[co + 3]};
      dot4(reinterpret_cast<const unsigned*>(xc),
           reinterpret_cast<const int*>(wdt + co * cin), cin4, accd);
      for (int j = 0; j < 4; ++j) acc[j] = repro::shift_align(accd[j], skip_shift);
    } else {
      for (int j = 0; j < 4; ++j) acc[j] = repro::shift_align(xc[co + j], skip_shift);
    }
    for (int j = 0; j < 4; ++j) acc[j] += sb1[co + j];
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw)
        dot4(reinterpret_cast<const unsigned*>(ys + ((oy + kh) * owp + ox + kw) * cout),
             reinterpret_cast<const int*>(w1t + ((kh * 3 + kw) * cout + co) * cout),
             cout4, acc);
    *reinterpret_cast<unsigned*>(on + pix * cout + co) = pack_u8(acc, shift1);
  }
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
