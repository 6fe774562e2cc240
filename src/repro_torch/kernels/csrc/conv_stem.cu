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
// sizes the launch itself is most of the time.
//
// Design: one thread per output pixel computes all output channels in
// registers (16 at a time); the 432-byte filter and the bias are staged in
// shared memory once per block.  The (1, 1) zero pad is applied by bounds
// checks on the unpadded image, so the wrapper copies nothing.  Each thread
// stores its 16 output bytes as one 128-bit write, so a warp writes 512
// contiguous bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 16;  // output channels held in registers at a time

__global__ void __launch_bounds__(kThreads)
conv_stem_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
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

}  // namespace

// x: (n, h, w, cin) u8 unpadded; w: (3, 3, cin, cout) s8; b: (cout,) s32;
// out: (n, h, w, cout) u8.  Returns the cudaError_t of the launch.
REPRO_EXPORT int conv_stem_launch(const void* x, const void* w, const void* b,
                                  void* out, int n, int h, int w_img, int cin,
                                  int cout, int shift, void* stream) {
  const int smem = 4 * cout + 9 * cin * cout;
  if (smem > repro::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long npix = static_cast<long long>(n) * h * w_img;
  const unsigned blocks = static_cast<unsigned>((npix + kThreads - 1) / kThreads);
  conv_stem_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(b), static_cast<uint8_t*>(out), n, h, w_img,
      cin, cout, shift);
  return static_cast<int>(cudaGetLastError());
}
