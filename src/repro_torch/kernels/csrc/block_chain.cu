// block_chain: a run of consecutive residual blocks of the integer ResNet,
// optionally headed by the 3x3 stem conv, in ONE launch.  The running
// activation stays in shared memory from the chain's input to its output:
// device memory sees the chain's input read once and its output written
// once.  This is the paper's layer-to-layer streaming (§III-D) pushed past
// the block boundary.
//
//   [stem]  h = requant_u8(conv3x3(x) + b, stem_shift)          stride 1
//   link j  y0 = requant_u8(conv0(h) + b0, shift0)              stride 1 or 2
//           skip = shift_align(h or h *1x1 wd + bd, skip_shift)
//           h = requant_u8(skip + b1 + conv1(y0), shift1)
//
// Replaces the TPU kernel
// src/repro/kernels/megakernel/megakernel.py:block_chain (body _kernel ->
// _block_body -> _conv_taps; wrapper ops.py:block_chain_op).  The
// inter-block SAME re-pad (_pad_for: (1, 1) at stride 1, (0, 1) at stride
// 2) happens on chip: every map lives in a plane with a one-pixel zero
// ring, and a stride-2 conv starts one row and column into it.
//
// What bounds it on an H100: operations.  ResNet20's chain does 40.8 M
// multiply-adds per image; at batch 32 that is 1.32 us at the int8
// tensor-core peak (1,979 TOP/s), against 0.15 us for its bytes at 3.35
// TB/s (the images in, the 8x8x64 maps out, the weights once).  Like
// resblock_fused, this kernel runs its products on the CUDA cores with
// dp4a and one thread block per batch_tile images, so at batch 32 only 32
// of the 132 SMs work and the dp4a loops wait on shared-memory loads: it
// runs far from that bound, for the same reason as resblock_fused.  What
// the chain removes is per-block overhead: 9 of ResNet20's 10 launches and
// the HBM round trips of every interior activation.
//
// Design: one thread block per batch_tile images.  Dynamic shared memory
// (chain_layout below; the planner's core/dataflow.py:chain_task_smem_bytes
// is the same formula) holds the stem's transposed filter and bias (staged
// once), ONE link's transposed filters and biases (restaged at the start
// of every link; after the first thread block they come from L2), and per
// image three activation planes — link input, y0, link output — swapped
// between links.  Pinning every weight of the chain instead, as the TPU
// kernel does in VMEM, cannot hold ResNet20's 270,256 B of int8 weights in
// 227 KB.  The block arithmetic is block_body.cuh's, shared with
// resblock_fused.  Tensor cores (mma.sync .u8.s8) and thread block
// clusters that split an image across SMs are later work.
#include "block_body.cuh"

namespace {

constexpr int kThreads = 512;
// At ResNet widths a thread block needs 114-186 KB of shared memory, so an
// SM holds one: the bound lets ptxas use up to 128 registers a thread
// (with the default target of 64 the block body spills).
constexpr int kMinBlocks = 1;
constexpr int kMaxLinks = 32;
constexpr int kLinkInts = 9;  // h, w, cin, cout, stride, has_ds, shift0, shift1, skip_shift
constexpr int kLinkPtrs = 6;  // w0, b0, w1, b1, wd, bd

struct Link {
  const int8_t* w0;
  const int32_t* b0;
  const int8_t* w1;
  const int32_t* b1;
  const int8_t* wd;
  const int32_t* bd;
  int h, w, cin, cout, stride, has_ds, shift0, shift1, skip_shift;
};

struct ChainLayout {
  int stem_bytes, link_bytes, plane_bytes, bytes;
};

struct ChainArgs {
  const uint8_t* x;
  uint8_t* out;
  const int8_t* stem_w;
  const int32_t* stem_b;
  int stem_cin, stem_cout, stem_shift;
  int n_links, batch_tile;
  ChainLayout l;
  Link links[kMaxLinks];
};

__host__ __device__ inline int align16(int v) { return (v + 15) / 16 * 16; }
inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int pad_lo_of(int stride) { return stride == 1 ? 1 : 0; }
// output size of a 3x3 conv padded (pad_lo, 1)
__host__ __device__ inline int out_size(int n, int stride) {
  return (n + pad_lo_of(stride) + 1 - 3) / stride + 1;
}

// Shared-memory layout: stem bias | stem filter (cin rounded up to 4) ||
// b0 | b1 | bd | w0t | w1t | wdt of the largest link || batch_tile planes
// A | batch_tile planes B | batch_tile planes C.  A plane holds the largest
// (h + 2) x (w + 2) x c map of the chain, the image included.
inline ChainLayout chain_layout(const int* ints, int n_links, int stem_cin,
                                int stem_cout, int batch_tile) {
  ChainLayout l;
  const int cin_pad = (stem_cin + 3) / 4 * 4;
  l.stem_bytes = stem_cout ? align16(4 * stem_cout + 9 * cin_pad * stem_cout) : 0;
  l.link_bytes = 0;
  int plane = stem_cout ? (ints[0] + 2) * (ints[1] + 2) * cin_pad : 0;
  for (int j = 0; j < n_links; ++j) {
    const int* k = ints + j * kLinkInts;
    const int h = k[0], w = k[1], cin = k[2], cout = k[3], stride = k[4], has_ds = k[5];
    const int wts = 3 * 4 * cout + 9 * cin * cout + 9 * cout * cout + (has_ds ? cin * cout : 0);
    l.link_bytes = imax(l.link_bytes, align16(wts));
    plane = imax(plane, (h + 2) * (w + 2) * cin);
    plane = imax(plane, (out_size(h, stride) + 2) * (out_size(w, stride) + 2) * cout);
  }
  l.plane_bytes = align16(plane);
  l.bytes = l.stem_bytes + l.link_bytes + 3 * batch_tile * l.plane_bytes;
  return l;
}

// The stem's HWIO (3, 3, cin, cout) filter -> [tap][cout][4] in shared
// memory for cin <= 4 (the RGB image), channels past cin zero: one dp4a
// word per tap, like the image plane's pixels.
__device__ void stage_stem(const int8_t* __restrict__ src, int8_t* dst,
                           int cin, int cout) {
  for (int row = threadIdx.x; row < 9 * cout; row += blockDim.x) {
    const int tap = row / cout;
    const int8_t* s = src + tap * cin * cout + (row - tap * cout);
    unsigned v = 0;
    for (int c = 0; c < cin; ++c)
      v |= static_cast<unsigned>(static_cast<uint8_t>(s[c * cout])) << (8 * c);
    reinterpret_cast<unsigned*>(dst)[row] = v;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_chain_kernel(const __grid_constant__ ChainArgs a) {
  using repro::Map;
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainLayout& l = a.l;
  const int bt = a.batch_tile, plane = l.plane_bytes;
  int32_t* stem_b = reinterpret_cast<int32_t*>(smem);
  int8_t* stem_wt = reinterpret_cast<int8_t*>(smem + 4 * a.stem_cout);
  unsigned char* wreg = smem + l.stem_bytes;
  uint8_t* pa = smem + l.stem_bytes + l.link_bytes;  // link input
  uint8_t* pb = pa + bt * plane;                      // y0
  uint8_t* pc = pb + bt * plane;                      // link output
  const size_t img0 = static_cast<size_t>(blockIdx.x) * bt;

  // ---- stage the chain's input into a zero-ringed plane ----
  const Link& first = a.links[0];
  const int h0 = first.h, w0 = first.w;
  const int cin = a.stem_cout ? a.stem_cin : first.cin;
  const int c4 = (cin + 3) / 4, wp0 = w0 + 2;
  uint8_t* in_plane = a.stem_cout ? pb : pa;  // the stem writes pa
  const uint8_t* xt = a.x + img0 * h0 * w0 * cin;
  for (int i = threadIdx.x; i < bt * (h0 + 2) * wp0 * c4; i += blockDim.x) {
    const int n = i / ((h0 + 2) * wp0 * c4);
    const int r = i - n * (h0 + 2) * wp0 * c4;
    const int pos = r / c4, q = r - pos * c4;
    const int iy = pos / wp0 - 1, ix = pos - (pos / wp0) * wp0 - 1;
    unsigned v = 0;
    if (iy >= 0 && iy < h0 && ix >= 0 && ix < w0) {
      const uint8_t* px = xt + ((static_cast<size_t>(n) * h0 + iy) * w0 + ix) * cin + 4 * q;
      if (cin % 4 == 0) {
        v = *reinterpret_cast<const unsigned*>(px);
      } else {  // the RGB image: 3 bytes a pixel, not word aligned
        for (int j = 0; j < 4 && 4 * q + j < cin; ++j) v |= static_cast<unsigned>(px[j]) << (8 * j);
      }
    }
    reinterpret_cast<unsigned*>(in_plane + static_cast<size_t>(n) * plane)[pos * c4 + q] = v;
  }

  // ---- the stem, fused at the head: image plane -> pa ----
  if (a.stem_cout) {
    repro::stage_bias(a.stem_b, stem_b, a.stem_cout);
    stage_stem(a.stem_w, stem_wt, a.stem_cin, a.stem_cout);
    __syncthreads();
    for (int n = 0; n < bt; ++n) {
      repro::conv3x3_requant(Map{pb + n * plane, wp0, 0, 4 * c4}, stem_wt, stem_b, 1, h0,
                             w0, a.stem_cout, a.stem_shift, Map{pa + n * plane, wp0, 1, a.stem_cout});
      repro::zero_ring(pa + n * plane, h0, w0, a.stem_cout);
    }
  }

  for (int j = 0; j < a.n_links; ++j) {
    const Link& k = a.links[j];
    const int cout = k.cout, pad_lo = pad_lo_of(k.stride);
    const int oh = out_size(k.h, k.stride), ow = out_size(k.w, k.stride);
    int32_t* sb0 = reinterpret_cast<int32_t*>(wreg);
    int32_t* sb1 = sb0 + cout;
    int32_t* sbd = sb1 + cout;
    int8_t* w0t = reinterpret_cast<int8_t*>(wreg + 3 * 4 * cout);
    int8_t* w1t = w0t + 9 * k.cin * cout;
    int8_t* wdt = w1t + 9 * cout * cout;

    __syncthreads();  // the previous link (or the stem) is done with wreg and its planes
    repro::stage_bias(k.b0, sb0, cout);
    repro::stage_bias(k.b1, sb1, cout);
    repro::stage_bias(k.bd, sbd, cout);
    repro::stage_transposed(k.w0, w0t, 9, k.cin, cout);
    repro::stage_transposed(k.w1, w1t, 9, cout, cout);
    if (k.has_ds) repro::stage_transposed(k.wd, wdt, 1, k.cin, cout);
    __syncthreads();

    // ---- phase A: conv0 (strided) -> requant_u8 -> y0 in pb.  The link
    // input's (pad_lo, 1)-padded coordinate 0 is stored row/column
    // 1 - pad_lo of its ringed plane ----
    for (int n = 0; n < bt; ++n) {
      repro::conv3x3_requant(Map{pa + n * plane, k.w + 2, 1 - pad_lo, k.cin}, w0t, sb0,
                             k.stride, oh, ow, cout, k.shift0,
                             Map{pb + n * plane, ow + 2, 1, cout});
      repro::zero_ring(pb + n * plane, oh, ow, cout);
    }
    __syncthreads();

    // ---- phase B: skip + b1 + conv1 -> requant_u8 -> pc, or the output ----
    const bool last = j + 1 == a.n_links;
    for (int n = 0; n < bt; ++n) {
      const Map out = last ? Map{a.out + (img0 + n) * oh * ow * cout, ow, 0, cout}
                           : Map{pc + n * plane, ow + 2, 1, cout};
      repro::residual_requant(Map{pa + n * plane, k.w + 2, 1 - pad_lo, k.cin}, pad_lo,
                              k.stride, wdt, sbd, k.has_ds != 0, k.skip_shift,
                              Map{pb + n * plane, ow + 2, 0, cout}, w1t, sb1, oh, ow,
                              cout, k.shift1, out);
      if (!last) repro::zero_ring(pc + n * plane, oh, ow, cout);
    }
    uint8_t* t = pa;
    pa = pc;
    pc = t;
  }
}

}  // namespace

// Dynamic shared memory one thread block uses.  link_ints: n_links rows of
// (h, w, cin, cout, stride, has_ds, shift0, shift1, skip_shift); stem_cout
// = 0 when no stem is fused.
REPRO_EXPORT int block_chain_smem_bytes(const int* link_ints, int n_links,
                                        int stem_cin, int stem_cout,
                                        int batch_tile) {
  return chain_layout(link_ints, n_links, stem_cin, stem_cout, batch_tile).bytes;
}

// x: (n, h, w, cin) u8 unpadded (the image when the stem is fused);
// out: (n, oh, ow, cout) u8 of the last link.  link_ints as above;
// link_ptrs: n_links rows of (w0, b0, w1, b1, wd, bd) — HWIO s8 filters
// and s32 biases, wd and bd null for an identity skip.  stem_w: (3, 3,
// stem_cin, stem_cout) s8 with stem_cin <= 4 and stem_b: (stem_cout,)
// s32, or null with stem_cout = 0.  Every link's cin and cout must be multiples of 4, every
// pointer 4-byte aligned, and batch_tile must divide n.  Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for arguments the kernel
// does not take, shared memory above repro::kMaxSmemBytes included.
REPRO_EXPORT int block_chain_launch(const void* x, void* out, const void* stem_w,
                                    const void* stem_b, int stem_cin,
                                    int stem_cout, int stem_shift,
                                    const int* link_ints,
                                    const void* const* link_ptrs, int n_links,
                                    int n, int batch_tile, void* stream) {
  if (n_links < 1 || n_links > kMaxLinks || batch_tile < 1 || n % batch_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a;
  a.x = static_cast<const uint8_t*>(x);
  a.out = static_cast<uint8_t*>(out);
  a.stem_w = static_cast<const int8_t*>(stem_w);
  a.stem_b = static_cast<const int32_t*>(stem_b);
  a.stem_cin = stem_cin;
  a.stem_cout = stem_cout;
  a.stem_shift = stem_shift;
  a.n_links = n_links;
  a.batch_tile = batch_tile;
  a.l = chain_layout(link_ints, n_links, stem_cin, stem_cout, batch_tile);
  for (int j = 0; j < n_links; ++j) {
    const int* k = link_ints + j * kLinkInts;
    const void* const* p = link_ptrs + j * kLinkPtrs;
    Link& d = a.links[j];
    d.w0 = static_cast<const int8_t*>(p[0]);
    d.b0 = static_cast<const int32_t*>(p[1]);
    d.w1 = static_cast<const int8_t*>(p[2]);
    d.b1 = static_cast<const int32_t*>(p[3]);
    d.wd = static_cast<const int8_t*>(p[4]);
    d.bd = static_cast<const int32_t*>(p[5]);
    d.h = k[0], d.w = k[1], d.cin = k[2], d.cout = k[3], d.stride = k[4];
    d.has_ds = k[5], d.shift0 = k[6], d.shift1 = k[7], d.skip_shift = k[8];
    if (d.cin % 4 || d.cout % 4) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (stem_cout && (stem_cout % 4 || stem_cin < 1 || stem_cin > 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = a.l.bytes;
  if (smem > repro::kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_chain_kernel<<<n / batch_tile, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
