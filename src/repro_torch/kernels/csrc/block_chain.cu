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
// TB/s (the images in, the 8x8x64 maps out, the weights once).  At these
// sizes a link is a few microseconds of work, so latency bounds it in
// practice: the dependent mma chain of a warp item, the cluster barriers,
// and fetching each link's weights.
//
// Design: a thread block cluster of `split` thread blocks (1, 2, 4 or 8,
// chosen by tune/space.py:chain_split) takes batch_tile images; thread block
// r of the cluster owns row band r of every map of the chain (32 -> 16 -> 8
// rows split evenly, so the stride-2 links' bands line up: output band
// [r0, r1) reads input rows [2 r0, 2 r1] and the skip's [2 r0, 2 r1)).
// After each conv phase every thread block pushes its edge rows into its
// neighbours' halo rows (one below, one above) through distributed shared
// memory, and the cluster syncs.  Dynamic shared memory (chain_layout
// below; the planner's core/dataflow.py:chain_task_smem_bytes is the same
// formula) holds the stem's filter and bias, two weight slots, and per
// image three band planes — link input, y0, link output — swapped between
// links.  A link's packed block (block_body.cuh: biases and
// mma-fragment-ordered filters) has one part a conv phase; the parts
// stream through the two slots by cp.async one phase ahead (conv1's part
// arrives while conv0 computes, the next link's conv0 part while conv1
// does), so two slots of the largest part (39,424 B: the 32 -> 64 link's
// conv1 and downsample) serve where two whole links would take twice
// that.  At splits 4 and 8 a thread block then needs under half of an
// SM's shared memory, and two of them share an SM.
// The block products are block_body.cuh's implicit GEMMs on the int8 tensor
// cores (mma.sync .u8.s8), shared with resblock_fused, each link's in the
// warp-item tile of its link-table row (tune/space.py:chain_tiles).  The
// stem (cin 3, padded to 4; 0.44 M of the 40.8 M multiply-adds an image)
// stays on dp4a on the CUDA cores: a K of 4 bytes would fill an eighth of
// an m16n8k32.
#include <cooperative_groups.h>

#include "block_body.cuh"

namespace cg = cooperative_groups;

namespace {

// Two thread blocks an SM: 256 threads at up to 128 registers each, and
// at split 4 or 8 a thread block needs under half of the SM's shared
// memory.  tune/space.py:chain_split sizes the grid from the clusters the
// card runs at once (block_chain_max_clusters below).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;
constexpr int kMaxLinks = 32;
// The longest side of a warp-item tile the kernel instantiates: 2, since a
// tile 4 pixel tiles or 4 channel pairs long spills beside the chain's
// state within 128 registers a thread (block_body.cuh's tile_ok).
constexpr int kTileSide = 2;
// h, w, cin, cout, stride, has_ds, shift0, shift1, skip_shift, mt, nt
constexpr int kLinkInts = 11;

struct Link {
  const unsigned char* packed;
  int h, w, cin, cout, stride, has_ds, shift0, shift1, skip_shift;
  int mt, nt;  // the warp-item tile of both conv phases (block_body.cuh)
};

struct ChainLayout {
  int stem_bytes, slot_bytes, plane_bytes, bytes;
};

struct ChainArgs {
  const uint8_t* x;
  uint8_t* out;
  const int8_t* stem_w;
  const int32_t* stem_b;
  int stem_cin, stem_cout, stem_shift;
  int n_links, batch_tile, split;
  int* sm_ids;  // null, or one int a thread block: the SM it ran on
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
// two weight slots, each the largest part (A: b0, w0; B: b1, bd, w1, wd)
// of any link's packed block ||
// batch_tile planes A | batch_tile planes B | batch_tile planes C.  A plane
// holds the largest (h / split + 2) x (w + 2) band of the chain's maps,
// pixel_pitch bytes a pixel (4 for the image), halo rows and ring included.
inline ChainLayout chain_layout(const int* ints, int n_links, int stem_cin,
                                int stem_cout, int batch_tile, int split) {
  ChainLayout l;
  const int cin_pad = (stem_cin + 3) / 4 * 4;
  l.stem_bytes = stem_cout ? align16(4 * stem_cout + 9 * cin_pad * stem_cout) : 0;
  l.slot_bytes = 0;
  int plane = stem_cout ? (ints[0] / split + 2) * (ints[1] + 2) * cin_pad : 0;
  for (int j = 0; j < n_links; ++j) {
    const int* k = ints + j * kLinkInts;
    const int h = k[0], w = k[1], cin = k[2], cout = k[3], stride = k[4], has_ds = k[5];
    for (int part = 0; part < 2; ++part)
      l.slot_bytes = imax(l.slot_bytes, repro::packed_part_bytes(cin, cout, has_ds, part));
    plane = imax(plane, (h / split + 2) * (w + 2) * repro::pixel_pitch(cin));
    plane = imax(plane, (out_size(h, stride) / split + 2) *
                            (out_size(w, stride) + 2) * repro::pixel_pitch(cout));
  }
  l.plane_bytes = align16(plane);
  l.bytes = l.stem_bytes + 2 * l.slot_bytes + 3 * batch_tile * l.plane_bytes;
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

// The stem conv on the CUDA cores: out(oy, ox) = requant_u8(bias + sum over
// taps of in(oy + kh, ox + kw) . wt) for output rows [oy0, oy0 + rows);
// in: the image band, 4 bytes a pixel; wt: [9][cout] dp4a words.  An item
// is one output pixel times four consecutive output channels.
__device__ void stem_dp4a(const repro::Map in, const int8_t* wt,
                          const int32_t* bias, int oy0, int rows, int ow,
                          int cout, int shift, const repro::Map out) {
  const int cout4 = cout / 4;
  const int* w = reinterpret_cast<const int*>(wt);
  for (int it = threadIdx.x; it < rows * ow * cout4; it += blockDim.x) {
    const int pix = it / cout4;
    const int co = 4 * (it - pix * cout4);
    const int oy = oy0 + pix / ow, ox = pix - (pix / ow) * ow;
    int acc[4] = {bias[co], bias[co + 1], bias[co + 2], bias[co + 3]};
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned v = *reinterpret_cast<const unsigned*>(in.at(oy + tap / 3, ox + tap % 3));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = repro::dp4a_us(v, w[tap * cout + co + j], acc[j]);
    }
    *reinterpret_cast<unsigned*>(out.at(oy, ox) + co) =
        repro::requant_u8(acc[0], shift) | repro::requant_u8(acc[1], shift) << 8 |
        repro::requant_u8(acc[2], shift) << 16 | repro::requant_u8(acc[3], shift) << 24;
  }
}

// Fill the halo rows of the batch_tile band planes at `plane` (nb own rows
// stored at 1 .. nb, (w + 2) pixels of `pitch` bytes, just written): push
// this thread block's first own row into the block above's stored row
// nb + 1 and its last into the block below's stored row 0, through
// distributed shared memory; at the map's edges zero this block's own halo
// row instead.  The cluster barrier then makes every push visible (its
// arrive releases, its wait acquires).  No thread block pushes into a
// plane its neighbour still reads: the previous use of every plane ended
// at an earlier cluster barrier.
__device__ void push_halo(cg::cluster_group& cl, uint8_t* plane,
                          int plane_bytes, int bt, int nb, int w, int pitch) {
  __syncthreads();  // this block's own rows and ring columns are written
  const int rank = static_cast<int>(cl.block_rank());
  const int split = static_cast<int>(cl.num_blocks());
  const int row_bytes = (w + 2) * pitch, row16 = row_bytes / 16;
  for (int i = threadIdx.x; i < bt * 2 * row16; i += blockDim.x) {
    const int n = i / (2 * row16), k = i - n * 2 * row16;
    const int down = k >= row16, q = k - down * row16;
    uint8_t* base = plane + n * plane_bytes;
    const int nbr = down ? rank + 1 : rank - 1;
    if (nbr >= 0 && nbr < split) {
      const uint4 v = reinterpret_cast<const uint4*>(base + (down ? nb : 1) * row_bytes)[q];
      uint8_t* dst = base + (down ? 0 : nb + 1) * row_bytes;
      reinterpret_cast<uint4*>(cl.map_shared_rank(dst, nbr))[q] = v;
    } else {
      reinterpret_cast<uint4*>(base + (down ? nb + 1 : 0) * row_bytes)[q] =
          make_uint4(0, 0, 0, 0);
    }
  }
  cl.sync();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_chain_kernel(const __grid_constant__ ChainArgs a) {
  using repro::Map;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainLayout& l = a.l;
  const int bt = a.batch_tile, plane = l.plane_bytes, split = a.split;
  const int rank = static_cast<int>(cl.block_rank());
  int32_t* stem_b = reinterpret_cast<int32_t*>(smem);
  int8_t* stem_wt = reinterpret_cast<int8_t*>(smem + 4 * a.stem_cout);
  unsigned char* slot0 = smem + l.stem_bytes;
  unsigned char* slot1 = slot0 + l.slot_bytes;
  uint8_t* pa = smem + l.stem_bytes + 2 * l.slot_bytes;  // link input
  uint8_t* pb = pa + bt * plane;                          // y0
  uint8_t* pc = pb + bt * plane;                          // link output
  const size_t img0 = static_cast<size_t>(blockIdx.x / split) * bt;
  if (a.sm_ids != nullptr && threadIdx.x == 0) a.sm_ids[blockIdx.x] = repro::sm_id();

  // weight part q (link q / 2; A for conv0 when q is even, B for conv1
  // and the downsample when odd) streams into slot q % 2 by cp.async
  auto fetch = [&](int q) {
    const Link& k = a.links[q / 2];
    const int part = q & 1;
    repro::copy_async(part ? slot1 : slot0,
                      k.packed + (part ? repro::packed_part_bytes(k.cin, k.cout, k.has_ds, 0) : 0),
                      repro::packed_part_bytes(k.cin, k.cout, k.has_ds, part));
    repro::cp_async_commit();
  };
  fetch(0);
  // every thread block of the cluster has started before any pushes into
  // another's shared memory
  cl.sync();

  // ---- the chain's input band (rows r0 - 1 .. r0 + nb, zero outside the
  // map): the image for the stem, else the first link's input ----
  const Link& first = a.links[0];
  const int h0 = first.h, w0 = first.w, nb0 = h0 / split, r00 = rank * nb0;
  if (a.stem_cout) {
    const int cin = a.stem_cin;
    for (int n = 0; n < bt; ++n)
      repro::stage_rows(a.x + (img0 + n) * h0 * w0 * cin, h0, w0, cin, pb + n * plane,
                        4, w0 + 2, 1, r00 - 1, nb0 + 2);
    repro::stage_bias(a.stem_b, stem_b, a.stem_cout);
    stage_stem(a.stem_w, stem_wt, cin, a.stem_cout);
    __syncthreads();
    // ---- the stem, fused at the head: image band -> pa's own rows ----
    const int ps = repro::pixel_pitch(a.stem_cout);
    for (int n = 0; n < bt; ++n) {
      stem_dp4a(Map{pb + n * plane, w0 + 2, -r00, 0, 4}, stem_wt, stem_b, r00, nb0,
                w0, a.stem_cout, a.stem_shift, Map{pa + n * plane, w0 + 2, 1 - r00, 1, ps});
      repro::zero_ring_cols(pa + n * plane, w0, ps, 1, nb0 + 1);
    }
    push_halo(cl, pa, plane, bt, nb0, w0, ps);
  } else {
    for (int n = 0; n < bt; ++n)
      repro::stage_rows(a.x + (img0 + n) * h0 * w0 * first.cin, h0, w0, first.cin,
                        pa + n * plane, repro::pixel_pitch(first.cin), w0 + 2, 1,
                        r00 - 1, nb0 + 2);
  }

  for (int j = 0; j < a.n_links; ++j) {
    const Link& k = a.links[j];
    const int cout = k.cout, pad_lo = pad_lo_of(k.stride);
    const int oh = out_size(k.h, k.stride), ow = out_size(k.w, k.stride);
    const int nbi = k.h / split, ri = rank * nbi;  // input band
    const int nbo = oh / split, ro = rank * nbo;   // output band
    const int pin = repro::pixel_pitch(k.cin), pout = repro::pixel_pitch(cout);
    const bool last = j + 1 == a.n_links;

    // conv1's part streams into slot 1 while conv0 computes; slot 1 held
    // link j - 1's conv1 part, done with since the last cluster barrier
    fetch(2 * j + 1);
    repro::cp_async_wait<1>();
    __syncthreads();
    const repro::Packed pk(slot0, slot1, k.cin, cout);

    // ---- phase A: conv0 (strided) -> requant_u8 -> y0's own rows in pb.
    // The input's (pad_lo, 1)-padded coordinate 0 is stored column
    // 1 - pad_lo, and its row ri - 1 stored row 0 ----
    for (int n = 0; n < bt; ++n) {
      const Map in{pa + n * plane, k.w + 2, 1 - pad_lo - ri, 1 - pad_lo, pin};
      repro::with_tile<kTileSide>(k.mt, k.nt, [&](auto tile) {
        using T = decltype(tile);
        repro::conv3x3_mma<T::MT, T::NT>(in, k.cin, pk.w0, pk.b0, k.stride, ro,
                                         nbo, ow, cout, k.shift0,
                                         Map{pb + n * plane, ow + 2, 1 - ro, 1, pout});
      });
      repro::zero_ring_cols(pb + n * plane, ow, pout, 1, nbo + 1);
    }
    push_halo(cl, pb, plane, bt, nbo, ow, pout);

    // the next link's conv0 part streams into slot 0 while conv1 computes
    if (!last) {
      fetch(2 * j + 2);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();

    // ---- phase B: skip + b1 + conv1 -> requant_u8 -> pc, or the output ----
    for (int n = 0; n < bt; ++n) {
      const Map x{pa + n * plane, k.w + 2, 1 - pad_lo - ri, 1 - pad_lo, pin};
      const Map out = last ? Map{a.out + (img0 + n) * oh * ow * cout, ow, 0, 0, cout}
                           : Map{pc + n * plane, ow + 2, 1 - ro, 1, pout};
      repro::with_tile<kTileSide>(k.mt, k.nt, [&](auto tile) {
        using T = decltype(tile);
        repro::residual_mma<T::MT, T::NT>(
            x, k.cin, pad_lo, k.stride, pk, k.has_ds != 0, k.skip_shift,
            Map{pb + n * plane, ow + 2, -ro, 0, pout}, ro, nbo, ow, cout,
            k.shift1, out);
      });
      if (!last) repro::zero_ring_cols(pc + n * plane, ow, pout, 1, nbo + 1);
    }
    if (!last) push_halo(cl, pc, plane, bt, nbo, ow, pout);
    uint8_t* t = pa;
    pa = pc;
    pc = t;
  }
  // no thread block leaves while a neighbour may still read its planes
  cl.sync();
}

}  // namespace

// Dynamic shared memory one thread block uses.  link_ints: n_links rows of
// (h, w, cin, cout, stride, has_ds, shift0, shift1, skip_shift, mt, nt),
// (mt, nt) the link's warp-item tile (tune/space.py:chain_tiles); stem_cout
// = 0 when no stem is fused; split: thread blocks an image.
REPRO_EXPORT int block_chain_smem_bytes(const int* link_ints, int n_links,
                                        int stem_cin, int stem_cout,
                                        int batch_tile, int split) {
  return chain_layout(link_ints, n_links, stem_cin, stem_cout, batch_tile, split).bytes;
}

// Clusters of `split` thread blocks of smem bytes each that the current
// device runs at once (cudaOccupancyMaxActiveClusters), or a negative
// cudaError_t.
REPRO_EXPORT int block_chain_max_clusters(int split, int smem) {
  // the launch's opt-in limit, never lowered below the 48 KB default that
  // block_chain_launch counts on
  cudaError_t err = cudaFuncSetAttribute(
      block_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, repro::kMaxSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, block_chain_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// x: (n, h, w, cin) u8 unpadded (the image when the stem is fused);
// out: (n, oh, ow, cout) u8 of the last link.  link_ints as above;
// link_ptrs: n_links packed blocks (block_body.cuh's layout, 16-byte
// aligned).  stem_w: (3, 3, stem_cin, stem_cout) s8 HWIO with stem_cin <= 4
// and stem_b: (stem_cout,) s32, or null with stem_cout = 0.  Every link's
// cin and cout must be multiples of 4 and at most 128, its tile one of
// block_body.cuh's set of sides up to kTileSide with nt dividing cout's
// channel pairs (tune/space.py:CHAIN_TILES), x and out 4-byte aligned,
// batch_tile must divide n, and split (1, 2, 4 or 8 thread blocks an
// image, one cluster) every map height of the chain.  Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for arguments the
// kernel does not take, shared memory above repro::kMaxSmemBytes included.
// sm_ids: null, or n / batch_tile * split ints that receive the SM of each
// thread block.
REPRO_EXPORT int block_chain_launch(const void* x, void* out, const void* stem_w,
                                    const void* stem_b, int stem_cin,
                                    int stem_cout, int stem_shift,
                                    const int* link_ints,
                                    const void* const* link_ptrs, int n_links,
                                    int n, int batch_tile, int split,
                                    int* sm_ids, void* stream) {
  if (n_links < 1 || n_links > kMaxLinks || batch_tile < 1 || n % batch_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split != 1 && split != 2 && split != 4 && split != 8)
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
  a.split = split;
  a.sm_ids = sm_ids;
  a.l = chain_layout(link_ints, n_links, stem_cin, stem_cout, batch_tile, split);
  for (int j = 0; j < n_links; ++j) {
    const int* k = link_ints + j * kLinkInts;
    Link& d = a.links[j];
    d.packed = static_cast<const unsigned char*>(link_ptrs[j]);
    d.h = k[0], d.w = k[1], d.cin = k[2], d.cout = k[3], d.stride = k[4];
    d.has_ds = k[5], d.shift0 = k[6], d.shift1 = k[7], d.skip_shift = k[8];
    d.mt = k[9], d.nt = k[10];
    if (!repro::tile_ok<kTileSide>(d.mt, d.nt) ||
        (repro::round16(d.cout) / 16) % d.nt)
      return static_cast<int>(cudaErrorInvalidValue);
    if (d.cin % 4 || d.cout % 4 || repro::round16(d.cin) > repro::kMaxK ||
        repro::round16(d.cout) > repro::kMaxK || d.h % split ||
        out_size(d.h, d.stride) % split ||
        reinterpret_cast<uintptr_t>(d.packed) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / batch_tile * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, block_chain_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
