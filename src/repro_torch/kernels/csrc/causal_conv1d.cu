// causal_conv1d: the Mamba1 block's int8 causal depthwise conv over the
// sequence, its requantize and the SiLU onto the next matmul's grid, in one
// pass over u:
//   acc[b, t, c] = bq[c] + sum_k wq[k, c] * x[b, t - K + 1 + k, c]   (int32)
//   q = clamp(round_shift(acc, shift), -128, 127)
//   out[b, t, c] = table[q + 128]
// where positions before 0 read as 0 (no read crosses into another
// sequence) and `table` maps the conv's int8 code to SiLU of it on the
// consumer's grid (built at lower time by the PyTorch functions of the
// plain chain, so the map is that chain's float32 arithmetic, bit for bit).
//
// Replaces no TPU kernel: the JAX package has no Mamba1 conv.  It replaces
// the ~25 PyTorch elementwise kernels of the plain chain (widen, pad, four
// strided tap products and adds, requantize, dequantize, sigmoid, multiply,
// quantize), which moved ~3.6 GB a layer at falcon-mamba-7b's shape.
//
// What bounds it on an H100: bytes.  At (B, S, C) = (4, 512, 8192) it reads
// 16.8 MB of int8 u (a column slice of [u | z], row stride 16,384) and
// writes 16.8 MB: 10 us at 3.35 TB/s.  Integer work is ~11 instructions an
// output, about as long at the SMs' int32 rate, so the instruction count
// is kept low too.
//
// Design: a thread takes 16 consecutive channels (one 16-byte access a
// row) over a run of kRun = 4 consecutive positions of one sequence.  It
// loads the run's rows and the 3 rows before it (the halo, zero before
// position 0) up front, so every load is in flight at once, and slides a
// 4-row window over them in registers.  The halo rows are the previous
// run's, read again mostly from L2; runs of 4 beat runs of 8 and 16 on the
// H100 (15.2 us a launch from cold buffers against 16.9 and 18.0: fewer
// registers, 80 a thread, so more threads an SM).  Each 4 x 4 byte block
// of the window (4 positions x 4 channels) is transposed with byte
// permutes into one word a channel, and one dp4a against the channel's
// taps (packed the same way, zero-padded in front for K < 4) adds the 4
// products to the bias.  Taps and biases stay in registers; the 256-byte
// table is in shared memory.
// The output is written contiguous (B, S, C).  Consecutive threads take
// consecutive channel groups, so a warp reads and writes 512 contiguous
// bytes of a row.  Where the pointers, strides or channel count do not
// allow 16-byte accesses, the same kernel loads and stores byte by byte
// with the ragged channels masked (the <false> instance).
#include "common.cuh"

namespace {

constexpr int kTaps = 4;       // the window; K <= kTaps
constexpr int kLanes = 16;     // channels a thread: one 16-byte access a row
constexpr int kRun = 4;        // consecutive positions a thread
constexpr int kThreads = 128;

struct Row {
  unsigned w[kLanes / 4];
};

__device__ __forceinline__ Row zero_row() { return Row{{0u, 0u, 0u, 0u}}; }

// 16 bytes of channels c0.. of one row; channels at or past `c` read as 0
template <bool kVec>
__device__ __forceinline__ Row load_row(const signed char* p, int c0, int c) {
  Row r;
  if constexpr (kVec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kLanes / 4; ++i) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 4 * i + j;
        if (c0 + ch < c) word |= static_cast<unsigned>(static_cast<unsigned char>(p[ch])) << (8 * j);
      }
      r.w[i] = word;
    }
  }
  return r;
}

template <bool kVec>
__device__ __forceinline__ void store_row(signed char* p, const Row& r, int c0, int c) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
#pragma unroll
    for (int ch = 0; ch < kLanes; ++ch)
      if (c0 + ch < c) p[ch] = static_cast<signed char>(r.w[ch / 4] >> (8 * (ch % 4)));
  }
}

// rows a, b, c, d of 4 channels each -> col[j] = (a_j, b_j, c_j, d_j)
__device__ __forceinline__ void transpose4(unsigned a, unsigned b, unsigned c, unsigned d,
                                           unsigned* col) {
  const unsigned ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const unsigned ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const unsigned cd_lo = __byte_perm(c, d, 0x5140);
  const unsigned cd_hi = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(ab_lo, cd_lo, 0x5410);         // a0 b0 c0 d0
  col[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  col[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  col[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_kernel(const signed char* __restrict__ x, const signed char* __restrict__ wq,
                     const int* __restrict__ bq, const signed char* __restrict__ table,
                     signed char* __restrict__ out, int b, int s, int c, long long sb,
                     long long ss, int k, int shift) {
  __shared__ signed char s_table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_table[i] = table[i];
  __syncthreads();

  const int groups = (c + kLanes - 1) / kLanes;
  const int runs = (s + kRun - 1) / kRun;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= static_cast<long long>(b) * runs * groups) return;
  const int g = static_cast<int>(item % groups);
  const long long rest = item / groups;
  const int t0 = static_cast<int>(rest % runs) * kRun;
  const int bi = static_cast<int>(rest / runs);
  const int c0 = g * kLanes;

  // taps, one word a channel: byte i the tap at position t - 3 + i
  unsigned wcol[kLanes];
  {
    Row tr[kTaps];
#pragma unroll
    for (int i = 0; i < kTaps; ++i)
      tr[i] = i < kTaps - k ? zero_row()
                            : load_row<kVec>(wq + static_cast<long long>(i - kTaps + k) * c + c0, c0, c);
#pragma unroll
    for (int w = 0; w < kLanes / 4; ++w)
      transpose4(tr[0].w[w], tr[1].w[w], tr[2].w[w], tr[3].w[w], &wcol[4 * w]);
  }
  int bias[kLanes];
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kLanes / 4; ++i) {
      const int4 v = reinterpret_cast<const int4*>(bq + c0)[i];
      bias[4 * i] = v.x, bias[4 * i + 1] = v.y, bias[4 * i + 2] = v.z, bias[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < kLanes; ++ch) bias[ch] = c0 + ch < c ? bq[c0 + ch] : 0;
  }

  // the halo and the run, every load issued before any is used
  const signed char* xb = x + static_cast<long long>(bi) * sb + c0;
  Row win[kTaps - 1], cur[kRun];
#pragma unroll
  for (int i = 0; i < kTaps - 1; ++i) {
    const int t = t0 - (kTaps - 1) + i;
    win[i] = t >= 0 ? load_row<kVec>(xb + t * ss, c0, c) : zero_row();
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    cur[i] = t0 + i < s ? load_row<kVec>(xb + (t0 + i) * ss, c0, c) : zero_row();

  signed char* ob = out + (static_cast<long long>(bi) * s + t0) * c + c0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (t0 + i >= s) break;
    Row o;
#pragma unroll
    for (int w = 0; w < kLanes / 4; ++w) {
      unsigned col[4];
      transpose4(win[0].w[w], win[1].w[w], win[2].w[w], cur[i].w[w], col);
      unsigned q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int acc = __dp4a(static_cast<int>(col[j]), static_cast<int>(wcol[4 * w + j]),
                               bias[4 * w + j]);
        // Q.requantize_shift: a rounding right shift for shift > 0, a left
        // shift otherwise, then the int8 clamp
        const int v = min(max(repro::shift_align(acc, -shift), -128), 127);
        q[j] = static_cast<unsigned>(s_table[v + 128]);
      }
      o.w[w] = __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040),
                           0x5410);
    }
    store_row<kVec>(ob + static_cast<long long>(i) * c, o, c0, c);
    win[0] = win[1], win[1] = win[2], win[2] = cur[i];
  }
}

}  // namespace

// x: (b, s, c) int8 at strides (sb, ss, 1) elements, e.g. the first c
// columns of a wider row; wq: (k, c) int8 taps, 1 <= k <= 4; bq: (c,) int32
// at the product domain; table: 256 int8, indexed by the requantized code
// + 128; out: (b, s, c) int8, contiguous.  shift > 0 is a rounding right
// shift, shift <= 0 a left shift by -shift.  vec != 0 runs the 16-byte
// instance, which needs every pointer 16-byte aligned and c, sb and ss
// multiples of 16 (refused otherwise).  Returns the cudaError_t of the
// launch.
REPRO_EXPORT int causal_conv1d_launch(const void* x, const void* wq, const void* bq,
                                      const void* table, void* out, int b, int s, int c,
                                      long long sb, long long ss, int k, int shift, int vec,
                                      void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k < 1 || k > kTaps || shift < -31 || shift > 31 ||
      (vec && !(aligned(x) && aligned(wq) && aligned(bq) && aligned(out) && c % 16 == 0 &&
                sb % 16 == 0 && ss % 16 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(b) * ((s + kRun - 1) / kRun) *
                          ((c + kLanes - 1) / kLanes);
  if (items == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((items + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const signed char*>(x);
  const auto* wp = static_cast<const signed char*>(wq);
  const auto* bp = static_cast<const int*>(bq);
  const auto* tp = static_cast<const signed char*>(table);
  auto* op = static_cast<signed char*>(out);
  if (vec)
    causal_conv1d_kernel<true><<<blocks, kThreads, 0, st>>>(xp, wp, bp, tp, op, b, s, c, sb, ss,
                                                            k, shift);
  else
    causal_conv1d_kernel<false><<<blocks, kThreads, 0, st>>>(xp, wp, bp, tp, op, b, s, c, sb,
                                                             ss, k, shift);
  return static_cast<int>(cudaGetLastError());
}
