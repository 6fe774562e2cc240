// selective_scan: the Mamba1 recurrence, sequential in t and parallel over
// (batch, d_inner):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   y_t = sum_N h_t * C_t
// returning y and the last state.  softplus(dt), the D term and the gating
// stay outside, as in the TPU kernel.
//
// Replaces the TPU kernel
// src/repro/kernels/selective_scan/selective_scan.py:selective_scan
// (body _kernel; wrapper ops.py:selective_scan_op).
//
// What bounds it on an H100: bytes.  falcon-mamba-7b at bucket 4 (B = 4,
// S = 512, d_inner = 8192, N = 16) reads u and dt (134 MB) and writes y
// (67 MB): 62 us at 3.35 TB/s with the states, against 1.9 G float
// operations (28 us at the 67 TFLOP/s float32 peak, counting exp as one).
// In practice it is bound by latency: 512 dependent steps a channel, each
// an exp, a multiply-add chain and an N-term sum.
//
// Design: L lanes a channel (the rule: L = 4), each lane keeping 16 / L
// of the channel's N <= 16 states and their row of A in registers, so a
// step of one lane is 16 / L exp and as many updates; at the rule's 4
// lanes and 32 channels a thread block, 4 x 32 x 32 = 131,072 threads
// cover falcon-mamba-7b's shape (31 warps an SM where one thread a channel
// gave 8).  A thread block of C x L threads owns C consecutive channels of
// one batch row.  The kernel is a template on (C, L), instantiated over
// C in {16, 32, 64} x L in {2, 4, 8} but (64, 8), whose 57 KB of static
// shared memory exceed the 48 KB a static allocation may take; the wrapper
// takes the pair from its config (cout_block, lanes).  u, dt, B and C are
// staged in shared memory a chunk of 16 steps at a time with cp.async,
// double-buffered: the next chunk's loads are in flight while this chunk
// computes.  y_t needs the N products h_t * C_t summed in order; y does
// not feed back, so the sum is off the recurrence's critical path and is
// done with the roles transposed: every L steps each lane writes its
// products to shared memory, then lane r of the channel sums the 16
// products of step r in state order.  y is staged per chunk and written
// as coalesced rows.
// Arithmetic as the plain version: each update is __fmul_rn / __fadd_rn,
// so no multiply-add is contracted, and y_t = (((0 + p_0) + p_1) + ...) +
// p_{N-1}, so each step rounds as the plain version's separate torch
// operations do and only expf can differ, whatever (C, L).  Built without
// fast math: expf is the full-precision one.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxState = 16;
constexpr int kChunk = 16;                    // steps staged at a time

// the decomposition of one instance: C channels a block, L lanes a channel
template <int C, int L>
struct ScanCfg {
  static constexpr int kPerLane = kMaxState / L;        // states a lane
  static constexpr int kThreads = C * L;
  static constexpr int kGroup = L;                      // steps between the y sums
  static constexpr int kPStride = C * kMaxState + 4;    // padded: no bank conflicts
  static constexpr int kSmem =
      4 * (2 * 2 * kChunk * C + 2 * 2 * kChunk * kMaxState + kGroup * kPStride + kChunk * C);
  static_assert(32 % L == 0 && kChunk % L == 0, "a channel's lanes share a warp");
  static_assert(kMaxState % L == 0 && (kPerLane % 4 == 0 || kPerLane == 2), "lane vectors");
  static_assert(kSmem <= 48 * 1024, "static shared memory is at most 48 KB");
};

// the lane's kPerLane consecutive floats, as 16- or 8-byte accesses
template <int PL>
__device__ __forceinline__ void load_lane(float (&dst)[PL], const float* src) {
  if constexpr (PL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x, dst[i + 1] = v.y, dst[i + 2] = v.z, dst[i + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x, dst[1] = v.y;
  }
}
template <int PL>
__device__ __forceinline__ void store_lane(float* dst, const float (&src)[PL]) {
  if constexpr (PL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < PL; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int C, int L>
__global__ void __launch_bounds__(C * L)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ bc,
                      const float* __restrict__ cc, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int s,
                      int di, int n) {
  using Cfg = ScanCfg<C, L>;
  __shared__ __align__(16) float s_u[2][kChunk][C];
  __shared__ __align__(16) float s_dt[2][kChunk][C];
  __shared__ __align__(16) float s_b[2][kChunk][kMaxState];
  __shared__ __align__(16) float s_c[2][kChunk][kMaxState];
  __shared__ __align__(16) float s_p[Cfg::kGroup * Cfg::kPStride];
  __shared__ float s_y[kChunk][C];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int ch = threadIdx.x / L, lane = threadIdx.x % L;
  const int d = d0 + ch;
  const bool live = d < di;
  const long long state = (static_cast<long long>(b) * di + d) * n;

  float h[Cfg::kPerLane], a[Cfg::kPerLane];
#pragma unroll
  for (int i = 0; i < Cfg::kPerLane; ++i) {
    const int j = lane * Cfg::kPerLane + i;
    const bool on = live && j < n;
    h[i] = on ? h0[state + j] : 0.f;
    a[i] = on ? A[static_cast<long long>(d) * n + j] : 0.f;
  }

  // chunk c of u, dt (rows of C channels) and B, C (rows of n, zero
  // padded to 16) into buffer c & 1; out-of-range elements read as zero
  auto stage = [&](int c) {
    const int buf = c & 1, t0 = c * kChunk;
    for (int e = threadIdx.x; e < kChunk * C; e += Cfg::kThreads) {
      const int tt = e / C, cc_ = e % C;
      const bool ok = t0 + tt < s && d0 + cc_ < di;
      const long long o = ok ? (static_cast<long long>(b) * s + t0 + tt) * di + d0 + cc_ : 0;
      cp_async4(&s_u[buf][tt][cc_], u + o, ok);
      cp_async4(&s_dt[buf][tt][cc_], dt + o, ok);
    }
    for (int e = threadIdx.x; e < kChunk * kMaxState; e += Cfg::kThreads) {
      const int tt = e / kMaxState, j = e % kMaxState;
      const bool ok = t0 + tt < s && j < n;
      const long long o = ok ? (static_cast<long long>(b) * s + t0 + tt) * n + j : 0;
      cp_async4(&s_b[buf][tt][j], bc + o, ok);
      cp_async4(&s_c[buf][tt][j], cc + o, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int chunks = (s + kChunk - 1) / kChunk;
  stage(0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, t0 = c * kChunk, len = min(kChunk, s - t0);
    if (c + 1 < chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();   // chunk c has landed for every thread

    // a full chunk of N = 16 states (every chunk of the LM's scan but a
    // ragged last one) runs with its trip counts and guards known at
    // compile time
    auto steps = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int len_ = kFull ? kChunk : len;
      const int n_ = kFull ? kMaxState : n;
#pragma unroll
      for (int g = 0; g < (kFull ? kChunk : len_); g += Cfg::kGroup) {
#pragma unroll
        for (int q = 0; q < Cfg::kGroup; ++q) {
          const int tt = g + q;
          if (kFull || tt < len_) {
            const float dtv = s_dt[buf][tt][ch];
            const float du = __fmul_rn(dtv, s_u[buf][tt][ch]);
            float bj[Cfg::kPerLane], cj[Cfg::kPerLane], p[Cfg::kPerLane];
            load_lane(bj, &s_b[buf][tt][lane * Cfg::kPerLane]);
            load_lane(cj, &s_c[buf][tt][lane * Cfg::kPerLane]);
#pragma unroll
            for (int i = 0; i < Cfg::kPerLane; ++i) {
              const float e = expf(__fmul_rn(dtv, a[i]));
              h[i] = __fadd_rn(__fmul_rn(e, h[i]), __fmul_rn(du, bj[i]));
              p[i] = __fmul_rn(h[i], cj[i]);
            }
            store_lane(&s_p[q * Cfg::kPStride + ch * kMaxState + lane * Cfg::kPerLane], p);
          }
        }
        __syncwarp();
        // lane r sums step g + r over the states in order
        const int tt = g + lane;
        if (kFull || tt < len_) {
          const float4* pr = reinterpret_cast<const float4*>(
              &s_p[lane * Cfg::kPStride + ch * kMaxState]);
          float yv = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxState / 4; ++i) {
            const float4 pv = pr[i];
            const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (kFull || 4 * i + k < n_) yv = __fadd_rn(yv, pj[k]);
          }
          s_y[tt][ch] = yv;
        }
        __syncwarp();
      }
    };
    if (len == kChunk && n == kMaxState)
      steps(std::true_type{});
    else
      steps(std::false_type{});
    __syncthreads();   // s_y complete; buffer buf consumed
    for (int e = threadIdx.x; e < len * C; e += Cfg::kThreads) {
      const int tt = e / C, cc_ = e % C;
      if (d0 + cc_ < di)
        y[(static_cast<long long>(b) * s + t0 + tt) * di + d0 + cc_] = s_y[tt][cc_];
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < Cfg::kPerLane; ++i) {
    const int j = lane * Cfg::kPerLane + i;
    if (j < n) h_last[state + j] = h[i];
  }
}

template <int C, int L>
cudaError_t launch_scan(const void* u, const void* dt, const void* A, const void* bc,
                        const void* cc, const void* h0, void* y, void* h_last, int b,
                        int s, int di, int n, cudaStream_t stream) {
  const dim3 grid((di + C - 1) / C, b);
  selective_scan_kernel<C, L><<<grid, ScanCfg<C, L>::kThreads, 0, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bc),
      static_cast<const float*>(cc), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), s, di, n);
  return cudaGetLastError();
}

// the instantiated (channels, lanes) pairs; the wrapper's scan_knobs holds
// the same list (kernels/selective_scan/ops.py:SHAPES)
#define REPRO_SCAN_SHAPES(X) \
  X(16, 2) X(16, 4) X(16, 8) X(32, 2) X(32, 4) X(32, 8) X(64, 2) X(64, 4)

}  // namespace

// u, dt, y: (b, s, di); A: (di, n); bc, cc: (b, s, n); h0, h_last:
// (b, di, n); all float32, contiguous; n <= 16.  A thread block takes
// `channels` channels of one batch row, each on `lanes` threads, one of
// the pairs of REPRO_SCAN_SHAPES.  Returns the cudaError_t of the launch.
REPRO_EXPORT int selective_scan_launch(const void* u, const void* dt,
                                       const void* A, const void* bc,
                                       const void* cc, const void* h0,
                                       void* y, void* h_last, int b, int s,
                                       int di, int n, int channels, int lanes,
                                       void* stream) {
  if (n <= 0 || n > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SCAN_LAUNCH(C, L)                                                      \
  if (channels == C && lanes == L)                                                 \
    return static_cast<int>(launch_scan<C, L>(u, dt, A, bc, cc, h0, y, h_last, b, s, \
                                              di, n, st));
  REPRO_SCAN_SHAPES(REPRO_SCAN_LAUNCH)
#undef REPRO_SCAN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The static shared memory of the (channels, lanes) instance as the
// compiler laid it out (cudaFuncGetAttributes), into *bytes.
REPRO_EXPORT int selective_scan_smem_bytes(int channels, int lanes, int* bytes) {
  *bytes = 0;
  cudaFuncAttributes attr;
#define REPRO_SCAN_SMEM(C, L)                                                     \
  if (channels == C && lanes == L) {                                            \
    const cudaError_t e = cudaFuncGetAttributes(&attr, selective_scan_kernel<C, L>); \
    if (e == cudaSuccess) *bytes = static_cast<int>(attr.sharedSizeBytes);        \
    return static_cast<int>(e);                                                 \
  }
  REPRO_SCAN_SHAPES(REPRO_SCAN_SMEM)
#undef REPRO_SCAN_SMEM
  return static_cast<int>(cudaErrorInvalidValue);
}
