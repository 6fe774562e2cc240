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
// Design: four lanes a channel, each lane keeping 4 of the channel's N <= 16
// states and their row of A in registers, so a step of one lane is 4 exp
// and 4 updates, and 4 x 32 x 32 = 131,072 threads cover falcon-mamba-7b's
// shape (31 warps an SM where one thread a channel gave 8).  A thread
// block of 128 threads owns 32 consecutive channels of one batch row.  u,
// dt, B and C are staged in shared memory a chunk of 16 steps at a time
// with cp.async, double-buffered: the next chunk's loads are in flight
// while this chunk computes.  y_t needs the N products h_t * C_t summed in
// order; y does not feed back, so the sum is off the recurrence's critical
// path and is done with the roles transposed: every 4 steps each lane
// writes its products to shared memory, then lane r of the channel sums
// the 16 products of step r in state order.  y is staged per chunk and
// written as coalesced rows.
// Arithmetic as the plain version: each update is __fmul_rn / __fadd_rn,
// so no multiply-add is contracted, and y_t = (((0 + p_0) + p_1) + ...) +
// p_{N-1}, so each step rounds as the plain version's separate torch
// operations do and only expf can differ.  Built without fast math: expf
// is the full-precision one.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxState = 16;
constexpr int kLanes = 4;                     // lanes a channel
constexpr int kPerLane = kMaxState / kLanes;  // states a lane
constexpr int kChannels = 32;                 // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kChunk = 16;                    // steps staged at a time
constexpr int kGroup = 4;                     // steps between the y sums (= kLanes)
constexpr int kPStride = kChannels * kMaxState + 4;   // padded: no bank conflicts

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ bc,
                      const float* __restrict__ cc, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int s,
                      int di, int n) {
  __shared__ __align__(16) float s_u[2][kChunk][kChannels];
  __shared__ __align__(16) float s_dt[2][kChunk][kChannels];
  __shared__ __align__(16) float s_b[2][kChunk][kMaxState];
  __shared__ __align__(16) float s_c[2][kChunk][kMaxState];
  __shared__ __align__(16) float s_p[kGroup * kPStride];
  __shared__ float s_y[kChunk][kChannels];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = d0 + ch;
  const bool live = d < di;
  const long long state = (static_cast<long long>(b) * di + d) * n;

  float h[kPerLane], a[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane * kPerLane + i;
    const bool on = live && j < n;
    h[i] = on ? h0[state + j] : 0.f;
    a[i] = on ? A[static_cast<long long>(d) * n + j] : 0.f;
  }

  // chunk c of u, dt (rows of 32 channels) and B, C (rows of n, zero
  // padded to 16) into buffer c & 1; out-of-range elements read as zero
  auto stage = [&](int c) {
    const int buf = c & 1, t0 = c * kChunk;
    for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc_ = e % kChannels;
      const bool ok = t0 + tt < s && d0 + cc_ < di;
      const long long o = ok ? (static_cast<long long>(b) * s + t0 + tt) * di + d0 + cc_ : 0;
      cp_async4(&s_u[buf][tt][cc_], u + o, ok);
      cp_async4(&s_dt[buf][tt][cc_], dt + o, ok);
    }
    for (int e = threadIdx.x; e < kChunk * kMaxState; e += kThreads) {
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
      for (int g = 0; g < (kFull ? kChunk : len_); g += kGroup) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int tt = g + q;
          if (kFull || tt < len_) {
            const float dtv = s_dt[buf][tt][ch];
            const float du = __fmul_rn(dtv, s_u[buf][tt][ch]);
            const float4 bv = *reinterpret_cast<const float4*>(&s_b[buf][tt][lane * kPerLane]);
            const float4 cv = *reinterpret_cast<const float4*>(&s_c[buf][tt][lane * kPerLane]);
            const float bj[kPerLane] = {bv.x, bv.y, bv.z, bv.w};
            const float cj[kPerLane] = {cv.x, cv.y, cv.z, cv.w};
            float p[kPerLane];
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              const float e = expf(__fmul_rn(dtv, a[i]));
              h[i] = __fadd_rn(__fmul_rn(e, h[i]), __fmul_rn(du, bj[i]));
              p[i] = __fmul_rn(h[i], cj[i]);
            }
            *reinterpret_cast<float4*>(&s_p[q * kPStride + ch * kMaxState + lane * kPerLane]) =
                make_float4(p[0], p[1], p[2], p[3]);
          }
        }
        __syncwarp();
        // lane r sums step g + r over the states in order
        const int tt = g + lane;
        if (kFull || tt < len_) {
          const float4* pr = reinterpret_cast<const float4*>(
              &s_p[lane * kPStride + ch * kMaxState]);
          float yv = 0.f;
#pragma unroll
          for (int i = 0; i < kLanes; ++i) {
            const float4 pv = pr[i];
            const float pj[kPerLane] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int k = 0; k < kPerLane; ++k)
              if (kFull || i * kPerLane + k < n_) yv = __fadd_rn(yv, pj[k]);
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
    for (int e = threadIdx.x; e < len * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc_ = e % kChannels;
      if (d0 + cc_ < di)
        y[(static_cast<long long>(b) * s + t0 + tt) * di + d0 + cc_] = s_y[tt][cc_];
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int j = lane * kPerLane + i;
    if (j < n) h_last[state + j] = h[i];
  }
}

}  // namespace

// u, dt, y: (b, s, di); A: (di, n); bc, cc: (b, s, n); h0, h_last:
// (b, di, n); all float32, contiguous; n <= 16.  Returns the cudaError_t of
// the launch.
REPRO_EXPORT int selective_scan_launch(const void* u, const void* dt,
                                       const void* A, const void* bc,
                                       const void* cc, const void* h0,
                                       void* y, void* h_last, int b, int s,
                                       int di, int n, void* stream) {
  if (n <= 0 || n > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + kChannels - 1) / kChannels, b);
  selective_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bc),
      static_cast<const float*>(cc), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), s, di, n);
  return static_cast<int>(cudaGetLastError());
}
