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
// (67 MB): 65 us at 3.35 TB/s with the states, against 1.9 G float
// operations (28 us at the 67 TFLOP/s float32 peak, counting exp as one).
// The serial chain of 512 dependent steps per channel is what one thread a
// channel cannot hide.
//
// Design: one thread per (batch, channel) keeps the channel's N <= 16
// states and its row of A in registers and walks t.  A thread block of 128
// consecutive channels of one batch row reads u_t and dt_t as one
// coalesced 512-byte line a step and writes y_t the same way; B_t and C_t,
// shared by every channel, are staged in shared memory 64 steps at a time.
// The update is written with __fmul_rn / __fadd_rn, so no multiply-add is
// contracted and each step rounds as the plain version's separate torch
// operations do, the N-term sum in the same order; only expf can differ.
// Built without fast math: expf is the full-precision one.
#include "common.cuh"

namespace {

constexpr int kThreads = 128, kChunk = 64, kMaxState = 16;

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ bc,
                      const float* __restrict__ cc, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int s,
                      int di, int n) {
  __shared__ float s_b[kChunk * kMaxState];
  __shared__ float s_c[kChunk * kMaxState];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const long long state = (static_cast<long long>(b) * di + d) * n;

  float h[kMaxState], a[kMaxState];
#pragma unroll
  for (int j = 0; j < kMaxState; ++j) {
    const bool on = live && j < n;
    h[j] = on ? h0[state + j] : 0.f;
    a[j] = on ? A[static_cast<long long>(d) * n + j] : 0.f;
  }

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    __syncthreads();   // the previous chunk's B and C are consumed
    const long long row = (static_cast<long long>(b) * s + t0) * n;
    for (int i = threadIdx.x; i < len * n; i += kThreads) {
      s_b[i] = bc[row + i];
      s_c[i] = cc[row + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < len; ++tt) {
      const long long o = (static_cast<long long>(b) * s + t0 + tt) * di + d;
      const float dtv = dt[o];
      const float du = __fmul_rn(dtv, u[o]);
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxState; ++j) {
        if (j >= n) continue;
        const float e = expf(__fmul_rn(dtv, a[j]));
        h[j] = __fadd_rn(__fmul_rn(e, h[j]), __fmul_rn(du, s_b[tt * n + j]));
        yv = __fadd_rn(yv, __fmul_rn(h[j], s_c[tt * n + j]));
      }
      y[o] = yv;
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kMaxState; ++j)
    if (j < n) h_last[state + j] = h[j];
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
  const dim3 grid((di + kThreads - 1) / kThreads, b);
  selective_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bc),
      static_cast<const float*>(cc), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), s, di, n);
  return static_cast<int>(cudaGetLastError());
}
