// flash_attention: causal or non-causal attention with a float32 online
// softmax, in the public (B, S, H, hd) layout.  The q rows are the suffix
// of the key sequence (q_offset = Sk - Sq, the decode convention); the
// output is acc / max(l, 1e-30).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (body _kernel; wrapper ops.py:flash_attention_op, which repeats grouped
// K/V heads and flattens to (B*H, S, hd)).
//
// What bounds it on an H100: operations.  gemma-2b at bucket 4 (B = 4,
// S = 512, H = 8, hd = 256, causal) does 4.3 GFLOP of float32 products on
// 37.7 MB of operands and output: 64 us at the float32 peak outside the
// tensor cores (67 TFLOP/s), 11 us at 3.35 TB/s.
//
// Design: one thread block of 256 threads per (batch * head, 64-row q
// tile).  The TPU kernel holds a head's whole K/V in VMEM; at hd = 256 one
// head's K alone is 512 KB, so here K/V stream through shared memory in
// 64-row tiles: q (pre-scaled by 1/sqrt(hd)), k and v tiles in float32 (64
// x 257, 64 x 257 and 64 x 256 floats, the odd rows keep the q.k loop free
// of bank conflicts) plus the 64 x 65 score tile: 214,528 B at hd = 256.
// Each thread owns a 4 x 4 block of scores and a 4 x (hd/16) block of the
// output accumulator in registers; a warp runs the online-softmax update
// of 8 rows with shuffle reductions.  Masked scores are -1e30 (not -inf),
// as in the TPU kernel; keys past Sk (the ragged last tile) get -inf, so
// they weigh exactly 0.  K/V tiles past the causal bound are never read.
// Query head h reads kv head h / (H / KV) in place, so grouped K/V are
// never repeated in memory.  bf16 inputs are widened to float32 at
// staging and the output rounded back to bf16.  Built without fast math:
// expf and the final divide are the full-precision ones.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256, kMaxHd = 256;
constexpr int kMaxCols = kMaxHd / 16;   // output columns a thread holds
constexpr float kMasked = -1e30f;

constexpr int smem_floats(int hd) {
  return kBQ * (hd + 1) + kBK * (hd + 1) + kBK * hd + kBQ * (kBK + 1) + 3 * kBQ;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int heads, int kv_heads, int hd, bool causal,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = hd + 1, lds = kBK + 1;
  float* s_q = smem;                  // [kBQ][hd + 1]
  float* s_k = s_q + kBQ * ldq;       // [kBK][hd + 1]
  float* s_v = s_k + kBK * ldq;       // [kBK][hd]
  float* s_s = s_v + kBK * hd;        // [kBQ][kBK + 1] scores, then p
  float* s_m = s_s + kBQ * lds;       // running max per row
  float* s_l = s_m + kBQ;             // running denominator per row
  float* s_c = s_l + kBQ;             // this tile's rescale per row

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q_offset = sk - sq;
  const int ncols = hd / 16;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    float x = 0.f;
    if (q0 + r < sq)
      x = widen(q[(static_cast<long long>(b * sq + q0 + r) * heads + h) * hd + c]) * scale;
    s_q[r * ldq + c] = x;
  }
  if (tid < kBQ) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  float acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;

  const int nk_all = (sk + kBK - 1) / kBK;
  const int nk = causal ? min((q_offset + q0 + kBQ + kBK - 1) / kBK, nk_all) : nk_all;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk) {
        const long long o = (static_cast<long long>(b * sk + k0 + r) * kv_heads + kvh) * hd + c;
        kx = widen(k[o]);
        vx = widen(v[o]);
      }
      s_k[r * ldq + c] = kx;
      s_v[r * hd + c] = vx;
    }
    __syncthreads();

    // scores of rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < hd; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = s_q[(ty + 16 * i) * ldq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = s_k[(tx + 16 * j) * ldq + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, kc = tx + 16 * j;
        float x = s[i][j];
        if (k0 + kc >= sk)
          x = -INFINITY;
        else if (causal && q_offset + q0 + r < k0 + kc)
          x = kMasked;
        s_s[r * lds + kc] = x;
      }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w + 7
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x0 = s_s[r * lds + lane], x1 = s_s[r * lds + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      s_s[r * lds + lane] = p0;
      s_s[r * lds + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        s_c[r] = c;
        s_l[r] = s_l[r] * c + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * c + p @ v for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = s_c[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncols) acc[i][j] *= c;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * lds + kk];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j >= ncols) continue;
        const float vv = s_v[kk * hd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(s_l[r], 1e-30f);
    T* o = out + (static_cast<long long>(b * sq + q0 + r) * heads + h) * hd;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncols) store(o + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int heads, int kv_heads, int hd, bool causal,
           float scale, cudaStream_t stream) {
  const int smem = 4 * smem_floats(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, b * heads);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, heads, kv_heads,
      hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT int flash_attention_smem_bytes(int hd) { return 4 * smem_floats(hd); }

// q: (b, sq, heads, hd); k, v: (b, sk, kv_heads, hd); out like q; all
// contiguous, float32 (dtype 0) or bfloat16 (dtype 1).  scale = 1/sqrt(hd).
// Returns the cudaError_t of the launch.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* out, int b,
                                        int sq, int sk, int heads,
                                        int kv_heads, int hd, int causal,
                                        float scale, int dtype, void* stream) {
  if (hd % 16 != 0 || hd > kMaxHd || kv_heads <= 0 || heads % kv_heads != 0 ||
      4 * smem_floats(hd) > repro::kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, sq, sk, heads, kv_heads, hd,
                         causal != 0, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, heads, kv_heads, hd,
                                 causal != 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
