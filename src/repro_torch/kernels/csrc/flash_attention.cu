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
// S = 512, H = 8, KV = 1, hd = 256, causal) does 4.3 GFLOP of float32
// products on 37.7 MB of operands and output: 64 us at the float32 peak
// outside the tensor cores (67 TFLOP/s), 11 us at 3.35 TB/s.  Products
// stay float32 FMAs on the CUDA cores: single-pass TF32 keeps about three
// decimal digits and cannot hold the 2e-5 tolerance.
//
// Design.  A thread block of 256 threads owns 64 q rows: `gh` query heads
// that share one kv head times `pos` consecutive positions (gh * pos <=
// 64, chosen by the wrapper: all 8 heads x 8 positions for gemma-2b's
// MQA), so every staged K/V tile feeds every head of the group, and the
// block's causal bound is that of `pos` positions.  K/V stream in 64-row
// tiles through shared memory (float32; q, k row stride hd + 4, so the
// 16-byte reads of a warp fall in distinct banks).  Per tile:
//   1. S = Q K^T: each thread holds a 4 x 4 block of scores (rows
//      rg + 16 i, keys kg + 16 j) and reads q and k as float4 along hd:
//      64 FMAs per 8 16-byte shared reads.
//   2. Online softmax in registers: the 16 threads of a row group sit in
//      one half-warp, so row max and row sum are 4 shuffles each; m and l
//      stay in registers; p goes to shared memory transposed ([key][row])
//      and the rescale c per row beside it.
//   3. O = O * c + P V: each thread holds an 8 x 8 block of the output
//      (hd = 256; 8 x 4 at 128, 4 x 4 at 64) in registers, reading p and
//      v as float4: 64 FMAs per 4 16-byte reads.
// The loads are asynchronous (cp.async, 16 bytes a copy, zero-filled past
// Sk) and alternate with the phases that free their buffers: K of tile
// t + 1 streams in while tile t's P V runs, V of tile t + 1 while tile
// t + 1's Q K^T runs; two __syncthreads a tile.  bf16 operands are widened
// to float32 as they are staged (synchronous loads).  Blocks are issued
// heaviest first (the latest positions, which read the most K/V tiles),
// so the last wave of a causal grid is the light one.
//
// Arithmetic, per score and output element, takes the plain version's
// steps: q pre-scaled by 1/sqrt(hd), the q.k sum (here over hd in order),
// masked scores -1e30 (not -inf) as on the TPU, keys past Sk -inf, K/V
// tiles past the block's causal bound never read, acc rescaled then p.v
// summed over the tile's keys in order, the final divide by
// max(l, 1e-30).  The plain version's products may sum in another order,
// hence the 2e-5 tolerance.  Built without fast math: expf and the divide
// are the full-precision ones.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRows = 64, kBK = 64, kThreads = 256, kMaxHd = 256;
constexpr int kLdP = kRows + 4;   // row stride of the transposed p tile
constexpr float kMasked = -1e30f;

template <int HD>
struct Tile {
  static constexpr int kLd = HD + 4;                   // q, k row stride
  static constexpr int kTC = HD >= 256 ? 8 : 4;        // output cols a thread
  static constexpr int kCG = HD / kTC;                 // column groups
  static constexpr int kTR = kRows * kCG / kThreads;   // output rows a thread
  static constexpr int kNch = kTC / 4;                 // float4 chunks a thread
  static constexpr int kChunkStride = HD / kNch;
  static constexpr int kCpr = HD / 4;                  // 16-byte chunks a row
  static constexpr int kRowsPerPass = kThreads / kCpr;
  static constexpr int kFloats =
      kRows * kLd + kBK * kLd + kBK * HD + kBK * kLdP + 2 * kRows;
  static_assert(kTR * (kThreads / kCG) == kRows, "rows cover the q tile");
  static_assert(kCG * kNch * 4 == HD, "columns cover hd");
};

constexpr int padded_hd(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

constexpr int smem_bytes_for(int hd) {
  return 4 * (padded_hd(hd) == 64    ? Tile<64>::kFloats
              : padded_hd(hd) == 128 ? Tile<128>::kFloats
                                     : Tile<256>::kFloats);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 widen4(uint2 raw) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage 64 rows of hd values into dst (row stride ld): row r comes from
// row_ptr(r), or is zero where that is null.  float32 rows are copied
// asynchronously (the caller commits and waits); bf16 rows are widened
// through registers.  Columns past hd are not written.
template <int HD, typename T, typename RowPtr>
__device__ __forceinline__ void stage(float* dst, int ld, int hd,
                                      const T* any, RowPtr row_ptr) {
  using C = Tile<HD>;
  const int c4 = threadIdx.x % C::kCpr;
  if (4 * c4 >= hd) return;
  for (int r = threadIdx.x / C::kCpr; r < kRows; r += C::kRowsPerPass) {
    const T* src = row_ptr(r);
    float* d = dst + r * ld + 4 * c4;
    if constexpr (sizeof(T) == 4) {
      cp_async16(d, src != nullptr ? src + 4 * c4 : any, src != nullptr);
    } else {
      *reinterpret_cast<float4*>(d) =
          src != nullptr ? widen4(*reinterpret_cast<const uint2*>(src + 4 * c4))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int batch, int sq, int sk, int heads, int kv_heads,
                       int hd, int gh, int pos, bool causal, float scale) {
  using C = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                    // [kRows][kLd], pre-scaled q
  float* s_k = s_q + kRows * C::kLd;    // [kBK][kLd]
  float* s_v = s_k + kBK * C::kLd;      // [kBK][HD]
  float* s_p = s_v + kBK * HD;          // [kBK][kLdP], p transposed
  float* s_c = s_p + kBK * kLdP;        // rescale of this tile per row
  float* s_l = s_c + kRows;             // final denominator per row

  const int tid = threadIdx.x;
  const int group = heads / kv_heads;
  const int nhc = (group + gh - 1) / gh;
  const int npg = (sq + pos - 1) / pos;
  const int inner = batch * kv_heads * nhc;
  const int pg = npg - 1 - static_cast<int>(blockIdx.x) / inner;   // heaviest first
  int rest = static_cast<int>(blockIdx.x) % inner;
  const int hc = rest % nhc;
  rest /= nhc;
  const int kvh = rest % kv_heads;
  const int b = rest / kv_heads;
  const int p0 = pg * pos;
  const int q_offset = sk - sq;

  // q row r of the block: head hc * gh + r / pos of the group, position
  // p0 + r % pos; -1 where the row is padding
  auto row_head = [&](int r) {
    const int hl = r / pos;
    if (hl >= gh || hc * gh + hl >= group || p0 + r - hl * pos >= sq) return -1;
    return kvh * group + hc * gh + hl;
  };
  auto q_row = [&](int r) -> const T* {
    const int h = row_head(r);
    if (h < 0) return nullptr;
    const int p = p0 + r % pos;
    return q + (static_cast<long long>(b * sq + p) * heads + h) * hd;
  };
  auto kv_row = [&](const T* base, int k0) {
    return [=](int r) -> const T* {
      if (k0 + r >= sk) return nullptr;
      return base + (static_cast<long long>(b * sk + k0 + r) * kv_heads + kvh) * hd;
    };
  };

  const int nk_all = (sk + kBK - 1) / kBK;
  const int nk = causal ? min((q_offset + p0 + pos + kBK - 1) / kBK, nk_all) : nk_all;

  stage<HD>(s_q, C::kLd, hd, q, q_row);
  stage<HD>(s_k, C::kLd, hd, k, kv_row(k, 0));
  cp_commit();
  stage<HD>(s_v, HD, hd, v, kv_row(v, 0));
  cp_commit();
  cp_wait<1>();
  {  // scale this thread's own q chunks (bf16 rows: the values it widened)
    const int c4 = tid % C::kCpr;
    if (4 * c4 < hd)
      for (int r = tid / C::kCpr; r < kRows; r += C::kRowsPerPass) {
        float4* p = reinterpret_cast<float4*>(s_q + r * C::kLd + 4 * c4);
        const float4 x = *p;
        *p = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
  }
  __syncthreads();

  // phase 1-2 ownership: rows rg + 16 i, keys kg + 16 j
  const int kg = tid & 15, rg = tid >> 4;
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q_offset + p0 + (rg + 16 * i) % pos;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // phase 3 ownership: rows rw * kTR + i, columns n * kChunkStride + 4 cg + e
  const int cg = tid % C::kCG, rw = tid / C::kCG;
  float acc[C::kTR][C::kTC];
#pragma unroll
  for (int i = 0; i < C::kTR; ++i)
#pragma unroll
    for (int j = 0; j < C::kTC; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    // 1. scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    {
      const float* qb = s_q + rg * C::kLd;
      const float* kb = s_k + kg * C::kLd;
#pragma unroll 4
      for (int c = 0; c < hd; c += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qb + 16 * i * C::kLd + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bb[j] = *reinterpret_cast<const float4*>(kb + 16 * j * C::kLd + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[i][j];
            x = fmaf(a[i].x, bb[j].x, x);
            x = fmaf(a[i].y, bb[j].y, x);
            x = fmaf(a[i].z, bb[j].z, x);
            x = fmaf(a[i].w, bb[j].w, x);
            s[i][j] = x;
          }
      }
    }
    // 2. online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + kg + 16 * j;
        float x = s[i][j];
        if (key >= sk)
          x = -INFINITY;
        else if (causal && qpos[i] < key)
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float c = expf(m[i] - m_new);
      l[i] = l[i] * c + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) s_p[(kg + 16 * j) * kLdP + r] = s[i][j];
      if (kg == 0) s_c[r] = c;
    }
    cp_wait<0>();      // this thread's part of V_t
    __syncthreads();   // p, c and V_t visible; K_t consumed
    if (t + 1 < nk) stage<HD>(s_k, C::kLd, hd, k, kv_row(k, k0 + kBK));
    cp_commit();

    // 3. acc = acc * c + p @ v
    {
      float cr[C::kTR];
#pragma unroll
      for (int i = 0; i < C::kTR; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(s_c + rw * C::kTR + i);
        cr[i] = x.x;
        cr[i + 1] = x.y;
        cr[i + 2] = x.z;
        cr[i + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < C::kTR; ++i)
#pragma unroll
        for (int j = 0; j < C::kTC; ++j) acc[i][j] *= cr[i];
      const float* pb = s_p + rw * C::kTR;
      const float* vb = s_v + 4 * cg;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float pr[C::kTR], vr[C::kTC];
#pragma unroll
        for (int i = 0; i < C::kTR; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(pb + kk * kLdP + i);
          pr[i] = x.x;
          pr[i + 1] = x.y;
          pr[i + 2] = x.z;
          pr[i + 3] = x.w;
        }
#pragma unroll
        for (int n = 0; n < C::kNch; ++n) {
          const float4 x = *reinterpret_cast<const float4*>(vb + kk * HD + n * C::kChunkStride);
          vr[4 * n] = x.x;
          vr[4 * n + 1] = x.y;
          vr[4 * n + 2] = x.z;
          vr[4 * n + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < C::kTR; ++i)
#pragma unroll
          for (int j = 0; j < C::kTC; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
      }
    }
    cp_wait<0>();      // this thread's part of K_{t+1}
    __syncthreads();   // K_{t+1} visible; V_t and p consumed
    if (t + 1 < nk) stage<HD>(s_v, HD, hd, v, kv_row(v, k0 + kBK));
    cp_commit();
  }

  if (kg == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) s_l[rg + 16 * i] = l[i];
  __syncthreads();

#pragma unroll
  for (int i = 0; i < C::kTR; ++i) {
    const int r = rw * C::kTR + i;
    const int h = row_head(r);
    if (h < 0) continue;
    const float lr = fmaxf(s_l[r], 1e-30f);
    T* o = out + (static_cast<long long>(b * sq + p0 + r % pos) * heads + h) * hd;
#pragma unroll
    for (int n = 0; n < C::kNch; ++n) {
      const int col = n * C::kChunkStride + 4 * cg;
      if (col >= hd) continue;
      store4(o + col, acc[i][4 * n] / lr, acc[i][4 * n + 1] / lr,
             acc[i][4 * n + 2] / lr, acc[i][4 * n + 3] / lr);
    }
  }
}

template <int HD, typename T>
cudaError_t prepare(int* smem) {
  *smem = 4 * Tile<HD>::kFloats;
  return cudaFuncSetAttribute(flash_attention_kernel<HD, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int heads, int kv_heads, int hd, int gh, int pos,
           bool causal, float scale, cudaStream_t stream) {
  int smem = 0;
  cudaError_t err = prepare<HD, T>(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = heads / kv_heads;
  const long long blocks = static_cast<long long>((sq + pos - 1) / pos) * b *
                           kv_heads * ((group + gh - 1) / gh);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<HD, T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), b, sq, sk, heads,
      kv_heads, hd, gh, pos, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int sq, int sk, int heads, int kv_heads, int hd, int gh, int pos,
             bool causal, float scale, cudaStream_t s) {
  switch (padded_hd(hd)) {
    case 64:
      return launch<64, T>(q, k, v, out, b, sq, sk, heads, kv_heads, hd, gh, pos, causal, scale, s);
    case 128:
      return launch<128, T>(q, k, v, out, b, sq, sk, heads, kv_heads, hd, gh, pos, causal, scale, s);
    default:
      return launch<256, T>(q, k, v, out, b, sq, sk, heads, kv_heads, hd, gh, pos, causal, scale, s);
  }
}

template <int HD, typename T>
int occupancy(int* blocks) {
  int smem = 0;
  cudaError_t err = prepare<HD, T>(&smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_attention_kernel<HD, T>, kThreads, smem));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

REPRO_EXPORT int flash_attention_smem_bytes(int hd) { return smem_bytes_for(hd); }

// Thread blocks one SM holds at head dim hd (dtype 0 float32, 1 bfloat16),
// as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it, into *blocks.
REPRO_EXPORT int flash_attention_blocks_per_sm(int hd, int dtype, int* blocks) {
  *blocks = 0;
  if (hd <= 0 || hd > kMaxHd || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int p = padded_hd(hd);
  if (dtype == 0)
    return p == 64 ? occupancy<64, float>(blocks)
         : p == 128 ? occupancy<128, float>(blocks) : occupancy<256, float>(blocks);
  return p == 64 ? occupancy<64, __nv_bfloat16>(blocks)
       : p == 128 ? occupancy<128, __nv_bfloat16>(blocks)
                  : occupancy<256, __nv_bfloat16>(blocks);
}

// q: (b, sq, heads, hd); k, v: (b, sk, kv_heads, hd); out like q; all
// contiguous and 16-byte aligned, float32 (dtype 0) or bfloat16 (dtype 1).
// A thread block takes gh query heads of one kv group times pos positions
// (gh * pos <= 64).  scale = 1/sqrt(hd).  Returns the cudaError_t of the
// launch.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* out, int b,
                                        int sq, int sk, int heads,
                                        int kv_heads, int hd, int gh, int pos,
                                        int causal, float scale, int dtype,
                                        void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hd <= 0 || hd % 16 != 0 || hd > kMaxHd ||
      kv_heads <= 0 || heads % kv_heads != 0 || gh <= 0 || pos <= 0 ||
      gh * pos > kRows || gh > heads / kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, sq, sk, heads, kv_heads, hd, gh, pos,
                           causal != 0, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, sk, heads, kv_heads, hd,
                                   gh, pos, causal != 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
