// Shared device arithmetic of the integer conv kernels.
//
// requant_u8 and shift_align are the CUDA twins of
// repro_torch/kernels/common.py:requant_u8 and core/quant.py:shift_align,
// which hold the JAX package's rounding: (acc + half) >> s, i.e.
// floor(x + 0.5) with ties toward +infinity and an arithmetic shift on
// negative values.  Left shifts and the rounding add go through unsigned
// arithmetic: shifting a negative int32 left (or overflowing the add) is
// undefined in C++17, while the reference wraps modulo 2^32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// Largest dynamic shared memory one block may use on Hopper (227 KB).
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ int shift_align(int acc, int shift) {
  if (shift >= 0) return static_cast<int>(static_cast<unsigned>(acc) << shift);
  const unsigned half = 1u << (-shift - 1);
  return static_cast<int>(static_cast<unsigned>(acc) + half) >> (-shift);
}

// ReLU, then the pow2 shift (positive = rounding right shift, negative =
// left shift), then clip to [0, 255].
__device__ __forceinline__ unsigned requant_u8(int acc, int shift) {
  acc = max(acc, 0);
  if (shift > 0) {
    acc = static_cast<int>(static_cast<unsigned>(acc) + (1u << (shift - 1))) >> shift;
  } else if (shift < 0) {
    acc = static_cast<int>(static_cast<unsigned>(acc) << (-shift));
  }
  return static_cast<unsigned>(min(max(acc, 0), 255));
}

// c + sum_k a.u8[k] * b.s8[k]: four unsigned activation bytes times four
// signed weight bytes, accumulated in int32.
__device__ __forceinline__ int dp4a_us(unsigned a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The SM this thread runs on (%smid).  The block kernels record it per
// thread block when asked, so that a launch can report the SMs it used.
__device__ __forceinline__ int sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return static_cast<int>(id);
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
