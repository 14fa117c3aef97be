// Device helpers shared by the attention kernels (short_attention.cu,
// short_attention_qtiled.cu).  ops/cuda_build.py hashes every .cuh here into
// each library's name, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dmt {

constexpr int kWarps = 8;                // warps per attention block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride of a staged K/V tile, in elements: hd plus one 32-bit word, so a
// warp whose lanes read 32 different rows at one column hits 32 banks.
template <typename T> __host__ __device__ constexpr int padded_ld(int hd) {
  return hd + (sizeof(T) == 2 ? 2 : 1);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace dmt
