// Device helpers shared by the attention kernels (short_attention.cu,
// short_attention_qtiled.cu, flash_attention.cu) and bottleneck.cu.
// ops/cuda_build.py hashes every .cuh here into each library's name, so an
// edit here rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dmt {

constexpr int kWarps = 8;                // warps per attention block
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

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

// ------------------------------------------- bf16 tensor-core building blocks
// (kernels 1 and 3 in short_attention.cu, kernels 5 and 6 in flash_attention.cu)

// Byte offset of 16-byte chunk c of row r in a swizzled [rows, HD] bf16 tile:
// the chunk index is XORed with the row, so the 8 rows one ldmatrix matrix
// reads at one logical chunk fall in 8 different 16-byte bank groups.
template <int HD> __device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int C = HD / 8;  // 16-byte chunks per row
  const int x = C >= 8 ? (r & 7) : ((r >> 1) & 3);  // hd 32: two rows per 128 bytes
  return (uint32_t)(r * (C * 16) + ((c ^ x) * 16));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, rows) of a [*, HD] bf16 slice whose rows are ld elements apart,
// into a swizzled tile; rows at or past n_valid are zero-filled.  Threads
// tid, tid + n_threads, ... each copy one 16-byte chunk.
template <int HD>
__device__ __forceinline__ void stage_rows(uint32_t dst, const __nv_bfloat16* src, int rows,
                                           int n_valid, int ld, int tid, int n_threads) {
  constexpr int C = HD / 8;
  for (int i = tid; i < rows * C; i += n_threads) {
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid;
    cp_async16(dst + swz<HD>(r, c), src + (size_t)(ok ? r : 0) * ld + c * 8, ok ? 16 : 0);
  }
}

}  // namespace dmt
