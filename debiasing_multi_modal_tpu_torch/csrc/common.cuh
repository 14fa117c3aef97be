// Device helpers shared by the attention kernels (short_attention.cu,
// short_attention_qtiled.cu, flash_attention.cu), bottleneck.cu and
// quant_gemm.cu.
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
// 4-byte async copy (lse, delta rows are 4-byte aligned only); src_bytes 0
// zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// ------------------------------------ wgmma, TMA and mbarrier building blocks
// (kernel 7 in quant_gemm.cu; sm_90a only)

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows that TMA
// wrote in its 128-byte swizzle (tile 1024-byte aligned): start address >> 4,
// leading offset 1 (unused when swizzled), stride 64 (1024 bytes from one
// 8-row group to the next), layout 1 (128-byte swizzle).  Adding b >> 4 steps
// b bytes along K inside the row; the hardware swizzles the final address.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Orders this thread's register and shared-memory accesses before the wgmmas after it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Closes the wgmmas issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmmas that write it.
__device__ __forceinline__ void fence_operand(int& x) { asm volatile("" : "+r"(x) :: "memory"); }

// An mbarrier that completes a phase after `count` arrivals (one thread).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// Makes the initialized barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// One arrival that also expects `bytes` of asynchronous (TMA) writes before
// the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Whether the phase of parity `parity` has completed (a fresh barrier is in
// phase 0, so parity 1 has).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Waits for that phase.  A wrong parity would wait forever: after 2^32
// cycles (~2 s) the kernel traps instead, which the launch reports as an
// error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}
// TMA: the box at (c0 innermost, c1) of a 2-D tensor map into shared memory
// at dst, completing `bar`'s expected bytes (out-of-bounds elements read as
// zeros and still count).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) over `n` threads, a multiple of 32.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

}  // namespace dmt
