// bf16 tensor-core building blocks of the whole-row softmax attention
// kernels: kernel 1 (short_attention.cu, K_h and V_h resident) and kernel 2
// (short_attention_qtiled.cu, K and V streamed) both run their two-pass path
// from these, so where both take a shape their outputs are equal bit for bit.
// A chunk is 8*NT keys of one warp's 16 query rows; the logits stay f32 in
// the mma.sync accumulator layout (rows g and g + 8 of the tile, columns 2t
// and 2t + 1 of each 8-key step).

#pragma once

#include "common.cuh"

namespace dmt {
namespace attn_tc {

constexpr int kChunkKeys2Pass = 64;  // keys per chunk of the two-pass path (NT = 8)

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Raw (unscaled) f32 logits of this warp's 16 query rows against the keys
// of chunk c (8*NT keys), key steps at or past n_ks left at -inf; then the
// mask (keys past S, and for causal calls keys past the row) where the
// chunk reaches mask_from.
template <int HD, int NT>
__device__ __forceinline__ void chunk_scores(float (&sc)[NT][4], const uint32_t (&qf)[HD / 16][4],
                                             uint32_t k_s, int c, int n_ks, int r0, int S,
                                             int causal, int mask_from, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    const int ks = c * (NT / 2) + jp;  // 16-key step
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[2 * jp][e] = sc[2 * jp + 1][e] = 0.f;
    if (ks < n_ks) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        // keys ks*16 + [0, 8) and [8, 16), head dims kd*16 + [0, 8) and [8, 16)
        uint32_t kb[4];
        ldsm_x4(kb, k_s + swz<HD>(ks * 16 + (lane & 7) + (lane >> 4) * 8,
                                   2 * kd + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * jp], qf[kd], kb[0], kb[1]);
        mma_bf16(sc[2 * jp + 1], qf[kd], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * jp + h;
      const int key0 = ks * 16 + h * 8;
      if (ks >= n_ks) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = -INFINITY;
      } else if (key0 + 8 > mask_from) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 2 * t + (e & 1);
          const int row = r0 + g + (e >> 1) * 8;
          if (key >= S || (causal && key > row)) sc[j][e] = -INFINITY;
        }
      }
    }
  }
}

// Raw logits -> e = exp(logit * scale - row max * scale), as exp2 of the f32
// logits times scale * log2 e (ms0, ms1: the rows' max times the same).
template <int NT>
__device__ __forceinline__ void to_exp(float (&sc)[NT][4], float ms0, float ms1,
                                       float scale_log2) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sc[j][0] = exp2f(fmaf(sc[j][0], scale_log2, -ms0));
    sc[j][1] = exp2f(fmaf(sc[j][1], scale_log2, -ms0));
    sc[j][2] = exp2f(fmaf(sc[j][2], scale_log2, -ms1));
    sc[j][3] = exp2f(fmaf(sc[j][3], scale_log2, -ms1));
  }
}

}  // namespace attn_tc
}  // namespace dmt
