// Register-tiled f32 attention on the CUDA cores: the device code of f32
// kernels 1 and 3 (short_attention.cu, the head's K_h and V_h resident in
// shared memory) and of f32 kernel 2 (short_attention_qtiled.cu, K and V
// streamed through key tiles).
//
// The function is kernel 1's: q, k, v, o are [B, S, D] merged-head rows
// (row stride ld_in for the inputs, ld_out for o), logits (q_h . k_h) * scale
// in f32, an optional causal mask, an exact whole-row softmax w = e / sum(e),
// then P.V with f32 accumulation.
//
// What bounds it on the H100: a block of MQ query rows does 2*MQ*S*hd FMAs
// against S*hd*8 bytes of K and V, so the card's limit is the FMA pipe (67
// TFLOP/s in f32).  What bounds this design is the shared-memory pipe that
// feeds it: a warp-wide 16-byte load costs two 128-byte wavefronts even when
// its lanes read only 8 distinct chunks (measured on the H100), so a thread
// tile of r x c needs (r + c) / (r * c) floats per FMA, and the pipe's 256
// bytes of lane data per clock against 128 FMAs per clock break even at
// 4 x 4.  So a 16 x 16 grid of threads covers the block's tile, and each
// thread keeps in registers:
//   - scores: an RM x NJ tile of logits (RM = MQ/16 rows, NJ <= 8 keys of a
//     128-key tile): per 4 head dims RM + NJ 16-byte loads for 4*RM*NJ FMAs;
//   - P.V: an RM x hd/16 tile of outputs: per 8 keys 2*RM loads of p and 8
//     (hd 128: 16) of v.
// K and V tiles and the q rows are staged with 16-byte cp.async into rows of
// hd floats whose 16-byte chunks are XORed with the row (chunk c of row r at
// c ^ (r & 7)): the 8 rows a quarter warp reads at one chunk, and the 2 rows
// a half warp reads, fall in distinct bank groups, with no padding to break
// the 16-byte alignment.  Key rows past S are zero-filled, never padded in
// device memory.
//
// Three summation orders are fixed, so the outputs are bit-equal across the
// resident and streamed forms and any tile shape (kernel 2 equals kernel 1,
// kernel 3 equals kernel 1):
//   - each logit is one in-order fmaf chain over the head dims, then * scale;
//   - the softmax: the row max, e = expf(s - max), lane l of the row's warp
//     adding keys l, l + 32, ... in order, warp_sum, and w = e / sum
//     correctly rounded (div_rn);
//   - each output is one in-order fmaf chain over keys 0, 1, ....  Keys
//     masked out of a row carry p = 0 exactly and V rows past S are zeros, so
//     the extra terms of a 4- or 8-key step add +0.
//
// Shared memory, mirrored by ops/short_attention.py (smem_bytes,
// qtiled_smem_bytes): MQ query rows [MQ][hd], the f32 score rows
// [MQ][score_ld(S)], then K_h and V_h [max(round4(S), 64)][hd] each
// (resident), or `bufs` key tiles [keys][hd] (streamed).

#pragma once

#include "common.cuh"

namespace dmt {
namespace f32attn {

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use

__host__ __device__ constexpr int round4(int s) { return (s + 3) / 4 * 4; }

// Row stride of the f32 score rows: S rounded up to 4, plus 4 where that is a
// multiple of 32, so the two rows a half warp reads at one column sit in
// different bank groups.
__host__ __device__ constexpr int score_ld(int S) {
  return round4(S) % 32 ? round4(S) : round4(S) + 4;
}

// Rows of the resident K_h (and of V_h): at least 64, so that the 128 rows a
// score tile reads stay inside K_h and V_h.
__host__ __device__ constexpr int resident_kv_rows(int S) {
  return round4(S) > 64 ? round4(S) : 64;
}

inline size_t resident_smem_bytes(int S, int hd, int rows) {
  return ((size_t)rows * hd + (size_t)rows * score_ld(S) +
          2 * (size_t)resident_kv_rows(S) * hd) * sizeof(float);
}

inline size_t streamed_smem_bytes(int S, int hd, int rows, int bufs, int keys) {
  return ((size_t)rows * hd + (size_t)rows * score_ld(S) + (size_t)bufs * keys * hd) *
         sizeof(float);
}

// Query rows per resident (kernel 1) block: 32 for short rows (S = 77 gives
// three tiles, not two with 51 idle rows), 64 past 128 keys where they fit.
inline int resident_rows(int S, int hd) {
  return S > 128 && resident_smem_bytes(S, hd, 64) <= kSmemLimit ? 64 : 32;
}

// The streamed (kernel 2) block: 64 query rows with two 128-key K/V buffers
// where they fit (S <= 748 / 588 / 268 at hd 32 / 64 / 128); else 32 rows
// with two 64-key buffers; else 32 rows with one, the smallest block (S <=
// 1,720 / 1,624 / 1,432).
inline void streamed_tile(int S, int hd, int& rows, int& bufs, int& keys) {
  if (streamed_smem_bytes(S, hd, 64, 2, 128) <= kSmemLimit) {
    rows = 64, bufs = 2, keys = 128;
  } else if (streamed_smem_bytes(S, hd, 32, 2, 64) <= kSmemLimit) {
    rows = 32, bufs = 2, keys = 64;
  } else {
    rows = 32, bufs = 1, keys = 64;
  }
}

// Rows [0, n_rows) of a [*, HD] f32 slice whose rows are ld floats apart into
// a swizzled [n_rows, HD] tile, rows at or past n_valid zero-filled.  Every
// thread of the block takes part.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int n_rows, int n_valid,
                                      int ld) {
  constexpr int C = HD / 4;  // 16-byte chunks per row
  const uint32_t d0 = smem_u32(dst);
  for (int i = threadIdx.x; i < n_rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid;
    const int pc = c ^ (r & 7);
    cp_async16(d0 + (uint32_t)(r * HD + pc * 4) * 4, src + (size_t)(ok ? r : 0) * ld + c * 4,
               ok ? 16 : 0);
  }
}

// Logits of the block's query rows ty + 16*i against keys j0 + tx + 16*jj of
// a swizzled K tile whose row `row0` (a multiple of 64) holds key j0; rows
// past the keys staged are read too (the caller keeps them inside shared
// memory), and their logits are never stored.  Stored scaled, for keys below
// S that the mask keeps.  A thread's rows all sit at x = tx & 7 in the
// swizzle, so chunk 8*a + b of its rows lies at 8*a + (b ^ x): eight
// offsets per thread, and every load is one of them plus a constant.
template <int HD, int RM, int NJ>
__device__ __forceinline__ void score_tile(const float* __restrict__ qs,
                                           const float* __restrict__ kt, int row0,
                                           float* __restrict__ sc, int ldS, int j0, int S,
                                           int q0, int causal, float scale, int tx, int ty) {
  const float* kp = kt + (row0 + tx) * HD;
  const float* qp = qs + ty * HD;
  const int x = tx & 7, y = ty & 7;  // rows ty + 16*i all sit at y
  float acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
#pragma unroll
  for (int a = 0; a < HD / 32; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float* kc = kp + 32 * a + ((b ^ x) << 2);
      float4 qv[RM], kv[NJ];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qp + 16 * i * HD + 32 * a + ((b ^ y) << 2));
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(kc + 16 * jj * HD);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          acc[i][jj] = fmaf(qv[i].x, kv[jj].x, acc[i][jj]);
          acc[i][jj] = fmaf(qv[i].y, kv[jj].y, acc[i][jj]);
          acc[i][jj] = fmaf(qv[i].z, kv[jj].z, acc[i][jj]);
          acc[i][jj] = fmaf(qv[i].w, kv[jj].w, acc[i][jj]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if (j < S && (!causal || j <= q0 + r)) sc[r * ldS + j] = acc[i][jj] * scale;
    }
  }
}

// score_tile over the 16-key groups of a tile that hold keys below key_end
// (a short causal tile or the ragged last tile computes no whole group of
// masked keys): nj groups, NJ at most.
template <int HD, int RM, int NJ>
__device__ __forceinline__ void scores(int nj, const float* qs, const float* kt, int row0,
                                       float* sc, int ldS, int j0, int S, int q0, int causal,
                                       float scale, int tx, int ty) {
  if constexpr (NJ > 1) {
    if (nj < NJ) {
      scores<HD, RM, NJ - 1>(nj, qs, kt, row0, sc, ldS, j0, S, q0, causal, scale, tx, ty);
      return;
    }
  }
  score_tile<HD, RM, NJ>(qs, kt, row0, sc, ldS, j0, S, q0, causal, scale, tx, ty);
}

// a / b rounded to nearest, from y = RN(1 / b) computed once per row: q =
// RN(a*y) lies within one ulp of a / b, and then RN(q + RN(a - b*q)*y) is
// a / b correctly rounded (Markstein's theorem), the IEEE division's result,
// whenever the quotient is a normal float (a >= 2^-100 here, b >= 1).
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

// x / b for four values: div_rn, or the division itself where any lane of
// the warp holds a smaller value (e = expf(s - max) for a logit ~70 below
// its row's max; a warp-uniform branch, almost never taken).
__device__ __forceinline__ float4 div4(float4 x, float b, float y) {
  const float lo = fminf(fminf(x.x, x.y), fminf(x.z, x.w));
  if (__any_sync(0xffffffffu, lo < 0x1p-100f))
    return make_float4(x.x / b, x.y / b, x.z / b, x.w / b);
  return make_float4(div_rn(x.x, b, y), div_rn(x.y, b, y), div_rn(x.z, b, y), div_rn(x.w, b, y));
}

// The exact whole-row softmax of the block's rows, in place: w = e / sum for
// each row's keys, and 0 for its masked keys below kend4 (the 4- and 8-key
// steps of P.V read them).  Warp w takes rows w + 8*k, and each row's
// arithmetic is the one-lane-per-key code's: the row max, e = expf(s - max),
// lane l adding keys l, l + 32, ... in order, warp_sum, then e / sum (as
// div_rn).  Only the sum needs that lane order; the max, the exponentials
// and the divisions go four keys to a lane (16-byte loads and stores).  Each
// pass takes kGroup rows side by side, every load of the group before any
// store: the compiler cannot tell the rows apart, so a load written after
// another row's store would wait for it, and one row at a time leaves the
// pass waiting on each shared load.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

constexpr int kGroup = 4;  // rows a softmax pass takes side by side

template <int MQ>
__device__ __forceinline__ void softmax_rows(float* sc, int ldS, int q0, int S, int causal,
                                             int kend4, int warp, int lane) {
  constexpr int RW = MQ / kWarps;  // rows per warp: warp + 8*k
  constexpr int G = kGroup;
  static_assert(RW % G == 0, "whole groups");
  float m[RW], sum[RW];
  int n[RW];
  float* row[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    const int r = warp + kWarps * k;
    n[k] = q0 + r < S ? (causal ? q0 + r + 1 : S) : 0;  // rows past S: none
    row[k] = sc + r * ldS;
    m[k] = -INFINITY;
    sum[k] = 0.f;
  }
#pragma unroll
  for (int k0 = 0; k0 < RW; k0 += G) {
    int nn = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) nn = max(nn, n[k0 + g]);
    for (int j = 4 * lane; j < nn; j += 128) {
      float4 x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) x[g] = ld4(row[k0 + g] + j);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = k0 + g;
        if (j < n[k]) m[k] = fmaxf(m[k], x[g].x);
        if (j + 1 < n[k]) m[k] = fmaxf(m[k], x[g].y);
        if (j + 2 < n[k]) m[k] = fmaxf(m[k], x[g].z);
        if (j + 3 < n[k]) m[k] = fmaxf(m[k], x[g].w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) m[k] = warp_max(m[k]);
  // e for the rows' keys (and for up to three masked keys of a row's last
  // four, which the division pass overwrites with 0)
#pragma unroll
  for (int k0 = 0; k0 < RW; k0 += G) {
    int nn = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) nn = max(nn, n[k0 + g]);
    for (int j = 4 * lane; j < nn; j += 128) {
      float4 x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) x[g] = ld4(row[k0 + g] + j);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mk = m[k0 + g];
        x[g] = make_float4(expf(x[g].x - mk), expf(x[g].y - mk), expf(x[g].z - mk),
                           expf(x[g].w - mk));
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (j < n[k0 + g]) st4(row[k0 + g] + j, x[g]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int k0 = 0; k0 < RW; k0 += G) {
    int nn = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) nn = max(nn, n[k0 + g]);
#pragma unroll 4
    for (int j = lane; j < nn; j += 32) {
      float x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) x[g] = row[k0 + g][j];
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (j < n[k0 + g]) sum[k0 + g] += x[g];
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) sum[k] = warp_sum(sum[k]);
  __syncwarp();
#pragma unroll
  for (int k0 = 0; k0 < RW; k0 += G) {
    float y[G];
#pragma unroll
    for (int g = 0; g < G; ++g) y[g] = __frcp_rn(sum[k0 + g]);
    for (int j0 = 0; j0 < kend4; j0 += 128) {  // warp-uniform, for div4's vote
      const int j = j0 + 4 * lane;
      float4 x[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int nk = n[k0 + g];
        x[g] = j < nk ? ld4(row[k0 + g] + j) : make_float4(1.f, 1.f, 1.f, 1.f);
        if (j + 1 >= nk) x[g].y = 1.f;  // masked keys: 1, which div4 takes fast
        if (j + 2 >= nk) x[g].z = 1.f;
        if (j + 3 >= nk) x[g].w = 1.f;
        x[g] = div4(x[g], sum[k0 + g], y[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int nk = n[k0 + g];
        if (j < kend4 && nk > 0)
          st4(row[k0 + g] + j, make_float4(j < nk ? x[g].x : 0.f, j + 1 < nk ? x[g].y : 0.f,
                                           j + 2 < nk ? x[g].z : 0.f, j + 3 < nk ? x[g].w : 0.f));
      }
    }
  }
}

// acc += P[:, j0 : j0 + n4] . V over keys j0 + [0, n4) (n4 a multiple of 4)
// of a swizzled V tile whose row `row0` (a multiple of 64) holds key j0,
// each output's chain in key order.  Thread (tx, ty) owns rows ty + 16*i and
// head dims 4*(tx + 16*g) + [0, 4) (hd 32: 2*tx + [0, 2)).  Keys go 16, 8
// or 4 at a time from a multiple of 8, so key u of a step sits at swizzle
// x = u & 7: eight offsets per thread.
template <int HD, int RM, int U>
__device__ __forceinline__ void pv_keys(float (&acc)[RM][HD / 16], const float* __restrict__ pp,
                                        const float* __restrict__ vr, int ldS,
                                        const int (&voff)[8]) {
  float4 p4[RM][U / 4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int h = 0; h < U / 4; ++h)
      p4[i][h] = *reinterpret_cast<const float4*>(pp + 16 * i * ldS + 4 * h);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float* vu = vr + voff[u & 7] + (u & 8) * HD;
    float p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 w = p4[i][u / 4];
      p[i] = u % 4 == 0 ? w.x : u % 4 == 1 ? w.y : u % 4 == 2 ? w.z : w.w;
    }
    if constexpr (HD >= 64) {
#pragma unroll
      for (int g = 0; g < HD / 64; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vu + 64 * g);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    } else {
      const float2 vv = *reinterpret_cast<const float2*>(vu);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(p[i], vv.x, acc[i][0]);
        acc[i][1] = fmaf(p[i], vv.y, acc[i][1]);
      }
    }
  }
}

template <int HD, int RM>
__device__ __forceinline__ void pv_tile(float (&acc)[RM][HD / 16], const float* __restrict__ sc,
                                        int ldS, int j0, const float* __restrict__ vt, int row0,
                                        int n4, int tx, int ty) {
  int voff[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    voff[u] = u * HD + (HD >= 64 ? ((tx ^ u) << 2) : (((tx >> 1) ^ u) << 2) + (tx & 1) * 2);
  const float* pp = sc + ty * ldS + j0;
  const float* vr = vt + row0 * HD;
  int j = 0;
  for (; j + 16 <= n4; j += 16) pv_keys<HD, RM, 16>(acc, pp + j, vr + j * HD, ldS, voff);
  for (; j + 8 <= n4; j += 8) pv_keys<HD, RM, 8>(acc, pp + j, vr + j * HD, ldS, voff);
  if (j < n4) pv_keys<HD, RM, 4>(acc, pp + j, vr + j * HD, ldS, voff);
}

// One block per (tile of MQ query rows, head, image), 256 threads.
// Bufs = 0: K_h and V_h resident (kernels 1 and 3), all copies issued
// before any compute and V's waited for only after the softmax; the scores
// go 128 keys at a time.  Bufs = 1 or 2: K, then V, streamed through that
// many KT-key tiles (kernel 2); with two, the next tile (V's first during
// the softmax) loads while this one is consumed.  A causal tile reads only
// the keys its last row sees.
template <int HD, int MQ, int Bufs, int KT>
__global__ void __launch_bounds__(kThreads, MQ == 32 ? 2 : 1)
f32_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S, int ld_in,
                int ld_out, int causal, float scale) {
  static_assert(MQ == 32 || MQ == 64, "16 x 16 threads over 32 or 64 rows");
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dims");
  static_assert(KT == 64 || KT == 128, "key tiles");
  constexpr int RM = MQ / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldS = score_ld(S);
  float* qs = reinterpret_cast<float*>(smem_raw);  // [MQ][HD]
  float* sc = qs + MQ * HD;                         // [MQ][ldS]
  float* kv = sc + MQ * ldS;                        // K_h, V_h or the key tiles

  const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a half warp covers 8 key (or dim) columns x 2 rows: its q and p loads
  // are 2 addresses in 2 bank groups, its k and v loads 8 chunks in 8
  const int tx = (lane & 7) + 8 * (warp & 1), ty = (lane >> 3) + 4 * (warp >> 1);
  const size_t in_base = (size_t)b * S * ld_in + (size_t)h * HD;
  const float* kb = k + in_base;
  const float* vb = v + in_base;
  const int key_end = causal ? min(S, q0 + MQ) : S;  // keys any row here sees
  const int kend4 = round4(key_end);
  const int nt = (key_end + KT - 1) / KT;

  float acc[RM][HD / 16];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) acc[i][t] = 0.f;

  stage<HD>(qs, q + in_base + (size_t)q0 * ld_in, MQ, S - q0, ld_in);
  if constexpr (Bufs == 0) {
    float* ks = kv;
    float* vs = kv + (size_t)resident_kv_rows(S) * HD;
    stage<HD>(ks, kb, kend4, S, ld_in);
    cp_async_commit();
    stage<HD>(vs, vb, kend4, S, ld_in);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    for (int t = 0; t < nt; ++t)
      scores<HD, RM, KT / 16>((key_end - t * KT + 15) / 16, qs, ks, t * KT, sc, ldS, t * KT, S,
                              q0, causal, scale, tx, ty);
    __syncthreads();
    softmax_rows<MQ>(sc, ldS, q0, S, causal, kend4, warp, lane);
    cp_async_wait<0>();
    __syncthreads();
    pv_tile<HD, RM>(acc, sc, ldS, 0, vs, 0, kend4, tx, ty);
  } else {
    // tile i of 2*nt: K tile i, then V tile i - nt, into buffer i % Bufs;
    // one commit group per tile (empty past the last)
    auto load = [&](int i) {
      if (i < 2 * nt) {
        const int t = i < nt ? i : i - nt;
        stage<HD>(kv + (i % Bufs) * KT * HD, (i < nt ? kb : vb) + (size_t)t * KT * ld_in,
                  min(KT, kend4 - t * KT), S - t * KT, ld_in);
      }
      cp_async_commit();
    };
    load(0);  // with the q rows
    for (int i = 0; i < 2 * nt; ++i) {
      if constexpr (Bufs == 2) {
        load(i + 1);  // into the buffer freed at the end of the last step
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* buf = kv + (i % Bufs) * KT * HD;
      if (i < nt) {
        scores<HD, RM, KT / 16>((key_end - i * KT + 15) / 16, qs, buf, 0, sc, ldS, i * KT, S,
                                q0, causal, scale, tx, ty);
      } else {
        const int t = i - nt;
        pv_tile<HD, RM>(acc, sc, ldS, t * KT, buf, 0, min(KT, kend4 - t * KT), tx, ty);
      }
      if (i == nt - 1) {
        __syncthreads();
        softmax_rows<MQ>(sc, ldS, q0, S, causal, kend4, warp, lane);
      }
      __syncthreads();  // this buffer is consumed (and every row's p is final)
      if (Bufs == 1) load(i + 1);
    }
  }

  float* ob = o + (size_t)b * S * ld_out + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    float* orow = ob + (size_t)r * ld_out;
    if constexpr (HD >= 64) {
#pragma unroll
      for (int g = 0; g < HD / 64; ++g)
        *reinterpret_cast<float4*>(orow + 4 * (tx + 16 * g)) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    } else {
      *reinterpret_cast<float2*>(orow + 2 * tx) = make_float2(acc[i][0], acc[i][1]);
    }
  }
}

// Launch on `stream`: grid (query tiles, H, B), dynamic shared memory set
// first; returns cudaGetLastError().
template <int HD, int MQ, int Bufs, int KT>
int launch(const float* q, const float* k, const float* v, float* o, int B, int S, int H,
           int ld_in, int ld_out, int causal, cudaStream_t stream) {
  const size_t smem = Bufs == 0 ? resident_smem_bytes(S, HD, MQ)
                                : streamed_smem_bytes(S, HD, MQ, Bufs, KT);
  auto kernel = f32_attn_kernel<HD, MQ, Bufs, KT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + MQ - 1) / MQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, S, ld_in, ld_out, causal,
                                           1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// Kernels 1 and 3 (resident), if the block fits; else an invalid-value error.
template <int HD>
int launch_resident(const float* q, const float* k, const float* v, float* o, int B, int S,
                    int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
  const int rows = resident_rows(S, HD);
  if (resident_smem_bytes(S, HD, rows) > kSmemLimit) return (int)cudaErrorInvalidValue;
  return rows == 64
             ? launch<HD, 64, 0, 128>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream)
             : launch<HD, 32, 0, 128>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
}

// Kernel 2 (streamed), if the block fits; else an invalid-value error.
template <int HD>
int launch_streamed(const float* q, const float* k, const float* v, float* o, int B, int S,
                    int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
  int rows, bufs, keys;
  streamed_tile(S, HD, rows, bufs, keys);
  if (streamed_smem_bytes(S, HD, rows, bufs, keys) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (rows == 64) return launch<HD, 64, 2, 128>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  if (bufs == 2) return launch<HD, 32, 2, 64>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  return launch<HD, 32, 1, 64>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
}

}  // namespace f32attn
}  // namespace dmt
