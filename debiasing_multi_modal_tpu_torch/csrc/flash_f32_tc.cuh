// Flash attention forward and backward in f32 on the Hopper tensor cores
// (sm_90a), as split-TF32: kernels 4, 5 and 6 of flash_attention.cu for float
// inputs.
//
// Replaces the TPU kernels of debiasing_multi_modal_tpu/ops/flash_attention.py:
//   kernel 4  flash_fwd_f32tc_kernel  <- _attn_fwd_kernel (out, row logsumexp)
//   kernel 5  flash_dq_f32tc_kernel   <- _bwd_dq_kernel   (dQ)
//   kernel 6  flash_dkv_f32tc_kernel  <- _bwd_dkv_kernel  (dK and dV)
// with the same function as the bf16 kernels beside them in
// flash_attention.cu: s = scale * (q.k^T) accumulated in f32; forward: an
// online softmax over 64-key tiles, out = sum p.v / l, lse = m + log(l);
// backward: p = exp(s - lse) (0 at masked keys: past Skv and, when causal,
// top-left kv_pos > q_pos), dp = dO.v^T, ds = p * (dp - delta) * scale,
// dq = sum ds.k, dk = sum ds^T.q, dv = sum p^T.dO, every sum in f32.  In f32
// the roundings of p and ds to the operand dtype are the identity.
//
// Why split-TF32.  The tensor cores multiply f32 data only as TF32 (10
// mantissa bits).  One TF32 product per product leaves out, dq, dk and dv
// ~1e-4 to 1e-3 of scale off (tests/test_torch_flash_attention.py emulates it), over the
// f32 limit of 1e-4.  So each operand is split, x = hi + lo, hi being x and
// lo the exact remainder x - hi, each rounded to TF32 as cvt.rna.tf32.f32
// rounds (to nearest, ties away from zero), and each product is three
// mma.sync.m16n8k8 TF32 products into f32 accumulators, lo.hi + hi.lo +
// hi.hi.  The dropped lo.lo term and lo's rounding are ~2^-22 relative, the
// order of f32's own rounding (CUTLASS's OpMultiplyAddFastF32 takes the same
// three products); emulated, ~1e-6 of scale.  The split is made on each
// fragment load, four ALU operations per element (common.cuh: split), not once
// per staged tile: staged hi and lo tiles would double shared memory, and
// kernel 6's six f32 tiles already take 192 KB of the 227 KB at hd 128.
// Operands a warp holds for its whole loop (kernel 5's Q and dO rows, kernel
// 6's K and V rows, at hd <= 64) are split once and kept as hi/lo fragments
// in registers; kernel 4 re-reads its Q rows (below: occupancy).
//
// What bounds them on the H100.  At the training shapes (S = 50/77, hd 64)
// each kernel moves its inputs and outputs once, 4-6 [B, S, H, hd] f32
// tensors, against 4-8 flops per (query, key) pair and head dim: bytes bound
// them (3.35 TB/s).  From S ~ 1k on the three TF32 products of every product
// bound them: 3 * (4, 6 or 8) * pairs * hd flops at 495 TFLOP/s, 2.4x faster
// than the same work on the CUDA cores at 67 TFLOP/s.  Against the bytes the
// design reads every input once per tile pass through 16-byte cp.async,
// double-buffered so the next streamed tile's copies overlap this tile's
// products, and keeps every [Sq, Skv] tensor in registers; against the
// operations it skips 8-key (8-row) steps a warp's rows cannot see (ragged
// tails, causal steps above the diagonal) and tests the mask only on edge
// steps.  Measured, the kernels issue mma.sync at the bf16 kernels' rate,
// and a split-TF32 product takes six m16n8k8 instructions where bf16 takes
// one m16n8k16: that rate, not the bytes, holds them back at every S
// (PERF.md); wgmma's TF32 rate is the way past it.
//
// The design follows the bf16 kernels of flash_attention.cu: one block of 4
// warps per 64-row tile it owns, one warp per 16 of those rows, no atomics
// (one output tile per block, so results are the same bit for bit from run to
// run); kernel 4 runs its online softmax in registers over 32-key
// sub-tiles of logits; kernel 6 computes the transposed products s^T = K.Q^T and
// dp^T = V.dO^T.  Staged tiles are f32 rows with their 16-byte chunks XORed
// with the row (sw below): the fragment loads of a warp, 8 rows by 4 words
// for a row-major B (or A) operand and 4 rows (2t, 2t + 1) by 8 words for a
// k-major one, hit 32 different banks.  p and ds never touch shared memory:
// an m16n8 accumulator holds columns (2t, 2t + 1) of its rows, the m16n8k8
// A fragment columns (t, t + 4).  The next product sums over those 8 keys
// (or rows), so their order is free: A's column t takes key 2t and t + 4 takes
// 2t + 1, and the B operand's rows are read in the same order.

#pragma once

#include "common.cuh"

namespace dmt {
namespace f32tc {

constexpr int kTile = 64;  // q rows per q tile, keys per kv tile
constexpr int kNumWarps = kTile / 16;
constexpr int kNumThreads = kNumWarps * 32;

template <int HD> __host__ __device__ constexpr int tile_floats() { return kTile * HD; }
// kernel 4: q and one K/V buffer
template <int HD> constexpr size_t fwd_smem_bytes() {
  return 3 * (size_t)tile_floats<HD>() * sizeof(float);
}
// kernel 5: q, dO and two K/V buffers
template <int HD> constexpr size_t dq_smem_bytes() {
  return 6 * (size_t)tile_floats<HD>() * sizeof(float);
}
// kernel 6: k, v and two Q/dO buffers, each with its tile's lse and delta
template <int HD> constexpr size_t dkv_smem_bytes() {
  return 6 * (size_t)tile_floats<HD>() * sizeof(float) + 2 * 2 * kTile * sizeof(float);
}

// Index of column c of row r in a staged [64, HD] f32 tile: the 16-byte chunk
// c / 4 is XORed with r & 7.
template <int HD> __device__ __forceinline__ int sw(int r, int c) {
  static_assert(HD % 32 == 0, "8 chunks or more per row");
  return r * HD + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Rows [0, 64) of a [*, HD] f32 slice whose rows are ld elements apart into a
// swizzled tile by 16-byte cp.async; rows at or past n_valid are zero-filled.
template <int HD>
__device__ __forceinline__ void stage(uint32_t dst, const float* src, int n_valid, int ld,
                                      int tid) {
  constexpr int C = HD / 4;  // 16-byte chunks per row
  for (int i = tid; i < kTile * C; i += kNumThreads) {
    const int r = i / C, c = i % C;
    const bool ok = r < n_valid;
    cp_async16(dst + 4u * (uint32_t)(r * HD + ((c ^ (r & 7)) << 2)),
               src + (size_t)(ok ? r : 0) * ld + c * 4, ok ? 16 : 0);
  }
}

// The A fragment of rows r0 + [0, 16), head dims 8kd + [0, 8), of a staged tile.
template <int HD>
__device__ __forceinline__ void load_a(Frag& f, const float* tile, int r0, int kd, int g,
                                       int t) {
  split(tile[sw<HD>(r0 + g, 8 * kd + t)], f.hi[0], f.lo[0]);
  split(tile[sw<HD>(r0 + g + 8, 8 * kd + t)], f.hi[1], f.lo[1]);
  split(tile[sw<HD>(r0 + g, 8 * kd + t + 4)], f.hi[2], f.lo[2]);
  split(tile[sw<HD>(r0 + g + 8, 8 * kd + t + 4)], f.hi[3], f.lo[3]);
}

// An m16n8 accumulator (columns 2t, 2t + 1 of rows g, g + 8) as the A
// fragment of the next product, whose 8-deep sum takes A's column t as
// column 2t and t + 4 as 2t + 1.
__device__ __forceinline__ void acc_to_a(Frag& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// d += A . B^T for head dims 8kd + [0, 8), B^T the rows r0 + [0, 8) of a
// staged tile (the 8 output columns).
template <int HD>
__device__ __forceinline__ void mma_rows(float (&d)[4], const Frag& a, const float* tile,
                                         int r0, int kd, int g, int t) {
  mma3(d, a, tile[sw<HD>(r0 + g, 8 * kd + t)], tile[sw<HD>(r0 + g, 8 * kd + t + 4)]);
}

// acc += A . B, B the rows r0 + [0, 8) of a staged tile (the 8-deep sum, in
// acc_to_a's order: A's column t meets row 2t, t + 4 row 2t + 1) by all HD
// columns.
template <int HD>
__device__ __forceinline__ void mma_cols(float (&acc)[HD / 8][4], const Frag& a,
                                         const float* tile, int r0, int g, int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    mma3(acc[j], a, tile[sw<HD>(r0 + 2 * t, 8 * j + g)], tile[sw<HD>(r0 + 2 * t + 1, 8 * j + g)]);
}

// Rows row and row + 8 of a warp's [16, HD] accumulators into rows of a
// [*, HD] output whose rows are ld elements apart (rows at or past n_rows are
// not stored).
template <int HD>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[HD / 8][4], int row,
                                           int n_rows, int ld, int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row < n_rows)
      *reinterpret_cast<float2*>(out + (size_t)row * ld + col) = make_float2(acc[j][0], acc[j][1]);
    if (row + 8 < n_rows)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * ld + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

// Kernel 4, f32.  Warp w owns q rows q0 + 16w + [0, 16): its output in f32
// accumulators [16, HD], its running max m of the raw logits (scale > 0, so
// the max of the scaled logits is m * scale exactly) and its share of the row
// sums l in registers.  K/V tiles of 64 keys go through one buffer: a tile is
// staged once the previous one is consumed.  Per 32-key sub-tile (kSub 8-key
// steps): s = Q.K^T for the steps the warp's rows see, Q's A fragments read
// and split from the staged q tile (-1e30 at masked keys, tested on edge
// sub-tiles only); m_new = max(m, row max of s) over the 4 lanes that share
// a row; p = exp2(s * scale * log2e - m_new * scale * log2e), against the
// running max as the JAX kernel takes it; corr = exp2((m - m_new) * scale *
// log2e); l = l * corr + sum p; acc = acc * corr + P.V with p as the A
// fragment in registers (its rounding to v's dtype is the identity in f32).
// out = acc / l; lse = m * scale + log(l).
//
// Why one buffer and Q not held in registers: occupancy.  The kernel waits
// on its loads at the training shapes (one or two K/V tiles per block), and
// what hides a wait is another block on the SM.  Three f32 tiles (48 KB at
// hd 64) and ~125 registers let four blocks share an SM; a second K/V buffer
// (80 KB) or Q's split fragments in registers (64 more) held it to two, and
// measured slower at every timed shape, S = 2048 included (PERF.md).  The
// 32-key sub-tile measured faster than a whole 64-key tile per softmax
// update (fewer logits live) and than 16 keys (more updates).
template <int HD>
__global__ void __launch_bounds__(kNumThreads)
flash_fwd_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Skv, int H, int causal, float scale,
                       float scale_log2) {
  constexpr int kTileF = tile_floats<HD>();
  constexpr int kSub = 4;  // 8-key steps per online-softmax update
  constexpr float kNegInf = -1e30f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_t = reinterpret_cast<float*>(smem_raw);
  float* k_t = q_t + kTileF;
  float* v_t = k_t + kTileF;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ld = H * HD;
  const size_t q_base = ((size_t)b * Sq * H + h) * HD;
  const size_t kv_base = ((size_t)b * Skv * H + h) * HD;
  const int nq = min(kTile, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;  // keys any row of the tile sees
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  // keys this warp's rows see (none for a warp wholly past Sq)
  const int w0 = q0 + 16 * warp;
  const int w_end = w0 >= Sq ? 0 : causal ? min(kv_end, w0 + 16) : kv_end;

  stage<HD>(smem_u32(q_t), q + q_base + (size_t)q0 * ld, nq, ld, threadIdx.x);

  const int row = w0 + g;  // and row + 8
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of the raw logits, rows row, row + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of their sums

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kTile;
    if (it > 0) __syncthreads();  // every warp is done with the buffer before it is refilled
    stage<HD>(smem_u32(k_t), k + kv_base + (size_t)j0 * ld, kv_end - j0, ld, threadIdx.x);
    stage<HD>(smem_u32(v_t), v + kv_base + (size_t)j0 * ld, kv_end - j0, ld, threadIdx.x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int n_ks = (min(kTile, max(0, w_end - j0)) + 7) / 8;  // 8-key steps this warp runs
    for (int s0 = 0; s0 < n_ks; s0 += kSub) {
      float s[kSub][4];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = 0.f;
      // head-dim chunks outer: each Q fragment is split once per sub-tile,
      // and the steps' products are independent chains
#pragma unroll
      for (int kd = 0; kd < HD / 8; ++kd) {
        Frag a;
        load_a<HD>(a, q_t, 16 * warp, kd, g, t);
#pragma unroll
        for (int u = 0; u < kSub; ++u)
          if (s0 + u < n_ks) mma_rows<HD>(s[u], a, k_t, 8 * (s0 + u), kd, g, t);
      }
      // keys past Skv and causal keys past a row (which covers the steps the
      // warp skipped); rows past Sq are never stored
      const int key0 = j0 + 8 * s0;
      if (key0 + 8 * kSub > Skv || (causal && key0 + 8 * kSub - 1 > w0)) {
#pragma unroll
        for (int u = 0; u < kSub; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * u + 2 * t + (e & 1), r = row + 8 * (e >> 1);
            if (key >= Skv || (causal && key > r)) s[u][e] = kNegInf;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        mx0 = fmaxf(mx0, fmaxf(s[u][0], s[u][1]));
        mx1 = fmaxf(mx1, fmaxf(s[u][2], s[u][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's 4 threads
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float c0 = exp2f((m0 - mx0) * scale_log2), c1 = exp2f((m1 - mx1) * scale_log2);
      const float n0 = mx0 * scale_log2, n1 = mx1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {  // s becomes p in place
        s[u][0] = exp2f(fmaf(s[u][0], scale_log2, -n0));
        s[u][1] = exp2f(fmaf(s[u][1], scale_log2, -n0));
        s[u][2] = exp2f(fmaf(s[u][2], scale_log2, -n1));
        s[u][3] = exp2f(fmaf(s[u][3], scale_log2, -n1));
        sum0 += s[u][0] + s[u][1];
        sum1 += s[u][2] + s[u][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        if (s0 + u < n_ks) {
          Frag pa;
          acc_to_a(pa, s[u]);
          mma_cols<HD>(acc, pa, v_t, 8 * (s0 + u), g, t);
        }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // every real row sees key 0, so l > 0 there (rows past Sq are not stored)
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[j][0] /= l0;
    acc[j][1] /= l0;
    acc[j][2] /= l1;
    acc[j][3] /= l1;
  }
  store_rows<HD>(o + q_base, acc, row, Sq, ld, t);
  if (t == 0) {
    const size_t stat = ((size_t)b * H + h) * Sq;
    if (row < Sq) lse[stat + row] = m0 * scale + logf(l0);
    if (row + 8 < Sq) lse[stat + row + 8] = m1 * scale + logf(l1);
  }
}

// Kernel 5, f32.  Warp w owns q rows q0 + 16w + [0, 16) and their dq in f32
// accumulators; at hd <= 64 its Q and dO A fragments are split once and held
// in registers, at hd 128 they are re-read and split at each step.  Per
// 8-key step of a streamed K/V tile: s = Q.K^T and dp = dO.V^T, p =
// exp2(s * scale * log2e - lse * log2e) (0 at masked keys), ds = p * (dp -
// delta) * scale, then dq += ds.K with ds as the A fragment in registers.
template <int HD>
__global__ void __launch_bounds__(kNumThreads)
flash_dq_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int Sq, int Skv, int H, int causal, float scale,
                      float scale_log2) {
  constexpr bool kQInRegs = HD <= 64;
  constexpr int kTileF = tile_floats<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_t = reinterpret_cast<float*>(smem_raw);
  float* do_t = q_t + kTileF;
  float* kv_t = do_t + kTileF;  // buffer i: K at kv_t + 2i * kTileF, V after it

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ld = H * HD;
  const size_t q_base = ((size_t)b * Sq * H + h) * HD;
  const size_t kv_base = ((size_t)b * Skv * H + h) * HD;
  const int nq = min(kTile, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;  // keys any row of the tile sees
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  // keys this warp's rows see (none for a warp wholly past Sq)
  const int w0 = q0 + 16 * warp;
  const int w_end = w0 >= Sq ? 0 : causal ? min(kv_end, w0 + 16) : kv_end;

  stage<HD>(smem_u32(q_t), q + q_base + (size_t)q0 * ld, nq, ld, threadIdx.x);
  stage<HD>(smem_u32(do_t), dout + q_base + (size_t)q0 * ld, nq, ld, threadIdx.x);
  stage<HD>(smem_u32(kv_t), k + kv_base, kv_end, ld, threadIdx.x);
  stage<HD>(smem_u32(kv_t + kTileF), v + kv_base, kv_end, ld, threadIdx.x);
  cp_async_commit();

  const size_t stat = ((size_t)b * H + h) * Sq;
  const int row = w0 + g;  // and row + 8
  const float lse0 = row < Sq ? lse[stat + row] * kLog2e : 0.f;
  const float lse1 = row + 8 < Sq ? lse[stat + row + 8] * kLog2e : 0.f;
  const float dl0 = row < Sq ? delta[stat + row] : 0.f;
  const float dl1 = row + 8 < Sq ? delta[stat + row + 8] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  Frag qf[kQInRegs ? HD / 8 : 1], df[kQInRegs ? HD / 8 : 1];

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kTile;
    if (it + 1 < n_tiles) {  // the next K/V tile, into the buffer tile it-1 used
      float* nb = kv_t + ((it + 1) & 1) * 2 * kTileF;
      const int nj = j0 + kTile;
      stage<HD>(smem_u32(nb), k + kv_base + (size_t)nj * ld, kv_end - nj, ld, threadIdx.x);
      stage<HD>(smem_u32(nb + kTileF), v + kv_base + (size_t)nj * ld, kv_end - nj, ld,
                threadIdx.x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kd = 0; kd < HD / 8; ++kd) {
          load_a<HD>(qf[kd], q_t, 16 * warp, kd, g, t);
          load_a<HD>(df[kd], do_t, 16 * warp, kd, g, t);
        }
      }
    }
    const float* k_t = kv_t + (it & 1) * 2 * kTileF;
    const float* v_t = k_t + kTileF;
    const int n_ks = (min(kTile, max(0, w_end - j0)) + 7) / 8;  // 8-key steps this warp runs
    for (int ks = 0; ks < n_ks; ++ks) {
      const int key0 = j0 + 8 * ks;
      // even and odd head-dim chunks into two accumulators each: four
      // independent chains of tensor-core products instead of two
      float s2[2][4] = {}, dp2[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < HD / 8; ++kd) {
        if constexpr (kQInRegs) {
          mma_rows<HD>(s2[kd & 1], qf[kd], k_t, 8 * ks, kd, g, t);
          mma_rows<HD>(dp2[kd & 1], df[kd], v_t, 8 * ks, kd, g, t);
        } else {
          Frag a;
          load_a<HD>(a, q_t, 16 * warp, kd, g, t);
          mma_rows<HD>(s2[kd & 1], a, k_t, 8 * ks, kd, g, t);
          load_a<HD>(a, do_t, 16 * warp, kd, g, t);
          mma_rows<HD>(dp2[kd & 1], a, v_t, 8 * ks, kd, g, t);
        }
      }
      float s[4], dp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = s2[0][e] + s2[1][e];
        dp[e] = dp2[0][e] + dp2[1][e];
      }
      // keys past Skv, and causal keys past a row: rows past Sq are never stored
      const bool edge = key0 + 8 > Skv || (causal && key0 + 7 > w0);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 2 * t + (e & 1), r = row + 8 * (e >> 1);
        float p = exp2f(fmaf(s[e], scale_log2, -(e >> 1 ? lse1 : lse0)));
        if (edge && (key >= Skv || (causal && key > r))) p = 0.f;
        ds[e] = p * (dp[e] - (e >> 1 ? dl1 : dl0)) * scale;
      }
      Frag da;
      acc_to_a(da, ds);
      mma_cols<HD>(acc, da, k_t, 8 * ks, g, t);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<HD>(dq + q_base, acc, row, Sq, ld, t);
}

// Kernel 6, f32.  Warp w owns keys j0 + 16w + [0, 16) and their dk and dv in
// f32 accumulators; at hd <= 64 its K and V A fragments are split once and
// held in registers, at hd 128 they are re-read and split at each step (the
// split pairs would spill beside the two [16, 128] accumulators).  Per 8-row
// step of a streamed q tile: the transposed products s^T = K.Q^T and dp^T =
// V.dO^T come out with keys as rows, p^T = exp2(s^T * scale * log2e - lse *
// log2e) (0 at masked keys and rows past Sq) and ds^T = p^T * (dp^T - delta)
// * scale, then dv += p^T.dO and dk += ds^T.Q with p^T and ds^T as A
// fragments in registers.  lse and delta of the streamed tile come in by
// 4-byte cp.async with it.
template <int HD>
__global__ void __launch_bounds__(kNumThreads)
flash_dkv_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                       int causal, float scale, float scale_log2) {
  constexpr bool kKVInRegs = HD <= 64;
  constexpr int kTileF = tile_floats<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_t = reinterpret_cast<float*>(smem_raw);
  float* v_t = k_t + kTileF;
  float* qd_t = v_t + kTileF;         // buffer i: Q at qd_t + 2i * kTileF, dO after it
  float* stats = qd_t + 4 * kTileF;   // buffer i: lse at stats + 2i * kTile, delta after it

  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ld = H * HD;
  const size_t q_base = ((size_t)b * Sq * H + h) * HD;
  const size_t kv_base = ((size_t)b * Skv * H + h) * HD;
  const size_t stat = ((size_t)b * H + h) * Sq;
  const int nk = min(kTile, Skv - j0);
  const int key = j0 + 16 * warp + g;  // this thread's keys: key and key + 8
  // a causal kv tile starts at the q tile holding its diagonal: rows above
  // see none of its keys
  const int start = causal ? j0 : 0;
  const int n_tiles = start < Sq ? (Sq - start + kTile - 1) / kTile : 0;

  auto stage_q = [&](int it) {  // q tile it: Q, dO, lse, delta into buffer it & 1
    const int q0 = start + it * kTile, n = Sq - q0;
    float* buf = qd_t + (it & 1) * 2 * kTileF;
    stage<HD>(smem_u32(buf), q + q_base + (size_t)q0 * ld, n, ld, threadIdx.x);
    stage<HD>(smem_u32(buf + kTileF), dout + q_base + (size_t)q0 * ld, n, ld, threadIdx.x);
    const int r = threadIdx.x % kTile;
    const float* src = (threadIdx.x < kTile ? lse : delta) + stat + q0 + (r < n ? r : 0);
    cp_async4(smem_u32(stats + (it & 1) * 2 * kTile + threadIdx.x), src, r < n ? 4 : 0);
  };
  static_assert(kNumThreads == 2 * kTile, "one thread per staged lse or delta value");

  if (n_tiles > 0) {  // else no row sees these keys: dk and dv are zeros
    stage<HD>(smem_u32(k_t), k + kv_base + (size_t)j0 * ld, nk, ld, threadIdx.x);
    stage<HD>(smem_u32(v_t), v + kv_base + (size_t)j0 * ld, nk, ld, threadIdx.x);
    stage_q(0);
  }
  cp_async_commit();

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  Frag kf[kKVInRegs ? HD / 8 : 1], vf[kKVInRegs ? HD / 8 : 1];
  const int k_first = j0 + 16 * warp;  // the warp's first key
  const bool warp_live = k_first < Skv;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = start + it * kTile;
    if (it + 1 < n_tiles) {
      stage_q(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kKVInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kd = 0; kd < HD / 8; ++kd) {
          load_a<HD>(kf[kd], k_t, 16 * warp, kd, g, t);
          load_a<HD>(vf[kd], v_t, 16 * warp, kd, g, t);
        }
      }
    }
    const float* q_t = qd_t + (it & 1) * 2 * kTileF;
    const float* do_t = q_t + kTileF;
    const float* lse_t = stats + (it & 1) * 2 * kTile;
    const float* dl_t = lse_t + kTile;
    // 8-row steps with a row at or past the warp's first key (causal) and before Sq
    const int first = causal ? max(0, (k_first - q0) / 8) : 0;
    const int n_qs = warp_live ? (min(kTile, Sq - q0) + 7) / 8 : 0;
    for (int qs = first; qs < n_qs; ++qs) {
      const int r0 = q0 + 8 * qs;
      // one accumulator each (unlike kernel 5: two would spill beside the
      // split K and V fragments and the two [16, hd] accumulators)
      float s[4] = {}, dp[4] = {};
#pragma unroll
      for (int kd = 0; kd < HD / 8; ++kd) {
        if constexpr (kKVInRegs) {
          mma_rows<HD>(s, kf[kd], q_t, 8 * qs, kd, g, t);
          mma_rows<HD>(dp, vf[kd], do_t, 8 * qs, kd, g, t);
        } else {
          Frag a;
          load_a<HD>(a, k_t, 16 * warp, kd, g, t);
          mma_rows<HD>(s, a, q_t, 8 * qs, kd, g, t);
          load_a<HD>(a, v_t, 16 * warp, kd, g, t);
          mma_rows<HD>(dp, a, do_t, 8 * qs, kd, g, t);
        }
      }
      // rows past Sq, keys past Skv, and causal keys past a row
      const bool edge = r0 + 8 > Sq || k_first + 16 > Skv || (causal && k_first + 15 > r0);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * qs + 2 * t + (e & 1);  // row within the q tile
        const int kk = key + 8 * (e >> 1);
        p[e] = exp2f(fmaf(s[e], scale_log2, -lse_t[c] * kLog2e));
        if (edge && (q0 + c >= Sq || kk >= Skv || (causal && kk > q0 + c))) p[e] = 0.f;
        ds[e] = p[e] * (dp[e] - dl_t[c]) * scale;
      }
      Frag pa, da;
      acc_to_a(pa, p);
      acc_to_a(da, ds);
      mma_cols<HD>(dv_acc, pa, do_t, 8 * qs, g, t);
      mma_cols<HD>(dk_acc, da, q_t, 8 * qs, g, t);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<HD>(dk + kv_base, dk_acc, key, Skv, ld, t);
  store_rows<HD>(dv + kv_base, dv_acc, key, Skv, ld, t);
}

}  // namespace f32tc
}  // namespace dmt
