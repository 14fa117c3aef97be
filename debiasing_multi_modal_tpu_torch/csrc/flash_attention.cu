// Blockwise (flash) attention for Hopper (sm_90a): kernels 4, 5 and 6.
//
// Replaces the TPU kernels of debiasing_multi_modal_tpu/ops/flash_attention.py:
//   kernel 4  flash_fwd_f32tc_kernel (f32, flash_f32_tc.cuh), flash_fwd_tc_kernel (bf16)
//                               <- _attn_fwd_kernel  (forward + row logsumexp)
//   kernel 5  flash_dq_f32tc_kernel (f32, flash_f32_tc.cuh), flash_dq_tc_kernel (bf16)
//                               <- _bwd_dq_kernel    (dQ)
//   kernel 6  flash_dkv_f32tc_kernel (f32, flash_f32_tc.cuh), flash_dkv_tc_kernel (bf16)
//                               <- _bwd_dkv_kernel   (dK and dV)
// Same functions:
//   s = scale * q.k^T accumulated in f32 (scale = hd^-0.5), keys masked where
//   kv_pos >= Skv and, when causal, where kv_pos > q_pos (top-left aligned, so
//   Sq != Skv is allowed).  Forward: online softmax over key tiles, running
//   max m and sum l in f32, p = exp(s - m) rounded to v's dtype before P.V,
//   which accumulates in f32; out = acc / l in q's dtype; lse = m + log(l) in
//   f32.  Backward, over lse and delta = sum_d dO*O (a plain reduction in the
//   wrapper, as XLA computes it outside the TPU kernels): p = exp(s - lse),
//   dp = dO.v^T (f32), ds = p * (dp - delta) * scale; dq = sum ds.k with ds
//   rounded to k's dtype; dv = sum p^T.dO with p rounded to dO's dtype;
//   dk = sum ds^T.q with ds rounded to q's dtype.
//
// Layout: q, dO, out, dq are [B, Sq, H, hd] and k, v, dk, dv [B, Skv, H, hd],
// the [B, S, D] projection outputs viewed head-split, so a head's rows are
// H*hd elements apart.  lse and delta are [B, H, Sq] f32.  Nothing is padded
// or transposed in device memory: a tile past the ragged S edge is masked
// inside the kernel (staged as zeros, excluded from every sum and store).
//
// Grid: one block per (64-row tile it owns, head, image).  Kernels 4 and 5
// own a q tile and stream 64-key K/V tiles; kernel 6 owns a kv tile and
// streams 64-row q/dO tiles (a causal kv tile starts at the q tile holding
// its diagonal; a causal q tile stops at its last row's key).  No block
// writes another's output, so there are no atomics and every result is the
// same bit for bit from run to run (a rematerialized step gets the gradients
// of a plain one).
//
// What bounds it on the H100: at the training shapes (S=50/77, hd=64) each
// kernel moves ~4-8 B*S*D elements against ~4-8 B*H*S^2*hd flops, 10-40
// flops per byte in bf16, under the ~295 the tensor cores need, so the bound
// is bytes; at S=4096 it is operations (989 TFLOP/s bf16).
//
// In bf16 all three run on the tensor cores (flash_fwd_tc_kernel,
// flash_dq_tc_kernel, flash_dkv_tc_kernel): 4 warps, 16 owned rows each;
// mma.sync.m16n8k16 with f32 accumulators for every product; ldmatrix /
// ldmatrix.trans fragments of XOR-swizzled tiles staged by 16-byte cp.async
// (rows past the ragged edge zero-filled, then masked out of every product
// and store); the streamed tiles double-buffered so the next tile's copies
// overlap this tile's products (64 tiles at S=4096).  Kernel 4 keeps each
// warp's Q fragments in registers and runs the online softmax in registers
// on the f32 logits of a whole 64-key tile (running max, corr, l of the
// unrounded p); kernel 6 computes the transposed products s^T = K.Q^T and
// dp^T = V.dO^T, so p^T and ds^T come out as the A fragments of p^T.dO and
// ds^T.Q.  p and ds are rounded to bf16 in the accumulator layout, straight
// into the next product's A fragment, and never touch shared memory.
// exp(s*scale - m) is computed as exp2f(s * scale*log2e - m * scale*log2e)
// on the f32 logits (the card tests hold it to the plain version's expf
// within the bf16 limits).  Against the bytes bound the design reads each
// input once per tile pass (K/V once per q tile, Q/dO once per kv tile) and
// keeps every [Sq, Skv] tensor out of device memory; against the
// operations bound it runs every product on the tensor cores, skips causal
// tiles and 16-key (16-row) steps wholly above the diagonal per warp, and
// tests the mask only on edge tiles (ragged Skv, the causal diagonal).
//
// In f32 all three run on the tensor cores as split-TF32 (flash_f32_tc.cuh):
// each operand split into TF32 hi and lo parts, each product three
// mma.sync.m16n8k8 TF32 products (lo.hi + hi.lo + hi.hi) into f32
// accumulators, since one TF32 product (~5e-4 relative) breaks the f32 limit
// of 1e-4 of scale and the dropped lo.lo term (~2^-22) does not.  They are
// bound by bytes at S = 50/77 and by operations from S ~ 1k, where the bound
// is three TF32 products per product at 495 TFLOP/s; the header says how the
// design meets each.
//
// Shared memory (fwd/dq/dkv_tc_smem_bytes below and
// f32tc::fwd/dq/dkv_smem_bytes, mirrored per dtype by ops/flash_attention.py)
// is the gate for supported(): it depends on hd and the dtype only, and hd <=
// 128 fits every kernel.
//
// C interface for ctypes, as in short_attention.cu: each entry launches on
// the given stream, allocates nothing, does not synchronize, and returns
// cudaGetLastError() (0 on success).  Every entry needs 16-byte aligned q,
// k and v base pointers (and dO for the backward) in both dtypes (the
// wrappers check).

#include <type_traits>

#include "common.cuh"
#include "flash_f32_tc.cuh"

namespace {

using namespace dmt;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;            // q rows per q tile, keys per kv tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------- kernels 4, 5 and 6, bf16, tensor cores
//
// One block of kTcWarps warps per 64-row tile it owns, one warp per 16 of
// those rows: kernels 4 and 5 own q rows and stream 64-key K/V tiles, kernel 6
// owns keys and streams 64-row Q/dO tiles (with their lse and delta).  The
// streamed tiles are double-buffered: tile i+1's 16-byte cp.async copies are
// in flight while tile i's products run.  All bf16 tiles are XOR-swizzled
// (common.cuh swz) and read with ldmatrix; every product is
// mma.sync.m16n8k16 with f32 accumulators, 16 keys (kernels 4 and 5) or 16
// q rows (kernel 6) per step.  The step's f32 s and dp become p and ds in
// registers; p and ds are rounded to bf16 in the accumulator layout, which
// is already the A fragment of the step's next products, so neither goes
// through shared memory.

constexpr int kTcWarps = kTile / 16;  // 4: 16 owned rows per warp
constexpr int kTcThreads = kTcWarps * 32;

template <int HD> __host__ __device__ constexpr size_t tc_tile_bytes() {
  return (size_t)kTile * HD * 2;
}
// kernel 4: q and two K/V buffers
template <int HD> constexpr size_t fwd_tc_smem_bytes() { return 5 * tc_tile_bytes<HD>(); }
// kernel 5: q, dO and two K/V buffers
template <int HD> constexpr size_t dq_tc_smem_bytes() { return 6 * tc_tile_bytes<HD>(); }
// kernel 6: k, v and two Q/dO buffers, each with its tile's lse and delta
template <int HD> constexpr size_t dkv_tc_smem_bytes() {
  return 6 * tc_tile_bytes<HD>() + 2 * 2 * kTile * sizeof(float);
}

// A fragments of rows [16w, 16w + 16) of a swizzled [64, HD] tile, head dims
// 16 at a time.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&f)[HD / 16][4], uint32_t tile, int w, int lane) {
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd)
    ldsm_x4(f[kd], tile + swz<HD>(16 * w + (lane & 15), 2 * kd + (lane >> 4)));
}

// d[0..1] += A . B^T for the 16 rows r0.. of a swizzled [64, HD] tile taken
// as B^T (rows r0 + [0, 8) into d[0], r0 + [8, 16) into d[1]): one head-dim
// chunk kd of the product.
template <int HD>
__device__ __forceinline__ void mma_rows(float (&d)[2][4], const uint32_t (&a)[4],
                                         uint32_t tile, int r0, int kd, int lane) {
  uint32_t b[4];
  ldsm_x4(b, tile + swz<HD>(r0 + (lane & 7) + (lane >> 4) * 8, 2 * kd + ((lane >> 3) & 1)));
  mma_bf16(d[0], a, b[0], b[1]);
  mma_bf16(d[1], a, b[2], b[3]);
}

// acc += A . B where B is rows r0 + [0, 16) of a swizzled [64, HD] tile (the
// product's 16-deep dimension) by all HD columns, read by ldmatrix.trans.
template <int HD>
__device__ __forceinline__ void mma_cols(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                         uint32_t tile, int r0, int lane) {
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, tile + swz<HD>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * dp + (lane >> 4)));
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Rows r and r + 8 (r = 16w + g) of a warp's f32 [16, HD] accumulators as
// packed bf16 pairs into rows row0.. of a [*, HD] output with row stride ld.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 8][4],
                                           int row, int n_rows, int ld, int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row < n_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * ld + col) = pack_bf16(acc[j][0], acc[j][1]);
    if (row + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * ld + col) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

// Kernel 4, bf16.  Warp w owns q rows q0 + 16w + [0, 16): its Q A fragments
// stay in registers for the whole key loop, its output in f32 accumulators
// [16, HD], its running max m (of the raw logits; scale > 0, so the max of
// the scaled logits is m * scale exactly) and its share of the row sums l in
// registers.  Per 64-key tile: s = Q.K^T for the 16-key steps the warp sees
// (K rows as B^T, non-transposed ldmatrix); m_new = max(m, row max of s);
// p = exp2(s * scale * log2e - m_new * scale * log2e), against the running
// max as the JAX kernel takes it (0 at masked keys); corr = exp2((m - m_new)
// * scale * log2e); l = l * corr + sum of the unrounded p; acc = acc * corr
// + P.V with p rounded to bf16 in the accumulator layout as the A fragment
// and V read by ldmatrix.trans.  out = acc / l; lse = m * scale + log(l).
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Skv, int H, int causal,
                    float scale, float scale_log2) {
  constexpr uint32_t kTileB = (uint32_t)tc_tile_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t kv_s = q_s + kTileB;  // buffer i: K at kv_s + 2i*kTileB, V after it

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

  stage_rows<HD>(q_s, q + q_base + (size_t)q0 * ld, kTile, nq, ld, threadIdx.x, kTcThreads);
  stage_rows<HD>(kv_s, k + kv_base, kTile, kv_end, ld, threadIdx.x, kTcThreads);
  stage_rows<HD>(kv_s + kTileB, v + kv_base, kTile, kv_end, ld, threadIdx.x, kTcThreads);
  cp_async_commit();

  const int row = w0 + g;  // and row + 8
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of the raw logits, rows row, row + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of their sums
  uint32_t qf[HD / 16][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kTile;
    if (it + 1 < n_tiles) {  // the next K/V tile, into the buffer tile it-1 used
      const uint32_t nb = kv_s + ((it + 1) & 1) * 2 * kTileB;
      const int nj = j0 + kTile;
      stage_rows<HD>(nb, k + kv_base + (size_t)nj * ld, kTile, kv_end - nj, ld, threadIdx.x,
                     kTcThreads);
      stage_rows<HD>(nb + kTileB, v + kv_base + (size_t)nj * ld, kTile, kv_end - nj, ld,
                     threadIdx.x, kTcThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) load_a<HD>(qf, q_s, warp, lane);
    const uint32_t k_t = kv_s + (it & 1) * 2 * kTileB, v_t = k_t + kTileB;
    const int n_ks = min(kTile, max(0, w_end - j0) + 15) / 16;  // 16-key steps this warp runs
    if (n_ks > 0) {
      float s[kTile / 16][2][4];
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[ks][hh][e] = 0.f;
        if (ks < n_ks) {
#pragma unroll
          for (int kd = 0; kd < HD / 16; ++kd) mma_rows<HD>(s[ks], qf[kd], k_t, 16 * ks, kd, lane);
        }
      }
      // keys past Skv and causal keys past a row (which covers the steps the
      // warp skipped); rows past Sq are never stored
      if (j0 + kTile > Skv || (causal && j0 + kTile - 1 > w0)) {
#pragma unroll
        for (int ks = 0; ks < kTile / 16; ++ks)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = j0 + 16 * ks + 8 * hh + 2 * t + (e & 1), r = row + 8 * (e >> 1);
              if (key >= Skv || (causal && key > r)) s[ks][hh][e] = kNegInf;
            }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx0 = fmaxf(mx0, fmaxf(s[ks][hh][0], s[ks][hh][1]));
          mx1 = fmaxf(mx1, fmaxf(s[ks][hh][2], s[ks][hh][3]));
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's 4 threads
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float c0 = exp2f((m0 - mx0) * scale_log2), c1 = exp2f((m1 - mx1) * scale_log2);
      const float n0 = mx0 * scale_log2, n1 = mx1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[kTile / 16][4];
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p0 = exp2f(fmaf(s[ks][hh][0], scale_log2, -n0));
          const float p1 = exp2f(fmaf(s[ks][hh][1], scale_log2, -n0));
          const float p2 = exp2f(fmaf(s[ks][hh][2], scale_log2, -n1));
          const float p3 = exp2f(fmaf(s[ks][hh][3], scale_log2, -n1));
          sum0 += p0 + p1;  // l sums the unrounded p
          sum1 += p2 + p3;
          pa[ks][2 * hh] = pack_bf16(p0, p1);  // p rounds to v's dtype
          pa[ks][2 * hh + 1] = pack_bf16(p2, p3);
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
      for (int ks = 0; ks < kTile / 16; ++ks)
        if (ks < n_ks) mma_cols<HD>(acc, pa[ks], v_t, 16 * ks, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
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

// Kernel 5, bf16.  Warp w owns q rows q0 + 16w + [0, 16): its Q and dO A
// fragments stay in registers for the whole key loop, its dq in f32
// accumulators.  Per 16-key step: s = Q.K^T and dp = dO.V^T (K and V rows as
// B^T, non-transposed ldmatrix), p = exp2(s * scale * log2e - lse * log2e)
// (0 at masked keys), ds = p * (dp - delta) * scale, then dq += ds.K with ds
// rounded to bf16 as the A fragment and K read by ldmatrix.trans.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int Sq, int Skv, int H, int causal,
                   float scale, float scale_log2) {
  constexpr uint32_t kTileB = (uint32_t)tc_tile_bytes<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw), do_s = q_s + kTileB;
  const uint32_t kv_s = do_s + kTileB;  // buffer i: K at kv_s + 2i*kTileB, V after it

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

  stage_rows<HD>(q_s, q + q_base + (size_t)q0 * ld, kTile, nq, ld, threadIdx.x, kTcThreads);
  stage_rows<HD>(do_s, dout + q_base + (size_t)q0 * ld, kTile, nq, ld, threadIdx.x, kTcThreads);
  stage_rows<HD>(kv_s, k + kv_base, kTile, kv_end, ld, threadIdx.x, kTcThreads);
  stage_rows<HD>(kv_s + kTileB, v + kv_base, kTile, kv_end, ld, threadIdx.x, kTcThreads);
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
  uint32_t qf[HD / 16][4], dof[HD / 16][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kTile;
    if (it + 1 < n_tiles) {  // the next K/V tile, into the buffer tile it-1 used
      const uint32_t nb = kv_s + ((it + 1) & 1) * 2 * kTileB;
      const int nj = j0 + kTile;
      stage_rows<HD>(nb, k + kv_base + (size_t)nj * ld, kTile, kv_end - nj, ld, threadIdx.x,
                     kTcThreads);
      stage_rows<HD>(nb + kTileB, v + kv_base + (size_t)nj * ld, kTile, kv_end - nj, ld,
                     threadIdx.x, kTcThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a<HD>(qf, q_s, warp, lane);
      load_a<HD>(dof, do_s, warp, lane);
    }
    const uint32_t k_t = kv_s + (it & 1) * 2 * kTileB, v_t = k_t + kTileB;
    const int n_ks = min(kTile, max(0, w_end - j0) + 15) / 16;  // 16-key steps this warp runs
    for (int ks = 0; ks < n_ks; ++ks) {
      const int key0 = j0 + 16 * ks;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        mma_rows<HD>(s, qf[kd], k_t, 16 * ks, kd, lane);
        mma_rows<HD>(dp, dof[kd], v_t, 16 * ks, kd, lane);
      }
      // keys past Skv, and causal keys past a row: rows past Sq are never stored
      const bool edge = key0 + 16 > Skv || (causal && key0 + 15 > w0);
      uint32_t da[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * hh + 2 * t + (e & 1), r = row + 8 * (e >> 1);
          float p = exp2f(fmaf(s[hh][e], scale_log2, -(e >> 1 ? lse1 : lse0)));
          if (edge && (key >= Skv || (causal && key > r))) p = 0.f;
          ds[e] = p * (dp[hh][e] - (e >> 1 ? dl1 : dl0)) * scale;
        }
        da[2 * hh] = pack_bf16(ds[0], ds[1]);      // ds rounds to k's dtype
        da[2 * hh + 1] = pack_bf16(ds[2], ds[3]);
      }
      mma_cols<HD>(acc, da, k_t, 16 * ks, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<HD>(dq + q_base, acc, row, Sq, ld, t);
}

// Kernel 6, bf16.  Warp w owns keys j0 + 16w + [0, 16): its dk and dv sit in
// f32 accumulators; at hd <= 64 its K and V A fragments stay in registers,
// at hd 128 they are re-read from the staged tile at each step (registers
// would spill).  Per 16-row step of a streamed q tile, the transposed
// products s^T = K.Q^T and dp^T = V.dO^T come out with keys as rows, so
// p^T = exp2(s^T * scale * log2e - lse * log2e) (0 at masked keys and rows
// past Sq) and ds^T = p^T * (dp^T - delta) * scale, rounded to bf16, are
// the A fragments of dv += p^T.dO and dk += ds^T.Q (dO and Q read by
// ldmatrix.trans).  lse and delta of the streamed tile come in by 4-byte
// cp.async with it.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H,
                    int causal, float scale, float scale_log2) {
  constexpr bool kKVInRegs = HD <= 64;
  constexpr uint32_t kTileB = (uint32_t)tc_tile_bytes<HD>();
  constexpr uint32_t kBufB = 2 * kTileB;  // one Q/dO buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t k_s = smem_u32(smem_raw), v_s = k_s + kTileB;
  const uint32_t qd_s = v_s + kTileB;  // buffer i: Q at qd_s + i*kBufB, dO after it
  float* stats = reinterpret_cast<float*>(smem_raw + 6 * kTileB);  // buffer i: lse, delta

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
    const uint32_t buf = qd_s + (it & 1) * kBufB;
    stage_rows<HD>(buf, q + q_base + (size_t)q0 * ld, kTile, n, ld, threadIdx.x, kTcThreads);
    stage_rows<HD>(buf + kTileB, dout + q_base + (size_t)q0 * ld, kTile, n, ld, threadIdx.x,
                   kTcThreads);
    const int r = threadIdx.x % kTile;
    const float* src = (threadIdx.x < kTile ? lse : delta) + stat + q0 + (r < n ? r : 0);
    cp_async4(smem_u32(stats + (it & 1) * 2 * kTile + threadIdx.x), src, r < n ? 4 : 0);
  };
  static_assert(kTcThreads == 2 * kTile, "one thread per staged lse or delta value");

  if (n_tiles > 0) {  // else no row sees these keys: dk and dv are zeros
    stage_rows<HD>(k_s, k + kv_base + (size_t)j0 * ld, kTile, nk, ld, threadIdx.x, kTcThreads);
    stage_rows<HD>(v_s, v + kv_base + (size_t)j0 * ld, kTile, nk, ld, threadIdx.x, kTcThreads);
    stage_q(0);
  }
  cp_async_commit();

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  uint32_t kf[kKVInRegs ? HD / 16 : 1][4], vf[kKVInRegs ? HD / 16 : 1][4];
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
        load_a<HD>(kf, k_s, warp, lane);
        load_a<HD>(vf, v_s, warp, lane);
      }
    }
    const uint32_t q_t = qd_s + (it & 1) * kBufB, do_t = q_t + kTileB;
    const float* lse_t = stats + (it & 1) * 2 * kTile;
    const float* dl_t = lse_t + kTile;
    // 16-row steps with a row past the warp's first key (causal) and before Sq
    const int first = causal ? max(0, (k_first - q0) / 16) : 0;
    const int n_qs = warp_live ? min(kTile, Sq - q0 + 15) / 16 : 0;
    for (int qs = first; qs < n_qs; ++qs) {
      const int r0 = q0 + 16 * qs;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        if constexpr (kKVInRegs) {
          mma_rows<HD>(s, kf[kd], q_t, 16 * qs, kd, lane);
          mma_rows<HD>(dp, vf[kd], do_t, 16 * qs, kd, lane);
        } else {
          uint32_t a[4];
          ldsm_x4(a, k_s + swz<HD>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
          mma_rows<HD>(s, a, q_t, 16 * qs, kd, lane);
          ldsm_x4(a, v_s + swz<HD>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
          mma_rows<HD>(dp, a, do_t, 16 * qs, kd, lane);
        }
      }
      // rows past Sq, keys past Skv, and causal keys past a row
      const bool edge = r0 + 16 > Sq || k_first + 16 > Skv || (causal && k_first + 15 > r0);
      uint32_t pa[4], da[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * qs + 8 * hh + 2 * t + (e & 1);  // row within the q tile
          const int kk = key + 8 * (e >> 1);
          p[e] = exp2f(fmaf(s[hh][e], scale_log2, -lse_t[c] * kLog2e));
          if (edge && (q0 + c >= Sq || kk >= Skv || (causal && kk > q0 + c))) p[e] = 0.f;
          ds[e] = p[e] * (dp[hh][e] - dl_t[c]) * scale;
        }
        pa[2 * hh] = pack_bf16(p[0], p[1]);  // p rounds to dO's dtype
        pa[2 * hh + 1] = pack_bf16(p[2], p[3]);
        da[2 * hh] = pack_bf16(ds[0], ds[1]);  // ds rounds to q's dtype
        da[2 * hh + 1] = pack_bf16(ds[2], ds[3]);
      }
      mma_cols<HD>(dv_acc, pa, do_t, 16 * qs, lane);
      mma_cols<HD>(dk_acc, da, q_t, 16 * qs, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<HD>(dk + kv_base, dk_acc, key, Skv, ld, t);
  store_rows<HD>(dv + kv_base, dv_acc, key, Skv, ld, t);
}

// ---------------------------------------------------------------- launches --
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// bf16 takes the tensor-core kernels, f32 the split-TF32 tensor-core kernels
// of flash_f32_tc.cuh.
template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int Sq, int Skv, int H, int causal, cudaStream_t st) {
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = fwd_tc_smem_bytes<HD>();
    auto kernel = flash_fwd_tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv, H, causal, scale,
        scale * kLog2e);
  } else {
    const size_t smem = f32tc::fwd_smem_bytes<HD>();
    auto kernel = f32tc::flash_fwd_f32tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, f32tc::kNumThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), Sq, Skv,
        H, causal, scale, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Skv, int H, int causal, cudaStream_t st) {
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = dq_tc_smem_bytes<HD>();
    auto kernel = flash_dq_tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Skv, H, causal, scale,
        scale * kLog2e);
  } else {
    const size_t smem = f32tc::dq_smem_bytes<HD>();
    auto kernel = f32tc::flash_dq_f32tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, f32tc::kNumThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), Sq, Skv, H, causal, scale, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Sq, int Skv, int H, int causal, cudaStream_t st) {
  const dim3 grid((Skv + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = dkv_tc_smem_bytes<HD>();
    auto kernel = flash_dkv_tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
        Skv, H, causal, scale, scale * kLog2e);
  } else {
    const size_t smem = f32tc::dkv_smem_bytes<HD>();
    auto kernel = f32tc::flash_dkv_f32tc_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, f32tc::kNumThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, H, causal, scale,
        scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Skv, int H) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0;
}

}  // namespace

// Each entry dispatches on dtype (0 = float32, 1 = bfloat16) and hd.
#define DMT_DISPATCH(LAUNCH, ...)                                              \
  switch (dtype * 1000 + hd) {                                                 \
    case 32: return LAUNCH<float, 32>(__VA_ARGS__);                            \
    case 64: return LAUNCH<float, 64>(__VA_ARGS__);                            \
    case 128: return LAUNCH<float, 128>(__VA_ARGS__);                          \
    case 1032: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                  \
    case 1064: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                  \
    case 1128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                 \
    default: return (int)cudaErrorInvalidValue;                                \
  }

extern "C" {

int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int Sq, int Skv, int H, int hd,
                            int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Skv, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DMT_DISPATCH(launch_fwd, q, k, v, o, lse, B, Sq, Skv, H, causal, st)
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int Sq, int Skv, int H, int hd, int causal,
                       int dtype, void* stream) {
  if (bad_shape(B, Sq, Skv, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DMT_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, causal, st)
}

int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int Sq, int Skv, int H, int hd,
                        int causal, int dtype, void* stream) {
  if (bad_shape(B, Sq, Skv, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DMT_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, causal,
               st)
}

}  // extern "C"
