// Stride-1 folded-BatchNorm RN50 bottleneck block in one fused pass for
// Hopper (sm_90a): kernel 8 (implicit GEMM, optional 1x1 downsample) and
// kernel 9 (nine shifted products, identity residual).
//
// Replaces the TPU kernels
//   debiasing_multi_modal_tpu/ops/conv_gemm.py::_body        (kernel 8) and
//   debiasing_multi_modal_tpu/ops/fused_bottleneck.py::_kernel (kernel 9).
// Same function, NHWC, in the JAX kernels' roundings:
//   y1  = T(relu(x @ w1 + b1))                  zero-padded by one pixel
//   y2  = T(relu(conv3x3(y1, w2) + b2))
//   y3  = T(y2 @ w3 + b3)
//   res = x, or T(x @ wd + bd) with the downsample
//   out = relu(T(y3 + res))
// with every product accumulated in f32, T the activation dtype (f32 or
// bf16), the biases f32.  y1 is zero outside the image, after its bias and
// ReLU (conv_gemm.py:73-77): computing it from a zero x would give relu(b1).
// Kernel 8 sums conv2 as one K = 9M contraction (the patch GEMM of
// conv_gemm.py); kernel 9 sums each of the nine (dy, dx) shifts on its own
// and adds it to the accumulator, as fused_bottleneck.py adds nine dots.
//
// Design: one block of 256 threads per (group of G images, strip of S rows).
//   phase 1: y1 for the strip's rows plus one halo row above and below
//            (recomputed by both neighbouring strips), into a shared tile
//            [G][S+2][W+2][M] of T whose border columns and out-of-image
//            rows are zero;
//   phase 2: y2 for the strip, [G][S][W][M] of T in shared memory, read
//            from the y1 tile at the nine shifts;
//   phase 3: conv3 + bias, the residual (read from x, or the downsample
//            product of x), the add and the ReLU, streamed to device memory.
// The intermediates never reach device memory: the block reads x and the
// weights and writes out.  In bf16 every phase runs on the tensor cores
// (bottleneck_tc_kernel, mma.sync.m16n8k16 from ldmatrix fragments, the
// weights staged through a ring of shared buffers by cp.async); f32 keeps the
// first design on CUDA-core FMAs (bottleneck_f32_kernel), a correctness
// route that is not timed.
//
// What bounds it on the H100: at RN50's stride-1 blocks in bf16, batch 256,
// the block's 2*B*H*W*(Cin*M + 9M^2 + M*Cout [+ Cin*Cout]) operations take
// 0.11 ms at the bf16 tensor-core peak against 0.11-0.25 ms of bytes, so the
// bound is about balanced.  What the design meets it with: every product on
// the tensor cores; x read once per column pass and out written once; the
// weights read from L2 once per row pass of a block (32-deep k-tiles
// through a ring of four stage buffers, three tiles in flight).  Measured,
// this first design runs at ~10 % of the tensor-core rate: one block per SM
// (the tiles take 200+ KB of shared memory, the accumulators 200-250
// registers), so each per-tile barrier, each pass's pipeline fill and the
// residual loads stall the SM; and at layers 3-4 every block reads all the
// weights (2.2 / 8.9 MB) for 98 / 49 pixels (PERF.md).
//
// The shared tiles decide the strip: (G*(S+2)*(W+2)*M + G*S*W*M) elements
// of T, and in bf16 the ring of stage buffers (81,920 bytes), must fit the
// 232,448 bytes a block may use (smem_bytes; the Python gate
// ops/conv_gemm.py::smem_bytes mirrors it).
//
// C interface for ctypes: each entry launches on the given stream,
// allocates nothing, does not synchronize, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).

#include <type_traits>

#include "common.cuh"

namespace {

using dmt::cp_async16;
using dmt::cp_async_commit;
using dmt::cp_async_wait;
using dmt::ldsm_x4;
using dmt::ldsm_x4_trans;
using dmt::mma_bf16;
using dmt::pack_bf16;
using dmt::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;

struct Params {
  const void* x;    // [B, H, W, Cin] T
  const void* w1;   // [Cin, M] T
  const float* b1;  // [M]
  const void* w2;   // [9M, M] T, rows in (dy, dx, c) order
  const float* b2;  // [M]
  const void* w3;   // [M, Cout] T
  const float* b3;  // [Cout]
  const void* wd;   // [Cin, Cout] T, or NULL
  const float* bd;  // [Cout], or NULL
  void* out;        // [B, H, W, Cout] T
  int H, W, Cin, M, Cout, S, G;
};

// ------------------------------------------------ f32: CUDA-core FMAs
//
// The f32 route is a correctness route (not timed): each phase is a small
// GEMM computed by thread tiles of 4 pixel rows x 8 channels of f32 FMAs,
// A rows from x (global) or the shared tiles, the weights [K, N] read from
// global memory (L2).  Neighbouring lanes take neighbouring channel groups,
// so a warp's weight loads are contiguous and its A loads are broadcasts.

constexpr int kRP = 4;  // pixel rows per thread tile
constexpr int kRC = 8;  // channels per thread tile, one 8-element vector

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void zero(float (&acc)[kRP][kRC]) {
#pragma unroll
  for (int i = 0; i < kRP; ++i)
#pragma unroll
    for (int j = 0; j < kRC; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} a[i][k] * w[k * ldw + j]: one thread tile of a
// GEMM whose weight w [K, ldw] (already offset to the tile's first column)
// lies in global memory.  K is a multiple of 8.
__device__ __forceinline__ void mac(float (&acc)[kRP][kRC], const float* const (&a)[kRP],
                                    const float* __restrict__ w, int ldw, int K) {
  for (int k = 0; k < K; k += 8) {
    float av[kRP][8];
#pragma unroll
    for (int i = 0; i < kRP; ++i) load8(a[i] + k, av[i]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float wv[kRC];
      load8(w + (size_t)(k + kk) * ldw, wv);
#pragma unroll
      for (int i = 0; i < kRP; ++i)
#pragma unroll
        for (int j = 0; j < kRC; ++j) acc[i][j] = fmaf(av[i][kk], wv[j], acc[i][j]);
    }
  }
}

template <bool kDownsample, bool kShifted>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, Cin = p.Cin, M = p.M, Cout = p.Cout, S = p.S, G = p.G;
  const int Wp = W + 2;
  const int r0 = blockIdx.x * S;  // first output row of the strip
  const int n0 = blockIdx.y * G;  // first image of the group
  const float* __restrict__ x = static_cast<const float*>(p.x);
  const float* __restrict__ w1 = static_cast<const float*>(p.w1);
  const float* __restrict__ w2 = static_cast<const float*>(p.w2);
  const float* __restrict__ w3 = static_cast<const float*>(p.w3);
  float* __restrict__ out = static_cast<float*>(p.out);
  float* y1s = reinterpret_cast<float*>(smem);          // [G][S+2][W+2][M]
  float* y2s = y1s + (size_t)G * (S + 2) * Wp * M;      // [G][S][W][M]
  const int cgm = M / kRC;

  // ---- phase 1: y1 (strip rows and halo) into the zero-bordered tile
  {
    // border columns 0 and W+1 of every tile row
    const int vecs = G * (S + 2) * 2 * cgm;
    for (int v = threadIdx.x; v < vecs; v += kThreads) {
      const int c0 = (v % cgm) * kRC;
      const int rowcol = v / cgm;  // (g, rr, side)
      const int col = (rowcol % 2) ? W + 1 : 0;
      const float zeros[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      store8(y1s + ((size_t)(rowcol / 2) * Wp + col) * M + c0, zeros);
    }
    const int rows = G * (S + 2) * W;
    const int tiles = (rows + kRP - 1) / kRP * cgm;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int c0 = (t % cgm) * kRC, p0 = (t / cgm) * kRP;
      const float* a[kRP];
      int dst[kRP];
      bool inside[kRP];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const int q = min(p0 + i, rows - 1);
        const int g = q / ((S + 2) * W), rr = (q / W) % (S + 2), col = q % W;
        const int row = r0 - 1 + rr;
        inside[i] = row >= 0 && row < H;
        const int rowc = min(max(row, 0), H - 1);
        a[i] = x + (((size_t)(n0 + g) * H + rowc) * W + col) * Cin;
        dst[i] = ((g * (S + 2) + rr) * Wp + col + 1) * M + c0;
      }
      float acc[kRP][kRC];
      zero(acc);
      mac(acc, a, w1 + c0, M, Cin);
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (p0 + i >= rows) break;
        float v[8];
#pragma unroll
        for (int j = 0; j < kRC; ++j)
          v[j] = inside[i] ? fmaxf(acc[i][j] + p.b1[c0 + j], 0.f) : 0.f;
        store8(y1s + dst[i], v);
      }
    }
  }
  __syncthreads();

  // ---- phase 2: y2 = relu(conv3x3(y1) + b2) into shared memory
  {
    const int rows = G * S * W;
    const int tiles = (rows + kRP - 1) / kRP * cgm;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int c0 = (t % cgm) * kRC, p0 = (t / cgm) * kRP;
      const float* base[kRP];  // the (dy, dx) = (0, 0) corner of each pixel's window
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const int q = min(p0 + i, rows - 1);
        const int g = q / (S * W), s = (q / W) % S, col = q % W;
        base[i] = y1s + ((size_t)(g * (S + 2) + s) * Wp + col) * M;
      }
      float acc[kRP][kRC];
      zero(acc);
#pragma unroll 1
      for (int shift = 0; shift < 9; ++shift) {
        const int off = ((shift / 3) * Wp + shift % 3) * M;
        const float* a[kRP];
#pragma unroll
        for (int i = 0; i < kRP; ++i) a[i] = base[i] + off;
        const float* ws = w2 + (size_t)shift * M * M + c0;
        if (kShifted) {  // kernel 9: each shift's product on its own, then added
          float part[kRP][kRC];
          zero(part);
          mac(part, a, ws, M, M);
#pragma unroll
          for (int i = 0; i < kRP; ++i)
#pragma unroll
            for (int j = 0; j < kRC; ++j) acc[i][j] += part[i][j];
        } else {  // kernel 8: one K = 9M contraction
          mac(acc, a, ws, M, M);
        }
      }
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (p0 + i >= rows) break;
        float v[8];
#pragma unroll
        for (int j = 0; j < kRC; ++j) v[j] = fmaxf(acc[i][j] + p.b2[c0 + j], 0.f);
        store8(y2s + (size_t)(p0 + i) * M + c0, v);
      }
    }
  }
  __syncthreads();

  // ---- phase 3: out = relu(y2 @ w3 + b3 + res) to device memory
  {
    const int rows = G * S * W;
    const int cgo = Cout / kRC;
    const int tiles = (rows + kRP - 1) / kRP * cgo;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int c0 = (t % cgo) * kRC, p0 = (t / cgo) * kRP;
      const float* a[kRP];
      const float* xr[kRP];
      size_t pix[kRP];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        const int q = min(p0 + i, rows - 1);
        const int g = q / (S * W), s = (q / W) % S, col = q % W;
        pix[i] = ((size_t)(n0 + g) * H + r0 + s) * W + col;
        a[i] = y2s + (size_t)q * M;
        xr[i] = x + pix[i] * Cin;
      }
      float acc[kRP][kRC];
      zero(acc);
      mac(acc, a, w3 + c0, Cout, M);
      float res[kRP][kRC];
      if (kDownsample) {
        zero(res);
        mac(res, xr, static_cast<const float*>(p.wd) + c0, Cout, Cin);
#pragma unroll
        for (int i = 0; i < kRP; ++i)
#pragma unroll
          for (int j = 0; j < kRC; ++j) res[i][j] += p.bd[c0 + j];
      } else {
#pragma unroll
        for (int i = 0; i < kRP; ++i) load8(xr[i] + c0, res[i]);
      }
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (p0 + i >= rows) break;
        float v[8];
#pragma unroll
        for (int j = 0; j < kRC; ++j) v[j] = fmaxf(acc[i][j] + p.b3[c0 + j] + res[i][j], 0.f);
        store8(out + pix[i] * Cout + c0, v);
      }
    }
  }
}

// ------------------------------------------------ bf16: tensor cores
//
// Every product is an implicit GEMM, rows = pixels, columns = channels, on
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators).  Each warp owns a
// 32-row x 64-column tile of a pass (acc[2][8][4]); the 8 warps of a block
// form wm x wn = 8 x 1, 4 x 2 or 2 x 4 tiles (pick_layout: the least
// estimated time for this phase's rows, columns and depth), so a pass covers
// 32 wm rows x 64 wn columns.  A pass walks K in 32-deep tiles: the weight
// rows [K, N] of the pass's columns (B), and for conv1 and the downsample
// the x rows of the pass's pixels (A), go through a ring of four stage
// buffers by 16-byte cp.async (tiles i+1..i+3 in flight while tile i is
// multiplied, one block barrier per tile), read by ldmatrix.trans (B) and
// ldmatrix (A).  conv2 and conv3
// read A straight from the shared y1 and y2 tiles by ldmatrix: for conv2
// each lane gives the address of its own pixel's window corner plus the
// (dy, dx) shift, so the nine shifts are nine base offsets and no patch
// matrix is built.  Tiles are XORed by 16-byte chunk with the row
// (swizzle_mask) so the 8 rows one ldmatrix matrix reads hit 8 different
// bank groups.

constexpr int kKT = 32;     // k depth of a stage tile (2 k16 steps)
constexpr int kStages = 4;  // the ring: tiles it+1..it+3 in flight while it is multiplied
// one stage buffer: B [32, 64 wn] and A [32 wm, 32] bf16, 20,480 bytes at
// wn = 1 or 4 and 16,384 at wn = 2
constexpr int kStageBytes = kKT * 2 * (64 + 256);

// The XOR mask of a tile with C 16-byte chunks per row: chunk c of row r
// sits at chunk c ^ (r & mask), within each group of 8 chunks (fewer where C
// is a smaller power of two; none otherwise).
__device__ __forceinline__ int swizzle_mask(int C) {
  return (C & 7) == 0 ? 7 : (C & (C - 1)) == 0 ? C - 1 : 0;
}

struct Layout {
  int wm, wn;  // warps along rows and along columns
};

// The warp layout of a phase with R rows and N columns, a weight of depth Kb
// and x rows of depth Ka staged from device memory: the least estimated
// time, counting the padded products at the tensor cores' rate (~4,270 flop
// per clock per SM) and the bytes each pass stages from L2 (~24 per clock
// per SM when every SM streams): the weight [Kb, 64 wn] and the x rows
// [32 wm, Ka] of every pass.
__device__ __forceinline__ Layout pick_layout(int R, int N, int Kb, int Ka) {
  Layout best{8, 1};
  float best_cost = -1.f;
  for (int wn = 1; wn <= 4; wn *= 2) {
    if (wn > 1 && 64 * wn > N) break;
    const int wm = 8 / wn;
    const float passes = (float)((R + 32 * wm - 1) / (32 * wm)) * ((N + 64 * wn - 1) / (64 * wn));
    const float flops = 2.f * 32 * wm * 64 * wn * Kb;
    const float bytes = 2.f * (Kb * 64 * wn + Ka * 32 * wm);
    const float cost = passes * (flops / 4270.f + bytes / 24.f);
    if (best_cost < 0.f || cost < best_cost) {
      best = Layout{wm, wn};
      best_cost = cost;
    }
  }
  return best;
}

struct Strip {  // the block's share of the batch
  int H, W, S, G, Wp, r0, n0;
  // row h of the halo strip (S + 2 rows of W pixels per image)
  __device__ __forceinline__ void halo(int h, int& gi, int& rr, int& col) const {
    gi = h / ((S + 2) * W);
    rr = (h / W) % (S + 2);
    col = h % W;
  }
  // output pixel q of the strip (S rows of W pixels per image)
  __device__ __forceinline__ void pixel(int q, int& gi, int& s, int& col) const {
    gi = q / (S * W);
    s = (q / W) % S;
    col = q % W;
  }
  // x pixel index of halo row h (rows outside the image clamped in) or of
  // output pixel q
  __device__ __forceinline__ int x_pix(int i, bool halo_rows) const {
    int gi, r, col;
    if (halo_rows) {
      halo(i, gi, r, col);
      r = min(max(r0 - 1 + r, 0), H - 1);
    } else {
      pixel(i, gi, r, col);
      r += r0;
    }
    return ((n0 + gi) * H + r) * W + col;
  }
};

// One GEMM pass of the warp's 32 x 64 tile, the block's warps laid out
// (8 / WN) x WN: acc (+)= A . B, K walked as n_seg segments of Kseg (conv2:
// nine shifts of M; otherwise one of K), each in 32-deep tiles through the
// kStages-buffer ring.  B is the
// [n_seg Kseg, N] weight at columns np + [0, 64 WN).  A is the x rows xpix[]
// of the pass (kGlobalA, staged), or rows of a shared tile at a_tile whose
// pixel for the lane's row of m-tile mi is apix[mi] plus the segment's (dy,
// dx) shift, CA chunks per pixel, chunks XORed with the pixel's bits amask.
// kParts (kernel 9): each segment sums into its own zeroed part, then is
// added to acc.  Every address that does not move with the k-tile is
// computed once per pass: the layout is a template parameter, so the copy
// and fragment offsets are shifts and adds.
template <bool kGlobalA, bool kParts, int WN>
__device__ __forceinline__ void gemm_pass(float (&acc)[2][8][4], uint32_t stage, int wr, int wc,
                                          const bf16* __restrict__ w, int N, int Kseg, int n_seg,
                                          int Wp, int np, int rp, int R,
                                          const bf16* __restrict__ x, const int (&xpix)[4],
                                          uint32_t a_tile, const int (&apix)[2], int CA,
                                          int amask) {
  constexpr int WM = 8 / WN, NP = 64 * WN, CB = NP / 8;
  constexpr int kBRows = kThreads / CB;          // weight rows one sweep of the block copies
  constexpr uint32_t kAOff = kKT * NP * 2;       // A part of a stage buffer, after B
  static_assert(kBRows % 8 == 0 && kKT % kBRows == 0, "a thread's chunks share a swizzle");
  const int lane = threadIdx.x % 32, l7 = lane & 7, hi = lane >> 4;
  const int tiles_per_seg = (Kseg + kKT - 1) / kKT, n_tiles = n_seg * tiles_per_seg;
  const int K = n_seg * Kseg;
  const bool live = rp + 32 * wr < R;  // the warp has rows in this pass
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  float part[2][8][4];

  // this thread's copies: weight chunk cb of rows br0 + kBRows j; x chunk ca
  // of rows ar0 + 32 j (row & 7 is the same for all j, so is the swizzle)
  const int cb = threadIdx.x % CB, br0 = threadIdx.x / CB;
  const uint32_t b_dst = (uint32_t)((br0 * CB + (cb ^ (br0 & 7))) * 16);
  const bool b_col_ok = np + 8 * cb < N;
  const bf16* b_src = w + (size_t)br0 * N + np + 8 * cb;
  // staged x rows are 64 bytes (4 chunks): chunk c of row r sits at c ^ ((r
  // >> 1) & 3), so the 8 rows one ldmatrix matrix reads hit 8 bank groups
  constexpr int kACh = kKT / 8;
  const int ca = threadIdx.x % kACh, ar0 = threadIdx.x / kACh;
  const uint32_t a_dst = kAOff + (uint32_t)((ar0 * kACh + (ca ^ ((ar0 >> 1) & 3))) * 16);
  // fragment offsets: B rows 16 ks + (lane & 7) + 8 ((lane >> 3) & 1), chunk
  // (64 wc + 16 dp) / 8 + hi, swizzled by lane & 7; staged A rows 32 wr + 16
  // mi + (lane & 15), chunk 2 ks + hi, swizzled by ((lane & 15) >> 1) & 3
  const uint32_t b_row = (uint32_t)((l7 + ((lane >> 3) & 1) * 8) * CB * 16);
  const uint32_t a_row = kAOff + (uint32_t)((32 * wr + (lane & 15)) * kKT * 2);
  const int a_sw = ((lane & 15) >> 1) & 3;

  auto stage_tile = [&](int it, int seg, int kc) {
    const uint32_t buf = stage + (uint32_t)((it % kStages) * kStageBytes);
    const int kb = seg * Kseg + kc;
#pragma unroll
    for (int j = 0; j < kKT / kBRows; ++j) {
      const bool ok = b_col_ok && kb + br0 + kBRows * j < K;
      cp_async16(buf + b_dst + (uint32_t)(j * kBRows * CB * 16),
                 ok ? b_src + (size_t)(kb + kBRows * j) * N : w, ok ? 16 : 0);
    }
    if constexpr (kGlobalA) {
#pragma unroll
      for (int j = 0; j < WM / 2; ++j) {  // kThreads / kACh = 64 rows per sweep
        const bool ok = rp + ar0 + 64 * j < R && kc + 8 * ca < Kseg;
        cp_async16(buf + a_dst + (uint32_t)(j * 64 * kKT * 2),
                   ok ? x + (size_t)xpix[j] * Kseg + kc + 8 * ca : x, ok ? 16 : 0);
      }
    }
  };

  auto mma_tile = [&](float (&d)[2][8][4], int it, int seg, int kc) {
    const uint32_t buf = stage + (uint32_t)((it % kStages) * kStageBytes);
    const int steps = min(kKT, Kseg - kc) / 16;
    uint32_t a_base[2] = {0, 0};
    int a_x[2] = {0, 0};
    if constexpr (!kGlobalA) {
      const int shift = (seg / 3) * Wp + seg % 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int pix = apix[mi] + shift;
        a_base[mi] = a_tile + (uint32_t)(pix * CA * 16);
        a_x[mi] = pix & amask;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) {
      if (ks < steps) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (kGlobalA) {
            ldsm_x4(a[mi], buf + a_row + (uint32_t)(mi * 16 * kKT * 2) +
                               (uint32_t)((((2 * ks) + hi) ^ a_sw) * 16));
          } else {
            ldsm_x4(a[mi], a_base[mi] + (uint32_t)((((kc >> 3) + 2 * ks + hi) ^ a_x[mi]) * 16));
          }
        }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          if (np + 64 * wc + 16 * dp < N) {
            uint32_t b[4];
            ldsm_x4_trans(b, buf + (uint32_t)(ks * 16 * CB * 16) + b_row +
                                 (uint32_t)((((8 * wc + 2 * dp) + hi) ^ l7) * 16));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(d[mi][2 * dp], a[mi], b[0], b[1]);
              mma_bf16(d[mi][2 * dp + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
    }
  };

  // (seg, kc) of the tile being multiplied and of the next one to stage
  int seg = 0, kc = 0, nseg = 0, nkc = 0;
  auto advance = [&](int& sg, int& k) {
    k += kKT;
    if (k >= Kseg) {
      k = 0;
      ++sg;
    }
  };
  // prologue: tiles 0..kStages-2 (one commit group each, empty past the end)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      stage_tile(i, nseg, nkc);
      advance(nseg, nkc);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it have landed
    // every thread's copies of tile it are visible, and every warp is done
    // with tile it-1, whose buffer the next copy refills
    __syncthreads();
    if (it + kStages - 1 < n_tiles) {
      stage_tile(it + kStages - 1, nseg, nkc);
      advance(nseg, nkc);
    }
    cp_async_commit();
    if (live) {
      if constexpr (kParts) {
        if (kc == 0) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[mi][j][e] = 0.f;
        }
        mma_tile(part, it, seg, kc);
        if (kc + kKT >= Kseg) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
        }
      } else {
        mma_tile(acc, it, seg, kc);
      }
    }
    advance(seg, kc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before the next pass refills it
}

// The epilogue of a pass: for each of the thread's four rows inside the pass
// (row < R), info = row_info(row) once, then f(info, mi, j, hh, col, v0, v1)
// for each accumulator pair acc[mi][j][2hh], acc[mi][j][2hh + 1] whose column
// (even) is < N.
template <typename RowF, typename F>
__device__ __forceinline__ void epilogue(const float (&acc)[2][8][4], int rp, int np, int wr,
                                         int wc, int R, int N, RowF row_info, F f) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rp + 32 * wr + 16 * mi + g + 8 * hh;
      if (row >= R) continue;
      const auto info = row_info(row);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = np + 64 * wc + 8 * j + 2 * t;
        if (col < N) f(info, mi, j, hh, col, acc[mi][j][2 * hh], acc[mi][j][2 * hh + 1]);
      }
    }
}

__device__ __forceinline__ float2 bias2(const float* b, int col) {
  return *reinterpret_cast<const float2*>(b + col);
}

// The lane's row of m-tile mi in a pass, clamped into [0, R).
__device__ __forceinline__ int lane_row(int rp, int wr, int mi, int R) {
  return min(rp + 32 * wr + 16 * mi + ((int)threadIdx.x % 32 & 15), R - 1);
}

// Runs body(std::integral_constant<int, WN>) for the layout's WN.
template <typename Body>
__device__ __forceinline__ void with_layout(const Layout L, Body body) {
  if (L.wn == 1) body(std::integral_constant<int, 1>());
  else if (L.wn == 2) body(std::integral_constant<int, 2>());
  else body(std::integral_constant<int, 4>());
}

template <bool kDownsample, bool kShifted>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, Cin = p.Cin, M = p.M, Cout = p.Cout, S = p.S, G = p.G;
  const Strip st{H, W, S, G, W + 2, (int)blockIdx.x * S, (int)blockIdx.y * G};
  const bf16* __restrict__ x = static_cast<const bf16*>(p.x);
  bf16* __restrict__ out = static_cast<bf16*>(p.out);
  const int CM = M / 8;  // 16-byte chunks per y1 / y2 pixel
  const int mmask = swizzle_mask(CM);
  const uint32_t y1_bytes = (uint32_t)(G * (S + 2) * st.Wp * M * 2);
  const uint32_t y1s = smem_u32(smem);           // [G][S+2][W+2][M], swizzled by pixel
  const uint32_t y2s = y1s + y1_bytes;           // [G][S][W][M], swizzled by pixel
  const uint32_t stage = y2s + (uint32_t)(G * S * W * M * 2);  // the ring of stage buffers
  unsigned char* y1p = smem;
  unsigned char* y2p = smem + y1_bytes;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int R1 = G * (S + 2) * W, R2 = G * S * W;  // conv1 rows (halo strip), conv2/3 rows
  float acc[2][8][4];
  int xpix[4];  // x pixel of the staged rows tid / 4 + 64 j of a pass
  int apix[2] = {0, 0};

  // border columns 0 and W+1 of every y1 row: zeros
  for (int i = threadIdx.x; i < G * (S + 2) * 2 * CM; i += kThreads) {
    const int c = i % CM, rc = i / CM;
    const int pix = (rc / 2) * st.Wp + ((rc & 1) ? W + 1 : 0);
    *reinterpret_cast<uint4*>(y1p + pix * CM * 16 + c * 16) = make_uint4(0, 0, 0, 0);
  }

  // ---- phase 1: y1 = relu(x @ w1 + b1) on the strip and its halo rows,
  // zero outside the image, into the y1 tile
  {
    const Layout L = pick_layout(R1, M, Cin, Cin);
    const int wr = warp % L.wm, wc = warp / L.wm;
    for (int rp = 0; rp < R1; rp += 32 * L.wm) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xpix[j] = st.x_pix(min(rp + (int)threadIdx.x / 4 + 64 * j, R1 - 1), true);
      for (int np = 0; np < M; np += 64 * L.wn) {
        with_layout(L, [&](auto wn) {
          constexpr int WN = decltype(wn)::value;
          gemm_pass<true, false, WN>(acc, stage, wr, wc, static_cast<const bf16*>(p.w1), M, Cin,
                                     1, st.Wp, np, rp, R1, x, xpix, 0, apix, 0, 0);
        });
        float2 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bias2(p.b1, min(np + 64 * wc + 8 * j + 2 * t, M - 2));
        // row -> (y1 pixel, inside the image), the pixel -1 outside
        epilogue(acc, rp, np, wr, wc, R1, M, [&](int row) {
          int gi, rr, cx;
          st.halo(row, gi, rr, cx);
          const bool inside = st.r0 - 1 + rr >= 0 && st.r0 - 1 + rr < H;
          const int pix = (gi * (S + 2) + rr) * st.Wp + cx + 1;
          return inside ? pix : -1 - pix;
        }, [&](int info, int, int j, int, int col, float v0, float v1) {
          const int pix = info >= 0 ? info : -1 - info;
          *reinterpret_cast<uint32_t*>(y1p + pix * CM * 16 + (((col >> 3) ^ (pix & mmask)) << 4) +
                                       (col & 7) * 2) =
              info >= 0 ? pack_bf16(fmaxf(v0 + b[j].x, 0.f), fmaxf(v1 + b[j].y, 0.f)) : 0u;
        });
      }
    }
  }

  // ---- phase 2: y2 = relu(conv3x3(y1) + b2) into the y2 tile; A straight
  // from the y1 tile at each lane's window corner plus the shift
  {
    const Layout L = pick_layout(R2, M, 9 * M, 0);
    const int wr = warp % L.wm, wc = warp / L.wm;
    for (int rp = 0; rp < R2; rp += 32 * L.wm) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        int gi, s, col;
        st.pixel(lane_row(rp, wr, mi, R2), gi, s, col);
        apix[mi] = (gi * (S + 2) + s) * st.Wp + col;
      }
      for (int np = 0; np < M; np += 64 * L.wn) {
        with_layout(L, [&](auto wn) {
          constexpr int WN = decltype(wn)::value;
          gemm_pass<false, kShifted, WN>(acc, stage, wr, wc, static_cast<const bf16*>(p.w2), M,
                                         M, 9, st.Wp, np, rp, R2, x, xpix, y1s, apix, CM, mmask);
        });
        float2 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bias2(p.b2, min(np + 64 * wc + 8 * j + 2 * t, M - 2));
        epilogue(acc, rp, np, wr, wc, R2, M, [&](int row) { return row; },
                 [&](int pix, int, int j, int, int col, float v0, float v1) {
          *reinterpret_cast<uint32_t*>(y2p + pix * CM * 16 + (((col >> 3) ^ (pix & mmask)) << 4) +
                                       (col & 7) * 2) =
              pack_bf16(fmaxf(v0 + b[j].x, 0.f), fmaxf(v1 + b[j].y, 0.f));
        });
      }
    }
  }

  // ---- phase 3: out = relu(T(T(y2 @ w3 + b3) + res)), res = x or
  // T(x @ wd + bd), to device memory
  {
    const Layout L = pick_layout(R2, Cout, M + (kDownsample ? Cin : 0), kDownsample ? Cin : 0);
    const int wr = warp % L.wm, wc = warp / L.wm;
    for (int rp = 0; rp < R2; rp += 32 * L.wm) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) apix[mi] = lane_row(rp, wr, mi, R2);
      for (int np = 0; np < Cout; np += 64 * L.wn) {
        // the residual as bf16 pairs: the downsample product, rounded, or x,
        // loaded before the conv3 product so the loads overlap it
        uint32_t res[2][8][2];
        if constexpr (!kDownsample) {
          const int lane = threadIdx.x % 32;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = rp + 32 * wr + 16 * mi + (lane >> 2) + 8 * hh;
              if (row >= R2) continue;
              const size_t px = (size_t)st.x_pix(row, false) * Cin;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = np + 64 * wc + 8 * j + 2 * t;
                if (col < Cout) res[mi][j][hh] = *reinterpret_cast<const uint32_t*>(x + px + col);
              }
            }
        } else {
          // recomputed per column pass, so that xpix is not live beside res
          // in the conv3 product (registers)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xpix[j] = st.x_pix(min(rp + (int)threadIdx.x / 4 + 64 * j, R2 - 1), false);
          with_layout(L, [&](auto wn) {
            constexpr int WN = decltype(wn)::value;
            gemm_pass<true, false, WN>(acc, stage, wr, wc, static_cast<const bf16*>(p.wd), Cout,
                                       Cin, 1, st.Wp, np, rp, R2, x, xpix, 0, apix, 0, 0);
          });
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 b = bias2(p.bd, min(np + 64 * wc + 8 * j + 2 * t, Cout - 2));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              res[mi][j][0] = pack_bf16(acc[mi][j][0] + b.x, acc[mi][j][1] + b.y);
              res[mi][j][1] = pack_bf16(acc[mi][j][2] + b.x, acc[mi][j][3] + b.y);
            }
          }
        }
        with_layout(L, [&](auto wn) {
          constexpr int WN = decltype(wn)::value;
          gemm_pass<false, false, WN>(acc, stage, wr, wc, static_cast<const bf16*>(p.w3), Cout,
                                      M, 1, st.Wp, np, rp, R2, x, xpix, y2s, apix, CM, mmask);
        });
        float2 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = bias2(p.b3, min(np + 64 * wc + 8 * j + 2 * t, Cout - 2));
        // row -> its pixel in out
        epilogue(acc, rp, np, wr, wc, R2, Cout,
                 [&](int row) { return (size_t)st.x_pix(row, false); },
                 [&](size_t pix, int mi, int j, int hh, int col, float v0, float v1) {
          const __nv_bfloat162 y3 = __floats2bfloat162_rn(v0 + b[j].x, v1 + b[j].y);
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&res[mi][j][hh]);
          const float2 a = __bfloat1622float2(y3), c = __bfloat1622float2(r);
          *reinterpret_cast<uint32_t*>(out + pix * Cout + col) =
              pack_bf16(fmaxf(__bfloat162float(__float2bfloat16(a.x + c.x)), 0.f),
                        fmaxf(__bfloat162float(__float2bfloat16(a.y + c.y)), 0.f));
        });
      }
    }
  }
}

// The block's dynamic shared memory: the y1 and y2 tiles of the activation
// dtype, and in bf16 the ring of stage buffers.
size_t smem_bytes(int W, int M, int S, int G, int dtype) {
  const size_t tiles = (size_t)G * (S + 2) * (W + 2) * M + (size_t)G * S * W * M;
  return dtype == 0 ? tiles * sizeof(float) : tiles * 2 + kStages * kStageBytes;
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int B, int dtype, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.W, p.M, p.S, p.G, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H / p.S, B / p.G);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Channel counts: multiples of 8 in f32 (8-element vectors), of 16 in bf16
// (the k16 step of mma.sync); B * H * W pixels fit an int.
bool shape_ok(int B, int H, int W, int Cin, int M, int Cout, int S, int G, int dtype) {
  if (B <= 0 || H <= 0 || W <= 0 || S <= 0 || G <= 0) return false;
  if (H % S || B % G || B / G > 65535 || (long long)B * H * W > 0x7fffffff) return false;
  const int vec = dtype == 0 ? 8 : 16;
  if (Cin % vec || M % vec || Cout % vec || Cin <= 0 || M <= 0 || Cout <= 0) return false;
  if (dtype != 0 && dtype != 1) return false;
  return smem_bytes(W, M, S, G, dtype) <= (size_t)kSmemLimit;
}

template <bool kDownsample, bool kShifted>
int dispatch(const Params& p, int B, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(bottleneck_f32_kernel<kDownsample, kShifted>, p, B, dtype, st);
  return launch(bottleneck_tc_kernel<kDownsample, kShifted>, p, B, dtype, st);
}

}  // namespace

extern "C" {

// Kernel 8.  x [B, H, W, Cin], w1 [Cin, M], w2 [9M, M], w3 [M, Cout] and wd
// [Cin, Cout] (or NULL) of the activation dtype; biases f32; out
// [B, H, W, Cout].  H % strip == 0, B % images_per_cell == 0, channel
// counts multiples of 8 (f32) or 16 (bf16), Cin == Cout without a
// downsample, 16-byte aligned operands.  dtype: 0 = float32, 1 = bfloat16.
int bottleneck_gemm_forward(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* w3, const void* b3, const void* wd,
                            const void* bd, void* out, int B, int H, int W, int Cin, int M,
                            int Cout, int strip, int images_per_cell, int dtype,
                            void* stream) {
  if (!shape_ok(B, H, W, Cin, M, Cout, strip, images_per_cell, dtype))
    return (int)cudaErrorInvalidValue;
  if ((wd == nullptr) != (bd == nullptr) || (wd == nullptr && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  const Params p{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
                 w3, static_cast<const float*>(b3), wd, static_cast<const float*>(bd),
                 out, H, W, Cin, M, Cout, strip, images_per_cell};
  if (wd != nullptr) return dispatch<true, false>(p, B, dtype, stream);
  return dispatch<false, false>(p, B, dtype, stream);
}

// Kernel 9.  x [B, H, W, C], w1 [C, M], w2 [9M, M], w3 [M, C] of the
// activation dtype; biases f32; out [B, H, W, C]; one image per block and
// H % strip == 0.
int bottleneck_shifted_forward(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* w3, const void* b3, void* out,
                               int B, int H, int W, int C, int M, int strip, int dtype,
                               void* stream) {
  if (!shape_ok(B, H, W, C, M, C, strip, 1, dtype)) return (int)cudaErrorInvalidValue;
  const Params p{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
                 w3, static_cast<const float*>(b3), nullptr, nullptr, out,
                 H, W, C, M, C, strip, 1};
  return dispatch<false, true>(p, B, dtype, stream);
}

}  // extern "C"
