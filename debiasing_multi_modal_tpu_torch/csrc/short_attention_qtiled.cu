// q-tiled merged-head self-attention for Hopper (sm_90a): kernel 2.
//
// Replaces the TPU kernel debiasing_multi_modal_tpu/ops/short_attention.py::
// _qtiled_kernel, the mode the JAX package takes when a whole-row cell does
// not fit VMEM (ViT-L/14@336px in f32, S=577, D=1024).  Same function as
// kernel 1 (csrc/short_attention.cu): q, k, v, o are [B, S, D] merged-head,
// f32 logits scaled by hd^-0.5, causality from global query positions, an
// exact whole-row softmax (w = e / sum(e), no online rescaling of the
// output), the probabilities rounded to the input dtype before an
// f32-accumulated P.V.
//
// What the TPU kernel keeps and this one cannot: the whole K/V slab resident
// per cell.  At f32 S=577 hd=64 one head's K_h plus V_h is ~300 KB, over the
// 227 KB a block may use.  So one block per (query tile, head, image) streams
// K_h and V_h through shared memory in key tiles.  The ragged S edge is
// masked, never padded in device memory; a causal tile streams only the keys
// its last row sees.
//
// f32 (attention_f32.cuh, f32_attn_kernel<HD, MQ, Bufs, KT>): kernel 1's
// f32 device code with K and V streamed, so where both kernels take an f32
// shape their outputs agree bit for bit.  Register tiles on the CUDA cores,
// fed by 16-byte shared loads; 16-byte cp.async copies.  The tile by S
// (f32attn::streamed_tile): 64 query rows with two 128-key K/V buffers where
// they fit, then 32 rows with two 64-key buffers, then 32 rows with one; the
// f32 score rows of the tile stay in shared memory, which is what bounds S.
// What bounds it on the H100: ~4*S*hd FMA flops per query row against its
// share of K/V, so the FMA pipe, fed at this design's limit by the
// shared-memory pipe.
//
// bf16 (qtiled_tc_kernel below): kernel 1's two-pass tensor-core path
// (attention_tc.cuh: chunk_scores, to_exp) with K_h and V_h streamed, not
// resident.  One block of 8 warps per (128 query rows, head, image), one warp
// per 16 rows, its Q fragments loaded once by ldmatrix and held in registers.
// The block streams 64-key chunks, K alone for pass 1 and K with V for pass
// 2, through a three-stage ring of 16-byte cp.async copies into the
// XOR-swizzled layout ldmatrix reads (rows past S zero-filled, so 0 * garbage
// never makes a NaN), one block barrier per chunk.  Pass 1: Q.K^T on
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators), the row max and sum
// kept online in registers by quad shuffles.  Pass 2: the logits again, w =
// e / sum rounded to bf16 (the TPU kernel's rounding point), packed from the
// accumulators straight into A fragments, times V by ldmatrix.trans into f32
// accumulators, stored as packed bf16 pairs.  A causal block streams the
// chunks its last row sees and each warp skips those wholly above its
// diagonal.  The chunk order, the 16-row warp tiles and the device functions
// are kernel 1's, so where kernel 1 also takes its two-pass path (S > 80 at
// hd 32/64, S > 32 at hd 128) the two are equal bit for bit.  Shared memory
// (the Q tile and three stages of K and V) no longer grows with S: 64 KB at
// hd 64, so two blocks share an SM.  What bounds it on the H100: at S=1025
// the two passes take 6 flops per (query, key, head dim), 25.8 GFLOP at
// ViT-L/14@448's B=4 D=1024, 0.026 ms at the bf16 tensor-core peak, and two
// exponentials per (query, key), 0.034 ms at the SFU rate; each 128-row
// tile reads K twice and V once from L2 (~230 MB at that shape).  Measured
// (PERF.md), it issues mma.sync at about a quarter of the dense peak, as
// the flash kernels do: the exact softmax's second pass is the price of the
// TPU kernel's rounding point.  Pass 2 takes each chunk in two 32-key
// halves, which keeps hd 64 at two blocks per SM without spilling.
//
// The gate (ops/short_attention.py::supported_qtiled): in f32 shared memory
// (f32attn::streamed_smem_bytes, mirrored by qtiled_smem_bytes); in bf16 the
// largest S the first CUDA-core design took (1,750 / 1,686 / 1,558 at hd 32 /
// 64 / 128), kept so that longer rows go on to the flash kernels, which have
// a backward kernel (this kernel's backward is the plain VJP, which would
// build the S^2 matrix).
//
// C interface for ctypes, as in short_attention.cu.

#include "attention_f32.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using namespace dmt;
using namespace dmt::attn_tc;
using bf16 = __nv_bfloat16;

constexpr int kQRows = 128;                 // query rows per bf16 block
constexpr int kQWarps = kQRows / 16;        // one warp per 16 rows
constexpr int kQThreads = kQWarps * 32;
constexpr int kChunk = kChunkKeys2Pass;     // keys per streamed chunk
constexpr int kRing = 3;                    // stages of the K/V ring: two chunks in flight

// hd <= 64: two blocks of 8 warps per SM (registers capped at 128); hd 128
// keeps up to 255 for its 32 Q-fragment and 64 accumulator registers.
template <int HD> constexpr int qtiled_min_blocks() { return HD == 128 ? 1 : 2; }

// The Q tile plus kRing stages of one K chunk and one V chunk.
template <int HD> constexpr size_t qtiled_smem_bytes_bf16() {
  return (size_t)(kQRows + kRing * 2 * kChunk) * HD * 2;
}

template <int HD>
__global__ void __launch_bounds__(kQThreads, qtiled_min_blocks<HD>())
qtiled_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int S, int D, int causal, float scale_log2) {
  constexpr int kRowBytes = HD * 2;
  constexpr int NT = kChunk / 8;
  constexpr uint32_t kChunkBytes = kChunk * kRowBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t ring = q_s + kQRows * kRowBytes;  // each stage: a K chunk, then a V chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kQRows;

  // this warp's rows r0 + [0, 16): the keys they see, as in kernel 1
  const int r0 = q0 + 16 * warp;
  const bool live = r0 < S;
  const int key_end = causal ? min(S, r0 + 16) : S;
  const int n_ks = (key_end + 15) / 16;
  const int n_chunks = (n_ks + NT / 2 - 1) / (NT / 2);
  const int mask_from = causal ? r0 : S;
  // the block's chunks (its last row's), streamed once per pass: step s <
  // nc is K chunk s (pass 1), step s >= nc K and V chunk s - nc (pass 2)
  const int nc = ((causal ? min(S, q0 + kQRows) : S) + kChunk - 1) / kChunk;
  const int n_steps = 2 * nc;
  // row r of this (image, head) in q, k, v or o: recomputed from blockIdx
  // where used, which keeps registers for the fragments
  auto at = [&](int r) { return ((size_t)blockIdx.z * S + r) * D + (size_t)blockIdx.y * HD; };
  auto issue = [&](int step) {
    const uint32_t buf = ring + (uint32_t)(step % kRing) * 2 * kChunkBytes;
    const int key0 = (step < nc ? step : step - nc) * kChunk;
    stage_rows<HD>(buf, k + at(key0), kChunk, S - key0, D, threadIdx.x, kQThreads);
    if (step >= nc)
      stage_rows<HD>(buf + kChunkBytes, v + at(key0), kChunk, S - key0, D, threadIdx.x,
                     kQThreads);
  };

  // the Q tile and step 0 (group 0), then steps 1 .. kRing - 2: one commit
  // group each, empty past the end
  stage_rows<HD>(q_s, q + at(q0), kQRows, S - q0, D, threadIdx.x, kQThreads);
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < n_steps) issue(i);
    cp_async_commit();
  }

  // the top of every step: this step's copies landed for every thread, every
  // warp is done with the last step (whose buffer the next copy refills),
  // then step + kRing - 1 is issued
  auto begin_step = [&](int step) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (step + kRing - 1 < n_steps) issue(step + kRing - 1);
    cp_async_commit();
  };
  // K of chunk c, staged by step: its rows c*64 + [0, 64) indexed by key,
  // as chunk_scores indexes kernel 1's resident K_h (64 rows keep the
  // swizzle's row bits)
  auto chunk_k = [&](int step, int c) {
    return ring + (uint32_t)(step % kRing) * 2 * kChunkBytes - (uint32_t)c * kChunkBytes;
  };

  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[HD / 16][4];  // A fragments of Q, head dims 16 at a time
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // pass 1: row max and sum (rows g and g + 8 of the tile), chunk by chunk
  for (int c = 0; c < nc; ++c) {
    begin_step(c);
    if (c == 0) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        ldsm_x4(qf[kd], q_s + swz<HD>(16 * warp + (lane & 15), 2 * kd + (lane >> 4)));
    }
    if (!live || c >= n_chunks) continue;  // warp-uniform
    float sc[NT][4];
    chunk_scores<HD, NT>(sc, qf, chunk_k(c, c), c, n_ks, r0, S, causal, mask_from, lane);
    float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      c0 = fmaxf(c0, fmaxf(sc[j][0], sc[j][1]));
      c1 = fmaxf(c1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
    l0 *= exp2f((m0 - n0) * scale_log2);
    l1 *= exp2f((m1 - n1) * scale_log2);
    m0 = n0;
    m1 = n1;
    to_exp<NT>(sc, m0 * scale_log2, m1 * scale_log2, scale_log2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      l0 += sc[j][0] + sc[j][1];
      l1 += sc[j][2] + sc[j][3];
    }
  }

  // pass 2: the logits again, w = e / sum rounded to bf16, P.V into f32
  // accumulators; each chunk in two halves of 32 keys (registers), which
  // keeps kernel 1's sums: the logits of a key step do not depend on the
  // others, and P.V still adds the key steps in order
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    begin_step(nc + c);
    if (!live || c >= n_chunks) continue;
    const uint32_t k_s = chunk_k(nc + c, c), v_s = k_s + kChunkBytes;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sc[NT / 2][4];
      chunk_scores<HD, NT / 2>(sc, qf, k_s, 2 * c + half, n_ks, r0, S, causal, mask_from, lane);
      to_exp<NT / 2>(sc, m0 * scale_log2, m1 * scale_log2, scale_log2);
#pragma unroll
      for (int jp = 0; jp < NT / 4; ++jp) {
        const int ks = (2 * c + half) * (NT / 4) + jp;
        if (ks >= n_ks) continue;
        uint32_t pa[4];  // A fragment of P: keys ks*16 + [0, 16)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 2 * jp + hh;
          pa[2 * hh] = pack_bf16(sc[j][0] * inv0, sc[j][1] * inv0);
          pa[2 * hh + 1] = pack_bf16(sc[j][2] * inv1, sc[j][3] * inv1);
        }
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          // V rows ks*16 + [0, 8) and [8, 16), head dims dp*16 + [0, 8) and [8, 16)
          uint32_t vb[4];
          ldsm_x4_trans(vb, v_s + swz<HD>(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          2 * dp + (lane >> 4)));
          mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

  const int row0 = r0 + g, row1 = r0 + g + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(o + at(row0) + col) = pack_bf16(acc[j][0], acc[j][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(o + at(row1) + col) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int D,
                int H, int causal, cudaStream_t stream) {
  constexpr size_t smem = qtiled_smem_bytes_bf16<HD>();
  auto kernel = qtiled_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kQRows - 1) / kQRows, H, B);
  kernel<<<grid, kQThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, D, causal, kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int D, int H, int causal, cudaStream_t stream) {
  switch (D / H) {
    case 32: return launch_bf16<32>(q, k, v, o, B, S, D, H, causal, stream);
    case 64: return launch_bf16<64>(q, k, v, o, B, S, D, H, causal, stream);
    case 128: return launch_bf16<128>(q, k, v, o, B, S, D, H, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int D, int H, int causal, cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (D / H) {
    case 32: return f32attn::launch_streamed<32>(qf, kf, vf, of, B, S, H, D, D, causal, stream);
    case 64: return f32attn::launch_streamed<64>(qf, kf, vf, of, B, S, H, D, D, causal, stream);
    case 128:
      return f32attn::launch_streamed<128>(qf, kf, vf, of, B, S, H, D, D, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; both need 16-byte aligned base pointers.
int short_attention_qtiled_forward(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int D, int H,
                                   int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D % H) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, B, S, D, H, causal, st);
  if (dtype == 0) return dispatch_f32(q, k, v, o, B, S, D, H, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
