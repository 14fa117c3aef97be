// q-tiled merged-head self-attention for Hopper (sm_90a): kernel 2.
//
// Replaces the TPU kernel debiasing_multi_modal_tpu/ops/short_attention.py::
// _qtiled_kernel, the mode the JAX package takes when a whole-row cell does
// not fit VMEM (ViT-L/14@336px in f32, S=577, D=1024).  Same function as
// kernel 1 (csrc/short_attention.cu): q, k, v, o are [B, S, D] merged-head,
// f32 logits scaled by hd^-0.5, causality from global query positions, an
// exact whole-row softmax (w = e / sum(e), no online rescaling), the
// probabilities rounded to the input dtype before an f32-accumulated P.V.
//
// What the TPU kernel keeps and this one cannot: the whole K/V slab resident
// per cell.  At f32 S=577 hd=64 one head's K_h plus V_h is ~300 KB, over the
// 227 KB a block may use.  So one block per (query tile, head, image) keeps
// only its rows' whole f32 score rows and its query rows in shared memory,
// and K_h, then V_h, stream through 64-key tiles: pass 1 computes every
// score, the softmax runs on the rows in place, pass 2 accumulates P.V in
// registers.  The ragged S edge is masked, never padded in device memory; a
// causal tile streams only the keys its last row sees.
//
// f32 (attention_f32.cuh, f32_attn_kernel<HD, MQ, Bufs, KT>): kernel 1's
// f32 device code with K and V streamed, so where both kernels take an f32
// shape their outputs agree bit for bit.  Register tiles on the CUDA cores,
// fed by 16-byte shared loads; 16-byte cp.async copies, so the inputs need
// 16-byte aligned base pointers.  The tile by S (f32attn::streamed_tile):
// 64 query rows with two 128-key K/V buffers where they fit, then 32 rows
// with two 64-key buffers, then 32 rows with one.  What bounds it on the
// H100: ~4*S*hd FMA flops per query row against its share of K/V, so the
// FMA pipe, fed at this design's limit by the shared-memory pipe.
//
// bf16 (qtiled_attn_kernel below, CUDA cores): it runs only past bf16
// kernel 1's gate (S > 832 at hd 64), where no zoo model is.  One warp owns
// 4 query rows of a 32-row tile; lane j%32 scores key j with an in-order f32
// FMA chain, the row sum is a lane-strided sum and shuffle tree, P.V runs
// over keys in order; K and V pass through one padded 64-key tile.  bf16
// kernel 1 runs on the tensor cores, in another order: there the two agree
// within the bf16 limits, not bit for bit.  It is bound by the shared-memory
// loads that feed its FMAs.
//
// Shared memory (f32attn::streamed_smem_bytes and qtiled_smem_bytes below,
// mirrored by ops/short_attention.py::qtiled_smem_bytes) is the gate for
// supported_qtiled().
//
// C interface for ctypes, as in short_attention.cu.

#include "attention_f32.cuh"
#include "common.cuh"

namespace {

using namespace dmt;

constexpr int kQTile = 32;              // query rows per block
constexpr int kKTile = 64;              // keys per staged K or V tile
constexpr int kRows = kQTile / kWarps;  // query rows per warp

template <typename T> size_t qtiled_smem_bytes(int S, int hd) {
  return (size_t)kQTile * (S + hd) * sizeof(float)            // scores + q rows
         + (size_t)kKTile * padded_ld<T>(hd) * sizeof(T);      // one K/V tile
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
qtiled_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   int S, int D, int causal, float scale) {
  constexpr int ld = padded_ld<T>(HD);
  constexpr int kPerLane = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);       // [kQTile][S] scores
  float* qs = sc + (size_t)kQTile * S;                   // [kQTile][HD] q rows
  T* kv = reinterpret_cast<T*>(qs + kQTile * HD);        // [kKTile][ld] K or V

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)b * S * D + (size_t)h * HD;
  const int n_rows = min(kQTile, S - q0);
  const int n_keys_tile = causal ? q0 + n_rows : S;  // keys any row here sees

  for (int idx = threadIdx.x; idx < kQTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    qs[idx] = r < n_rows ? to_f32(q[base + (size_t)(q0 + r) * D + d]) : 0.f;
  }

  // This warp owns local rows warp + kWarps * i (interleaved, so a causal
  // tile's short and long rows spread over the warps).
  float m[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) m[i] = -INFINITY;

  // pass 1: scores, K streamed tile by tile
  for (int j0 = 0; j0 < n_keys_tile; j0 += kKTile) {
    const int nk = min(kKTile, n_keys_tile - j0);
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int idx = threadIdx.x; idx < nk * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      kv[j * ld + d] = k[base + (size_t)(j0 + j) * D + d];
    }
    __syncthreads();
    for (int jj = lane; jj < nk; jj += 32) {
      const T* kr = kv + jj * ld;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        const float kd = to_f32(kr[d]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i] = fmaf(qs[(warp + kWarps * i) * HD + d], kd, acc[i]);
      }
      const int j = j0 + jj;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
        if (r < n_rows && (!causal || j <= q0 + r)) {
          const float s = acc[i] * scale;
          sc[(size_t)r * S + j] = s;
          m[i] = fmaxf(m[i], s);
        }
      }
    }
  }

  // exact whole-row softmax of this warp's rows, in place
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    if (r >= n_rows) continue;  // warp-uniform
    float* row = sc + (size_t)r * S;
    const int n_keys = causal ? q0 + r + 1 : S;
    const float mx = warp_max(m[i]);
    float sum = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // probabilities, rounded to the input dtype as the TPU kernel does
    for (int j = lane; j < n_keys; j += 32) row[j] = to_f32(from_f32<T>(row[j] / sum));
  }

  // pass 2: P.V, V streamed tile by tile; lanes split the head dims
  float acc[kRows][kPerLane];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc[i][t] = 0.f;
  for (int j0 = 0; j0 < n_keys_tile; j0 += kKTile) {
    const int nk = min(kKTile, n_keys_tile - j0);
    __syncthreads();  // the previous tile is consumed (and every row's p is final)
    for (int idx = threadIdx.x; idx < nk * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      kv[j * ld + d] = v[base + (size_t)(j0 + j) * D + d];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_rows) continue;
      const int n_keys = causal ? q0 + r + 1 : S;
      const int jend = min(nk, n_keys - j0);
      const float* p = sc + (size_t)r * S + j0;
      for (int jj = 0; jj < jend; ++jj) {
        const float pj = p[jj];
        const T* vr = kv + jj * ld;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t)
          acc[i][t] = fmaf(pj, to_f32(vr[lane + 32 * t]), acc[i][t]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    if (r >= n_rows) continue;
    const size_t out_row = base + (size_t)(q0 + r) * D;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) o[out_row + lane + 32 * t] = from_f32<T>(acc[i][t]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int D, int H, int causal, cudaStream_t stream) {
  const size_t smem = qtiled_smem_bytes<T>(S, HD);
  auto kernel = qtiled_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, D, causal,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int D, int H, int causal, cudaStream_t stream) {
  using T = __nv_bfloat16;
  switch (D / H) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, D, H, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, D, H, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, D, H, causal, stream);
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

// dtype: 0 = float32 (16-byte aligned base pointers), 1 = bfloat16.
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
