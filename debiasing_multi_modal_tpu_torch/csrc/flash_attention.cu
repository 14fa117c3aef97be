// Blockwise (flash) attention for Hopper (sm_90a): kernels 4, 5 and 6.
//
// Replaces the TPU kernels of debiasing_multi_modal_tpu/ops/flash_attention.py:
//   kernel 4  flash_fwd_kernel  <- _attn_fwd_kernel  (forward + row logsumexp)
//   kernel 5  flash_dq_kernel   <- _bwd_dq_kernel    (dQ)
//   kernel 6  flash_dkv_kernel  <- _bwd_dkv_kernel   (dK and dV)
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
// Design: one block of 256 threads per (64-row tile, head, image).  Kernels 4
// and 5 own a q tile and stream 64-key K/V tiles through shared memory;
// kernel 6 owns a kv tile and streams q/dO tiles.  No block writes another's
// output, so there are no atomics and every result is the same bit for bit
// from run to run (a rematerialized step gets the gradients of a plain one).
// The 16x16 threads each own 4 rows x 4 columns of the 64x64 score tile
// (rows ty + 16i, columns tx + 16j) and 4 rows x hd/16 columns of the
// [64, hd] accumulators (columns tx + 16t); the 16 threads of a row group are
// one half-warp, so row max and row sum are four shuffles.  Staged tiles are
// f32 with rows padded by one word, so each inner step is conflict-free
// shared-memory loads: 8 loads per 16 FMAs for q.k^T (16 per 32 in the
// backward's paired products).
//
// What bounds it on the H100: at the training shapes (S=50/77, hd=64) each
// kernel moves ~4-8 B*S*D elements against ~4-8 B*H*S^2*hd flops, 10-40
// flops per byte in bf16, under the ~295 the tensor cores need, so the
// bound is bytes; at S=4096 the bound is operations (989 TFLOP/s bf16).
// This first version runs on CUDA-core FMAs fed from shared memory, so it
// is bound by those loads at every shape; the design's answer to the bytes
// bound is that every input element crosses device memory once per tile
// pass and no [Sq, Skv] tensor ever reaches it.  Tensor cores (mma.sync or
// wgmma) and TMA are later work.
//
// Shared memory (fwd/dq/dkv_smem_bytes below, mirrored by
// ops/flash_attention.py) is the gate for supported(): it depends on hd
// only, and hd <= 128 fits every kernel.
//
// C interface for ctypes, as in short_attention.cu: each entry launches on
// the given stream, allocates nothing, does not synchronize, and returns
// cudaGetLastError() (0 on success).

#include "common.cuh"

namespace {

using namespace dmt;

constexpr int kTile = 64;            // q rows per q tile, keys per kv tile
constexpr int kSide = 16;            // the 16x16 thread grid of a block
constexpr int kPer = kTile / kSide;  // rows (and columns) of a tile per thread
constexpr int kLdS = kTile + 1;      // padded row of a staged 64x64 f32 tile
constexpr float kNegInf = -1e30f;

static_assert(kSide * kSide == kThreads, "one thread per 4x4 cell of a tile");

__host__ __device__ constexpr int ld_of(int hd) { return hd + 1; }

size_t fwd_smem_bytes(int hd) {  // q, k, v tiles + p tile
  return (3 * (size_t)kTile * ld_of(hd) + (size_t)kTile * kLdS) * sizeof(float);
}
size_t dq_smem_bytes(int hd) {  // q, dO, k, v tiles + ds tile
  return (4 * (size_t)kTile * ld_of(hd) + (size_t)kTile * kLdS) * sizeof(float);
}
size_t dkv_smem_bytes(int hd) {  // k, v, q, dO tiles + p^T, ds^T tiles + lse, delta
  return (4 * (size_t)kTile * ld_of(hd) + 2 * (size_t)kTile * kLdS + 2 * kTile) *
         sizeof(float);
}

// Rows [row0, row0 + n) of one head (rows `stride` elements apart) into a
// [kTile][HD + 1] f32 tile; rows n..kTile-1 become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int n, size_t stride) {
  constexpr int ld = ld_of(HD);
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    dst[r * ld + d] = r < n ? to_f32(src[(size_t)(row0 + r) * stride + d]) : 0.f;
  }
}

// Reductions over the 16 threads of a row group (one half-warp).
__device__ __forceinline__ float group_max(float x) {
  for (int off = kSide / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = kSide / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// ---------------------------------------------------------------- kernel 4 --
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int causal,
                 float scale) {
  constexpr int ld = ld_of(HD);
  constexpr int kCols = HD / kSide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kTile][ld]
  float* ks = qs + kTile * ld;                      // [kTile][ld]
  float* vs = ks + kTile * ld;                      // [kTile][ld]
  float* ps = vs + kTile * ld;                      // [kTile][kLdS]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t stride = (size_t)H * HD;
  const size_t q_base = ((size_t)b * Sq * H + h) * HD;
  const size_t kv_base = ((size_t)b * Skv * H + h) * HD;
  const int nq = min(kTile, Sq - q0);
  // keys any row of this tile sees
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;

  stage<T, HD>(qs, q + q_base, q0, nq, stride);

  float m[kPer], l[kPer], acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[i][t] = 0.f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    const int nk = min(kTile, kv_end - j0);
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    stage<T, HD>(ks, k + kv_base, j0, nk, stride);
    stage<T, HD>(vs, v + kv_base, j0, nk, stride);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = qs[(ty + kSide * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kv[j] = ks[(tx + kSide * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax of this thread's 4 rows
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kSide * i;
      const int q_pos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kSide * j;
        const bool ok = c < nk && (!causal || j0 + c <= q_pos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        // p rounds to v's dtype before P.V; the sum l keeps it unrounded
        ps[r * kLdS + tx + kSide * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[i][t] *= corr;
    }
    __syncthreads();  // the p tile is complete

    for (int c = 0; c < nk; ++c) {
      float pv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = ps[(ty + kSide * i) * kLdS + c];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const float vv = vs[c * ld + tx + kSide * t];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][t] = fmaf(pv[i], vv, acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSide * i;
    if (r >= nq) continue;
    // every real row sees key 0, so l > 0
    const size_t row = q_base + (size_t)(q0 + r) * stride;
#pragma unroll
    for (int t = 0; t < kCols; ++t) o[row + tx + kSide * t] = from_f32<T>(acc[i][t] / l[i]);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + q0 + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------- kernel 5 --
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int Sq, int Skv, int H, int causal,
                float scale) {
  constexpr int ld = ld_of(HD);
  constexpr int kCols = HD / kSide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kTile][ld]
  float* dos = qs + kTile * ld;                     // [kTile][ld]
  float* ks = dos + kTile * ld;                     // [kTile][ld]
  float* vs = ks + kTile * ld;                      // [kTile][ld]
  float* dss = vs + kTile * ld;                     // [kTile][kLdS]

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t stride = (size_t)H * HD;
  const size_t q_base = ((size_t)b * Sq * H + h) * HD;
  const size_t kv_base = ((size_t)b * Skv * H + h) * HD;
  const size_t stat_base = ((size_t)b * H + h) * Sq;
  const int nq = min(kTile, Sq - q0);
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;

  stage<T, HD>(qs, q + q_base, q0, nq, stride);
  stage<T, HD>(dos, dout + q_base, q0, nq, stride);
  float row_lse[kPer], row_delta[kPer], acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSide * i;
    row_lse[i] = r < nq ? lse[stat_base + q0 + r] : 0.f;
    row_delta[i] = r < nq ? delta[stat_base + q0 + r] : 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[i][t] = 0.f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    const int nk = min(kTile, kv_end - j0);
    __syncthreads();  // the previous tile is consumed
    stage<T, HD>(ks, k + kv_base, j0, nk, stride);
    stage<T, HD>(vs, v + kv_base, j0, nk, stride);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = qs[(ty + kSide * i) * ld + d];
        dov[i] = dos[(ty + kSide * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        kv[j] = ks[(tx + kSide * j) * ld + d];
        vv[j] = vs[(tx + kSide * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kSide * j;
        const bool ok = r < nq && c < nk && (!causal || j0 + c <= q0 + r);
        const float p = ok ? expf(scale * s[i][j] - row_lse[i]) : 0.f;
        // ds rounds to k's dtype before ds.k
        dss[r * kLdS + c] = round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    }
    __syncthreads();  // the ds tile is complete

    for (int c = 0; c < nk; ++c) {
      float dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = dss[(ty + kSide * i) * kLdS + c];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const float kk = ks[c * ld + tx + kSide * t];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][t] = fmaf(dsv[i], kk, acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSide * i;
    if (r >= nq) continue;
    const size_t row = q_base + (size_t)(q0 + r) * stride;
#pragma unroll
    for (int t = 0; t < kCols; ++t) dq[row + tx + kSide * t] = from_f32<T>(acc[i][t]);
  }
}

// ---------------------------------------------------------------- kernel 6 --
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
                 int causal, float scale) {
  constexpr int ld = ld_of(HD);
  constexpr int kCols = HD / kSide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kTile][ld]
  float* vs = ks + kTile * ld;                      // [kTile][ld]
  float* qs = vs + kTile * ld;                      // [kTile][ld]
  float* dos = qs + kTile * ld;                     // [kTile][ld]
  float* pts = dos + kTile * ld;                    // [kTile][kLdS], p^T
  float* dsts = pts + kTile * kLdS;                 // [kTile][kLdS], ds^T
  float* lse_s = dsts + kTile * kLdS;               // [kTile]
  float* delta_s = lse_s + kTile;                   // [kTile]

  const int j0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const size_t stride = (size_t)H * HD;
  const size_t q_base = ((size_t)b * Sq * H + h) * HD;
  const size_t kv_base = ((size_t)b * Skv * H + h) * HD;
  const size_t stat_base = ((size_t)b * H + h) * Sq;
  const int nk = min(kTile, Skv - j0);

  stage<T, HD>(ks, k + kv_base, j0, nk, stride);
  stage<T, HD>(vs, v + kv_base, j0, nk, stride);
  float dk_acc[kPer][kCols], dv_acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int t = 0; t < kCols; ++t) dk_acc[i][t] = dv_acc[i][t] = 0.f;

  // a causal kv tile starts at the q tile holding its diagonal: rows above
  // see none of its keys
  const int start = causal ? (j0 / kTile) * kTile : 0;
  for (int q0 = start; q0 < Sq; q0 += kTile) {
    const int nq = min(kTile, Sq - q0);
    __syncthreads();  // the previous q tile is consumed (and ks, vs staged)
    stage<T, HD>(qs, q + q_base, q0, nq, stride);
    stage<T, HD>(dos, dout + q_base, q0, nq, stride);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      lse_s[r] = r < nq ? lse[stat_base + q0 + r] : 0.f;
      delta_s[r] = r < nq ? delta[stat_base + q0 + r] : 0.f;
    }
    __syncthreads();

    // this thread: keys c = ty + 16i (rows of k), queries r = tx + 16j
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[kPer], vv[kPer], qv[kPer], dov[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        kv[i] = ks[(ty + kSide * i) * ld + d];
        vv[i] = vs[(ty + kSide * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        qv[j] = qs[(tx + kSide * j) * ld + d];
        dov[j] = dos[(tx + kSide * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = tx + kSide * j;
        const bool ok = r < nq && c < nk && (!causal || j0 + c <= q0 + r);
        const float p = ok ? expf(scale * s[i][j] - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        pts[c * kLdS + r] = round_to<T>(p);    // p rounds to dO's dtype
        dsts[c * kLdS + r] = round_to<T>(ds);  // ds rounds to q's dtype
      }
    }
    __syncthreads();  // the p^T and ds^T tiles are complete

    for (int r = 0; r < nq; ++r) {
      float pv[kPer], dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = pts[(ty + kSide * i) * kLdS + r];
        dsv[i] = dsts[(ty + kSide * i) * kLdS + r];
      }
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const float dov = dos[r * ld + tx + kSide * t];
        const float qv = qs[r * ld + tx + kSide * t];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          dv_acc[i][t] = fmaf(pv[i], dov, dv_acc[i][t]);
          dk_acc[i][t] = fmaf(dsv[i], qv, dk_acc[i][t]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = ty + kSide * i;
    if (c >= nk) continue;
    const size_t row = kv_base + (size_t)(j0 + c) * stride;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      dk[row + tx + kSide * t] = from_f32<T>(dk_acc[i][t]);
      dv[row + tx + kSide * t] = from_f32<T>(dv_acc[i][t]);
    }
  }
}

// ---------------------------------------------------------------- launches --
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int Sq, int Skv, int H, int causal, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(HD);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Skv, H, causal,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Skv, int H, int causal, cudaStream_t st) {
  const size_t smem = dq_smem_bytes(HD);
  auto kernel = flash_dq_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Skv, H, causal,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Sq, int Skv, int H, int causal, cudaStream_t st) {
  const size_t smem = dkv_smem_bytes(HD);
  auto kernel = flash_dkv_kernel<T, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Skv + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, H, causal, 1.0f / sqrtf((float)HD));
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
