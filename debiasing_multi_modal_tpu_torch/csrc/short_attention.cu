// Whole-row merged-head self-attention for Hopper (sm_90a): kernel 1 and its
// packed variant, kernel 3.
//
// Replaces the TPU kernels debiasing_multi_modal_tpu/ops/short_attention.py::
// _short_attn_kernel (whole-row branch, merge=1) and ::_packed_attn_kernel.
// Same function:
//   q, k, v, o are [B, S, D] in merged-head layout; head h is the column
//   slice [h*hd, (h+1)*hd).  logits = (q_h . k_h) * hd^-0.5 in f32, an
//   optional causal mask built from positions, an exact whole-row softmax,
//   probabilities w = e / sum(e) rounded to the input dtype, then P.V with
//   f32 accumulation, written straight into the head's column slice of o.
//   No transposes on either side, and the logits never reach device memory.
//   The packed variant reads q, k and v from one [B, S, 3D] slab (the fused
//   in-projection GEMM's output) at column offsets 0, D and 2D: the same
//   device code with an input row stride of 3D, so its output is kernel 1's
//   bit for bit.
//
// What bounds it on the H100: at the text-tower shape (S=77, D=512, hd=64)
// and the ViT-B/32 shape (S=50, D=768, hd=64) it is memory-bound: 4*B*S*D
// elements of q/k/v/o against ~4*B*S^2*D flops, 13-19 flops per byte in
// bf16, far under the ~295 the tensor cores need.  So the design reads every
// input byte from device memory once and keeps enough bytes in flight.
//
// bf16 (short_attn_tc_kernel): one block per (head, image), grid (H, B),
// with one warp per 16 query rows (at most kMaxWarps; a warp takes every
// n_warps-th row tile).  The block stages that head's K_h and V_h ([S, hd],
// rows past S zero-filled, so 0 * garbage never makes a NaN) and each warp
// its 16 query rows, all with 16-byte cp.async.cg copies issued at once, in
// an XOR-swizzled layout that ldmatrix reads without bank conflicts (no row
// padding, so K_h and V_h of the largest S fit).  Products run on the
// tensor cores with mma.sync.m16n8k16 (bf16 operands, f32 accumulators,
// exactly the TPU's rounding model): S = Q.K^T from ldmatrix fragments (K
// rows are the col-major B as stored); the row max and sum are quad
// shuffles; the normalized probabilities are rounded to bf16 and packed from
// the accumulator layout straight into A fragments (no trip through shared
// memory); V comes in by ldmatrix.trans; O accumulates in f32 registers and
// is stored as packed bf16 pairs.  The scale is folded into exp2f on the f32
// logits (scale * log2 e), never into a bf16 Q.  A row tile's scores stay in
// registers when its keys fit one chunk of 8*NT keys (NT = 4, 8 or 10 at
// hd <= 64: S <= 80 covers the text and ViT-B/32 shapes); longer rows take
// two passes over 64-key chunks of the staged K_h (row max and sum, then the
// logits again, normalized, rounded and multiplied into V), which keeps the
// TPU's rounding point at no extra device-memory bytes (attention_tc.cuh:
// kernel 2 runs the same two passes with K and V streamed, so where both
// take them their bf16 outputs are equal bit for bit).  Causal row tiles
// skip the key steps wholly above their diagonal and mask inside it; keys
// past S are masked to -inf.
//
// Why mma.sync and not wgmma: wgmma takes 64-row M tiles per warpgroup, which
// at S=50 and S=77 wastes 22-40 % of the rows, and the tensor cores are not
// the limit here: a 0.03-0.04 ms kernel at these shapes needs ~80-100 TFLOP/s,
// far below what mma.sync gives.  TMA is not needed at these tile sizes.
//
// f32 (attention_f32.cuh, f32_attn_kernel<HD, MQ, 0, 128>): CUDA-core FMAs
// fed from registers.  One block of 256 threads per (tile of MQ query rows,
// head, image): 32 rows up to S = 128, 64 past it where they fit.  It stages
// the keys its rows see of K_h and V_h (16-byte cp.async, swizzled rows) and
// its q rows, all at once; each thread computes a register tile of logits,
// the warps run the exact softmax on the stored f32 score rows, and each
// thread a register tile of P.V.  f32 on the tensor cores would be TF32,
// which breaks the f32 limit against the plain version; kernel 2 runs the
// same device code with K and V streamed, so in f32 the two agree bit for
// bit.
//
// Shared memory (smem_bytes_bf16 below and f32attn::resident_smem_bytes,
// mirrored by ops/short_attention.py::smem_bytes) is the gate for supported_whole_row()
// and supported_packed().
//
// C interface for ctypes: each entry launches on the given stream, allocates
// nothing, does not synchronize, and returns cudaGetLastError() (0 on
// success).  Both entries need 16-byte aligned base pointers (the wrapper
// checks).

#include "attention_f32.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using namespace dmt;
using namespace dmt::attn_tc;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16, tensor cores

template <int HD> struct TcTraits {
  static constexpr int kMaxWarps = HD == 128 ? 4 : 8;    // 16 query rows each
  static constexpr int kRowBytes = HD * 2;
};

__host__ __device__ constexpr int round16(int s) { return (s + 15) / 16 * 16; }

// Most warps a block of one instantiation runs: the one-chunk instantiations
// (NT = 4, 10) serve S <= 8*NT only.  Each instantiation's register cap is
// then ~128 (two 8-warp blocks, three 5-warp ones, eight 2-warp ones per
// SM); hd 128 keeps up to 255 (201 used) and two 4-warp blocks.
template <int HD, int NT> constexpr int tc_max_warps() {
  return NT == 8 || NT / 2 > TcTraits<HD>::kMaxWarps ? TcTraits<HD>::kMaxWarps : NT / 2;
}
template <int HD, int NT> constexpr int tc_min_blocks() {
  return HD == 128 ? 2 : 65536 / (tc_max_warps<HD, NT>() * 32 * 128);
}

template <int HD> __host__ __device__ inline int tc_warps(int S) {
  const int tiles = round16(S) / 16;
  return tiles < TcTraits<HD>::kMaxWarps ? tiles : TcTraits<HD>::kMaxWarps;
}

// K_h and V_h (rows rounded up to 16) plus one 16-row Q tile per warp.
template <int HD> size_t smem_bytes_bf16(int S) {
  return 2 * (size_t)round16(S) * TcTraits<HD>::kRowBytes
         + (size_t)tc_warps<HD>(S) * 16 * TcTraits<HD>::kRowBytes;
}

// q, k, v point at head 0 of row 0 of image 0; their rows are ld_in elements
// apart (D, or 3D for the packed slab).  o's rows are ld_out (= D) apart.
template <int HD, int NT>
__global__ void __launch_bounds__(tc_max_warps<HD, NT>() * 32, tc_min_blocks<HD, NT>())
short_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int S, int ld_in, int ld_out, int causal, float scale_log2) {
  constexpr int kRowBytes = TcTraits<HD>::kRowBytes;
  // NT = 4 and 10 serve only rows that fit one chunk: Q's fragments are then
  // dead after pass 1, which keeps the registers under the cap
  constexpr bool kOneChunk = NT != kChunkKeys2Pass / 8;
  static_assert(NT % 2 == 0, "key chunks are whole 16-key steps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int S16 = round16(S);
  const int n_rt = S16 / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const uint32_t k_s = smem_u32(smem_raw);
  const uint32_t v_s = k_s + S16 * kRowBytes;
  const uint32_t q_s = v_s + S16 * kRowBytes + warp * 16 * kRowBytes;

  const int h = blockIdx.x, b = blockIdx.y;
  const size_t in_base = (size_t)b * S * ld_in + (size_t)h * HD;
  const bf16* qb = q + in_base;
  bf16* ob = o + (size_t)b * S * ld_out + (size_t)h * HD;

  // K_h and this warp's first Q tile (group 0), then V_h (group 1): every
  // input byte of the block is in flight before any compute
  stage_rows<HD>(k_s, k + in_base, S16, S, ld_in, threadIdx.x, blockDim.x);
  stage_rows<HD>(q_s, qb + (size_t)warp * 16 * ld_in, 16, S - warp * 16, ld_in, lane, 32);
  cp_async_commit();
  stage_rows<HD>(v_s, v + in_base, S16, S, ld_in, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  bool v_ready = false;
  for (int rt = warp; rt < n_rt; rt += n_warps) {
    const int r0 = rt * 16;
    if (rt != warp) {  // the tile this warp prefetched last iteration
      cp_async_wait<0>();
      __syncwarp();
    }
    uint32_t qf[HD / 16][4];  // A fragments of Q, head dims 16 at a time
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd)
      ldsm_x4(qf[kd], q_s + swz<HD>(lane & 15, 2 * kd + (lane >> 4)));
    __syncwarp();
    if (rt + n_warps < n_rt) {  // prefetch the next tile into the freed buffer
      const int nr0 = r0 + 16 * n_warps;
      stage_rows<HD>(q_s, qb + (size_t)nr0 * ld_in, 16, S - nr0, ld_in, lane, 32);
    }
    cp_async_commit();

    const int key_end = causal ? min(S, r0 + 16) : S;  // keys this tile sees
    const int n_ks = (key_end + 15) / 16;
    const int n_chunks = kOneChunk ? 1 : (n_ks + NT / 2 - 1) / (NT / 2);
    const int mask_from = causal ? r0 : S;

    // pass 1: row max and sum (rows g and g + 8 of the tile)
    float sc[NT][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      chunk_scores<HD, NT>(sc, qf, k_s, c, n_ks, r0, S, causal, mask_from, lane);
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
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

    if (!v_ready) {  // every warp runs its first tile, so every thread gets here once
      cp_async_wait<0>();
      __syncthreads();
      v_ready = true;
    }

    // pass 2: w = e / sum rounded to bf16, then P.V into f32 accumulators
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      // one chunk: sc already holds its e with the row's max
      if (!kOneChunk && n_chunks > 1) {
        chunk_scores<HD, NT>(sc, qf, k_s, c, n_ks, r0, S, causal, mask_from, lane);
        to_exp<NT>(sc, m0 * scale_log2, m1 * scale_log2, scale_log2);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int ks = c * (NT / 2) + jp;
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

    const int row0 = r0 + g, row1 = r0 + g + 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * ld_out + col) = pack_bf16(acc[j][0], acc[j][1]);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * ld_out + col) = pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

template <int HD, int NT>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<HD>(S);
  auto kernel = short_attn_tc_kernel<HD, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  kernel<<<grid, tc_warps<HD>(S) * 32, smem, stream>>>(
      q, k, v, o, S, ld_in, ld_out, causal, kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// The key chunk: the whole row in registers up to 80 keys (hd <= 64), else
// two passes over 64-key chunks.
template <int HD>
int dispatch_chunk(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                   int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
  if (S <= 32) return launch_bf16<HD, 4>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  if constexpr (HD <= 64) {
    if (S > kChunkKeys2Pass && S <= 80)
      return launch_bf16<HD, 10>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  }
  return launch_bf16<HD, kChunkKeys2Pass / 8>(q, k, v, o, B, S, H, ld_in, ld_out, causal,
                                              stream);
}

// ---------------------------------------------------------- f32, CUDA cores
// (attention_f32.cuh: register tiles, K_h and V_h resident)

// ------------------------------------------------------------------ dispatch

// q/k/v column offsets: 0/0/0 with row stride D (separate tensors), or
// 0/D/2D with row stride 3D (the packed slab).
template <typename T, template <int> class Launch>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
                int D, int H, int ld_in, int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (D / H) {
    case 32: return Launch<32>::run(qt, kt, vt, ot, B, S, H, ld_in, D, causal, stream);
    case 64: return Launch<64>::run(qt, kt, vt, ot, B, S, H, ld_in, D, causal, stream);
    case 128: return Launch<128>::run(qt, kt, vt, ot, B, S, H, ld_in, D, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int HD> struct LaunchBf16 {
  static int run(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S, int H,
                 int ld_in, int ld_out, int causal, cudaStream_t stream) {
    return dispatch_chunk<HD>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  }
};
template <int HD> struct LaunchF32 {
  static int run(const float* q, const float* k, const float* v, float* o, int B, int S,
                 int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
    return f32attn::launch_resident<HD>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  }
};

int forward(const void* q, const void* k, const void* v, void* o, int B, int S,
            int D, int H, int ld_in, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D % H) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_hd<bf16, LaunchBf16>(q, k, v, o, B, S, D, H, ld_in, causal, st);
  if (dtype == 0)
    return dispatch_hd<float, LaunchF32>(q, k, v, o, B, S, D, H, ld_in, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel 1.  dtype: 0 = float32, 1 = bfloat16.
int short_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int D, int H, int causal,
                            int dtype, void* stream) {
  return forward(q, k, v, o, B, S, D, H, D, causal, dtype, stream);
}

// Kernel 3: qkv is [B, S, 3D] (q | k | v along the last axis), o is [B, S, D].
int short_attention_packed_forward(const void* qkv, void* o, int B, int S,
                                   int D, int H, int causal, int dtype,
                                   void* stream) {
  const size_t off = (size_t)D * (dtype == 1 ? 2 : 4);  // D elements, in bytes
  const char* base = static_cast<const char*>(qkv);
  return forward(base, base + off, base + 2 * off, o, B, S, D, H, 3 * D, causal,
                 dtype, stream);
}

}  // extern "C"
