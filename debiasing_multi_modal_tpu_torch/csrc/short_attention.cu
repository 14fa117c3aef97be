// Whole-row merged-head self-attention for Hopper (sm_90a): kernel 1 and its
// packed variant, kernel 3.
//
// Replaces the TPU kernels debiasing_multi_modal_tpu/ops/short_attention.py::
// _short_attn_kernel (whole-row branch, merge=1) and ::_packed_attn_kernel.
// Same function:
//   q, k, v, o are [B, S, D] in merged-head layout; head h is the column
//   slice [h*hd, (h+1)*hd).  logits = (q_h . k_h) * hd^-0.5 in f32, an
//   optional causal mask built from positions, an exact whole-row softmax,
//   probabilities cast to the input dtype, then P.V with f32 accumulation,
//   written straight into the head's column slice of o.  No transposes on
//   either side, and the logits never reach device memory.
//   The packed variant reads q, k and v from one [B, S, 3D] slab (the fused
//   in-projection GEMM's output) at column offsets 0, D and 2D: the same
//   device code with an input row stride of 3D, so no split copies exist.
//
// What bounds it on the H100: at the text-tower shape (S=77, D=512, hd=64)
// and the ViT-B/32 shape (S=50, D=768, hd=64) it is memory-bound (4*B*S*D
// elements of q/k/v/o against ~4*B*S^2*D flops, 13-19 flops per byte in
// bf16, far under the ~295 the tensor cores need).  The design therefore
// reads every input element from device memory once: one block per (q-tile,
// head, image) stages that head's K_h and V_h ([S, hd], read as strided rows)
// in shared memory, and with S <= kRowsPerBlock one tile covers the whole
// row, so K/V are loaded exactly once.  Each warp then owns one query row at
// a time: lanes split the keys for the scores (f32), warp shuffles give the
// row max and sum, and lanes split the head dims for P.V.  The shared-memory
// rows are padded by one 32-bit word so a warp reading 32 rows hits 32 banks.
//
// This is the simple, right first version: CUDA-core FMAs, no wgmma or TMA.
// The shared-memory footprint (smem_bytes below, mirrored by
// ops/short_attention.py::smem_bytes) is the gate for supported_whole_row()
// and supported_packed().
//
// C interface for ctypes: each entry launches on the given stream, allocates
// nothing, does not synchronize, and returns cudaGetLastError() (0 on
// success).

#include "common.cuh"

namespace {

using namespace dmt;

constexpr int kRowsPerBlock = 128;  // query rows per block (one tile if S<=128)

template <typename T> size_t smem_bytes(int S, int hd) {
  return 2 * (size_t)S * padded_ld<T>(hd) * sizeof(T)      // K_h, V_h
         + (size_t)kWarps * (S + hd) * sizeof(float);     // per-warp scores + q row
}

// q, k, v point at head 0 of row 0 of image 0; their rows are ld_in elements
// apart (D, or 3D for the packed slab).  o's rows are ld_out (= D) apart.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
short_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  int S, int ld_in, int ld_out, int causal, float scale) {
  constexpr int ld = padded_ld<T>(HD);
  constexpr int kPerLane = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + (size_t)S * ld;
  float* warp_buf = reinterpret_cast<float*>(vs + (size_t)S * ld);

  const int tile0 = blockIdx.x * kRowsPerBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)b * S * ld_in + (size_t)h * HD;
  const size_t out_base = (size_t)b * S * ld_out + (size_t)h * HD;

  // Causal rows of this tile see keys [0, last row]; stage only those.
  const int row_end = min(tile0 + kRowsPerBlock, S);
  const int n_stage = causal ? row_end : S;
  for (int idx = threadIdx.x; idx < n_stage * HD; idx += kThreads) {
    const int j = idx / HD, d = idx % HD;
    const size_t g = base + (size_t)j * ld_in + d;
    ks[j * ld + d] = k[g];
    vs[j * ld + d] = v[g];
  }
  __syncthreads();

  float* sc = warp_buf + (size_t)warp * (S + HD);  // this warp's scores
  float* qs = sc + S;                               // this warp's query row

  for (int r = tile0 + warp; r < row_end; r += kWarps) {
    const size_t row = base + (size_t)r * ld_in;
    for (int d = lane; d < HD; d += 32) qs[d] = to_f32(q[row + d]);
    __syncwarp();
    const int n_keys = causal ? r + 1 : S;

    // scores: lanes split the keys; f32 dot over the head dim, then scale
    float m = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) {
      const T* kr = ks + j * ld;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) acc = fmaf(qs[d], to_f32(kr[d]), acc);
      acc *= scale;
      sc[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e = expf(sc[j] - m);
      sc[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // probabilities, rounded to the input dtype as the TPU kernel does
    for (int j = lane; j < n_keys; j += 32) sc[j] = to_f32(from_f32<T>(sc[j] / sum));
    __syncwarp();

    // P.V: lanes split the head dims; f32 accumulation
    float acc[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc[t] = 0.f;
    for (int j = 0; j < n_keys; ++j) {
      const float p = sc[j];
      const T* vr = vs + j * ld;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) acc[t] = fmaf(p, to_f32(vr[lane + 32 * t]), acc[t]);
    }
    const size_t out_row = out_base + (size_t)r * ld_out;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) o[out_row + lane + 32 * t] = from_f32<T>(acc[t]);
    __syncwarp();  // qs and sc are rewritten by this warp's next row
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
           int ld_in, int ld_out, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S, HD);
  auto kernel = short_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, S, ld_in, ld_out, causal,
                                           1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// q/k/v column offsets: 0/0/0 with row stride D (separate tensors), or
// 0/D/2D with row stride 3D (the packed slab).
template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int D, int H, int ld_in, int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (D / H) {
    case 32: return launch<T, 32>(qt, kt, vt, ot, B, S, H, ld_in, D, causal, stream);
    case 64: return launch<T, 64>(qt, kt, vt, ot, B, S, H, ld_in, D, causal, stream);
    case 128: return launch<T, 128>(qt, kt, vt, ot, B, S, H, ld_in, D, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int forward(const void* q, const void* k, const void* v, void* o, int B, int S,
            int D, int H, int ld_in, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D % H) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, D, H, ld_in, causal, st);
  if (dtype == 0) return dispatch_hd<float>(q, k, v, o, B, S, D, H, ld_in, causal, st);
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
