// int8 x int8 -> int32 GEMM with a fused f32 dequantization epilogue for
// Hopper (sm_90a): kernel 7.
//
// Replaces the TPU kernel debiasing_multi_modal_tpu/ops/quant_gemm.py::_body
// (the W8A8 backstop behind quant="int8_pallas").  Same function:
//   out[m, n] = ((float(acc[m, n]) * sx[m]) * sk[n] (+ bias[n])) cast to the
//   output dtype, acc = sum_k qx[m, k] * qk[k, n] in exact int32,
// in the JAX kernel's association (quant_gemm.py:43-46), with the last
// multiply and the bias add as one fused multiply-add that rounds once, as
// XLA fuses the JAX epilogue; the explicit round-to-nearest intrinsics keep
// the compiler from fusing anything else.  The int32 accumulator lives in
// registers and never reaches device memory.
//
// Layout: qx is [M, K] row-major; the weight arrives as qkT = [N, K]
// row-major (the wrapper's layout, which is torch's [out, in] Linear weight
// quantized per row), so both operands are K-contiguous, exactly the "row" A
// and "col" B that mma.sync.m16n8k32.row.col.s32.s8.s8.s32 takes.  K is a
// multiple of kBK (the wrapper pads with zeros, which add exact zeros), N a
// multiple of kBN (every CLIP Dense width is), and ragged M is masked: rows
// past M load as zeros and are never stored.
//
// What bounds it on the H100: at the ViT-B/32 c_fc shape (M=12,800 tokens,
// K=768, N=3,072) it does 2*M*N*K = 60 GOP against ~61 MB of bytes, about
// 1,000 operations per byte: bound by the int8 tensor cores (1,979 TOP/s
// dense), not by memory.  The design feeds the tensor cores through
// mma.sync (the warp-level instruction, simpler than wgmma) from one
// 128 x 128 output tile per block of 8 warps, each warp holding a 64 x 32
// int32 accumulator (16 mma tiles) in registers, over K tiles of 64 bytes
// staged in shared memory.  Shared-memory rows are padded by 16 bytes so the
// fragment loads (8 rows x 4 words per warp) hit 32 distinct banks.  There
// is no pipelining of the global loads (no cp.async or TMA) and no wgmma:
// the simple, right first version.
//
// C interface for ctypes: int8_matmul_forward launches on the given stream,
// allocates nothing, does not synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 64;           // K bytes per shared-memory stage
constexpr int kLds = kBK + 16;    // padded shared-memory row, bytes
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;        // rows per warp
constexpr int kWarpN = 32;        // columns per warp
constexpr int kMi = kWarpM / 16;  // m16 tiles per warp
constexpr int kNi = kWarpN / 8;   // n8 tiles per warp

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qkT,
                 const float* __restrict__ sx, const float* __restrict__ sk,
                 const float* __restrict__ bias, OutT* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * kWarpM;  // this warp's rows within the tile
  const int wn = (warp % 4) * kWarpN;  // and columns
  const int g = lane >> 2;             // mma groupID
  const int t = lane & 3;              // mma threadID_in_group

  int acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage the A and B tiles: 128 rows x 64 bytes each, 16 bytes a thread
#pragma unroll
    for (int c = tid; c < kBM * kBK / 16; c += kThreads) {
      const int row = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
      const int gm = m0 + row;
      int4 a = make_int4(0, 0, 0, 0);
      if (gm < M) a = *reinterpret_cast<const int4*>(qx + (size_t)gm * K + k0 + col);
      *reinterpret_cast<int4*>(As + row * kLds + col) = a;
      *reinterpret_cast<int4*>(Bs + row * kLds + col) =
          *reinterpret_cast<const int4*>(qkT + (size_t)(n0 + row) * K + k0 + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMi][4], b[kNi][2];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const int8_t* r = As + (wm + i * 16 + g) * kLds + kk + t * 4;
        a[i][0] = lds32(r);                 // row g,   k t*4..t*4+3
        a[i][1] = lds32(r + 8 * kLds);      // row g+8
        a[i][2] = lds32(r + 16);            // row g,   k 16+t*4..
        a[i][3] = lds32(r + 8 * kLds + 16); // row g+8, k 16+t*4..
      }
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int8_t* r = Bs + (wn + j * 8 + g) * kLds + kk + t * 4;
        b[j][0] = lds32(r);       // column g, k t*4..t*4+3
        b[j][1] = lds32(r + 16);  // column g, k 16+t*4..
      }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: fma(float(acc) * sx[m], sk[n], bias[n]), or the plain product
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + 8 * half;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          const float a = __fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), s);
          store(out + (size_t)m * N + n,
                bias != nullptr ? __fmaf_rn(a, sk[n], bias[n]) : __fmul_rn(a, sk[n]));
        }
      }
    }
  }
}

template <typename OutT>
int launch(const void* qx, const void* qkT, const float* sx, const float* sk,
           const float* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(qkT), sx, sk,
      bias, static_cast<OutT*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qx [M, K] int8, qkT [N, K] int8, sx [M] f32, sk [N] f32, bias [N] f32 or
// NULL, out [M, N].  K % 64 == 0, N % 128 == 0, 16-byte aligned operands.
// out_dtype: 0 = float32, 1 = bfloat16.
int int8_matmul_forward(const void* qx, const void* qkT, const void* sx,
                        const void* sk, const void* bias, void* out, int M,
                        int N, int K, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN || K % kBK) return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const float* skf = static_cast<const float*>(sk);
  const float* bf = static_cast<const float*>(bias);
  if (out_dtype == 0) return launch<float>(qx, qkT, sxf, skf, bf, out, M, N, K, st);
  if (out_dtype == 1) return launch<__nv_bfloat16>(qx, qkT, sxf, skf, bf, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
