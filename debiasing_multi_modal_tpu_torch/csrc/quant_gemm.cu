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
// quantized per row), so both operands are K-contiguous: the K-major A and B
// that the 8-bit wgmma requires.  K is a multiple of kBK (the wrapper pads
// with zeros, which add exact zeros), N a multiple of kBN (every CLIP Dense
// width is), and ragged M is masked: rows past M load as zeros through TMA's
// out-of-bounds fill and are never stored.
//
// What bounds it on the H100: at the ViT-B/32 c_fc shape (M=12,800 tokens,
// K=768, N=3,072) it does 2*M*N*K = 60 GOP against ~88 MB of bytes (the bf16
// output is 79 MB of it), about 690 operations per byte: bound by the int8
// tensor cores (1,979 TOP/s dense, 0.0305 ms), with the output store at
// ~0.023 ms of memory time close behind.  The design:
//   - products: wgmma.mma_async m64n128k32 s8.s8 -> s32, both operands read
//     from shared memory through descriptors (128-byte swizzle, K-major);
//   - one 128 x 128 output tile per block: two consumer warpgroups, each
//     m64 x n128 with its 64 int32 accumulators per thread in registers;
//   - one producer warp whose one thread keeps TMA loads
//     (cp.async.bulk.tensor.2d, mbarrier::complete_tx) in flight into a
//     ring of kStages stages of 128-byte K steps (A and B, 32 KB a stage);
//     consumers wait on each stage's full barrier and release it on its
//     empty barrier once the wgmmas that read it have completed, keeping
//     one wgmma group in flight;
//   - the epilogue stages the tile through shared memory (the drained ring)
//     and writes each output row with coalesced 16-byte stores;
//   - ~97 KB of shared memory, 288 threads and 96 registers a thread, so
//     two blocks share an SM and one block's epilogue overlaps the other's
//     products (bf16 output; the f32 output's epilogue needs more
//     registers and runs one block per SM).
// What holds it back at c_fc (0.081 ms, 2.65x the bound): each block reads
// (128 + 128) x K bytes of operands from L2 for 128 x 128 x K products, so
// the 2,400 blocks pull ~470 MB through L2 against 79 MB of output to
// device memory.  A 128 x 256 tile (one block per SM, 128 accumulators a
// thread) measured slower at c_fc and q/k/v, 5 % faster at c_proj; TMA
// multicast across a cluster, or a persistent grid that overlaps one
// tile's epilogue with the next tile's loads, are the next steps.
// The activation's tensor map is encoded per call on the host; the
// weight's, a function of (pointer, N, K) alone, is cached.
//
// C interface for ctypes: int8_matmul_forward launches on the given stream,
// allocates nothing, does not synchronize, and returns cudaGetLastError().
// The tensor maps are encoded through the runtime's driver entry point, so
// the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

using namespace dmt;

constexpr int kBM = 128;             // output rows per block: two warpgroups of 64
constexpr int kBN = 128;             // output columns per block
constexpr int kBK = 128;             // K bytes per ring stage: one swizzled 128-byte row
constexpr int kStages = 3;           // ring depth
constexpr int kConsumerWarps = 8;    // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr uint32_t kTileBytes = kBM * kBK;          // an A (qx) or B (qkT) tile
constexpr uint32_t kStageBytes = 2 * kTileBytes;
constexpr uint32_t kRingBytes = kStages * kStageBytes;
constexpr size_t kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;  // align slack, ring, barriers

static_assert(kBM == kBN, "one tensor-map box shape serves A and B");

// A staged output row, bytes: padded so the accumulator layout's pair stores
// (8 rows x 4 pairs per warp) hit distinct banks.
template <typename OutT> __host__ __device__ constexpr int out_ld() {
  return kBN * (int)sizeof(OutT) + (sizeof(OutT) == 2 ? 16 : 32);
}
static_assert(kBM * out_ld<float>() <= (int)kRingBytes, "the output tile fits the drained ring");

// d[64] += A . B^T, m64n128k32, s8 operands from shared-memory descriptors,
// s32 accumulators: d[4j + 2h + c] is row 16*warp + lane/4 + 8h, column
// 8j + 2*(lane%4) + c of the warpgroup's 64 x 128 tile.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Two neighbouring outputs of one row into the staged tile.
__device__ __forceinline__ void store_pair(unsigned char* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair_bf16(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Two blocks per SM cap ptxas at 96 registers, where the f32-output
// epilogue spills: that instantiation runs one block per SM.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, sizeof(OutT) == 2 ? 2 : 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap b_map,
                       const float* __restrict__ sx, const float* __restrict__ sk,
                       const float* __restrict__ bias, OutT* __restrict__ out,
                       int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  const uint32_t bars = ring + kRingBytes;  // full[s] at bars + 8s, empty[s] after them
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_k = K / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);                 // the producer's arrive + the TMA bytes
      mbar_init(empty(s), kConsumerWarps);   // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ------------------------------------------------ producer warp (TMA)
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(empty(s), phase ^ 1);  // the first pass finds every stage free
        mbar_arrive_expect_tx(full(s), kStageBytes);
        const uint32_t dst = ring + s * kStageBytes;
        tma_load_2d(dst, &a_map, full(s), kt * kBK, m0);
        tma_load_2d(dst + kTileBytes, &b_map, full(s), kt * kBK, n0);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------------------------------- two consumer warpgroups (wgmma)
    const int wg = warp / 4;  // rows 64 * wg .. of the block's tile
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(full(s), phase);
      const uint32_t st = ring + s * kStageBytes;
      const uint64_t da = wgmma_desc_sw128(st + wg * 64 * kBK);
      const uint64_t db = wgmma_desc_sw128(st + kTileBytes);
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes of K per wgmma
        wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      wgmma_wait<1>();  // the previous stage's group is done: release it
      if (kt > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);

    // epilogue: fma(float(acc) * sx[m], sk[n], bias[n]), or the plain
    // product, staged in the drained ring, then stored row by row
    named_bar_sync(1, kConsumerWarps * 32);  // both warpgroups are done with the ring
    constexpr int ld = out_ld<OutT>();
    unsigned char* tile = ring_ptr + wg * 64 * ld;
    const int g = lane >> 2, t = lane & 3;
    const int r = 16 * (warp % 4) + g;  // and r + 8, within the warpgroup's 64 rows
    const int m = m0 + 64 * wg + r;
    const float s0 = m < M ? sx[m] : 0.f, s1 = m + 8 < M ? sx[m + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      const int n = n0 + col;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = __fmul_rn(__int2float_rn(acc[4 * j + e]), e >> 1 ? s1 : s0);
        v[e] = bias != nullptr ? __fmaf_rn(a, sk[n + (e & 1)], bias[n + (e & 1)])
                               : __fmul_rn(a, sk[n + (e & 1)]);
      }
      unsigned char* p = tile + r * ld + col * (int)sizeof(OutT);
      if constexpr (sizeof(OutT) == 2) {
        store_pair_bf16(p, v[0], v[1]);
        store_pair_bf16(p + 8 * ld, v[2], v[3]);
      } else {
        store_pair(p, v[0], v[1]);
        store_pair(p + 8 * ld, v[2], v[3]);
      }
    }
    named_bar_sync(2 + wg, 128);  // this warpgroup's 64 rows are staged
    constexpr int kChunks = kBN * (int)sizeof(OutT) / 16;  // 16-byte chunks per row
    for (int i = threadIdx.x % 128; i < 64 * kChunks; i += 128) {
      const int row = i / kChunks, c = i % kChunks;
      const int gm = m0 + 64 * wg + row;
      if (gm < M)
        *reinterpret_cast<int4*>(reinterpret_cast<unsigned char*>(out + (size_t)gm * N + n0) +
                                 c * 16) = *reinterpret_cast<const int4*>(tile + row * ld + c * 16);
    }
  }
}

// --------------------------------------------------------------- host side --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A [rows, K] int8 row-major operand as a 2-D map, K innermost, read in
// [kBM, kBK] boxes in the 128-byte swizzle; rows past `rows` read as zeros.
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int K) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};  // bytes from one row to the next
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The weight's map, cached: a map is a function of (pointer, rows, K) alone,
// so a hit is exact whatever the tensor holds now.
int weight_map(CUtensorMap* map, const void* ptr, int rows, int K) {
  static std::mutex lock;
  static std::map<std::tuple<uintptr_t, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(ptr), rows, K);
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = encode_rows(map, ptr, rows, K);
  if (err) return err;
  if (cache.size() >= 1024) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

template <typename OutT>
int launch(const CUtensorMap& a, const CUtensorMap& b, const float* sx, const float* sk,
           const float* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  auto kernel = int8_gemm_wgmma_kernel<OutT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a, b, sx, sk, bias, static_cast<OutT*>(out),
                                                 M, N, K);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// qx [M, K] int8, qkT [N, K] int8, sx [M] f32, sk [N] f32, bias [N] f32 or
// NULL, out [M, N].  K % 128 == 0, N % 128 == 0, 16-byte aligned qx, qkT
// and out.  out_dtype: 0 = float32, 1 = bfloat16.
int int8_matmul_forward(const void* qx, const void* qkT, const void* sx,
                        const void* sk, const void* bias, void* out, int M,
                        int N, int K, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN || K % kBK) return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  if (!aligned16(qx) || !aligned16(qkT) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  CUtensorMap a, b;
  int err = encode_rows(&a, qx, M, K);
  if (err) return err;
  err = weight_map(&b, qkT, N, K);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const float* skf = static_cast<const float*>(sk);
  const float* bf = static_cast<const float*>(bias);
  if (out_dtype == 0) return launch<float>(a, b, sxf, skf, bf, out, M, N, K, st);
  if (out_dtype == 1) return launch<__nv_bfloat16>(a, b, sxf, skf, bf, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}

// Host microseconds to encode one activation tensor map (what each call
// pays), averaged over `iters` encodes; negative if encoding fails.
double int8_matmul_encode_us(const void* qx, int M, int K, int iters) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode_rows(&map, qx, M, K)) return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}

}  // extern "C"
