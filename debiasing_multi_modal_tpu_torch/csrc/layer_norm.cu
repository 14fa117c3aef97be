// LayerNorm over the last axis with f32 statistics, in one pass over device
// memory: the towers' LayerNormF32 (models/layers.py) on the card.
//
// Replaces no TPU kernel.  The JAX package's LayerNormF32
// (debiasing_multi_modal_tpu/models/layers.py) is flax's LayerNorm on an f32
// copy of its input, which XLA fuses with the casts around it.  Eager PyTorch
// ran the same function as four passes over device memory (widen to f32,
// moments, normalize, narrow): ~3.6 GB for one ViT-L/14@336px LayerNorm at
// batch 256, six times the bytes of the function.  Same function:
//   y = (x - mean) * rstd * weight + bias,   rstd = 1 / sqrt(var + eps),
// each row's mean and biased variance in f32, weight and bias the f32
// parameters, y computed in f32 and rounded once to x's dtype (bf16 or f32).
//
// What bounds it on the H100: bytes.  A row of D is read once and written
// once for ~8 D flops, under one flop a byte: 147,712 rows x 1,024 bf16
// (ViT-L/14@336px at batch 256) are 605 MB, 0.18 ms at 3.35 TB/s.  The
// design keeps the card's memory system busy and reads nothing twice:
//   - one warp per row: each lane loads its share of the row as 16-byte
//     vectors, neighbouring lanes on neighbouring addresses (1,024 bf16 is
//     four vectors a lane), and keeps them in registers;
//   - the mean, then the squared deviations from it (two passes over the
//     registers, the most accurate f32 form), each a warp all-reduce by
//     shuffles: the row is never read again;
//   - a persistent grid, as many 8-warp blocks as fit on the SMs: a warp
//     strides over the rows, loads its lanes' weight and bias into
//     registers once (scalar loads: the parameters may be views at any
//     4-byte offset, and a warp reads them once), and issues the next
//     row's loads before it reduces this one, so every warp keeps a row in
//     flight while it computes;
//   - the width a template parameter at the CLIP widths (512, 640, 768,
//     1,024), so the loops unroll and the vectors stay in registers; any
//     other multiple of 8 up to 2,048 takes a generic instance, which reads
//     weight and bias from the cache at each row;
//   - the output written once with 16-byte stores; x's rows may lie any
//     multiple of 16 bytes apart (ln_post's x[:, 0] view is read in place),
//     the output's rows are contiguous.
// On an H100 80GB HBM3 at 700 W it takes 0.214-0.217 ms at ViT-L/14@336px's
// rows, 83-84 % of the bytes bound (CUDA-graph replay, chip_smoke.py).
//
// C interface for ctypes: layer_norm_forward launches on the given stream,
// allocates nothing, does not synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows in flight per block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kGenericMaxWidth = 2048;

// Elements of T in one 16-byte vector.
template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int value = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int value = 8;
};

// Element j of a 16-byte vector, widened to f32 (exact for bf16).
template <typename T>
__device__ __forceinline__ float element(const uint4& v, int j);

template <>
__device__ __forceinline__ float element<float>(const uint4& v, int j) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[j]);
}

template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint4& v, int j) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[j >> 1];
  return __uint_as_float((j & 1) ? (word & 0xffff0000u) : (word << 16));
}

// A 16-byte vector of T from f32 values, each rounded to nearest even once.
__device__ __forceinline__ uint4 pack(const float (&y)[4]) {
  return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]),
                    __float_as_uint(y[3]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint4 pack(const float (&y)[8]) {
  return make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]), pack2(y[6], y[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// kWidth 0 is the generic instance (the width at run time).  bf16 at a CLIP
// width holds 76-128 registers a thread (ptxas, no spills): two blocks (16
// warps) an SM, each warp with a row in flight.
template <typename T, int kWidth>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 2 && kWidth) ? 2 : 1)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ out, int rows, int width,
                      long long x_stride, float eps) {
  constexpr int kN = VecWidth<T>::value;
  constexpr int kVecs = ((kWidth ? kWidth : kGenericMaxWidth) / kN + 31) / 32;  // a lane's
  constexpr bool kParamsInRegisters = kWidth != 0;
  const int d = kWidth ? kWidth : width;
  const int n_vec = d / kN;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int step = gridDim.x * kWarps;
  if (first >= rows) return;

  // A lane's vector v is the row's vector v * 32 + lane; at a CLIP width
  // the first term decides at compile time wherever it can.
  auto live = [&](int v) { return (v + 1) * 32 <= n_vec || v * 32 + lane < n_vec; };
  auto load_row = [&](int row, uint4 (&dst)[kVecs]) {
    const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * x_stride);
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      if (live(v)) dst[v] = __ldg(src + v * 32 + lane);
  };

  float w[kParamsInRegisters ? kVecs * kN : 1];
  float b[kParamsInRegisters ? kVecs * kN : 1];
  if constexpr (kParamsInRegisters) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      if (!live(v)) continue;
      const int col = (v * 32 + lane) * kN;
#pragma unroll
      for (int j = 0; j < kN; ++j)
        w[v * kN + j] = __ldg(weight + col + j), b[v * kN + j] = __ldg(bias + col + j);
    }
  }

  uint4 cur[kVecs], next[kVecs];
  load_row(first, cur);
  for (int row = first; row < rows; row += step) {
    if (row + step < rows) load_row(row + step, next);  // in flight while this row reduces

    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      if (live(v)) {
#pragma unroll
        for (int j = 0; j < kN; ++j) sum += element<T>(cur[v], j);
      }
    const float mean = warp_sum(sum) / static_cast<float>(d);
    float squares = 0.f;
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      if (live(v)) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float c = element<T>(cur[v], j) - mean;
          squares = fmaf(c, c, squares);
        }
      }
    const float var = warp_sum(squares) / static_cast<float>(d);
    const float rstd = 1.f / sqrtf(var + eps);

    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<long long>(row) * d);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      if (!live(v)) continue;
      const int col = (v * 32 + lane) * kN;
      float y[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float wj, bj;
        if constexpr (kParamsInRegisters) {
          wj = w[v * kN + j], bj = b[v * kN + j];
        } else {
          wj = __ldg(weight + col + j), bj = __ldg(bias + col + j);
        }
        y[j] = fmaf((element<T>(cur[v], j) - mean) * rstd, wj, bj);
      }
      dst[v * 32 + lane] = pack(y);
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) cur[v] = next[v];
  }
}

// Blocks of the persistent grid: as many as fit on the card's SMs at once,
// and no more than the rows need.  The occupancy and SM count are read once
// per instance (every card of a process is the same model).
template <typename T, int kWidth>
int launch(const void* x, const float* weight, const float* bias, void* out, int rows, int width,
           long long x_stride, float eps, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_norm_kernel<T, kWidth>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = sms * per_sm;
  }
  const int needed = (rows + kWarps - 1) / kWarps;
  const int blocks = needed < resident ? needed : resident;
  layer_norm_kernel<T, kWidth><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), weight, bias, static_cast<T*>(out), rows, width, x_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* weight, const float* bias, void* out, int rows, int width,
             long long x_stride, float eps, cudaStream_t stream) {
  switch (width) {
    case 512: return launch<T, 512>(x, weight, bias, out, rows, width, x_stride, eps, stream);
    case 640: return launch<T, 640>(x, weight, bias, out, rows, width, x_stride, eps, stream);
    case 768: return launch<T, 768>(x, weight, bias, out, rows, width, x_stride, eps, stream);
    case 1024: return launch<T, 1024>(x, weight, bias, out, rows, width, x_stride, eps, stream);
    default: return launch<T, 0>(x, weight, bias, out, rows, width, x_stride, eps, stream);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x: rows of `width` elements, `x_stride` elements apart, the last axis
// contiguous; weight, bias [width] f32; out [rows, width] contiguous, of x's
// dtype.  width a multiple of 8, at most 2,048; x and out 16-byte aligned,
// x_stride 16 bytes a multiple.  dtype: 0 = float32, 1 = bfloat16.
int layer_norm_forward(const void* x, const void* weight, const void* bias, void* out, int rows,
                       int width, int x_stride, int dtype, float eps, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (rows <= 0 || width <= 0 || width % 8 || width > kGenericMaxWidth || x_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((static_cast<long long>(x_stride) * itemsize) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return dispatch<float>(x, w, b, out, rows, width, x_stride, eps, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, b, out, rows, width, x_stride, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
