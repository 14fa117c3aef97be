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
// Each phase is a small GEMM computed by thread tiles of 4 pixel rows x 8
// channels: f32 FMAs on the CUDA cores, A rows from x (global) or the
// shared tiles, the weights [K, N] read from global memory (they stay in the
// 50 MB L2; the largest, layer4's w2, is 4.7 MB in bf16).  Neighbouring
// lanes take neighbouring channel groups, so a warp's weight loads are
// contiguous and its A loads are broadcasts.  The intermediates never reach
// device memory: the block reads x and the weights and writes out.
//
// What bounds it on the H100: at RN50's stride-1 blocks in bf16, batch 256,
// the block's 2*B*H*W*(Cin*M + 9M^2 + M*Cout [+ Cin*Cout]) operations take
// 0.11 ms at the bf16 tensor-core peak against 0.12-0.25 ms of bytes, so
// the bound is about balanced; this first version runs on CUDA-core FMAs
// (67 TFLOP/s f32 peak), so arithmetic bounds it, at ~15x the tensor-core
// bound or more.  Tensor cores (mma.sync, then wgmma) are the next step.
//
// The shared tiles decide the strip: (G*(S+2)*(W+2)*M + G*S*W*M) elements
// of T must fit the 232,448 bytes a block may use (the Python gate
// ops/conv_gemm.py::smem_bytes mirrors this).
//
// C interface for ctypes: each entry launches on the given stream,
// allocates nothing, does not synchronize, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).

#include "common.cuh"

namespace {

using dmt::from_f32;
using dmt::to_f32;

constexpr int kThreads = 256;
constexpr int kRP = 4;  // pixel rows per thread tile
constexpr int kRC = 8;  // channels per thread tile, one 8-element vector
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// round an f32 value to T and back: where the JAX kernels cast to x.dtype
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ void zero(float (&acc)[kRP][kRC]) {
#pragma unroll
  for (int i = 0; i < kRP; ++i)
#pragma unroll
    for (int j = 0; j < kRC; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} a[i][k] * w[k * ldw + j]: one thread tile of a
// GEMM whose weight w [K, ldw] (already offset to the tile's first column)
// lies in global memory.  K is a multiple of 8.
template <typename T>
__device__ __forceinline__ void mac(float (&acc)[kRP][kRC], const T* const (&a)[kRP],
                                    const T* __restrict__ w, int ldw, int K) {
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

template <typename T, bool kDownsample, bool kShifted>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, Cin = p.Cin, M = p.M, Cout = p.Cout, S = p.S, G = p.G;
  const int Wp = W + 2;
  const int r0 = blockIdx.x * S;  // first output row of the strip
  const int n0 = blockIdx.y * G;  // first image of the group
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w1 = static_cast<const T*>(p.w1);
  const T* __restrict__ w2 = static_cast<const T*>(p.w2);
  const T* __restrict__ w3 = static_cast<const T*>(p.w3);
  T* __restrict__ out = static_cast<T*>(p.out);
  T* y1s = reinterpret_cast<T*>(smem);                   // [G][S+2][W+2][M]
  T* y2s = y1s + (size_t)G * (S + 2) * Wp * M;           // [G][S][W][M]
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
      const T* a[kRP];
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
      mac<T>(acc, a, w1 + c0, M, Cin);
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
      const T* base[kRP];  // the (dy, dx) = (0, 0) corner of each pixel's window
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
        const T* a[kRP];
#pragma unroll
        for (int i = 0; i < kRP; ++i) a[i] = base[i] + off;
        const T* ws = w2 + (size_t)shift * M * M + c0;
        if (kShifted) {  // kernel 9: each shift's product on its own, then added
          float part[kRP][kRC];
          zero(part);
          mac<T>(part, a, ws, M, M);
#pragma unroll
          for (int i = 0; i < kRP; ++i)
#pragma unroll
            for (int j = 0; j < kRC; ++j) acc[i][j] += part[i][j];
        } else {  // kernel 8: one K = 9M contraction
          mac<T>(acc, a, ws, M, M);
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

  // ---- phase 3: out = relu(T(T(y2 @ w3 + b3) + res)) to device memory
  {
    const int rows = G * S * W;
    const int cgo = Cout / kRC;
    const int tiles = (rows + kRP - 1) / kRP * cgo;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int c0 = (t % cgo) * kRC, p0 = (t / cgo) * kRP;
      const T* a[kRP];
      const T* xr[kRP];
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
      mac<T>(acc, a, w3 + c0, Cout, M);
      float res[kRP][kRC];
      if (kDownsample) {
        zero(res);
        mac<T>(res, xr, static_cast<const T*>(p.wd) + c0, Cout, Cin);
#pragma unroll
        for (int i = 0; i < kRP; ++i)
#pragma unroll
          for (int j = 0; j < kRC; ++j) res[i][j] = round_to<T>(res[i][j] + p.bd[c0 + j]);
      } else {
#pragma unroll
        for (int i = 0; i < kRP; ++i) load8(xr[i] + c0, res[i]);
      }
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (p0 + i >= rows) break;
        float v[8];
#pragma unroll
        for (int j = 0; j < kRC; ++j) {
          const float y3 = round_to<T>(acc[i][j] + p.b3[c0 + j]);
          v[j] = fmaxf(round_to<T>(y3 + res[i][j]), 0.f);
        }
        store8(out + pix[i] * Cout + c0, v);
      }
    }
  }
}

size_t smem_bytes(int W, int M, int S, int G, size_t itemsize) {
  return ((size_t)G * (S + 2) * (W + 2) * M + (size_t)G * S * W * M) * itemsize;
}

template <typename T, bool kDownsample, bool kShifted>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.W, p.M, p.S, p.G, sizeof(T));
  auto kernel = bottleneck_kernel<T, kDownsample, kShifted>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H / p.S, B / p.G);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int W, int Cin, int M, int Cout, int S, int G, int dtype) {
  if (B <= 0 || H <= 0 || W <= 0 || S <= 0 || G <= 0) return false;
  if (H % S || B % G || B / G > 65535) return false;
  if (Cin % kRC || M % kRC || Cout % kRC || Cin <= 0 || M <= 0 || Cout <= 0) return false;
  if (dtype != 0 && dtype != 1) return false;
  return smem_bytes(W, M, S, G, dtype == 0 ? 4 : 2) <= (size_t)kSmemLimit;
}

template <bool kDownsample, bool kShifted>
int dispatch(const Params& p, int B, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kDownsample, kShifted>(p, B, st);
  return launch<__nv_bfloat16, kDownsample, kShifted>(p, B, st);
}

}  // namespace

extern "C" {

// Kernel 8.  x [B, H, W, Cin], w1 [Cin, M], w2 [9M, M], w3 [M, Cout] and wd
// [Cin, Cout] (or NULL) of the activation dtype; biases f32; out
// [B, H, W, Cout].  H % strip == 0, B % images_per_cell == 0, channel
// counts multiples of 8, Cin == Cout without a downsample, 16-byte aligned
// operands.  dtype: 0 = float32, 1 = bfloat16.
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
