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
// bf16 rows that fit one chunk of keys (short_attn_tc_kernel<HD, NT>): one
// block per (head, image), grid (H, B), with one warp per 16-row tile (at
// most 5).  The block stages that
// head's K_h and V_h ([S, hd], rows past S zero-filled, so 0 * garbage never
// makes a NaN) and each warp its 16 query rows, all with 16-byte cp.async.cg
// copies issued at once, in an XOR-swizzled layout that ldmatrix reads
// without bank conflicts.  Products run on the tensor cores with
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators, exactly the TPU's
// rounding model): S = Q.K^T from ldmatrix fragments (K rows are the
// col-major B as stored); the row max and sum are quad shuffles; the
// normalized probabilities are rounded to bf16 and packed from the
// accumulator layout straight into A fragments (no trip through shared
// memory); V comes in by ldmatrix.trans; O accumulates in f32 registers and
// is stored as packed bf16 pairs.  The scale is folded into exp2f on the f32
// logits (scale * log2 e), never into a bf16 Q.  A row tile's scores stay in
// registers: one chunk of 8*NT keys (NT = 4, 8 or 10: S <= 80 at hd <= 64,
// S <= 64 at hd 128 covers the text and ViT-B/32 shapes).  Causal row tiles
// skip the key steps wholly above their diagonal and mask inside it; keys
// past S are masked to -inf.
//
// Why mma.sync and not wgmma there: wgmma takes 64-row M tiles per
// warpgroup, which at S=50 and S=77 wastes 22-40 % of the rows, and the
// tensor cores are not the limit: a 0.03-0.04 ms kernel at these shapes
// needs ~80-100 TFLOP/s, far below what mma.sync gives.  TMA is not needed
// at these tile sizes.
//
// bf16 rows longer than one chunk (short_attn_tc_kernel_rows<HD>, the
// long-row route): S > 80 at hd 32 and 64, S > 64 at hd 128, such as
// ViT-L/14@336px's image tower (S=577, D=1024, H=16, B=256 a batch).  It
// replaces kernel 1's former multi-chunk branch, which staged a whole head's
// K_h and V_h per block: at S=577 168 KB, one block of 8 warps an SM, each
// warp running ~960 dependent mma.sync per row tile with nothing to hide
// their latency (4.2-4.3 ms a launch at that shape, 8.4 % of its bound).
// The function is the same, bit for bit: logits in f32, the exact two-pass
// softmax (the row max and sum over 64-key chunks in key order, then the
// logits again, w = e / sum rounded to bf16, the TPU kernel's rounding
// point), P.V accumulated in f32 in key order, so kernel 2
// (short_attention_qtiled.cu), which runs the same two passes on mma.sync,
// equals it wherever both take a shape.  Three things keep the bits:
// wgmma's bf16 products with f32 accumulation equal mma.sync's chained
// m16n8k16 ones (both operand majors; the card tests hold the kernels
// equal); ex2.approx.ftz.f32 is exp2f itself wherever exp2f's argument is
// >= -126, -inf or NaN (exp_rows, sfu_exact); and kernel 2's compiled sums
// fuse each chunk's rescale with its first add, which chunk_stats writes out
// as an fmaf.
//   What bounds it at S=577: the two passes take 6 flops per (query, key,
//   head dim), 0.53 ms at the bf16 tensor-core peak, and two exponentials
//   per (query, key), 2.73e9, ~0.70 ms at ~3.9e12 exp2f a second (16 a
//   clock per SM): the exponentials, not the 1.2 GB of q/k/v/o (0.36 ms),
//   set the floor.
//   The design (short_attn_tc_kernel_rows below):
//   - a persistent grid, one block per SM, walking tiles of 128 query rows
//     of one (head, image), row tiles fastest so a head's tiles share its K
//     and V in L2;
//   - two consumer warpgroups of 64 rows each, products on wgmma (Q and K
//     from shared memory, P from registers, f32 accumulators in registers),
//     so a K or V byte brought into shared memory feeds 64 rows, not 16;
//   - a producer warp whose one thread keeps TMA loads in flight into a
//     ring of 64-key chunks (K alone for pass 1, K with V for pass 2) and
//     double-buffered Q tiles, running on into the next tile, with mbarriers
//     between producer and consumers; rows past S come in as zeros;
//   - the products overlap the exponentials: pass 1 issues two chunks'
//     logits and takes the first's max and sum while the second's compute;
//     pass 2 issues a chunk's logits with the last chunk's P.V and computes
//     the probabilities under that P.V; the two warpgroups take turns to
//     issue, so one's exponentials run under the other's products;
//   - exponentials on the SFU alone where that is exp2f, and the output from
//     the f32 accumulators as packed bf16 pairs straight into the head's
//     column slice of the merged-head [B, S, D] layout.
//   ptxas serializes every wgmma of a kernel that writes an accumulator
//   with another instruction, or branches on the warp, while a wgmma is in
//   flight: the kernel is written so that it does neither.  Each query tile
//   reads K twice and V once from L2 (~4.9 GB a launch at S=577, B=256).
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
// The gate for supported_whole_row() and supported_packed() is shared memory
// as the first design used it (ops/short_attention.py::smem_bytes: K_h and
// V_h resident in bf16, f32attn::resident_smem_bytes in f32), kept in bf16
// so that every shape takes the kernel it took before: 1,744 / 832 / 416 at
// hd 32 / 64 / 128.  The long-row route's footprint does not grow with S;
// longer rows go on to kernel 2 and then to the flash kernels.
//
// C interface for ctypes: each entry launches on the given stream, allocates
// nothing, does not synchronize, and returns cudaGetLastError() (0 on
// success).  Both entries need 16-byte aligned base pointers (the wrapper
// checks).

#include <cuda.h>
#include <limits.h>

#include "attention_f32.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using namespace dmt;
using namespace dmt::attn_tc;
using bf16 = __nv_bfloat16;

// ---------------------------------------------- bf16, rows in one key chunk

__host__ __device__ constexpr int kRowBytesOf(int hd) { return hd * 2; }

__host__ __device__ constexpr int round16(int s) { return (s + 15) / 16 * 16; }

// One warp per 16-row tile of at most 8*NT rows; the register cap is then
// ~128 (four 4-warp blocks, three 5-warp ones, eight 2-warp ones per SM);
// hd 128 keeps up to 255 (201 used) and two 4-warp blocks.
template <int NT> constexpr int tc_max_warps() { return NT / 2; }
template <int HD, int NT> constexpr int tc_min_blocks() {
  return HD == 128 ? 2 : 65536 / (tc_max_warps<NT>() * 32 * 128);
}

// K_h and V_h (rows rounded up to 16) plus one 16-row Q tile per warp.
template <int HD> size_t smem_bytes_bf16(int S) {
  return 3 * (size_t)round16(S) * kRowBytesOf(HD);
}

// q, k, v point at head 0 of row 0 of image 0; their rows are ld_in elements
// apart (D, or 3D for the packed slab).  o's rows are ld_out (= D) apart.
// S is at most 8*NT.
template <int HD, int NT>
__global__ void __launch_bounds__(tc_max_warps<NT>() * 32, tc_min_blocks<HD, NT>())
short_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int S, int ld_in, int ld_out, int causal, float scale_log2) {
  constexpr int kRowBytes = kRowBytesOf(HD);
  static_assert(NT % 2 == 0, "key chunks are whole 16-key steps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int S16 = round16(S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t k_s = smem_u32(smem_raw);
  const uint32_t v_s = k_s + S16 * kRowBytes;
  const uint32_t q_s = v_s + S16 * kRowBytes + warp * 16 * kRowBytes;

  const int h = blockIdx.x, b = blockIdx.y;
  const size_t in_base = (size_t)b * S * ld_in + (size_t)h * HD;
  const int r0 = warp * 16;  // this warp's row tile

  // K_h and this warp's Q tile (group 0), then V_h (group 1): every input
  // byte of the block is in flight before any compute
  stage_rows<HD>(k_s, k + in_base, S16, S, ld_in, threadIdx.x, blockDim.x);
  stage_rows<HD>(q_s, q + in_base + (size_t)r0 * ld_in, 16, S - r0, ld_in, lane, 32);
  cp_async_commit();
  stage_rows<HD>(v_s, v + in_base, S16, S, ld_in, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[HD / 16][4];  // A fragments of Q, head dims 16 at a time
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd)
    ldsm_x4(qf[kd], q_s + swz<HD>(lane & 15, 2 * kd + (lane >> 4)));

  const int key_end = causal ? min(S, r0 + 16) : S;  // keys this tile sees
  const int n_ks = (key_end + 15) / 16;
  const int mask_from = causal ? r0 : S;

  // the row max and sum (rows g and g + 8 of the tile)
  float sc[NT][4];
  chunk_scores<HD, NT>(sc, qf, k_s, 0, n_ks, r0, S, causal, mask_from, lane);
  float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    c0 = fmaxf(c0, fmaxf(sc[j][0], sc[j][1]));
    c1 = fmaxf(c1, fmaxf(sc[j][2], sc[j][3]));
  }
  const float m0 = quad_max(c0), m1 = quad_max(c1);
  to_exp<NT>(sc, m0 * scale_log2, m1 * scale_log2, scale_log2);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    l0 += sc[j][0] + sc[j][1];
    l1 += sc[j][2] + sc[j][3];
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  cp_async_wait<0>();
  __syncthreads();

  // w = e / sum rounded to bf16, then P.V into f32 accumulators
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    if (ks >= n_ks) continue;
    uint32_t pa[4];  // A fragment of P: keys ks*16 + [0, 16)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = 2 * ks + hh;
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

  bf16* ob = o + (size_t)b * S * ld_out + (size_t)h * HD;
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

template <int HD, int NT>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16<HD>(S);
  auto kernel = short_attn_tc_kernel<HD, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  kernel<<<grid, round16(S) / 16 * 32, smem, stream>>>(
      q, k, v, o, S, ld_in, ld_out, causal, kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16, long rows

template <int HD> struct RowsTraits {
  static constexpr int kGroups = 2;                   // consumer warpgroups, 64 query rows each
  static constexpr int kConsumers = kGroups * 128;
  static constexpr int kThreads = kConsumers + 32;    // + the producer warp
  static constexpr int kRows = kGroups * 64;          // query rows per block
  static constexpr int kChunk = kChunkKeys2Pass;      // keys per streamed chunk
  static constexpr int kRing = HD == 128 ? 5 : 8;     // ring stages (5 is what fits at hd 128)
  static constexpr int kBoxCols = HD < 64 ? HD : 64;  // one TMA box: 64 rows of 64 or 128 bytes
  static constexpr uint32_t kBoxBytes = 64 * kBoxCols * 2;
  static constexpr uint32_t kChunkBytes = kChunk * kRowBytesOf(HD);  // a K or V chunk
  static constexpr uint32_t kBlockBytes = kChunk * 128;  // its 64-column block (hd >= 64)
  static constexpr uint32_t kQBytes = kRows * kRowBytesOf(HD);
  static constexpr uint32_t kRingBytes = kRing * 2 * kChunkBytes;  // a stage: K chunk, V chunk
  // alignment slack, two Q tiles, the ring, then the barriers (Q full[2]
  // and empty[2], then the ring's full[] and empty[])
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + kRingBytes + 8 * (4 + 2 * kRing);
};

// The tiles in shared memory are laid out as TMA writes them and wgmma reads
// them: at hd 32, rows of 64 bytes in the 64-byte swizzle; at hd 64 and 128,
// one block of 128-byte rows per 64 columns, in the 128-byte swizzle; every
// tile 1024-byte aligned.  wgmma descriptor of 64 rows of such a tile at
// addr (start >> 4; leading offset 1, unused: one swizzle atom wide; stride
// 1024 or 512 bytes from one 8-row group to the next; the swizzle).  It
// serves a K-major operand (Q or K rows: 16 head dims a step, +32 bytes) and
// an MN-major one (V rows: 16 keys a step, +2048 or +1024 bytes).
template <int HD> __device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  constexpr uint64_t kGroupBytes = HD == 32 ? 512 : 1024;
  constexpr uint64_t kSwizzle = HD == 32 ? 2 : 1;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((kGroupBytes >> 4) << 32) | (kSwizzle << 62);
}

// TMA: the box at (c0 innermost, c1, c2) of a 3-D tensor map into shared
// memory at dst, completing `bar`'s expected bytes (out-of-bounds elements
// read as zeros and still count).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2)
               : "memory");
}

// common.cuh's mbar_wait with every lane of the warp leaving the loop
// together, so ptxas sees no divergent path around the wgmmas that follow
// (it would serialize them all).  Traps after ~2^32 cycles as mbar_wait does.
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!__all_sync(0xffffffffu, mbar_try_wait(bar, parity)))
    if (__any_sync(0xffffffffu, clock64() - t0 > (1ll << 32))) __trap();
}

// Arrives at barrier `id` (1-15) of `n` threads without waiting.
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// d = a . b (+ d where add): m64nNk16 (N = 8 * NJ), bf16 operands, f32
// accumulators.  d[j][e] is the mma.sync accumulator of columns 8j + [0, 8)
// of the warp's 16 rows: row g + 8 * (e >> 1), column 2t + (e & 1).  The _t
// forms take a from registers (the mma.sync A fragment of the warp's rows)
// and b MN-major; wgmma_ss_n64 takes both by descriptor, K-major.
__device__ __forceinline__ void wgmma_n64_t(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                            int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(add));
}
__device__ __forceinline__ void wgmma_n32_t(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b,
                                            int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

template <int NJ, int NE> __device__ __forceinline__ void fence_acc(float (&d)[NJ][NE]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < NE; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}

// S = Q.K^T of the warpgroup's 64 query rows (q_blk: their rows of the
// staged Q tile) against the 64 keys of a staged K chunk (k_blk), head dims
// 16 at a time in order, f32 accumulators in d, issued (not committed).  Q
// and K are read from shared memory; the first step writes d, so no other
// instruction writes an accumulator: one that did while another wgmma is in
// flight would make ptxas serialize every wgmma of the kernel.
template <int HD>
__device__ __forceinline__ void wg_scores(float (&d)[8][4], uint32_t q_blk, uint32_t k_blk) {
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd)  // 32 bytes of each Q and K row a step
    wgmma_ss_n64(d, wg_desc<HD>(q_blk + (kd / 4) * RowsTraits<HD>::kRows * 128) + 2 * (kd % 4),
                 wg_desc<HD>(k_blk + (kd / 4) * RowsTraits<HD>::kBlockBytes) + 2 * (kd % 4),
                 kd > 0);
}

// O += P.V for one staged V chunk (v_blk), 16 keys a step in order; add = 0
// writes O (the first chunk).
template <int HD, int NJ, int kHalves>
__device__ __forceinline__ void wg_pv(float (&acc)[kHalves][NJ][4], const uint32_t (&pa)[4][4],
                                      uint32_t v_blk, int add) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {  // 16 V rows a step
    if constexpr (HD == 32) {
      wgmma_n32_t(acc[0], pa[ks], wg_desc<HD>(v_blk) + ks * (1024 >> 4), add || ks > 0);
    } else {
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
        wgmma_n64_t(acc[hh], pa[ks],
                     wg_desc<HD>(v_blk + hh * RowsTraits<HD>::kBlockBytes) + ks * (2048 >> 4),
                     add || ks > 0);
    }
  }
}

// Element (j, e) of a chunk's logits with attention_tc.cuh::chunk_scores's
// masks where kMask: keys at or past the row's limit (S, or for causal calls
// the row + 1) at -inf.  lim0, lim1: the limits of rows g and g + 8 less the
// chunk's first key and 2t, so the test is against a constant.
template <bool kMask>
__device__ __forceinline__ float logit(const float (&d)[8][4], int j, int e, int lim0, int lim1) {
  if (kMask && 8 * j + (e & 1) >= (e < 2 ? lim0 : lim1)) return -INFINITY;
  return d[j][e];
}

// attention_tc.cuh::to_exp, e = exp2f(fmaf(logit, scale_log2, -ms)), bit
// for bit in fewer instructions where kSfu: exp2f(x) is one SFU instruction
// (what ex2.approx.ftz.f32 compiles to) for x >= -126, x = -inf or NaN, and
// scales around it only for x in (-inf, -126), whose results are under
// 2^-126: a compare and two predicated multiplies an exponential saved.
template <bool kSfu>
__device__ __forceinline__ void exp_rows(float (&x)[8][4], float ms0, float ms1,
                                         float scale_log2) {
  if constexpr (!kSfu) {
    to_exp<8>(x, ms0, ms1, scale_log2);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = fmaf(x[j][e], scale_log2, e < 2 ? -ms0 : -ms1);
        asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(x[j][e]) : "f"(y));
      }
  }
}

// Whether every exponent of the warp's rows is >= -126 or -inf, so that
// exp_rows<true> equals exp2f: the least finite logit of each row decides,
// as fmaf is monotonic in it (lo0, lo1: those of rows g and g + 8, +inf if
// none).
__device__ __forceinline__ bool sfu_exact(float lo0, float lo1, float ms0, float ms1,
                                          float scale_log2) {
  const bool ok = fmaf(lo0, scale_log2, -ms0) >= -126.f && fmaf(lo1, scale_log2, -ms1) >= -126.f;
  return __all_sync(0xffffffffu, ok);
}

// Pass 1 on one chunk: the rows' running max and sum, in kernel 2's order,
// and their least finite logit (mn0, mn1) over the chunks so far.
template <bool kMask>
__device__ __forceinline__ void chunk_stats(const float (&d)[8][4], int lim0, int lim1,
                                            float scale_log2, float& m0, float& m1, float& l0,
                                            float& l1, float& mn0, float& mn1) {
  float x[8][4];
  float c0 = -INFINITY, c1 = -INFINITY, lo0 = INFINITY, lo1 = INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = logit<kMask>(d, j, e, lim0, lim1);
    c0 = fmaxf(c0, fmaxf(x[j][0], x[j][1]));
    c1 = fmaxf(c1, fmaxf(x[j][2], x[j][3]));
    if constexpr (kMask) {  // masked keys out of the least logit
      lo0 = fminf(lo0, fminf(x[j][0] == -INFINITY ? INFINITY : x[j][0],
                             x[j][1] == -INFINITY ? INFINITY : x[j][1]));
      lo1 = fminf(lo1, fminf(x[j][2] == -INFINITY ? INFINITY : x[j][2],
                             x[j][3] == -INFINITY ? INFINITY : x[j][3]));
    } else {
      lo0 = fminf(lo0, fminf(x[j][0], x[j][1]));
      lo1 = fminf(lo1, fminf(x[j][2], x[j][3]));
    }
  }
  const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
  const float r0 = exp2f((m0 - n0) * scale_log2), r1 = exp2f((m1 - n1) * scale_log2);
  m0 = n0;
  m1 = n1;
  mn0 = fminf(mn0, lo0);
  mn1 = fminf(mn1, lo1);
  const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
  if (sfu_exact(lo0, lo1, ms0, ms1, scale_log2)) exp_rows<true>(x, ms0, ms1, scale_log2);
  else exp_rows<false>(x, ms0, ms1, scale_log2);
  // kernel 2's compiled sums: the rescale fused with the first add
  l0 = fmaf(l0, r0, x[0][0] + x[0][1]);
  l1 = fmaf(l1, r1, x[0][2] + x[0][3]);
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    l0 += x[j][0] + x[j][1];
    l1 += x[j][2] + x[j][3];
  }
}

// Pass 2 on one chunk: w = exp(logit - max) / sum, rounded to bf16 and
// packed into the A fragments of P (keys 16ks + [0, 16)).
template <bool kMask, bool kSfu>
__device__ __forceinline__ void chunk_probs(const float (&d)[8][4], int lim0, int lim1,
                                            float ms0, float ms1, float scale_log2, float inv0,
                                            float inv1, uint32_t (&pa)[4][4]) {
  float x[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = logit<kMask>(d, j, e, lim0, lim1);
  exp_rows<kSfu>(x, ms0, ms1, scale_log2);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = 2 * ks + hh;
      pa[ks][2 * hh] = pack_bf16(x[j][0] * inv0, x[j][1] * inv0);
      pa[ks][2 * hh + 1] = pack_bf16(x[j][2] * inv1, x[j][3] * inv1);
    }
}

// A persistent grid, one block per SM: block i takes the tiles i, i + grid,
// ... of kRows query rows of one (head, image), row tiles fastest, so the
// tiles of one head and image run side by side and share its K and V in L2.
// A block has two consumer warpgroups, warpgroup w on rows q0 + 64w + [0,
// 64) (its warp v on the 16-row tile q0 + 64w + 16v, as a kernel-2 warp),
// and one producer warp whose one thread keeps TMA loads in flight: each
// tile's Q into one of two slots, then its steps' chunks into a ring of
// kRing stages, step s < nc K chunk s (pass 1), s >= nc K and V chunk s - nc
// (pass 2), running on into the next tile while the consumers finish this
// one.  Consumers wait on a slot's or a stage's full barrier and release it
// on its empty barrier once the wgmmas that read it have completed.
// Every branch from a wgmma's issue to its wait is uniform over the block
// (ptxas serializes every wgmma of a kernel that branches on the warp
// there): every warpgroup runs every chunk of the tile, rows past S
// included (TMA reads them as zeros), and stores only rows below S.  A
// chunk past a causal row is all -inf to it, and kernel 2's sums are
// unchanged by one: its max by max(m, -inf) = m, its sum by * exp2f(0) and + 0.
template <int HD>
__global__ void __launch_bounds__(RowsTraits<HD>::kThreads, 1)
short_attn_tc_kernel_rows(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                          int S, int H, int n_tiles, int ld_out, int causal, float scale_log2) {
  using T = RowsTraits<HD>;
  constexpr int kRing = T::kRing;
  constexpr int kHalves = HD == 128 ? 2 : 1;  // 64-column blocks of Q, K, V and O
  constexpr int NJ = HD == 32 ? 4 : 8;        // 8-column accumulator groups per block
  extern __shared__ __align__(1024) unsigned char smem_rows[];
  const uint32_t q_s = (smem_u32(smem_rows) + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t ring = q_s + 2 * T::kQBytes;  // after tile k's Q, at q_s + (k & 1) * kQBytes
  const uint32_t bars = ring + T::kRingBytes;
  auto q_tile = [&](int k) { return q_s + (uint32_t)(k & 1) * T::kQBytes; };
  auto q_full = [&](int k) { return bars + 8u * (k & 1); };
  auto q_empty = [&](int k) { return bars + 8u * (2 + (k & 1)); };
  auto stage = [&](int it) { return ring + (uint32_t)(it % kRing) * 2 * T::kChunkBytes; };
  auto full = [&](int it) { return bars + 8u * (4 + it % kRing); };
  auto empty = [&](int it) { return bars + 8u * (4 + kRing + it % kRing); };
  auto parity = [&](int it) { return (uint32_t)(it / kRing) & 1u; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_rt = (S + T::kRows - 1) / T::kRows;  // row tiles of one head and image
  // tile -> its first row, head, image and chunks (its last row's)
  auto tile_q0 = [&](int tile) { return tile % n_rt * T::kRows; };
  auto tile_nc = [&](int tile) {
    return ((causal ? min(S, tile_q0(tile) + T::kRows) : S) + T::kChunk - 1) / T::kChunk;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);              // the producer's arrive + the bytes
      // one arrive per consumer thread: a branch on the lane while a wgmma
      // is in flight would serialize them all
      mbar_init(q_empty(i), T::kConsumers);
    }
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), T::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == T::kConsumers / 32) {
    // ------------------------------------------------ producer warp (TMA)
    if (lane == 0) {
      int it = 0, k = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
        const int q0 = tile_q0(tile), h = tile / n_rt % H, b = tile / (n_rt * H);
        const int nc = tile_nc(tile);
        mbar_wait(q_empty(k), ((k >> 1) & 1) ^ 1);  // the first two tiles find Q free
        mbar_arrive_expect_tx(q_full(k), T::kQBytes);
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
          for (int i = 0; i < T::kRows / 64; ++i)
            tma_load_3d(q_tile(k) + hh * T::kRows * 128 + i * T::kBoxBytes, &q_map, q_full(k),
                        h * HD + hh * 64, q0 + 64 * i, b);
        for (int s = 0; s < 2 * nc; ++s, ++it) {
          mbar_wait(empty(it), parity(it) ^ 1);  // the first round finds every stage free
          const bool kv = s >= nc;
          const int key0 = (kv ? s - nc : s) * T::kChunk;
          mbar_arrive_expect_tx(full(it), (kv ? 2 : 1) * T::kChunkBytes);
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh) {
            tma_load_3d(stage(it) + hh * T::kBlockBytes, &k_map, full(it), h * HD + hh * 64,
                        key0, b);
            if (kv)
              tma_load_3d(stage(it) + T::kChunkBytes + hh * T::kBlockBytes, &v_map, full(it),
                          h * HD + hh * 64, key0, b);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups (wgmma)
  const int g = lane >> 2, t = lane & 3;
  // the warpgroups take turns to issue their wgmmas, so that one's
  // exponentials run under the other's products: barrier 1 + w is group w's
  // turn, which the other group signals once it has issued its own.  wg by
  // a shuffle, so ptxas sees it uniform over the warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  // this group's rows of a Q tile
  const uint32_t q_rows = wg * 64 * kRowBytesOf(HD < 64 ? HD : 64);
  auto my_turn = [&] { named_bar_sync(1 + wg, T::kConsumers); };
  auto your_turn = [&] { named_bar_arrive(2 - wg, T::kConsumers); };
  if (wg == 0) named_bar_arrive(1, T::kConsumers);  // group 0 goes first

  int it = 0, k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int q0 = tile_q0(tile), h = tile / n_rt % H, b = tile / (n_rt * H);
    const int nc = tile_nc(tile);
    // this warp's 16-row tile; the keys rows g and g + 8 see, [0, lim); the
    // first key a row of the tile masks
    const int r0 = q0 + 16 * warp;
    const int lim0 = causal ? min(S, r0 + g + 1) : S, lim1 = causal ? min(S, r0 + g + 9) : S;
    const int mask_from = causal ? min(S, q0 + 1) : S;

    const uint32_t q_blk = q_tile(k) + q_rows;
    mbar_wait_warp(q_full(k), (k >> 1) & 1);

    // pass 1: the rows' max and sum, two chunks a round, the second's logits
    // computed under the first's exponentials
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, mn0 = INFINITY, mn1 = INFINITY;
    auto stats = [&](const float (&d)[8][4], int c) {
      const int c_lim0 = lim0 - c * T::kChunk - 2 * t, c_lim1 = lim1 - c * T::kChunk - 2 * t;
      if ((c + 1) * T::kChunk > mask_from)
        chunk_stats<true>(d, c_lim0, c_lim1, scale_log2, m0, m1, l0, l1, mn0, mn1);
      else
        chunk_stats<false>(d, c_lim0, c_lim1, scale_log2, m0, m1, l0, l1, mn0, mn1);
    };
    for (int c = 0; c < nc; c += 2, it += 2) {
      const bool two = c + 1 < nc;
      float sa[8][4], sb[8][4];
      mbar_wait_warp(full(it), parity(it));
      if (two) mbar_wait_warp(full(it + 1), parity(it + 1));
      my_turn();
      wg_scores<HD>(sa, q_blk, stage(it));
      wgmma_commit();
      if (two) wg_scores<HD>(sb, q_blk, stage(it + 1));
      wgmma_commit();
      your_turn();
      wgmma_wait<1>();
      fence_acc(sa);
      mbar_arrive(empty(it));
      stats(sa, c);
      wgmma_wait<0>();
      fence_acc(sb);
      if (two) {
        mbar_arrive(empty(it + 1));
        stats(sb, c + 1);
      } else {
        --it;  // one step this round
      }
    }

    // pass 2: the logits again, w = e / sum rounded to bf16 into A
    // fragments, then P.V into f32 accumulators; chunk c's probabilities are
    // computed under chunk c - 1's P.V
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
    const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
    const bool sfu = sfu_exact(mn0, mn1, ms0, ms1, scale_log2);  // for every chunk of pass 2
    float acc[kHalves][NJ][4];  // written first by chunk 0's P.V
    uint32_t pa[4][4];          // A fragments of P
    for (int c = 0; c < nc; ++c, ++it) {
      float sc[8][4];
      mbar_wait_warp(full(it), parity(it));
      my_turn();
      wg_scores<HD>(sc, q_blk, stage(it));
      wgmma_commit();
      if (c > 0) wg_pv<HD, NJ, kHalves>(acc, pa, stage(it - 1) + T::kChunkBytes, c > 1);
      wgmma_commit();
      your_turn();
      wgmma_wait<1>();
      fence_acc(sc);
      const int c_lim0 = lim0 - c * T::kChunk - 2 * t, c_lim1 = lim1 - c * T::kChunk - 2 * t;
      uint32_t pn[4][4];
      const bool masked = (c + 1) * T::kChunk > mask_from;
      if (masked && sfu)
        chunk_probs<true, true>(sc, c_lim0, c_lim1, ms0, ms1, scale_log2, inv0, inv1, pn);
      else if (masked)
        chunk_probs<true, false>(sc, c_lim0, c_lim1, ms0, ms1, scale_log2, inv0, inv1, pn);
      else if (sfu)
        chunk_probs<false, true>(sc, c_lim0, c_lim1, ms0, ms1, scale_log2, inv0, inv1, pn);
      else
        chunk_probs<false, false>(sc, c_lim0, c_lim1, ms0, ms1, scale_log2, inv0, inv1, pn);
      wgmma_wait<0>();  // chunk c - 1's P.V no longer reads pa or its stage
      if (c > 0) mbar_arrive(empty(it - 1));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[ks][e] = pn[ks][e];
    }
    mbar_arrive(q_empty(k));  // the tile's last logits are done
    my_turn();
    wg_pv<HD, NJ, kHalves>(acc, pa, stage(it - 1) + T::kChunkBytes, nc > 1);
    wgmma_commit();
    your_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) fence_acc(acc[hh]);
    mbar_arrive(empty(it - 1));

    bf16* ob = o + (size_t)b * S * ld_out + (size_t)h * HD;
    const int row0 = r0 + g, row1 = r0 + g + 8;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = hh * 64 + j * 8 + 2 * t;
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * ld_out + col) =
              pack_bf16(acc[hh][j][0], acc[hh][j][1]);
        if (row1 < S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * ld_out + col) =
              pack_bf16(acc[hh][j][2], acc[hh][j][3]);
      }
  }
}

// ------------------------------------------------------------------ host side

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

// x's [B, S, D] columns of one of q, k, v (rows ld elements apart) as a 3-D
// map, read in boxes of 64 rows by kBoxCols columns in the swizzle wg_desc
// describes; rows past S read as zeros.
template <int HD>
int encode_qkv(CUtensorMap* map, const bf16* x, int B, int S, int D, int ld) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)S * ld * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)RowsTraits<HD>::kBoxCols, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_rows(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S, int H,
                int ld_in, int ld_out, int causal, cudaStream_t stream) {
  using T = RowsTraits<HD>;
  CUtensorMap maps[3];
  const bf16* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_qkv<HD>(&maps[i], src[i], B, S, H * HD, ld_in);
    if (err) return err;
  }
  auto kernel = short_attn_tc_kernel_rows<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (long long)(S + T::kRows - 1) / T::kRows * H * B;
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(maps[0], maps[1], maps[2], o, S, H,
                                                  (int)n_tiles, ld_out, causal,
                                                  kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// The route: a row's keys in one chunk in registers up to 32, 64 or (hd <=
// 64) 80 keys, else the long-row kernel's two passes over 64-key chunks.
template <int HD>
int dispatch_chunk(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                   int H, int ld_in, int ld_out, int causal, cudaStream_t stream) {
  if (S <= 32) return launch_bf16<HD, 4>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  if (S <= kChunkKeys2Pass)
    return launch_bf16<HD, kChunkKeys2Pass / 8>(q, k, v, o, B, S, H, ld_in, ld_out, causal,
                                                stream);
  if constexpr (HD <= 64) {
    if (S <= 80)
      return launch_bf16<HD, 10>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
  }
  return launch_rows<HD>(q, k, v, o, B, S, H, ld_in, ld_out, causal, stream);
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
