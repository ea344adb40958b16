// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_dq.cu, flash_attention_dkv.cu): the CUDA-core tile layer
// of the f32 kernels (namespace flash), and the tensor-core tile layer of
// the bf16 forward, dq and dk/dv (namespace flash::wg, below).
//
// Every CUDA-core kernel works on 64 x 64 tiles of the score matrix with 256 threads
// laid out 16 x 16: thread (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16)
// owns tile rows ty + 16 i and tile columns tx + 16 j (i, j < 4), and
// columns tx + 16 c (c < DMAX / 16) of a [64, D] accumulator. Operand tiles
// live in shared memory as float32, [64][DMAX + 1]: the odd row stride
// keeps the 16 threads of a half-warp, which read 16 different rows at one
// column, on 16 different banks. The 16 threads of a row are one half-warp,
// so row sums and maxima are four xor-shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace flash {

constexpr int kTile = 64;             // rows of a q tile and of a k tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kPer = kTile / 16;      // tile rows (and columns) per thread
constexpr int kPLd = kTile + 1;       // row stride of a [64][64] score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A float rounded to the element type E and back: what enters a product
// whose other operand is of type E.
template <typename E>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows [row0, row0 + kTile) of a row-major [rows, D] matrix into a
// [kTile][LD] float tile; rows past `rows` and columns past D are zero, so
// that a zero weight never meets padding.
template <typename E, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ tile,
                                          const E* __restrict__ src,
                                          int row0, int rows, int D) {
  for (int idx = threadIdx.x; idx < kTile * LD; idx += kThreads) {
    const int r = idx / LD, c = idx - r * LD;
    const int row = row0 + r;
    tile[idx] = (row < rows && c < D) ? to_f32(src[(size_t)row * D + c])
                                      : 0.0f;
  }
}

// out[i][j] = sum_{d < D} A[ty + 16 i][d] * B[tx + 16 j][d]  (f32 sums)
template <int LD>
__device__ __forceinline__ void dot_tile(float (&out)[kPer][kPer],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int D,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// Sum / max over the 16 threads of a tile row (one half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Is key `kpos` visible to query `qpos`: inside Tk, not padding, and, when
// causal, not after the query (start-aligned, as the Pallas kernels).
__device__ __forceinline__ bool visible(int qpos, int kpos, int Tk,
                                        const float* __restrict__ kmask,
                                        int causal) {
  return kpos < Tk && (kmask == nullptr || kmask[kpos] > 0.0f) &&
         (!causal || qpos >= kpos);
}

// Opt in above 48 KB of dynamic shared memory on the calling thread's
// current device (the attribute is per device, and cheap to set).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ------------------------------------------------------------------------
// Tensor-core tile layer (bf16): one warpgroup of 128 threads per 64-row
// query tile (key tile in dk/dv), products by wgmma.mma_async m64n64k16
// bf16 -> f32.
//
// Shared-memory tiles. A [64 rows][DMAX] bf16 tile (DMAX 64 or 128) is
// stored as DMAX / 64 column blocks of [64 rows][64 values], 8 KB each,
// every block in wgmma's 128-byte-swizzled canonical layout: row r's 16-byte
// chunk c (values 8c .. 8c + 7) lies at r * 128 + ((c ^ (r % 8)) * 16). The
// hardware applies the same XOR to the address bits it computes, so every
// block starts on a 1024-byte boundary. Columns past D and rows past the
// matrix are zero, so padding never meets a weight.
//
// One tile serves two ways. As an operand whose reduction runs along the
// row (q k^T: the query tile as A, the key tile as B; do v^T: the value
// tile as B) it is "K-major": 8-row groups 1024 bytes apart (SBO), and the
// k-th 16-value step starts 32 k bytes into the block. As the B operand of
// a product that reduces over the rows (p v, ds k: keys are the reduction
// axis, D the output columns) it is "MN-major", read transposed: the k-th
// 16-row step starts 2048 k bytes into the block, its two 8-row groups
// 1024 bytes apart.
//
// Register fragments (PTX ISA, wgmma register fragment layouts). Thread t =
// 32 w + l of the warpgroup holds, of a 64 x 64 f32 accumulator, rows
// 16 w + l / 4 ("row a") and 16 w + l / 4 + 8 ("row b"), and in each 8-column
// chunk j the columns 8 j + 2 (l % 4) and the next: d[4j], d[4j+1] on row
// a, d[4j+2], d[4j+3] on row b. The bf16 A operand of a k16 step kk, when it
// comes from registers, is the same rows at columns 16 kk + 2 (l % 4) (+1)
// and 16 kk + 8 + 2 (l % 4) (+1): exactly the accumulator's chunks 2 kk and
// 2 kk + 1. So a score tile packed to bf16 in place is the A operand of the
// next product (FlashAttention-3's layout), and p or ds never touch shared
// memory.

namespace wg {

constexpr int kThreads = 128;        // one warpgroup
constexpr int kBlockBytes = 64 * 128;  // one [64][64] bf16 column block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of value (r, c) in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 6) * kBlockBytes + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// 4 bytes global -> shared, asynchronously (through L1); src_bytes 0 writes
// a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// What the threads wrote to shared memory becomes visible to wgmma's reads.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of a row-major [rows, D] bf16 matrix into the
// swizzled tile at `tile`. With `vec` (D % 8 == 0 and 16-byte aligned
// rows) each 16-byte chunk is one cp.async, zero-filled past the matrix;
// otherwise the chunk is gathered value by value and stored at once.
template <int DMAX>
__device__ __forceinline__ void load_tile(uint8_t* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int D, bool vec) {
  constexpr int kChunks = DMAX / 8;  // per row
  const uint32_t base = smem_addr(tile);
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    const int row = row0 + r;
    const bool in = row < rows && c < D;
    const __nv_bfloat16* g = src + (in ? (size_t)row * D + c : 0);
    if (vec) {
      cp_async16(base + swizzled(r, c), g, in ? 16 : 0);
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(g);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = (in && c + 2 * e < D) ? h[2 * e] : 0u;
        const uint32_t hi = (in && c + 2 * e + 1 < D) ? h[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(tile + swizzled(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// k16 step kk of a K-major tile (reduction along the row).
__device__ __forceinline__ uint64_t k_major(const uint8_t* tile, int kk) {
  return descriptor(smem_addr(tile) + (kk >> 2) * kBlockBytes + (kk & 3) * 32,
                    16, 1024);
}
// k16 step kk (rows 16 kk ..) of an MN-major tile, output columns
// 64 nb .. 64 nb + 63. Only one 64-column atom is read, so the atom stride
// is not used; it is given the 8-row group stride as well.
__device__ __forceinline__ uint64_t mn_major(const uint8_t* tile, int kk,
                                             int nb) {
  return descriptor(smem_addr(tile) + nb * kBlockBytes + kk * 2048, 1024,
                    1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DL4J_WG_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DL4J_WG_OUT32(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B from shared memory (both K-major).
// accumulate = 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DL4J_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DL4J_WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (four bf16 pairs), B from shared
// memory, MN-major (transposed).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DL4J_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DL4J_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef DL4J_WG_D32
#undef DL4J_WG_OUT32

// 2^x on the special-function unit (ex2.approx: about 2 ulp; subnormal
// results flush to 0); 2^-inf = 0, so a masked score needs no select.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k16 step kk from a 64 x 64 f32 accumulator, each value
// rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[32],
                                       int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// A 1024-byte aligned start inside dynamic shared memory (the launch asks
// for 1 KB more than the tiles need).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Can every row of these [*, D] bf16 matrices be copied in 16-byte chunks.
inline bool vec_rows(int D, std::initializer_list<const void*> ptrs) {
  if (D % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace wg

}  // namespace flash
