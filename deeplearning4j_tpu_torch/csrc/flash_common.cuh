// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_dq.cu, flash_attention_dkv.cu).
//
// Every kernel works on 64 x 64 tiles of the score matrix with 256 threads
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

}  // namespace flash
