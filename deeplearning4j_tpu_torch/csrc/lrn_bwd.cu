// Local response normalization backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/lrn.py::_lrn_bwd_kernel (launched
// by _lrn_backward through pl.pallas_call). On the [R, C] row view, with the
// forward's window W(c) = [c - h, c + depth - 1 - h], h = depth / 2:
//
//   d[c]  = k + alpha * sum of x[j]^2 over j in W(c)   (recomputed; the
//                                                        forward saves x only)
//   u[c]  = g[c] * x[c] * d[c]^(-beta) / d[c]
//   t[c]  = sum of u[j] over j in [c - (depth - 1 - h), c + h]
//   dx[c] = g[c] * d[c]^(-beta) - 2 * alpha * beta * x[c] * t[c]
//
// t runs over the MIRRORED window (j such that c lies in W(j)): the Pallas
// kernel's product with the band's transpose. The two differ for even
// depth. d^(-beta-1) is formed as d^(-beta) / d, as the Pallas kernel does.
// Types: x, g and dx all float32 (dl4j_lrn_bwd) or all bfloat16
// (dl4j_lrn_bwd_bf16); the arithmetic is f32 and dx is rounded to the
// element type once.
//
// What bounds it on this card: memory. x and g are read once and dx
// written once for about 2 * depth + 10 flops and one powf an element: at
// AlexNet's conv1 LRN, [128, 54, 54, 96] f32, the byte bound is 128.3 us.
//
// Design: the forward's (lrn_fwd.cu). A block owns a contiguous run of
// whole rows, kTile elements at most; each thread holds x, g and d^(-beta)
// of its elements in registers. Pass 1 stages x^2 in shared memory; pass 2
// forms d, d^(-beta) and u and stages u; pass 3 sums the mirrored window of
// u and stores dx. Two arrays of kTile floats: 32 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                 // elements a block stages
constexpr int kItems = kTile / kThreads;    // elements a thread holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// sum of a[j] over j in [c - before, c + after], clipped to [0, C)
__device__ __forceinline__ float window(const float* a, int c, int C,
                                        int before, int after) {
  const int lo = max(0, c - before);
  const int hi = min(C - 1, c + after);
  float s = 0.f;
  for (int j = lo; j <= hi; ++j) s += a[j];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long R, int C, int rows_per_block,
               int depth, float alpha, float beta, float k) {
  __shared__ float sq[kTile];
  __shared__ float u[kTile];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, R - row0);
  const int n = rows * C;
  const long long base = row0 * C;
  const int h = depth / 2;
  const int h2 = depth - 1 - depth / 2;

  float xv[kItems], gv[kItems], dpow[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < n) {
      xv[i] = to_f32(x[base + e]);
      gv[i] = to_f32(g[base + e]);
      sq[e] = xv[i] * xv[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < n) {
      const int r = e / C;
      const int c = e - r * C;
      const float d = k + alpha * window(sq + r * C, c, C, h, h2);
      dpow[i] = powf(d, -beta);
      u[e] = gv[i] * xv[i] * dpow[i] / d;
    }
  }
  __syncthreads();
  const float coef = 2.f * alpha * beta;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < n) {
      const int r = e / C;
      const int c = e - r * C;
      const float t = window(u + r * C, c, C, h2, h);  // the mirrored window
      store(dx + base + e, gv[i] * dpow[i] - coef * xv[i] * t);
    }
  }
}

template <typename T>
int lrn_bwd(const T* x, const T* g, T* dx, long long R, int C, int depth,
            float alpha, float beta, float k, void* stream) {
  if (C < 1 || C > kTile || depth < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = kTile / C;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lrn_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, g, dx, R, C, rows_per_block, depth, alpha, beta, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the backward on `stream`; each returns a cudaError_t (0 =
// launched). x, g and dx are [R, C] row-major of the function's element
// type; C <= 4096.
int dl4j_lrn_bwd(const float* x, const float* g, float* dx, long long R,
                 int C, int depth, float alpha, float beta, float k,
                 void* stream) {
  return lrn_bwd<float>(x, g, dx, R, C, depth, alpha, beta, k, stream);
}

int dl4j_lrn_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                      __nv_bfloat16* dx, long long R, int C, int depth,
                      float alpha, float beta, float k, void* stream) {
  return lrn_bwd<__nv_bfloat16>(x, g, dx, R, C, depth, alpha, beta, k,
                                stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
