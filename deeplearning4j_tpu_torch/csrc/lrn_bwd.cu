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
// depth. Types: x, g and dx all float32 (dl4j_lrn_bwd) or all bfloat16
// (dl4j_lrn_bwd_bf16); the arithmetic is f32 and dx is rounded to the
// element type once.
//
// What bounds it on this card: memory. x and g are read once and dx
// written once for about 2 * depth + 10 flops and one power an element: at
// AlexNet's conv1 LRN, [128, 54, 54, 96] f32, the byte bound is 128.3 us.
// So the design spends as few instructions an element as it can and keeps
// enough loads in flight:
//
// - A thread owns kSeg = 8 consecutive channels of one row, loaded and
//   stored as 16-byte vectors (two for f32, one for bf16) where the three
//   pointers are 16-byte aligned and C is a multiple of the vector; else
//   element by element. A block owns P whole rows, tpr = ceil(C / kSeg)
//   threads a row (P tpr <= 256; one row of up to 512 threads when C >
//   2048), so the thread's row and channels come from one division when
//   it starts, none an element. A block's loads are all issued before its
//   first barrier; many small blocks (up to 8 an SM) keep HBM busy.
// - Two shared arrays of P rows, each row padded by kPad zeros on both
//   sides: x^2, then u. After one barrier a thread reads its window of x^2
//   as float4s (its 8 channels and kPad on either side) and forms d, the
//   power and u; after a second, the mirrored window of u and dx.
// - d^(-beta) is exp2(-beta log2 d) (the MUFU log2 and exp2), and
//   d^(-beta-1) is d^(-beta) over d by the fast division (__fdividef): no
//   powf and no full-precision division. g d^(-beta) replaces g in its
//   register, so a thread holds two values an element between the passes.
// - AlexNet's depth, 5, is a template constant: the two windows are five
//   register adds an element, unclipped thanks to the zero padding. Any
//   other depth >= 1 takes the same kernel with a run-time window clipped
//   to the row.
//
// The layout, the segment loads and stores and the window sums are in
// lrn_common.cuh, shared with the forward.

#include "lrn_common.cuh"

namespace {

using namespace lrn;

// Depth: 5 for the unrolled window, 0 for any depth (run-time, clipped).
// Vec: 16-byte loads and stores.
template <typename T, bool Vec, int Depth>
__global__ void __launch_bounds__(kMaxThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
               T* __restrict__ dx, long long R, int C, int tpr, int P,
               int depth, float alpha, float beta, float k) {
  extern __shared__ __align__(16) float smem[];
  const int S = tpr * kSeg + 2 * kPad;       // a shared row, padded
  float* sq = smem;                          // [P][S] x^2
  float* us = smem + (size_t)P * S;          // [P][S] u
  const int rr = threadIdx.x / tpr;          // row of the block
  const int c0 = (threadIdx.x - rr * tpr) * kSeg;  // first channel
  const long long r = (long long)blockIdx.x * P + rr;
  const int n = r < R ? min(kSeg, C - c0) : 0;     // channels in range
  const size_t at = (size_t)r * C + c0;
  float* sq_row = sq + (size_t)rr * S;
  float* u_row = us + (size_t)rr * S;

  float xv[kSeg], gv[kSeg];
  if (n > 0) {
    load_seg<Vec>(x + at, n, xv);
    load_seg<Vec>(g + at, n, gv);
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) xv[i] = gv[i] = 0.0f;
  }
  // x^2 of the thread's channels (zero past C) and the row's padding
  {
    float4* q = reinterpret_cast<float4*>(sq_row + kPad + c0);
#pragma unroll
    for (int i = 0; i < kSeg / 4; ++i)
      q[i] = make_float4(xv[4 * i] * xv[4 * i], xv[4 * i + 1] * xv[4 * i + 1],
                         xv[4 * i + 2] * xv[4 * i + 2],
                         xv[4 * i + 3] * xv[4 * i + 3]);
    if (c0 == 0) {
      *reinterpret_cast<float4*>(sq_row) = make_float4(0, 0, 0, 0);
      *reinterpret_cast<float4*>(u_row) = make_float4(0, 0, 0, 0);
    }
    if (c0 == (tpr - 1) * kSeg) {
      *reinterpret_cast<float4*>(sq_row + S - kPad) = make_float4(0, 0, 0, 0);
      *reinterpret_cast<float4*>(u_row + S - kPad) = make_float4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int h = depth / 2, h2 = depth - 1 - depth / 2;
  float v[kSeg];
  windows<Depth>(sq_row, c0, C, h, h2, v);
#pragma unroll
  for (int e = 0; e < kSeg; ++e) {
    const float d = k + alpha * v[e];
    const float dpow = exp2f(-beta * __log2f(d));         // d^(-beta)
    v[e] = gv[e] * xv[e] * __fdividef(dpow, d);           // g x d^(-beta-1)
    gv[e] *= dpow;
  }
  {  // u, zero past C, so that depth 5's unclipped window stays exact
    float4* q = reinterpret_cast<float4*>(u_row + kPad + c0);
#pragma unroll
    for (int i = 0; i < kSeg / 4; ++i)
      q[i] = make_float4(4 * i < n ? v[4 * i] : 0.0f,
                         4 * i + 1 < n ? v[4 * i + 1] : 0.0f,
                         4 * i + 2 < n ? v[4 * i + 2] : 0.0f,
                         4 * i + 3 < n ? v[4 * i + 3] : 0.0f);
  }
  __syncthreads();

  // the mirrored window [c - h2, c + h]
  windows<Depth>(u_row, c0, C, h2, h, v);
  const float coef = 2.0f * alpha * beta;
#pragma unroll
  for (int e = 0; e < kSeg; ++e) v[e] = gv[e] - coef * xv[e] * v[e];
  if (n > 0) store_seg<Vec>(dx + at, n, v);
}

template <typename T, bool Vec>
cudaError_t launch(const T* x, const T* g, T* dx, long long R, int C,
                   int depth, float alpha, float beta, float k,
                   cudaStream_t stream) {
  const Layout L = layout(C);
  const long long blocks = (R + L.P - 1) / L.P;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      2 * sizeof(float) * (size_t)L.P * (L.tpr * kSeg + 2 * kPad);
  if (depth == 5)
    lrn_bwd_kernel<T, Vec, 5><<<(unsigned)blocks, L.P * L.tpr, smem,
                                stream>>>(x, g, dx, R, C, L.tpr, L.P, depth,
                                          alpha, beta, k);
  else
    lrn_bwd_kernel<T, Vec, 0><<<(unsigned)blocks, L.P * L.tpr, smem,
                                stream>>>(x, g, dx, R, C, L.tpr, L.P, depth,
                                          alpha, beta, k);
  return cudaGetLastError();
}

template <typename T>
int lrn_bwd(const T* x, const T* g, T* dx, long long R, int C, int depth,
            float alpha, float beta, float k, void* stream) {
  if (C < 1 || C > kMaxChannels || depth < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = vector_path<T>(C, reinterpret_cast<uintptr_t>(x) |
                                         reinterpret_cast<uintptr_t>(g) |
                                         reinterpret_cast<uintptr_t>(dx));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<T, true>(x, g, dx, R, C, depth, alpha, beta, k, s)
                   : launch<T, false>(x, g, dx, R, C, depth, alpha, beta, k,
                                      s));
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
