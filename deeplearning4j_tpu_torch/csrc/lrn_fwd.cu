// Local response normalization forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/lrn.py::_lrn_kernel (launched by
// _lrn_forward through pl.pallas_call). On the [R, C] row view of a
// channels-last tensor (R pixels, C channels, channel axis contiguous):
//
//   ssum[r, c] = sum of x[r, j]^2 for j in [c - h, c + depth - 1 - h]
//   y[r, c]    = x[r, c] / (k + alpha * ssum[r, c])^beta,   h = depth / 2
//
// the window clipped to [0, C). It is asymmetric for even depth, as the
// XLA lowering's and the Pallas kernel's band (_band) are. Types: x and y
// both float32 (dl4j_lrn_fwd) or both bfloat16 (dl4j_lrn_fwd_bf16); the
// arithmetic is f32 and y is rounded to the element type once, as in the
// Pallas kernel.
//
// What bounds it on this card: memory. Each element is read once and
// written once for about depth + 5 flops and one power, far below the
// H100's ridge point: at AlexNet's conv1 LRN, [128, 54, 54, 96] f32, the
// byte bound is 85.6 us at 3.35 TB/s. So the design spends as few
// instructions an element as it can and keeps enough loads in flight. It
// is the backward's (lrn_bwd.cu) without its second pass, on the layout
// of lrn_common.cuh:
//
// - A thread owns kSeg = 8 consecutive channels of one row, loaded and
//   stored as 16-byte vectors where x and y are 16-byte aligned and C is
//   a multiple of the vector; else element by element (conv outputs are
//   not always aligned, and C = 77 or C = 3 never is a multiple). A block
//   owns P whole rows, tpr = ceil(C / kSeg) threads a row, so the thread's
//   row and channels come from one division when it starts, none an
//   element. Blocks are small (at most 256 threads and 16.4 KB of
//   shared memory) and many, so several are resident on an SM and HBM
//   stays busy.
// - One shared array of P rows of x^2, each padded by kPad zeros on both
//   sides. After one barrier a thread reads its window as float4s (its 8
//   channels and kPad on either side).
// - d^(-beta) is exp2(-beta log2 d) (the MUFU log2 and exp2) and y is x
//   times it: no powf and no division.
// - AlexNet's depth, 5, is a template constant: the window is five
//   register adds an element, unclipped thanks to the zero padding. Any
//   other depth >= 1 takes the same kernel with a run-time window clipped
//   to the row.

#include "lrn_common.cuh"

namespace {

using namespace lrn;

// v[i]^2 of a thread's channels into its shared row (at its left padding),
// and the row's padding by its first and last thread
__device__ __forceinline__ void put_squares(float* row, int c0, int tpr,
                                            const float* v) {
  float4* q = reinterpret_cast<float4*>(row + kPad + c0);
#pragma unroll
  for (int i = 0; i < kSeg / 4; ++i)
    q[i] = make_float4(v[4 * i] * v[4 * i], v[4 * i + 1] * v[4 * i + 1],
                       v[4 * i + 2] * v[4 * i + 2],
                       v[4 * i + 3] * v[4 * i + 3]);
  if (c0 == 0) *reinterpret_cast<float4*>(row) = make_float4(0, 0, 0, 0);
  if (c0 == (tpr - 1) * kSeg)
    *reinterpret_cast<float4*>(row + tpr * kSeg + kPad) =
        make_float4(0, 0, 0, 0);
}

// Depth: 5 for the unrolled window, 0 for any depth (run-time, clipped).
// Vec: 16-byte loads and stores.
template <typename T, bool Vec, int Depth>
__global__ void __launch_bounds__(kMaxThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long R,
               int C, int tpr, int P, int depth, float alpha, float beta,
               float k) {
  extern __shared__ __align__(16) float sq[];  // [P][S] x^2
  const int S = tpr * kSeg + 2 * kPad;         // a shared row, padded
  const int rr = threadIdx.x / tpr;            // row of the block
  const int c0 = (threadIdx.x - rr * tpr) * kSeg;  // first channel
  const long long r = (long long)blockIdx.x * P + rr;
  const int n = r < R ? min(kSeg, C - c0) : 0;     // channels in range
  const size_t at = (size_t)r * C + c0;
  float* row = sq + (size_t)rr * S;

  float xv[kSeg];
  if (n > 0) {
    load_seg<Vec>(x + at, n, xv);
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) xv[i] = 0.0f;
  }
  put_squares(row, c0, tpr, xv);  // zero past C, and the row's padding
  __syncthreads();

  float v[kSeg];
  windows<Depth>(row, c0, C, depth / 2, depth - 1 - depth / 2, v);
#pragma unroll
  for (int e = 0; e < kSeg; ++e)
    v[e] = xv[e] * exp2f(-beta * __log2f(k + alpha * v[e]));  // x d^(-beta)
  if (n > 0) store_seg<Vec>(y + at, n, v);
}

template <typename T, bool Vec>
cudaError_t launch(const T* x, T* y, long long R, int C, int depth,
                   float alpha, float beta, float k, cudaStream_t stream) {
  const Layout L = layout(C);
  const long long blocks = (R + L.P - 1) / L.P;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)L.P * (L.tpr * kSeg + 2 * kPad);
  if (depth == 5)
    lrn_fwd_kernel<T, Vec, 5><<<(unsigned)blocks, L.P * L.tpr, smem,
                                stream>>>(x, y, R, C, L.tpr, L.P, depth,
                                          alpha, beta, k);
  else
    lrn_fwd_kernel<T, Vec, 0><<<(unsigned)blocks, L.P * L.tpr, smem,
                                stream>>>(x, y, R, C, L.tpr, L.P, depth,
                                          alpha, beta, k);
  return cudaGetLastError();
}

template <typename T>
int lrn_fwd(const T* x, T* y, long long R, int C, int depth, float alpha,
            float beta, float k, void* stream) {
  if (C < 1 || C > kMaxChannels || depth < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = vector_path<T>(C, reinterpret_cast<uintptr_t>(x) |
                                         reinterpret_cast<uintptr_t>(y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<T, true>(x, y, R, C, depth, alpha, beta, k, s)
                   : launch<T, false>(x, y, R, C, depth, alpha, beta, k, s));
}

}  // namespace

extern "C" {

// Launch the forward on `stream`; each returns a cudaError_t (0 =
// launched). x and y are [R, C] row-major of the function's element type;
// C <= 4096.
int dl4j_lrn_fwd(const float* x, float* y, long long R, int C, int depth,
                 float alpha, float beta, float k, void* stream) {
  return lrn_fwd<float>(x, y, R, C, depth, alpha, beta, k, stream);
}

int dl4j_lrn_fwd_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, long long R,
                      int C, int depth, float alpha, float beta, float k,
                      void* stream) {
  return lrn_fwd<__nv_bfloat16>(x, y, R, C, depth, alpha, beta, k, stream);
}

// The launchers' design for C channels, x and y 16-byte aligned or not
// (`aligned`), bf16 or f32: out = {1 for 16-byte vectors, 0 element by
// element; rows a block; threads a row}. Returns a cudaError_t.
int dl4j_lrn_fwd_plan(int C, int aligned, int bf16, int* out) {
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  const uintptr_t pointers = aligned ? 0 : 1;
  const Layout L = layout(C);
  out[0] = bf16 ? vector_path<__nv_bfloat16>(C, pointers)
                : vector_path<float>(C, pointers);
  out[1] = L.P;
  out[2] = L.tpr;
  return 0;
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
