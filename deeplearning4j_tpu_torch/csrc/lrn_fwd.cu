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
// written once for depth + 4 flops and one powf, far below the H100's
// ridge point: at AlexNet's conv1 LRN, [128, 54, 54, 96] f32, the byte
// bound is 85.6 us at 3.35 TB/s.
//
// Design (simple and right first). The TPU kernel forms the window sum as
// a dense [C, C] band product on the MXU; here that would multiply the work
// by C / depth, so the sum is taken directly over the depth neighbours:
// - A block owns a run of whole rows, kTile elements at most (one row if C
//   is larger), and rows are contiguous in memory, so the block reads one
//   contiguous span, coalesced across its threads.
// - Each thread loads its elements (kItems at most) into registers and
//   writes their squares to shared memory; after one barrier it sums each
//   element's window from shared memory and stores y. x is read from
//   device memory once and y written once.
// - Any depth >= 1 and any C up to kTile (4096) run; the wrapper refuses a
//   larger C.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long R,
               int C, int rows_per_block, int depth, float alpha, float beta,
               float k) {
  __shared__ float sq[kTile];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, R - row0);
  const int n = rows * C;
  const long long base = row0 * C;
  const int lo_off = depth / 2;                // window: [c - lo_off,
  const int hi_off = depth - 1 - depth / 2;    //          c + hi_off]

  float v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < n) {
      v[i] = to_f32(x[base + e]);
      sq[e] = v[i] * v[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < n) {
      const int r = e / C;
      const int c = e - r * C;
      const float* s = sq + r * C;
      const int lo = max(0, c - lo_off);
      const int hi = min(C - 1, c + hi_off);
      float ssum = 0.f;
      for (int j = lo; j <= hi; ++j) ssum += s[j];
      const float d = k + alpha * ssum;
      store(y + base + e, v[i] / powf(d, beta));
    }
  }
}

template <typename T>
int lrn_fwd(const T* x, T* y, long long R, int C, int depth, float alpha,
            float beta, float k, void* stream) {
  if (C < 1 || C > kTile || depth < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = kTile / C;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lrn_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, y, R, C, rows_per_block, depth, alpha, beta, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the forward on `stream`; each returns a cudaError_t (0 = launched).
// x and y are [R, C] row-major of the function's element type; C <= 4096.
int dl4j_lrn_fwd(const float* x, float* y, long long R, int C, int depth,
                 float alpha, float beta, float k, void* stream) {
  return lrn_fwd<float>(x, y, R, C, depth, alpha, beta, k, stream);
}

int dl4j_lrn_fwd_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, long long R,
                      int C, int depth, float alpha, float beta, float k,
                      void* stream) {
  return lrn_fwd<__nv_bfloat16>(x, y, R, C, depth, alpha, beta, k, stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
