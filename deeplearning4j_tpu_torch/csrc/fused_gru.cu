// Fused GRU forward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/fused_gru.py::_gru_kernel
// (launched by _fused_gru_recurrence through pl.pallas_call). It computes
// the time-major recurrence over pre-projected gates xg = x @ W + b:
//
//   hg  = h_{t-1} @ R                             (gate order r, z, n)
//   r   = sigmoid(xg_r + hg_r)     z = sigmoid(xg_z + hg_z)
//   n   = tanh(xg_n + r * hg_n)                   (linear before reset)
//   h_t = (1 - z) * n + z * h_{t-1}
//
// The recurrent projection hg is kept apart from xg: n mixes them through
// r, so the two cannot be summed before the gates split, as the LSTM's
// can. The bias sits entirely in xg; there is no recurrent bias. The input
// projection and the reverse flip stay outside, as in the JAX package
// (_project_gates).
//
// Training: given a `reserve` buffer [4, T, B, H] float32, the kernel also
// writes what the backward kernel (fused_gru_bwd.cu) reads: the
// post-activation r, z, n and the raw hg_n (before it is multiplied by r),
// in that order and in kernel time order, as _gru_kernel does with
// save_residuals. A null reserve (serving, and every call made under
// torch.no_grad) writes nothing.
//
// Types: all tensors are float32 (dl4j_gru_fwd) or all bfloat16
// (dl4j_gru_fwd_bf16). As in the Pallas kernel, the sums, the gates and the
// carry h stay f32 (h_t's update reads the f32 h_{t-1}); h_{t-1} enters the
// product rounded to the element type (exact products summed in f32), and
// out and hT are rounded on store.
//
// What bounds it on this card: every step reads all of R [H, 3H] (768 KB
// in f32 at H=256, 12 MB at H=1024) to do 2*B*H*3H flops, so at these
// batch sizes it is far below the H100's ridge point: memory- and
// latency-bound; at decode (T=1) the launch latency around it is larger
// still than the bytes.
//
// Design (simple and right first; it mirrors fused_lstm.cu):
// - A block owns RB batch rows and a tile of hidden units; rows are
//   independent, so blocks never wait on one another. When T > 1 a block
//   owns all H units (every step needs the whole h_{t-1}) and loops over T
//   inside the block; when T == 1 there is no next step, so the units are
//   split across blocks to spread the read of R over more SMs.
// - h_{t-1} for the block's rows sits in shared memory twice: rounded to
//   the element type for the product, and the f32 carry of the block's own
//   units. R streams from device memory / L2 once per step per block and
//   is reused for all RB rows held in registers.
// - Each warp takes a (32-unit tile, k-slice) work item: lane j accumulates
//   the three gate columns R[:, j], R[:, H+j], R[:, 2H+j] over its k-slice
//   (coalesced across the warp). Several k-slices per tile keep enough
//   loads in flight per SM; their partial sums meet in shared memory.
// - After one barrier, threads sum the partials, apply the gates in f32
//   registers, and publish h_t to shared memory; a second barrier ends the
//   step.
// The fast design (R slices resident in shared memory across a
// thread-block cluster, h exchanged through distributed shared memory,
// wgmma, decode replayed by CUDA graphs) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // k-slices per unit tile
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// element type <-> f32 (round to nearest even on the way down)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// read-only cached load
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Shared memory layout (floats):
//   h    [RB][H]                     h_{t-1} rounded to E, then h_t
//   hc   [RB][upb]                   f32 carry of the block's own units
//   part [slices][tiles][3][RB][32]  partial sums of h @ R
template <typename E, int RB>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const E* __restrict__ xg,    // [T, B, 3H]
               const E* __restrict__ R,     // [H, 3H]
               const E* __restrict__ h0,    // [B, H]
               E* __restrict__ out,         // [T, B, H]
               E* __restrict__ hT,          // [B, H]
               float* __restrict__ reserve, // [4, T, B, H] or null
               int T, int B, int H, int upb, int slices) {
  extern __shared__ float smem[];
  const int tiles = (upb + kTile - 1) / kTile;
  float* h = smem;
  float* hc = h + RB * H;
  float* part = hc + RB * upb;

  const int G = 3 * H;
  const int b0 = blockIdx.x * RB;
  const int j0 = blockIdx.y * upb;
  const int nu = min(upb, H - j0);         // units this block owns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kchunk = (H + slices - 1) / slices;

  // h0 is of the element type, so the rounded copy and the carry agree
  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H, k = idx - r * H, b = b0 + r;
    h[idx] = b < B ? to_f32(h0[(size_t)b * H + k]) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < RB * nu; idx += blockDim.x) {
    const int r = idx / nu, u = idx - r * nu, b = b0 + r;
    hc[r * upb + u] = b < B ? to_f32(h0[(size_t)b * H + j0 + u]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- phase 1: partial h_{t-1} @ R over (unit tile, k-slice) items
    for (int item = warp; item < tiles * slices; item += kWarps) {
      const int tile = item / slices, ks = item - tile * slices;
      const int j = min(j0 + tile * kTile + lane, H - 1);  // clamp: in bounds
      const int k_begin = ks * kchunk;
      const int k_end = min(H, k_begin + kchunk);
      float acc[3][RB];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[g][r] = 0.0f;
      const E* Rk = R + (size_t)k_begin * G + j;
#pragma unroll 4
      for (int k = k_begin; k < k_end; ++k, Rk += G) {
        const float rr = ldg_f32(Rk);
        const float rz = ldg_f32(Rk + H);
        const float rn = ldg_f32(Rk + 2 * H);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = h[r * H + k];
          acc[0][r] = fmaf(hk, rr, acc[0][r]);
          acc[1][r] = fmaf(hk, rz, acc[1][r]);
          acc[2][r] = fmaf(hk, rn, acc[2][r]);
        }
      }
      float* p = part + (size_t)(ks * tiles + tile) * 3 * RB * kTile;
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) p[(g * RB + r) * kTile + lane] = acc[g][r];
    }
    __syncthreads();

    // ---- phase 2: sum partials, gates, publish h_t
    const E* xg_t = xg + (size_t)t * B * G;
    for (int idx = threadIdx.x; idx < RB * nu; idx += blockDim.x) {
      const int r = idx / nu, u = idx - r * nu, b = b0 + r;
      const int j = j0 + u;
      const int tile = u / kTile, l = u % kTile;
      float hg[3], xv[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float s = 0.0f;
        for (int ks = 0; ks < slices; ++ks)
          s += part[((size_t)(ks * tiles + tile) * 3 * RB + g * RB + r) * kTile + l];
        hg[g] = s;
        xv[g] = b < B ? to_f32(xg_t[(size_t)b * G + g * H + j]) : 0.0f;
      }
      const float rg = sigmoid_f(xv[0] + hg[0]);
      const float zg = sigmoid_f(xv[1] + hg[1]);
      const float ng = tanhf(xv[2] + rg * hg[2]);
      const float h_new = (1.0f - zg) * ng + zg * hc[r * upb + u];
      const E h_st = from_f32<E>(h_new);
      hc[r * upb + u] = h_new;
      // phase 1 of this step is over: safe to overwrite; the next product
      // reads h in the element type, as the Pallas kernel casts it
      h[r * H + j] = to_f32(h_st);
      if (b < B) {
        const size_t at = ((size_t)t * B + b) * H + j;
        out[at] = h_st;
        if (reserve != nullptr) {
          const size_t plane = (size_t)T * B * H;
          reserve[at] = rg;
          reserve[plane + at] = zg;
          reserve[2 * plane + at] = ng;
          reserve[3 * plane + at] = hg[2];
        }
        if (t == T - 1) hT[(size_t)b * H + j] = h_st;
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int rb, int H, int upb, int slices) {
  const int tiles = (upb + kTile - 1) / kTile;
  return sizeof(float) * ((size_t)rb * H + (size_t)rb * upb +
                          (size_t)slices * tiles * 3 * rb * kTile);
}

template <typename E, int RB>
cudaError_t launch(const E* xg, const E* R, const E* h0, E* out, E* hT,
                   float* reserve, int T, int B, int H, int upb, int slices,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(RB, H, upb, slices);
  if (smem > 48 * 1024) {
    // opt in above the default 48 KB on the calling thread's current
    // device; set per launch, as the attribute is per device (and cheap)
    cudaError_t err = cudaFuncSetAttribute(
        gru_fwd_kernel<E, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + RB - 1) / RB, (H + upb - 1) / upb);
  gru_fwd_kernel<E, RB><<<grid, kThreads, smem, stream>>>(
      xg, R, h0, out, hT, reserve, T, B, H, upb, slices);
  return cudaGetLastError();
}

template <typename E>
int gru_fwd(const E* xg, const E* R, const E* h0, E* out, E* hT,
            float* reserve, int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  // T == 1: split units across blocks; T > 1: a block needs all of h.
  const int upb = T == 1 ? std::min(H, kTile) : H;
  const int tiles = (upb + kTile - 1) / kTile;
  int rb = 1;
  while (rb < 8 && rb < B) rb *= 2;
  while (rb > 1 && smem_bytes(rb, H, upb, 1) > kSmemCap) rb /= 2;
  if (smem_bytes(rb, H, upb, 1) > kSmemCap) return (int)cudaErrorInvalidValue;
  // more k-slices while warps would idle, each slice >= 16 k long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         H >= 16 * slices * 2 &&
         smem_bytes(rb, H, upb, slices * 2) <= kSmemCap)
    slices *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rb) {
    case 8: return (int)launch<E, 8>(xg, R, h0, out, hT, reserve, T, B, H, upb, slices, s);
    case 4: return (int)launch<E, 4>(xg, R, h0, out, hT, reserve, T, B, H, upb, slices, s);
    case 2: return (int)launch<E, 2>(xg, R, h0, out, hT, reserve, T, B, H, upb, slices, s);
    default: return (int)launch<E, 1>(xg, R, h0, out, hT, reserve, T, B, H, upb, slices, s);
  }
}

}  // namespace

extern "C" {

// Launch the recurrence on `stream`; each returns a cudaError_t (0 =
// launched). Every pointer but `reserve` (float32, or null) is of the
// function's one element type.
int dl4j_gru_fwd(const float* xg, const float* R, const float* h0,
                 float* out, float* hT, float* reserve, int T, int B, int H,
                 void* stream) {
  return gru_fwd<float>(xg, R, h0, out, hT, reserve, T, B, H, stream);
}

int dl4j_gru_fwd_bf16(const __nv_bfloat16* xg, const __nv_bfloat16* R,
                      const __nv_bfloat16* h0, __nv_bfloat16* out,
                      __nv_bfloat16* hT, float* reserve, int T, int B, int H,
                      void* stream) {
  return gru_fwd<__nv_bfloat16>(xg, R, h0, out, hT, reserve, T, B, H,
                                stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
