// Fused LSTM forward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/fused_lstm.py::_lstm_kernel
// (launched by _fused_recurrence through pl.pallas_call). It computes the
// time-major recurrence over pre-projected gates:
//
//   g_t = xg_t + h_{t-1} @ R                       (IFOG gate order)
//   i = sigmoid(g_i + c_{t-1} * p_i)   f = sigmoid(g_f + c_{t-1} * p_f)
//   z = tanh(g_z)                      c_t = f * c_{t-1} + i * z
//   o = sigmoid(g_o + c_t * p_o)       h_t = o * tanh(c_t)
//
// with the GravesLSTM peepholes p optional. The input projection x @ W + b,
// the forget-gate bias and the reverse flip stay outside, as in the JAX
// package (_project_gates).
//
// Training: given a `reserve` buffer [5, T, B, H] float32, the kernel also
// writes the reserve the backward kernel (fused_lstm_bwd.cu) reads: the cell
// state c_t and the post-activation gates i, f, o, z, in that order and in
// kernel time order, as _lstm_kernel does with save_residuals. A null
// reserve (serving, and every call made under torch.no_grad) writes nothing.
//
// Types: all tensors are float32 (dl4j_lstm_fwd) or all bfloat16
// (dl4j_lstm_fwd_bf16). In bf16, as in the Pallas kernel, the sums, the
// gates and the cell state c stay in f32 registers and shared memory;
// h_{t-1} enters the product rounded to bf16 (exact bf16 x bf16 products
// summed in f32), and out, hT and cT are rounded to bf16 on store.
//
// What bounds it on this card: every step reads all of R [H, 4H] (1 MiB in
// f32 at H=256, half that in bf16) to do 2*B*H*4H flops, so at decode batch sizes it is far
// below the H100's ridge point and memory-bound; at decode (T=1) the launch
// latency around it is larger still than the bytes.
//
// Design (simple and right first):
// - A block owns RB batch rows and a tile of hidden units; rows are
//   independent, so blocks never wait on one another. When T > 1 a block
//   owns all H units (every step needs the whole h_{t-1}) and loops over T
//   inside the block; when T == 1 there is no next step, so the units are
//   split across blocks to spread the read of R over more SMs.
// - h_{t-1} for the block's rows sits in shared memory; R streams from
//   device memory / L2 once per step per block and is reused for all RB
//   rows held in registers.
// - Each warp takes a (32-unit tile, k-slice) work item: lane j accumulates
//   the four gate columns R[:, j], R[:, H+j], R[:, 2H+j], R[:, 3H+j] over its
//   k-slice (coalesced across the warp). Several k-slices per tile keep
//   enough loads in flight per SM; their partial sums meet in shared memory.
// - After one barrier, threads sum the partials, apply the cell update in
//   f32 registers, and publish h_t to shared memory; a second barrier ends
//   the step.
// The fast design (R slices resident in shared memory across a thread-block
// cluster, h exchanged through distributed shared memory, decode replayed by
// CUDA graphs) is later work.

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
//   h    [RB][H]                     h_{t-1}, then h_t
//   c    [RB][upb]                   c of the block's own units
//   part [slices][tiles][4][RB][32]  partial gate sums
template <typename E, int RB>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const E* __restrict__ xg,    // [T, B, 4H]
                const E* __restrict__ R,     // [H, 4H]
                const E* __restrict__ h0,    // [B, H]
                const E* __restrict__ c0,    // [B, H]
                const E* __restrict__ peep,  // [3H] or null
                E* __restrict__ out,         // [T, B, H]
                E* __restrict__ hT,          // [B, H]
                E* __restrict__ cT,          // [B, H]
                float* __restrict__ reserve, // [5, T, B, H] or null
                int T, int B, int H, int upb, int slices) {
  extern __shared__ float smem[];
  const int tiles = (upb + kTile - 1) / kTile;
  float* h = smem;
  float* c = h + RB * H;
  float* part = c + RB * upb;

  const int G = 4 * H;
  const int b0 = blockIdx.x * RB;
  const int j0 = blockIdx.y * upb;
  const int nu = min(upb, H - j0);         // units this block owns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kchunk = (H + slices - 1) / slices;

  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H, k = idx - r * H, b = b0 + r;
    h[idx] = b < B ? to_f32(h0[(size_t)b * H + k]) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < RB * nu; idx += blockDim.x) {
    const int r = idx / nu, u = idx - r * nu, b = b0 + r;
    c[r * upb + u] = b < B ? to_f32(c0[(size_t)b * H + j0 + u]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- phase 1: partial h_{t-1} @ R over (unit tile, k-slice) items
    for (int item = warp; item < tiles * slices; item += kWarps) {
      const int tile = item / slices, ks = item - tile * slices;
      const int j = min(j0 + tile * kTile + lane, H - 1);  // clamp: in bounds
      const int k_begin = ks * kchunk;
      const int k_end = min(H, k_begin + kchunk);
      float acc[4][RB];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[g][r] = 0.0f;
      const E* Rk = R + (size_t)k_begin * G + j;
#pragma unroll 4
      for (int k = k_begin; k < k_end; ++k, Rk += G) {
        const float ri = ldg_f32(Rk);
        const float rf = ldg_f32(Rk + H);
        const float ro = ldg_f32(Rk + 2 * H);
        const float rz = ldg_f32(Rk + 3 * H);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = h[r * H + k];
          acc[0][r] = fmaf(hk, ri, acc[0][r]);
          acc[1][r] = fmaf(hk, rf, acc[1][r]);
          acc[2][r] = fmaf(hk, ro, acc[2][r]);
          acc[3][r] = fmaf(hk, rz, acc[3][r]);
        }
      }
      float* p = part + (size_t)(ks * tiles + tile) * 4 * RB * kTile;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) p[(g * RB + r) * kTile + lane] = acc[g][r];
    }
    __syncthreads();

    // ---- phase 2: sum partials, cell update, publish h_t
    const E* xg_t = xg + (size_t)t * B * G;
    for (int idx = threadIdx.x; idx < RB * nu; idx += blockDim.x) {
      const int r = idx / nu, u = idx - r * nu, b = b0 + r;
      const int j = j0 + u;
      const int tile = u / kTile, l = u % kTile;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = b < B ? to_f32(xg_t[(size_t)b * G + g * H + j]) : 0.0f;
        for (int ks = 0; ks < slices; ++ks)
          s += part[((size_t)(ks * tiles + tile) * 4 * RB + g * RB + r) * kTile + l];
        gate[g] = s;
      }
      const float c_old = c[r * upb + u];
      if (peep != nullptr) {
        gate[0] += c_old * to_f32(peep[j]);
        gate[1] += c_old * to_f32(peep[H + j]);
      }
      const float ig = sigmoid_f(gate[0]);
      const float fg = sigmoid_f(gate[1]);
      const float zg = tanhf(gate[3]);
      const float c_new = fg * c_old + ig * zg;
      if (peep != nullptr) gate[2] += c_new * to_f32(peep[2 * H + j]);
      const float og = sigmoid_f(gate[2]);
      const E h_st = from_f32<E>(og * tanhf(c_new));
      c[r * upb + u] = c_new;
      // phase 1 of this step is over: safe to overwrite; the next product
      // reads h in the element type, as the Pallas kernel casts it
      h[r * H + j] = to_f32(h_st);
      if (b < B) {
        const size_t at = ((size_t)t * B + b) * H + j;
        out[at] = h_st;
        if (reserve != nullptr) {
          const size_t plane = (size_t)T * B * H;
          reserve[at] = c_new;
          reserve[plane + at] = ig;
          reserve[2 * plane + at] = fg;
          reserve[3 * plane + at] = og;
          reserve[4 * plane + at] = zg;
        }
        if (t == T - 1) {
          hT[(size_t)b * H + j] = h_st;
          cT[(size_t)b * H + j] = from_f32<E>(c_new);
        }
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int rb, int H, int upb, int slices) {
  const int tiles = (upb + kTile - 1) / kTile;
  return sizeof(float) * ((size_t)rb * H + (size_t)rb * upb +
                          (size_t)slices * tiles * 4 * rb * kTile);
}

template <typename E, int RB>
cudaError_t launch(const E* xg, const E* R, const E* h0, const E* c0,
                   const E* peep, E* out, E* hT, E* cT, float* reserve, int T,
                   int B, int H, int upb, int slices, cudaStream_t stream) {
  const size_t smem = smem_bytes(RB, H, upb, slices);
  if (smem > 48 * 1024) {
    // opt in above the default 48 KB on the calling thread's current
    // device; set per launch, as the attribute is per device (and cheap)
    cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel<E, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + RB - 1) / RB, (H + upb - 1) / upb);
  lstm_fwd_kernel<E, RB><<<grid, kThreads, smem, stream>>>(
      xg, R, h0, c0, peep, out, hT, cT, reserve, T, B, H, upb, slices);
  return cudaGetLastError();
}

template <typename E>
int lstm_fwd(const E* xg, const E* R, const E* h0, const E* c0,
             const E* peep, E* out, E* hT, E* cT, float* reserve, int T,
             int B, int H, void* stream) {
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
    case 8: return (int)launch<E, 8>(xg, R, h0, c0, peep, out, hT, cT, reserve, T, B, H, upb, slices, s);
    case 4: return (int)launch<E, 4>(xg, R, h0, c0, peep, out, hT, cT, reserve, T, B, H, upb, slices, s);
    case 2: return (int)launch<E, 2>(xg, R, h0, c0, peep, out, hT, cT, reserve, T, B, H, upb, slices, s);
    default: return (int)launch<E, 1>(xg, R, h0, c0, peep, out, hT, cT, reserve, T, B, H, upb, slices, s);
  }
}

}  // namespace

extern "C" {

// Launch the recurrence on `stream`; each returns a cudaError_t (0 =
// launched). Every pointer but `reserve` (float32, or null) is of the
// function's one element type.
int dl4j_lstm_fwd(const float* xg, const float* R, const float* h0,
                  const float* c0, const float* peep, float* out, float* hT,
                  float* cT, float* reserve, int T, int B, int H,
                  void* stream) {
  return lstm_fwd<float>(xg, R, h0, c0, peep, out, hT, cT, reserve, T, B, H,
                         stream);
}

int dl4j_lstm_fwd_bf16(const __nv_bfloat16* xg, const __nv_bfloat16* R,
                       const __nv_bfloat16* h0, const __nv_bfloat16* c0,
                       const __nv_bfloat16* peep, __nv_bfloat16* out,
                       __nv_bfloat16* hT, __nv_bfloat16* cT, float* reserve,
                       int T, int B, int H, void* stream) {
  return lstm_fwd<__nv_bfloat16>(xg, R, h0, c0, peep, out, hT, cT, reserve, T,
                                 B, H, stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
