// Fused GRU backward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/fused_gru.py::_gru_bwd_kernel
// (launched by _bwd_recurrence through pl.pallas_call). It walks the
// forward's time steps in reverse, in kernel time order (flipped when the
// layer runs reversed), reading the reserve the training forward saved
// (fused_gru.cu: the post-activation r, z, n and the raw hg_n), so h @ R is
// never recomputed. With `carry` the gradient reaching h_t from step t+1
// (0 at the last step):
//
//   dh   = dout[t] + carry
//   ga_n = dh * (1 - z) * (1 - n^2)               (gradient of xg_n)
//   ga_z = dh * (h_{t-1} - n) * z * (1 - z)
//   ga_r = ga_n * hg_n * r * (1 - r)
//   carry = z * dh + [ga_r, ga_z, r * ga_n] @ R^T  (for step t-1)
//
// The direct term z * dh lands in the unit's own column only; the product
// couples all H units. h_{t-1} is h0 at the first step and out[t-1] after
// it, read as the forward stored them. The carry left after step 0 is dh0,
// emitted by the kernel as _gru_bwd_kernel emits it: it holds the direct
// term and the r scaling, so it cannot be formed outside from dg[0] alone.
// The kernel emits the pre-activation gate gradients dg = [ga_r ga_z ga_n]
// as one [T, B, 3H] float32 buffer (each gate a [T, B, H] slice, so every
// product outside is one GEMM) and dh0. dx, dW, dR and db are plain
// products formed outside by the wrapper (ops/cuda/fused_gru.py), as
// _fused_bwd does; dR takes r * ga_n in the n block, dW, db and dx ga_n.
//
// Types: R^T, h0, out and dout are all float32 (dl4j_gru_bwd) or all
// bfloat16 (dl4j_gru_bwd_bf16); the reserve, dg and dh0 are float32. As in
// the Pallas kernel, the carry stays f32, and in bf16 [ga_r, ga_z,
// r * ga_n] enters the product rounded to bf16 (exact bf16 x bf16 products
// summed in f32).
//
// What bounds it on this card: every step reads all of R^T [3H, H] to do
// 2*B*3H*H flops, so at training batch sizes it is far below the H100's
// ridge point: memory- and latency-bound, like the forward.
//
// Design (simple and right first; it mirrors fused_lstm_bwd.cu):
// - A block owns RB batch rows and all H units and loops over t inside the
//   block: the carry couples every unit, so a block that owned a slice of H
//   could not form it without a grid-wide sync. Rows are independent, so
//   blocks never wait on one another.
// - The wrapper passes R transposed once per call, Rt [3H, H] contiguous,
//   so that the product reads it exactly as the forward reads R: each warp
//   takes a (32-unit tile, slice of the 3H reduction) work item, lane k
//   accumulates column k of Rt over its slice (coalesced across the warp)
//   for all RB rows held in registers, and the partial sums meet in shared
//   memory.
// - Phase A sums the partials and the previous step's direct term into the
//   carry, forms the gate gradients in f32 registers, stores dg, and keeps
//   this step's product operands and direct term in shared memory; one
//   barrier; phase B forms the partial products; a second barrier ends the
//   step. Step 0 runs phase B too: its carry is dh0.
// The fast design (R resident in shared memory across a thread-block
// cluster, wgmma, more rows per SM) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // slices of the 3H reduction
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use

// element type <-> f32 (round to nearest even on the way down)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// a float rounded to the element type and back: what enters the product
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// read-only cached load
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Shared memory layout (floats):
//   gh   [RB][3H]                 this step's [ga_r ga_z r*ga_n], rounded to E
//   zdh  [RB][H]                  this step's direct term z * dh
//   part [slices][tiles][RB][32]  partial sums of gh @ R^T
template <typename E, int RB>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const float* __restrict__ reserve,  // [4, T, B, H]
               const E* __restrict__ Rt,           // [3H, H]
               const E* __restrict__ h0,           // [B, H]
               const E* __restrict__ out,          // [T, B, H]
               const E* __restrict__ dout,         // [T, B, H]
               float* __restrict__ dg,             // [T, B, 3H]
               float* __restrict__ dh0,            // [B, H]
               int T, int B, int H, int slices) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int tiles = (H + kTile - 1) / kTile;
  float* gh = smem;
  float* zdh = gh + RB * G;
  float* part = zdh + RB * H;

  const size_t plane = (size_t)T * B * H;
  const float* rr = reserve;
  const float* rz = reserve + plane;
  const float* rn = reserve + 2 * plane;
  const float* rhgn = reserve + 3 * plane;

  const int b0 = blockIdx.x * RB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kchunk = (G + slices - 1) / slices;

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase A: the carry, the gate gradients, the product operands.
    // Each (row, unit) belongs to one thread for the whole walk, so zdh
    // needs no barrier of its own.
    for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
      const int r = idx / H, u = idx - r * H, b = b0 + r;
      float* gh_r = gh + (size_t)r * G;
      if (b >= B) {
        gh_r[u] = gh_r[H + u] = gh_r[2 * H + u] = 0.0f;
        zdh[idx] = 0.0f;
        continue;
      }
      float dh = 0.0f;
      if (t < T - 1) {
        const int tile = u / kTile, l = u % kTile;
        for (int ks = 0; ks < slices; ++ks)
          dh += part[((size_t)(ks * tiles + tile) * RB + r) * kTile + l];
        dh += zdh[idx];
      }
      const size_t at = ((size_t)t * B + b) * H + u;
      dh += to_f32(dout[at]);
      const float rg = rr[at], zg = rz[at], ng = rn[at];
      const float h_prev = t > 0 ? to_f32(out[at - (size_t)B * H])
                                 : to_f32(h0[(size_t)b * H + u]);
      const float ga_n = dh * (1.0f - zg) * (1.0f - ng * ng);
      const float ga_z = dh * (h_prev - ng) * zg * (1.0f - zg);
      const float ga_r = ga_n * rhgn[at] * rg * (1.0f - rg);
      float* dg_t = dg + ((size_t)t * B + b) * G;
      dg_t[u] = ga_r;
      dg_t[H + u] = ga_z;
      dg_t[2 * H + u] = ga_n;
      gh_r[u] = round_to(ga_r, Rt);
      gh_r[H + u] = round_to(ga_z, Rt);
      gh_r[2 * H + u] = round_to(rg * ga_n, Rt);
      zdh[idx] = zg * dh;
    }
    __syncthreads();

    // ---- phase B: partial gh @ R^T over (unit tile, slice) items
    for (int item = warp; item < tiles * slices; item += kWarps) {
      const int tile = item / slices, ks = item - tile * slices;
      const int k = min(tile * kTile + lane, H - 1);  // clamp: in bounds
      const int col_begin = ks * kchunk;
      const int col_end = min(G, col_begin + kchunk);
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      const E* Rk = Rt + (size_t)col_begin * H + k;
#pragma unroll 4
      for (int col = col_begin; col < col_end; ++col, Rk += H) {
        const float rv = ldg_f32(Rk);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          acc[r] = fmaf(gh[(size_t)r * G + col], rv, acc[r]);
      }
      float* p = part + (size_t)(ks * tiles + tile) * RB * kTile;
#pragma unroll
      for (int r = 0; r < RB; ++r) p[r * kTile + lane] = acc[r];
    }
    __syncthreads();
  }

  // the carry after step 0 is dh0
  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H, u = idx - r * H, b = b0 + r;
    if (b >= B) continue;
    const int tile = u / kTile, l = u % kTile;
    float s = zdh[idx];
    for (int ks = 0; ks < slices; ++ks)
      s += part[((size_t)(ks * tiles + tile) * RB + r) * kTile + l];
    dh0[(size_t)b * H + u] = s;
  }
}

size_t smem_bytes(int rb, int H, int slices) {
  const int tiles = (H + kTile - 1) / kTile;
  return sizeof(float) * ((size_t)rb * 3 * H + (size_t)rb * H +
                          (size_t)slices * tiles * rb * kTile);
}

template <typename E, int RB>
cudaError_t launch(const float* reserve, const E* Rt, const E* h0,
                   const E* out, const E* dout, float* dg, float* dh0, int T,
                   int B, int H, int slices, cudaStream_t stream) {
  const size_t smem = smem_bytes(RB, H, slices);
  if (smem > 48 * 1024) {
    // opt in above the default 48 KB on the calling thread's current
    // device; set per launch, as the attribute is per device (and cheap)
    cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_kernel<E, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + RB - 1) / RB);
  gru_bwd_kernel<E, RB><<<grid, kThreads, smem, stream>>>(
      reserve, Rt, h0, out, dout, dg, dh0, T, B, H, slices);
  return cudaGetLastError();
}

template <typename E>
int gru_bwd(const float* reserve, const E* Rt, const E* h0, const E* out,
            const E* dout, float* dg, float* dh0, int T, int B, int H,
            void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (H + kTile - 1) / kTile;
  int rb = 1;
  while (rb < 8 && rb < B) rb *= 2;
  while (rb > 1 && smem_bytes(rb, H, 1) > kSmemCap) rb /= 2;
  if (smem_bytes(rb, H, 1) > kSmemCap) return (int)cudaErrorInvalidValue;
  // more slices of the 3H reduction while warps would idle, each >= 16 long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         3 * H >= 16 * slices * 2 &&
         smem_bytes(rb, H, slices * 2) <= kSmemCap)
    slices *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rb) {
    case 8: return (int)launch<E, 8>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H, slices, s);
    case 4: return (int)launch<E, 4>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H, slices, s);
    case 2: return (int)launch<E, 2>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H, slices, s);
    default: return (int)launch<E, 1>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H, slices, s);
  }
}

}  // namespace

extern "C" {

// Launch the reverse walk on `stream`; each returns a cudaError_t (0 =
// launched). `reserve`, `dg` and `dh0` are float32; every other pointer is
// of the function's one element type.
int dl4j_gru_bwd(const float* reserve, const float* Rt, const float* h0,
                 const float* out, const float* dout, float* dg, float* dh0,
                 int T, int B, int H, void* stream) {
  return gru_bwd<float>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H, stream);
}

int dl4j_gru_bwd_bf16(const float* reserve, const __nv_bfloat16* Rt,
                      const __nv_bfloat16* h0, const __nv_bfloat16* out,
                      const __nv_bfloat16* dout, float* dg, float* dh0,
                      int T, int B, int H, void* stream) {
  return gru_bwd<__nv_bfloat16>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H,
                                stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
