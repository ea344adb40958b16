// Fused LSTM backward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/fused_lstm.py::_lstm_bwd_kernel
// (launched by _bwd_recurrence through pl.pallas_call). It walks the
// forward's time steps in reverse, in kernel time order (flipped when the
// layer runs reversed), reading the reserve the training forward saved
// (fused_lstm.cu: c_t and the post-activation gates i, f, o, z), so h @ R is
// never recomputed. With dh_rec the carry from step t+1 (0 at the last step)
// and dc the cell-state carry (dcT at the last step):
//
//   dh  = dout[t] + dh_rec                    th = tanh(c_t)
//   dgo = dh * th * o * (1 - o)
//   dc  = dc + dh * o * (1 - th^2)  (+ dgo * p_o with peepholes)
//   dgi = dc * z * i * (1 - i)      dgf = dc * c_{t-1} * f * (1 - f)
//   dgz = dc * i * (1 - z^2)
//   dc  = dc * f                    (+ dgi * p_i + dgf * p_f with peepholes)
//   dh_rec = [dgi dgf dgo dgz] @ R^T          (for step t-1)
//
// c_{t-1} is c0 at the first step and the reserve's c_{t-1} after it. It
// emits the pre-activation gate gradients dg = [dgi dgf dgo dgz] as one
// [T, B, 4H] float32 buffer (each gate a [T, B, H] slice, so every product
// outside the kernel is one GEMM) and dc0, the final dc carry. dh0, dx, dW,
// dR, db and the peephole sums are plain products, formed outside the
// kernel by the wrapper (ops/cuda/fused_lstm.py), as _fused_bwd does.
//
// Types: R, c0, dout, dcT and the peepholes are all float32
// (dl4j_lstm_bwd) or all bfloat16 (dl4j_lstm_bwd_bf16); the reserve, dg and
// dc0 are float32. As in the Pallas kernel, the carries dh_rec and dc stay
// f32, and in bf16 dg enters the product rounded to bf16 (exact bf16 x bf16
// products summed in f32).
//
// What bounds it on this card: every step reads all of R [4H, H] (640 KB in
// f32 at H=200) to do 2*B*4H*H flops, so at training batch sizes it is far
// below the H100's ridge point: memory- and latency-bound, like the forward.
//
// Design (simple and right first; it mirrors the forward kernel):
// - A block owns RB batch rows and all H units and loops over t inside the
//   block (every step needs the whole dh_rec); rows are independent, so
//   blocks never wait on one another.
// - The wrapper passes R transposed once per call, Rt [4H, H] contiguous, so
//   that the product dg @ R^T reads it exactly as the forward reads R: each
//   warp takes a (32-unit tile, slice of the 4H reduction) work item, lane k
//   accumulates column k of Rt over its slice (coalesced across the warp)
//   for all RB rows held in registers, and the partial sums meet in shared
//   memory.
// - Phase A sums the partials into dh_rec, forms the gate gradients in f32
//   registers, stores dg, and keeps the dc carry and this step's dg in
//   shared memory; one barrier; phase B forms the partial products; a
//   second barrier ends the step. The last step (t = 0) needs no product.
// The fast design (R resident in shared memory across a thread-block
// cluster, wgmma, more rows per SM) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // slices of the 4H reduction
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
//   dgs  [RB][4H]                 this step's dg, rounded to E
//   dc   [RB][H]                  dc carry
//   part [slices][tiles][RB][32]  partial sums of dh_rec
template <typename E, int RB>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const float* __restrict__ reserve,  // [5, T, B, H]
                const E* __restrict__ Rt,           // [4H, H]
                const E* __restrict__ c0,           // [B, H]
                const E* __restrict__ dout,         // [T, B, H]
                const E* __restrict__ dcT,          // [B, H] or null
                const E* __restrict__ peep,         // [3H] or null
                float* __restrict__ dg,             // [T, B, 4H]
                float* __restrict__ dc0,            // [B, H]
                int T, int B, int H, int slices) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int tiles = (H + kTile - 1) / kTile;
  float* dgs = smem;
  float* dc = dgs + RB * G;
  float* part = dc + RB * H;

  const size_t plane = (size_t)T * B * H;
  const float* cseq = reserve;
  const float* gi = reserve + plane;
  const float* gf = reserve + 2 * plane;
  const float* go = reserve + 3 * plane;
  const float* gz = reserve + 4 * plane;

  const int b0 = blockIdx.x * RB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kchunk = (G + slices - 1) / slices;

  // each (row, unit) belongs to one thread for the whole walk, so the dc
  // carry needs no barrier of its own
  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H, u = idx - r * H, b = b0 + r;
    dc[idx] = (b < B && dcT != nullptr) ? to_f32(dcT[(size_t)b * H + u]) : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase A: dh_rec from the partials, gate gradients, dc carry
    for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
      const int r = idx / H, u = idx - r * H, b = b0 + r;
      float* dgs_r = dgs + (size_t)r * G;
      if (b >= B) {
        dgs_r[u] = dgs_r[H + u] = dgs_r[2 * H + u] = dgs_r[3 * H + u] = 0.0f;
        continue;
      }
      float dh = 0.0f;
      if (t < T - 1) {
        const int tile = u / kTile, l = u % kTile;
        for (int ks = 0; ks < slices; ++ks)
          dh += part[((size_t)(ks * tiles + tile) * RB + r) * kTile + l];
      }
      const size_t at = ((size_t)t * B + b) * H + u;
      dh += to_f32(dout[at]);
      const float i = gi[at], f = gf[at], o = go[at], z = gz[at];
      const float c = cseq[at];
      const float c_prev = t > 0 ? cseq[at - (size_t)B * H]
                                 : to_f32(c0[(size_t)b * H + u]);
      const float th = tanhf(c);
      const float dgo = (dh * th) * o * (1.0f - o);
      float d = dc[idx] + dh * o * (1.0f - th * th);
      if (peep != nullptr) d += dgo * to_f32(peep[2 * H + u]);
      const float dgi = (d * z) * i * (1.0f - i);
      const float dgf = (d * c_prev) * f * (1.0f - f);
      const float dgz = (d * i) * (1.0f - z * z);
      float d_prev = d * f;
      if (peep != nullptr)
        d_prev += dgi * to_f32(peep[u]) + dgf * to_f32(peep[H + u]);
      dc[idx] = d_prev;
      float* dg_t = dg + ((size_t)t * B + b) * G;
      dg_t[u] = dgi;
      dg_t[H + u] = dgf;
      dg_t[2 * H + u] = dgo;
      dg_t[3 * H + u] = dgz;
      dgs_r[u] = round_to(dgi, Rt);
      dgs_r[H + u] = round_to(dgf, Rt);
      dgs_r[2 * H + u] = round_to(dgo, Rt);
      dgs_r[3 * H + u] = round_to(dgz, Rt);
    }
    if (t == 0) break;  // dh0 is formed outside, as in _fused_bwd
    __syncthreads();

    // ---- phase B: partial dh_rec = dg @ R^T over (unit tile, slice) items
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
          acc[r] = fmaf(dgs[(size_t)r * G + col], rv, acc[r]);
      }
      float* p = part + (size_t)(ks * tiles + tile) * RB * kTile;
#pragma unroll
      for (int r = 0; r < RB; ++r) p[r * kTile + lane] = acc[r];
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < RB * H; idx += blockDim.x) {
    const int r = idx / H, u = idx - r * H, b = b0 + r;
    if (b < B) dc0[(size_t)b * H + u] = dc[idx];
  }
}

size_t smem_bytes(int rb, int H, int slices) {
  const int tiles = (H + kTile - 1) / kTile;
  return sizeof(float) * ((size_t)rb * 4 * H + (size_t)rb * H +
                          (size_t)slices * tiles * rb * kTile);
}

template <typename E, int RB>
cudaError_t launch(const float* reserve, const E* Rt, const E* c0,
                   const E* dout, const E* dcT, const E* peep, float* dg,
                   float* dc0, int T, int B, int H, int slices,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(RB, H, slices);
  if (smem > 48 * 1024) {
    // opt in above the default 48 KB on the calling thread's current
    // device; set per launch, as the attribute is per device (and cheap)
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_kernel<E, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + RB - 1) / RB);
  lstm_bwd_kernel<E, RB><<<grid, kThreads, smem, stream>>>(
      reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B, H, slices);
  return cudaGetLastError();
}

template <typename E>
int lstm_bwd(const float* reserve, const E* Rt, const E* c0, const E* dout,
             const E* dcT, const E* peep, float* dg, float* dc0, int T,
             int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (H + kTile - 1) / kTile;
  int rb = 1;
  while (rb < 8 && rb < B) rb *= 2;
  while (rb > 1 && smem_bytes(rb, H, 1) > kSmemCap) rb /= 2;
  if (smem_bytes(rb, H, 1) > kSmemCap) return (int)cudaErrorInvalidValue;
  // more slices of the 4H reduction while warps would idle, each >= 16 long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         4 * H >= 16 * slices * 2 &&
         smem_bytes(rb, H, slices * 2) <= kSmemCap)
    slices *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rb) {
    case 8: return (int)launch<E, 8>(reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B, H, slices, s);
    case 4: return (int)launch<E, 4>(reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B, H, slices, s);
    case 2: return (int)launch<E, 2>(reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B, H, slices, s);
    default: return (int)launch<E, 1>(reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B, H, slices, s);
  }
}

}  // namespace

extern "C" {

// Launch the reverse walk on `stream`; each returns a cudaError_t (0 =
// launched). `reserve`, `dg` and `dc0` are float32; every other pointer is
// of the function's one element type; `dcT` and `peep` may be null.
int dl4j_lstm_bwd(const float* reserve, const float* Rt, const float* c0,
                  const float* dout, const float* dcT, const float* peep,
                  float* dg, float* dc0, int T, int B, int H, void* stream) {
  return lstm_bwd<float>(reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B, H,
                         stream);
}

int dl4j_lstm_bwd_bf16(const float* reserve, const __nv_bfloat16* Rt,
                       const __nv_bfloat16* c0, const __nv_bfloat16* dout,
                       const __nv_bfloat16* dcT, const __nv_bfloat16* peep,
                       float* dg, float* dc0, int T, int B, int H,
                       void* stream) {
  return lstm_bwd<__nv_bfloat16>(reserve, Rt, c0, dout, dcT, peep, dg, dc0,
                                 T, B, H, stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
