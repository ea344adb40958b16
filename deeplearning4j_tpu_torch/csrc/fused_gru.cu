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
// Two designs; the launcher (gru_fwd) chooses by shape and by what the
// card can co-schedule, never because a launch failed:
//
// - Cluster (gru_fwd_cluster_kernel), for T > 1 where a cluster can hold R:
//   every step needs all of R [H, 3H] (768 KB in f32 at H=256), more than
//   one SM's 227 KB, but a thread-block cluster of 8 (or 16) holds it.
//   CTA c of a cluster owns hidden units [c U, (c + 1) U) (U at most 32,
//   one a lane) and loads its three gate columns of R (r, z and n of those
//   units) into shared memory once, with cp.async; they stay there, in R's
//   type, for all T steps. A cluster owns RB batch rows; ceil(B / RB)
//   clusters run side by side, RB the smallest that lets every cluster be
//   resident at one CTA an SM (cudaOccupancyMaxActiveClusters). Each step,
//   each CTA: its 8 warps each take a k-slice of hg = h_{t-1} R for its
//   units and rows (lane = unit, RB rows in registers, h_{t-1} read as
//   float4 broadcasts from its local copy [RB, H]); after one barrier a
//   thread per (row, unit) sums the slices, applies the gates in f32, keeps
//   the f32 carry of its unit in a register, writes out, hT and the
//   reserve, and stores its rounded h_t into every CTA's h buffer through
//   distributed shared memory (double-buffered by step parity); one
//   cluster barrier ends the step. f32 and bf16 products stay on the CUDA
//   cores: h_{t-1} enters rounded to R's type and the sums are f32.
// - Stream (gru_fwd_kernel), for T == 1 (decode) and any shape whose R
//   does not fit in a cluster (H=1024): a block owns RB <= 8 batch rows
//   and a tile of hidden units; rows are independent, so blocks never wait
//   on one another. When T > 1 a block owns all H units (every step needs
//   the whole h_{t-1}) and loops over T inside the block; when T == 1
//   there is no next step, so the units are split across blocks to spread
//   the read of R over more SMs. h_{t-1} for the block's rows sits in
//   shared memory twice: rounded to the element type for the product, and
//   the f32 carry of the block's own units. R streams from device memory /
//   L2 once per step per block and is reused for all RB rows held in
//   registers. Each warp takes a (32-unit tile, k-slice) work item: lane j
//   accumulates the three gate columns R[:, j], R[:, H+j], R[:, 2H+j] over
//   its k-slice (coalesced across the warp); their partial sums meet in
//   shared memory. After one barrier, threads sum the partials, apply the
//   gates in f32 registers, and publish h_t to shared memory; a second
//   barrier ends the step.
// Later work: wgmma for the bf16 step product, and decode replayed by CUDA
// graphs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // k-slices per unit tile
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use
// the cluster design
constexpr int kClusterWarps = 8;           // k-slices of a step's product
constexpr int kClusterThreads = kClusterWarps * 32;
constexpr int kClusterUnits = 32;          // hidden units a CTA owns, at most
constexpr int kClusterSizes[] = {8, 16};   // CTAs a cluster, in order of choice
constexpr size_t kClusterSmemCap = 227 * 1024;  // all a block may use

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

// ------------------------------------------------------------ cluster design

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Units a CTA owns in a cluster of C: ceil(H / C), rounded up to even so
// that a bf16 pair of units starts on a 4-byte boundary when H is even.
inline int cluster_units(int H, int C) { return ((H + C - 1) / C + 1) & ~1; }

// Shared memory of a cluster CTA (bytes), with HP = H rounded up to 4:
//   Rs   [HP][3][kClusterUnits] E   its gate columns of R, resident
//   hs   [2][RB][HP] f32            h_{t-1} rounded to E, by step parity
//   part [kClusterWarps][3][RB][32] f32   partial sums by k-slice
size_t cluster_smem_bytes(int rb, int H, int e) {
  const size_t hp = (size_t)((H + 3) & ~3);
  return hp * 3 * kClusterUnits * e +
         sizeof(float) * (2 * rb * hp + (size_t)kClusterWarps * 3 * rb * 32);
}

// Rs[k][g][u] = R[k][g H + j0 + u] for k < H and u < nu; zero elsewhere
// (rows up to HP, lanes up to 32), so padding never meets a weight.
template <typename E>
__device__ __forceinline__ void load_r_slice(E* Rs, const E* R, int H, int HP,
                                             int j0, int nu) {
  const int G = 3 * H;
  if constexpr (sizeof(E) == 4) {
    for (int idx = threadIdx.x; idx < HP * 3 * kClusterUnits;
         idx += kClusterThreads) {
      const int u = idx % kClusterUnits, kg = idx / kClusterUnits;
      const int g = kg % 3, k = kg / 3;
      const bool in = k < H && u < nu;
      cp_async4(Rs + idx, R + (in ? (size_t)k * G + g * H + j0 + u : 0),
                in ? 4 : 0);
    }
  } else {  // bf16 pairs of units, one cp.async where 4-byte aligned
    for (int idx = threadIdx.x; idx < HP * 3 * kClusterUnits / 2;
         idx += kClusterThreads) {
      const int u = 2 * (idx % (kClusterUnits / 2));
      const int kg = idx / (kClusterUnits / 2);
      const int g = kg % 3, k = kg / 3;
      const E* src = R + (size_t)k * G + g * H + j0 + u;
      E* dst = Rs + 2 * idx;
      if (k < H && u + 1 < nu &&
          (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
        cp_async4(dst, src, 4);
      } else {
        dst[0] = k < H && u < nu ? src[0] : from_f32<E>(0.0f);
        dst[1] = k < H && u + 1 < nu ? src[1] : from_f32<E>(0.0f);
      }
    }
  }
}

template <typename E, int RB>
__global__ void __launch_bounds__(kClusterThreads, 1)
gru_fwd_cluster_kernel(const E* __restrict__ xg,    // [T, B, 3H]
                       const E* __restrict__ R,     // [H, 3H]
                       const E* __restrict__ h0,    // [B, H]
                       E* __restrict__ out,         // [T, B, H]
                       E* __restrict__ hT,          // [B, H]
                       float* __restrict__ reserve, // [4, T, B, H] or null
                       int T, int B, int H, int U) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = (H + 3) & ~3;
  E* Rs = reinterpret_cast<E*>(smem_raw);
  float* hs = reinterpret_cast<float*>(
      smem_raw + (size_t)HP * 3 * kClusterUnits * sizeof(E));
  float* part = hs + 2 * RB * HP;

  const int C = (int)cluster.num_blocks();
  const int j0 = (int)cluster.block_rank() * U;
  const int nu = max(0, min(U, H - j0));   // units this CTA owns
  const int b0 = (blockIdx.x / C) * RB;
  const int G = 3 * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_r_slice<E>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // h0 (of the element type, so its rounded copy and the carry agree) into
  // the step-0 buffer; the other buffer's padding columns stay zero
  for (int idx = threadIdx.x; idx < 2 * RB * HP; idx += kClusterThreads) {
    const int r = (idx / HP) % RB, k = idx % HP, b = b0 + r;
    hs[idx] = idx < RB * HP && b < B && k < H
                  ? to_f32(h0[(size_t)b * H + k]) : 0.0f;
  }
  // the thread of (row gr, unit j) keeps that unit's f32 carry
  const int gr = warp, j = j0 + lane;
  const bool owner = gr < RB && lane < nu;
  const int b = b0 + gr;
  const bool live = owner && b < B;
  float carry = live ? to_f32(h0[(size_t)b * H + j]) : 0.0f;
  float xv[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    xv[g] = live ? to_f32(xg[(size_t)b * G + g * H + j]) : 0.0f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // every CTA of the cluster is running and initialised before any CTA
  // stores into another's buffers
  cluster.sync();

  // this warp's k-slice, a multiple of 4 long
  const int kslice = ((HP / 4 + kClusterWarps - 1) / kClusterWarps) * 4;
  const int k_begin = min(HP, warp * kslice);
  const int k_end = min(HP, k_begin + kslice);
  const size_t plane = (size_t)T * B * H;

  for (int t = 0; t < T; ++t) {
    // the next step's gates are known now: their load overlaps the product
    float xn[3] = {0.0f, 0.0f, 0.0f};
    if (live && t + 1 < T) {
      const E* x_next = xg + ((size_t)(t + 1) * B + b) * G + j;
#pragma unroll
      for (int g = 0; g < 3; ++g) xn[g] = to_f32(x_next[g * H]);
    }

    // ---- this warp's k-slice of h_{t-1} @ R for its 32 units, RB rows
    const float* hcur = hs + (t & 1) * RB * HP;
    float acc[3][RB];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[g][r] = 0.0f;
    for (int k = k_begin; k < k_end; k += 4) {
      float4 h4[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        h4[r] = *reinterpret_cast<const float4*>(hcur + r * HP + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const E* rk = Rs + (size_t)(k + kk) * 3 * kClusterUnits + lane;
        const float rr = to_f32(rk[0]);
        const float rz = to_f32(rk[kClusterUnits]);
        const float rn = to_f32(rk[2 * kClusterUnits]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = kk == 0 ? h4[r].x : kk == 1 ? h4[r].y
                         : kk == 2 ? h4[r].z : h4[r].w;
          acc[0][r] = fmaf(hk, rr, acc[0][r]);
          acc[1][r] = fmaf(hk, rz, acc[1][r]);
          acc[2][r] = fmaf(hk, rn, acc[2][r]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r)
        part[((warp * 3 + g) * RB + r) * 32 + lane] = acc[g][r];
    __syncthreads();

    // ---- the gates of (row gr, unit j); h_t to every CTA of the cluster
    if (owner) {
      float hg[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kClusterWarps; ++w)
          sum += part[((w * 3 + g) * RB + gr) * 32 + lane];
        hg[g] = sum;
      }
      const float rg = sigmoid_f(xv[0] + hg[0]);
      const float zg = sigmoid_f(xv[1] + hg[1]);
      const float ng = tanhf(xv[2] + rg * hg[2]);
      const float h_new = (1.0f - zg) * ng + zg * carry;
      const E h_st = from_f32<E>(h_new);
      carry = h_new;
      // the next product reads h in the element type, as the Pallas
      // kernel casts it
      float* dst = hs + ((t + 1) & 1) * RB * HP + gr * HP + j;
      const float h_r = to_f32(h_st);
      for (int q = 0; q < C; ++q) *cluster.map_shared_rank(dst, q) = h_r;
      if (live) {
        const size_t at = ((size_t)t * B + b) * H + j;
        out[at] = h_st;
        if (reserve != nullptr) {
          reserve[at] = rg;
          reserve[plane + at] = zg;
          reserve[2 * plane + at] = ng;
          reserve[3 * plane + at] = hg[2];
        }
        if (t == T - 1) hT[(size_t)b * H + j] = h_st;
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) xv[g] = xn[g];
    // h_t has reached every CTA, and this step's buffers are free
    cluster.sync();
  }
}

// Calls f(std::integral_constant<int, rb>) for rb in {1, 2, 4, 8}: the
// kernels' row counts are template arguments.
template <typename F>
auto by_rows(int rb, F f) {
  switch (rb) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return f(std::integral_constant<int, 1>{});
  }
}

// Opts the cluster kernel in to `smem_max` bytes of dynamic shared memory
// and, past 8 CTAs, to its cluster size, and fills `cfg` for `clusters`
// clusters of C CTAs with `smem` bytes each.
template <typename E, int RB>
cudaError_t cluster_config(int C, int clusters, size_t smem, size_t smem_max,
                           cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  auto kernel = gru_fwd_cluster_kernel<E, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C * clusters);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// How many clusters of C CTAs, each with `smem` bytes of dynamic shared
// memory, the card holds at once (cudaOccupancyMaxActiveClusters), cached
// by (device, type, rows, C, smem).
template <typename E, int RB>
cudaError_t active_clusters(int C, size_t smem, int* n) {
  struct Entry { int dev, c; size_t smem; int n; };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> g(lock);
    for (int i = 0; i < used; ++i)
      if (cache[i].dev == dev && cache[i].c == C && cache[i].smem == smem) {
        *n = cache[i].n;
        return cudaSuccess;
      }
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = cluster_config<E, RB>(C, 1, smem, kClusterSmemCap, nullptr, &attr,
                              &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, gru_fwd_cluster_kernel<E, RB>,
                                         &cfg);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> g(lock);
  if (used < 64) cache[used++] = {dev, C, smem, *n};
  return cudaSuccess;
}

// ------------------------------------------------------------------ choice

// What the launcher runs for a [T, B, *, H] call: the cluster design (C
// CTAs a cluster, RB rows a cluster) or the stream design (RB rows a
// block, upb units a block, k-slices a unit tile), and the dynamic shared
// memory of a block.
struct Plan {
  int cluster, C, rb, upb, slices;
  size_t smem;
};

template <typename E>
cudaError_t plan_fwd(int T, int B, int H, Plan* plan) {
  int rb_max = 1;
  while (rb_max < 8 && rb_max < B) rb_max *= 2;
  if (T > 1) {
    int C = 0;
    for (int c : kClusterSizes)
      if (cluster_units(H, c) <= kClusterUnits) { C = c; break; }
    if (C > 0) {
      // clusters the card holds at one CTA an SM: the fewest rows a
      // cluster that lets every cluster be resident at once
      int slots = 0;
      cudaError_t err = active_clusters<E, 1>(C, kClusterSmemCap, &slots);
      if (err != cudaSuccess) return err;
      int rb = 1;
      while (rb < rb_max && (B + rb - 1) / rb > slots) rb *= 2;
      while (rb > 1 && cluster_smem_bytes(rb, H, sizeof(E)) > kClusterSmemCap)
        rb /= 2;
      const size_t smem = cluster_smem_bytes(rb, H, sizeof(E));
      int fits = 0;
      if (smem <= kClusterSmemCap) {
        err = by_rows(rb, [&](auto r) {
          return active_clusters<E, decltype(r)::value>(C, smem, &fits);
        });
        if (err != cudaSuccess) return err;
      }
      if (fits >= 1) {
        *plan = {1, C, rb, 0, 0, smem};
        return cudaSuccess;
      }
    }
  }
  // stream: T == 1 splits units across blocks; T > 1: a block needs all of h
  const int upb = T == 1 ? std::min(H, kTile) : H;
  const int tiles = (upb + kTile - 1) / kTile;
  int rb = rb_max;
  while (rb > 1 && smem_bytes(rb, H, upb, 1) > kSmemCap) rb /= 2;
  if (smem_bytes(rb, H, upb, 1) > kSmemCap) return cudaErrorInvalidValue;
  // more k-slices while warps would idle, each slice >= 16 k long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         H >= 16 * slices * 2 &&
         smem_bytes(rb, H, upb, slices * 2) <= kSmemCap)
    slices *= 2;
  *plan = {0, 0, rb, upb, slices, smem_bytes(rb, H, upb, slices)};
  return cudaSuccess;
}

template <typename E>
int gru_fwd(const E* xg, const E* R, const E* h0, E* out, E* hT,
            float* reserve, int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_fwd<E>(T, B, H, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_rows(p.rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    if (!p.cluster)
      return launch<E, RB>(xg, R, h0, out, hT, reserve, T, B, H, p.upb,
                           p.slices, s);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = cluster_config<E, RB>(p.C, (B + RB - 1) / RB, p.smem,
                                          p.smem, s, &attr, &cfg);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, gru_fwd_cluster_kernel<E, RB>, xg, R, h0,
                              out, hT, reserve, T, B, H,
                              cluster_units(H, p.C));
  });
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

// The launcher's choice for a [T, B, *, H] call of the element type (bf16
// nonzero: bfloat16, else float32) on the current device: out = {1 for the
// cluster design or 0 for the stream design, C (0 for stream), RB, dynamic
// shared memory bytes}. Returns a cudaError_t.
int dl4j_gru_fwd_plan(int T, int B, int H, int bf16, int* out) {
  Plan plan;
  cudaError_t err = bf16 ? plan_fwd<__nv_bfloat16>(T, B, H, &plan)
                         : plan_fwd<float>(T, B, H, &plan);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.cluster;
  out[1] = plan.C;
  out[2] = plan.rb;
  out[3] = (int)plan.smem;
  return 0;
}

// cudaOccupancyMaxActiveClusters of the cluster kernel (RB rows) for
// clusters of C CTAs with `smem` bytes each, into *n.
int dl4j_gru_active_clusters(int bf16, int rb, int C, int smem, int* n) {
  return (int)by_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? active_clusters<__nv_bfloat16, RB>(C, smem, n)
                : active_clusters<float, RB>(C, smem, n);
  });
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
