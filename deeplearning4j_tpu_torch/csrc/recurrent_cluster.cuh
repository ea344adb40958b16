// The thread-block-cluster layer of the recurrent kernels (sm_90a).
//
// Every step of a recurrence needs all of R [H, G H] (G gates: 3 for the
// GRU, 4 for the LSTM), 768 KB to 1 MB in f32 at H=256: more than one SM's
// 227 KB of shared memory, but a thread-block cluster of 8 (or 16) CTAs
// holds it. CTA c of a cluster of C owns hidden units [c U, c U + U) (U at
// most 32, one a lane) and loads the G gate columns of R for those units
// into shared memory once, with cp.async; they stay there, in R's type, for
// all T steps. A cluster owns RB batch rows; ceil(B / RB) clusters run side
// by side, RB the fewest rows that let every cluster be resident at one CTA
// an SM (cudaOccupancyMaxActiveClusters). What a step has to share across
// the cluster (h_t in the forwards, the partial carries in the GRU
// backward) goes through distributed shared memory, double-buffered by step
// parity, with one cluster barrier a step.
//
// The kernels built on it: gru_fwd_cluster_kernel (fused_gru.cu),
// gru_bwd_cluster_kernel (fused_gru_bwd.cu) and lstm_fwd_cluster_kernel
// (fused_lstm.cu). This header holds what they share: the element-type
// helpers, the R loader, the launch configuration and occupancy query, and
// the planner of cluster size and rows a cluster. Each launcher falls back
// to its stream design where plan_cluster finds no cluster that holds R,
// before any launch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterWarps = 8;           // warps of a cluster CTA
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

// Rs[k * Row + g * kClusterUnits + u] = R[k][g H + j0 + u] for k < H and
// u < nu; zero elsewhere (rows up to HP, lanes up to kClusterUnits), so
// padding never meets a weight. Row (elements, at least G kClusterUnits
// and even) may leave padding at the end of each row, never written. The
// kClusterThreads threads of the CTA copy with cp.async; the caller
// commits and waits for the copies.
template <typename E, int G, int Row = G * kClusterUnits>
__device__ __forceinline__ void load_r_slice(E* Rs, const E* R, int H,
                                             int HP, int j0, int nu) {
  const int ld = G * H;
  if constexpr (sizeof(E) == 4) {
    for (int idx = threadIdx.x; idx < HP * G * kClusterUnits;
         idx += kClusterThreads) {
      const int u = idx % kClusterUnits, kg = idx / kClusterUnits;
      const int g = kg % G, k = kg / G;
      const bool in = k < H && u < nu;
      cp_async4(Rs + (size_t)k * Row + g * kClusterUnits + u,
                R + (in ? (size_t)k * ld + g * H + j0 + u : 0), in ? 4 : 0);
    }
  } else {  // bf16 pairs of units, one cp.async where 4-byte aligned
    for (int idx = threadIdx.x; idx < HP * G * kClusterUnits / 2;
         idx += kClusterThreads) {
      const int u = 2 * (idx % (kClusterUnits / 2));
      const int kg = idx / (kClusterUnits / 2);
      const int g = kg % G, k = kg / G;
      const E* src = R + (size_t)k * ld + g * H + j0 + u;
      E* dst = Rs + (size_t)k * Row + g * kClusterUnits + u;
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

// Shared memory of a forward cluster CTA (bytes) for G gates, RB rows and
// elements of e bytes, with HP = H rounded up to 4:
//   Rs   [HP][G][kClusterUnits] E   its gate columns of R, resident
//   hs   [2][RB][HP] f32            h_{t-1} rounded to E, by step parity
//   part [kClusterWarps][G][RB][32] f32   partial sums by k-slice
inline size_t fwd_cluster_smem_bytes(int rb, int H, int G, int e) {
  const size_t hp = (size_t)((H + 3) & ~3);
  return hp * G * kClusterUnits * e +
         sizeof(float) * (2 * rb * hp + (size_t)kClusterWarps * G * rb * 32);
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

// Opts `kernel` in to `smem_max` bytes of dynamic shared memory and, past
// 8 CTAs, to its cluster size, and fills `cfg` for `clusters` clusters of C
// CTAs of kClusterThreads threads with `smem` bytes each.
template <typename K>
cudaError_t cluster_config(K kernel, int C, int clusters, size_t smem,
                           size_t smem_max, cudaStream_t stream,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
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

// How many clusters of C CTAs of `kernel`, each with `smem` bytes of
// dynamic shared memory, the card holds at once
// (cudaOccupancyMaxActiveClusters), cached by (device, kernel, C, smem).
template <typename K>
cudaError_t active_clusters(K kernel, int C, size_t smem, int* n) {
  struct Entry { int dev; const void* fn; int c; size_t smem; int n; };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> g(lock);
    for (int i = 0; i < used; ++i)
      if (cache[i].dev == dev && cache[i].fn == fn && cache[i].c == C &&
          cache[i].smem == smem) {
        *n = cache[i].n;
        return cudaSuccess;
      }
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = cluster_config(kernel, C, 1, smem, kClusterSmemCap, nullptr, &attr,
                       &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> g(lock);
  if (used < 64) cache[used++] = {dev, fn, C, smem, *n};
  return cudaSuccess;
}

// The cluster a [T > 1, B, *, H] call takes: C CTAs a cluster (0: no
// cluster holds R, take the stream design), RB rows a cluster and the
// dynamic shared memory of a CTA.
struct ClusterPlan {
  int C, rb;
  size_t smem;
};

// The first cluster size that gives a CTA at most kClusterUnits units;
// then rows a cluster: the fewest (a power of two, up to 8 and up to B
// rounded up) that let every cluster be resident at one CTA an SM, halved
// while the shared memory exceeds the cap. No cluster when that is still
// over the cap or the card holds none. `smem_of(rb, C)` is a CTA's shared
// memory; `slots(rb, C, smem, &n)` the card's active clusters of the
// kernel's instance for rb rows.
template <typename SmemFn, typename SlotsFn>
cudaError_t plan_cluster(int B, int H, SmemFn smem_of, SlotsFn slots,
                         ClusterPlan* plan) {
  *plan = ClusterPlan{0, 0, 0};
  int C = 0;
  for (int c : kClusterSizes)
    if (cluster_units(H, c) <= kClusterUnits) { C = c; break; }
  if (C == 0) return cudaSuccess;
  int rb_max = 1;
  while (rb_max < 8 && rb_max < B) rb_max *= 2;
  int resident = 0;
  cudaError_t err = slots(1, C, kClusterSmemCap, &resident);
  if (err != cudaSuccess) return err;
  int rb = 1;
  while (rb < rb_max && (B + rb - 1) / rb > resident) rb *= 2;
  while (rb > 1 && smem_of(rb, C) > kClusterSmemCap) rb /= 2;
  const size_t smem = smem_of(rb, C);
  int fits = 0;
  if (smem <= kClusterSmemCap) {
    err = slots(rb, C, smem, &fits);
    if (err != cudaSuccess) return err;
  }
  if (fits >= 1) *plan = ClusterPlan{C, rb, smem};
  return cudaSuccess;
}

}  // namespace
