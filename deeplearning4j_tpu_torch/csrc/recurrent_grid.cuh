// The grid-resident layer of the recurrent kernels (sm_90a).
//
// Past H = 512 no thread-block cluster holds R [H, G H] (12 MB in f32 at
// H = 1024 for the GRU), but the whole card does: 132 SMs of 227 KB hold
// about 30 MB. So R is split across more CTAs than a cluster has (the
// persistent-RNN design: Diamos et al., "Persistent RNNs", ICML 2016).
// CTA c of a row group of n CTAs owns hidden units [c U, c U + U) (U at
// most kGridSlots * 4 / sizeof(E): 16 in f32, 32 in bf16) and loads their
// G gate columns of R into shared memory once; they stay there for all T
// steps. A row group owns RB batch rows; the groups that the card holds
// run side by side, and a group takes its next RB rows after its last
// step while rows are left (passes).
//
// What a step shares goes through L2, with one barrier a step over the
// CTAs of a row group (only CTAs that share rows wait for each other):
// the forward's h_t, the backward's partial carries. Every such buffer is
// double-buffered by step parity, so one barrier a step suffices: a CTA
// rewrites a parity's buffer only after the next barrier, which every CTA
// of its group reaches after it has read that buffer.
//
// Where trouble lies, and what this layer does about it:
// - Co-residency: a spinning barrier hangs if a CTA of a group is not
//   resident. The planner counts the CTAs the card holds at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor after raising
//   cudaFuncAttributeMaxDynamicSharedMemorySize, times
//   cudaDevAttrMultiProcessorCount; never a hardcoded SM count) and takes
//   no more groups than fit. The launch is cooperative
//   (cudaLaunchAttributeCooperative through cudaLaunchKernelEx), so the
//   runtime refuses a grid it cannot make co-resident rather than hang;
//   the launcher returns that error and the wrapper raises (no retry on
//   another design).
// - L1 is not coherent across SMs: what other CTAs wrote is read only
//   through L2, by cp.async.cg (grid_stage16) or ld.global.cg
//   (ld_cg_f32), never by __ldg, ld.ca or the cluster layer's cp_async4
//   (cp.async.ca). grid_sync fences the CTA's writes (__syncthreads, then
//   __threadfence and a release add by one thread) before it arrives, and
//   acquires (ld.acquire.gpu) before any thread reads.
// - The barrier's counter is one word a group that only grows: arrival k
//   of a group waits until the word reaches n (k + 1). The launcher zeroes
//   the words (cudaMemsetAsync on the stream) before each launch.
// - Ragged edges: units past H and rows past B are zero in the resident R
//   and in the staged operands (cp.async's zero fill), and write nothing.
//
// The kernels built on it: gru_fwd_grid_kernel (fused_gru.cu) and
// gru_bwd_grid_kernel (fused_gru_bwd.cu). This header holds what they
// share: the sizes, the R loader, the L2 reads, the group barrier, the
// launch configuration and occupancy query, and the planner.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "recurrent_cluster.cuh"

namespace {

constexpr int kGridWarps = 8;                  // warps of a grid CTA
constexpr int kGridThreads = kGridWarps * 32;
constexpr int kGridSlots = 16;                 // unit slots of a half-warp
constexpr int kGridStage = 2048;               // floats of one h stage
constexpr int kGridStagePad = 8;               // floats after a staged row
constexpr int kGridOperandPad = 8;             // floats after an operand row
constexpr int kGridRows[] = {8, 16, 32};       // rows a group, in order
constexpr size_t kGridSmemCap = 227 * 1024;    // all a block may use
constexpr int kGridBarWords = 32;              // a group's counter line

// Hidden units a CTA owns at most for elements of e bytes: a lane slot
// holds one f32 unit or a bf16 pair (one 4-byte word).
__host__ __device__ constexpr int grid_units(int e) {
  return kGridSlots * 4 / e;
}
// H rounded up to 16: the f32 forward's two half-warps take alternate
// chunks of 4 k, the bf16 forward's tensor-core product steps of 16 k
inline __host__ __device__ int grid_hp(int H) { return (H + 15) & ~15; }

// Elements (room for f32) of one h stage buffer: RB rows of kGridStage /
// RB k, each padded by kGridStagePad elements (in bf16 a row stride of 4
// mod 32 words keeps the product's fragment loads off each other's
// banks), at the most rows.
constexpr int kGridStageFloats = kGridStage + kGridStagePad * 32;

// Words of a resident row of the forward: G gates x kGridSlots slots and
// 4 words of padding, so that the half-warp reading row k + 4 hits the
// other 16 banks (4 (16 G + 4) = 16 mod 32).
template <int G>
__host__ __device__ constexpr int fwd_grid_row() { return G * kGridSlots + 4; }
// Words of a resident row of the backward for elements of e bytes: in
// f32 one word of padding (an odd row), so that 32 lanes reading rows
// k .. k + 31 hit 32 banks; in bf16 the forward's 4 words (16-byte rows
// for ldmatrix, eight of them on disjoint banks).
__host__ __device__ constexpr int bwd_grid_row(int G, int e) {
  return G * kGridSlots + (e == 2 ? 4 : 1);
}

// Shared memory of a forward grid CTA (bytes), with HP = grid_hp(H):
//   Rs [HP][fwd_grid_row] words      its gate columns of R, resident
//   hs [2][kGridStageFloats] E       h_{t-1} staged in k-tiles, double
//                                    buffer (room for f32)
inline size_t fwd_grid_smem_bytes(int H, int G) {
  return (size_t)grid_hp(H) * (G * kGridSlots + 4) * 4 +
         2 * sizeof(float) * kGridStageFloats;
}

// Shared memory of a backward grid CTA (bytes) for RB rows and elements
// of e bytes:
//   Rs [HP][bwd_grid_row] words           its gate columns of R, resident
//   gp [RB][G units + kGridOperandPad] f32  this step's product operands
//                                         (the padding keeps the bf16
//                                         product's fragment loads off
//                                         each other's banks)
inline size_t bwd_grid_smem_bytes(int rb, int H, int G, int e) {
  return (size_t)grid_hp(H) * bwd_grid_row(G, e) * 4 +
         sizeof(float) * (size_t)rb * (G * grid_units(e) + kGridOperandPad);
}

// The workspace of a call (bytes): a counter line a group, then the
// forward's h exchange hx [2][B][HP] of the element type (room for f32),
// or the backward's partial carries [2][groups][n][RB][HP] f32.
inline size_t grid_bar_bytes(int groups) {
  return (size_t)groups * kGridBarWords * 4;
}
inline size_t fwd_grid_workspace_bytes(int groups, int B, int H) {
  return grid_bar_bytes(groups) + 2 * sizeof(float) * (size_t)B * grid_hp(H);
}
inline size_t bwd_grid_workspace_bytes(int groups, int n, int rb, int H) {
  return grid_bar_bytes(groups) +
         2 * sizeof(float) * (size_t)groups * n * rb * grid_hp(H);
}

// Rs[k * Row + g * UL + u] = R[k][g H + j0 + u] for k < H and u < nu
// (UL = grid_units); zero elsewhere (rows up to HP), so padding never meets
// a weight. Row is in elements; the padding at a row's end is never
// written or read. The caller commits and waits for the copies.
template <typename E, int G, int Row>
__device__ __forceinline__ void load_grid_r(E* Rs, const E* R, int H, int HP,
                                            int j0, int nu) {
  constexpr int UL = grid_units(sizeof(E));
  const int ld = G * H;
  for (int idx = threadIdx.x; idx < HP * G * UL; idx += kGridThreads) {
    const int u = idx % UL, kg = idx / UL;
    const int g = kg % G, k = kg / G;
    const bool in = k < H && u < nu;
    E* dst = Rs + (size_t)k * Row + g * UL + u;
    if constexpr (sizeof(E) == 4) {
      cp_async4(dst, R + (in ? (size_t)k * ld + g * H + j0 + u : 0),
                in ? 4 : 0);
    } else {  // R is read-only for the kernel's life: plain loads
      *dst = in ? R[(size_t)k * ld + g * H + j0 + u] : from_f32<E>(0.0f);
    }
  }
}

// 16 bytes global -> shared through L2 only (cp.async.cg), the first
// src_bytes of them (the rest zero): reads what other SMs wrote.
__device__ __forceinline__ void grid_stage16(void* dst, const void* src,
                                             int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// ---- the bf16 step product on the tensor cores (mma.sync m16n8k16)

// Two floats (each already exact in bf16) as the bf16 pair of an mma
// fragment register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix of four 8 x 8 bf16 matrices whose rows (16 bytes each,
// 16-byte aligned) this lane addresses: the B fragments of an [n][k]
// row-major tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row)))
      : "memory");
}

// ldmatrix .trans of four (x4) or two (x2) 8 x 8 bf16 matrices whose rows
// (16 bytes each, 16-byte aligned) this lane addresses: the B fragments
// of a [k][n] row-major tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row)))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row)))
      : "memory");
}

// c += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col) and f32 C:
// exact products summed in f32.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A float another SM wrote, read through L2 (ld.global.cg).
__device__ __forceinline__ float ld_cg_f32(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// The barrier of a row group: every thread's writes before it are
// visible to every CTA of the group after it. `count` is the group's
// counter, `target` n times the number of this CTA's arrivals so far
// (this one included).
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count),
                 "r"(1u)
                 : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while ((int)(seen - target) < 0);
  }
  __syncthreads();
}

// Calls f(std::integral_constant<int, rb>) for rb in kGridRows: the grid
// kernels' row counts are template arguments.
template <typename F>
auto by_grid_rows(int rb, F f) {
  switch (rb) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

// Opts `kernel` in to kGridSmemCap bytes of dynamic shared memory and
// fills `cfg` for a cooperative grid of `ctas` CTAs of kGridThreads
// threads with `smem` bytes each.
template <typename K>
cudaError_t grid_config(K kernel, int ctas, size_t smem, cudaStream_t stream,
                        cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGridSmemCap);
  attr->id = cudaLaunchAttributeCooperative;
  attr->val.cooperative = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas);
  cfg->blockDim = dim3(kGridThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// How many CTAs of `kernel`, each with `smem` bytes of dynamic shared
// memory, the card holds at once: blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs, cached
// by (device, kernel, smem).
template <typename K>
cudaError_t grid_resident(K kernel, size_t smem, int* n) {
  struct Entry { int dev; const void* fn; size_t smem; int n; };
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
      if (cache[i].dev == dev && cache[i].fn == fn && cache[i].smem == smem) {
        *n = cache[i].n;
        return cudaSuccess;
      }
  }
  int per_sm = 0, sms = 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGridSmemCap);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kGridThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *n = per_sm * sms;
  std::lock_guard<std::mutex> g(lock);
  if (used < 64) cache[used++] = {dev, fn, smem, *n};
  return cudaSuccess;
}

// The design a GRU launcher runs, as its plan query reports it.
enum Kind { kStream = 0, kCluster = 1, kGrid = 2 };

// The grid a [T > 1, B, *, H] call takes: U units a CTA, n CTAs a row
// group, RB rows a group, the groups launched together and the dynamic
// shared memory of a CTA; U == 0: the card holds no row group.
struct GridPlan {
  int U, n, rb, groups;
  size_t smem;
};

// U: H split evenly over the fewest CTAs of at most grid_units(e) units.
// Rows a group: the fewest of kGridRows whose ceil(B / RB) groups the
// card holds at once; if none, the most rows that fit, in as many groups
// as the card holds (each group then takes several passes). No grid where
// a CTA's shared memory is over the cap or the card holds no row group.
// `smem_of(rb)` is a CTA's shared memory, `resident(rb, smem, &n)` the
// CTAs of the kernel's instance for rb rows the card holds at once.
template <typename SmemFn, typename ResidentFn>
cudaError_t plan_grid(int B, int H, int e, SmemFn smem_of,
                      ResidentFn resident, GridPlan* plan) {
  *plan = GridPlan{0, 0, 0, 0, 0};
  const int ul = grid_units(e);
  const int n0 = (H + ul - 1) / ul;
  const int U = (H + n0 - 1) / n0;
  const int n = (H + U - 1) / U;
  for (int rb : kGridRows) {
    const size_t smem = smem_of(rb);
    if (smem > kGridSmemCap) break;
    int cap = 0;
    cudaError_t err = resident(rb, smem, &cap);
    if (err != cudaSuccess) return err;
    const int most = cap / n;
    if (most < 1) continue;
    const int need = (B + rb - 1) / rb;
    *plan = GridPlan{U, n, rb, std::min(need, most), smem};
    if (need <= most) break;
  }
  return cudaSuccess;
}

}  // namespace
