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
// Three designs; the launcher (gru_fwd) chooses by shape and by what the
// card can co-schedule, never because a launch failed:
//
// - Cluster (gru_fwd_cluster_kernel), for T > 1 where a cluster can hold R,
//   on the cluster layer of recurrent_cluster.cuh: CTA c of a cluster of 8
//   (or 16) keeps the r, z and n columns of R for its U <= 32 units in
//   shared memory for all T steps (96 KB in f32 at H=256); a cluster owns
//   RB batch rows, the fewest that let every cluster be
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
//   fits neither a cluster nor the card: a block owns RB <= 8 batch rows
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
// - Grid (gru_fwd_grid_kernel), for T > 1 where no cluster holds R (H >
//   512) but the whole card does, on the grid layer of recurrent_grid.cuh:
//   CTA c of a row group of n keeps the r, z and n columns of R for its U
//   units (16 in f32, 32 in bf16; 192 KB at H = 1024) in shared memory for
//   all T steps; a group owns RB rows (32 in f32 at B = 64: 2 groups of 64
//   CTAs; 16 in bf16: 4 groups of 32). Each step, after one barrier over
//   its group, a CTA reads h_{t-1} [RB, H] back from L2 (cp.async.cg),
//   staged through shared memory in k-tiles, double-buffered. The step
//   product runs on the CUDA cores in f32 (two half-warps on alternate k
//   chunks) and on the tensor cores in bf16 (mma.sync m16n8k16: exact
//   products of h_{t-1}, already rounded to bf16, and R, summed in f32),
//   as the kernel's own comment details. The thread that owns (row, unit)
//   applies the gates, keeps the f32 carry in a register and writes its
//   rounded h_t to the group's exchange buffer in L2 (double-buffered by
//   step parity), then arrives at the next step's barrier.
// Later work: wgmma for the cluster design's bf16 step product, and
// decode replayed by CUDA graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "recurrent_cluster.cuh"
#include "recurrent_grid.cuh"

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // k-slices per unit tile
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use

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

  load_r_slice<E, 3>(Rs, R, H, HP, j0, nu);
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

// --------------------------------------------------------------- grid design

// One CTA of a row group: its units' gate columns of R resident, h_{t-1}
// of the group's RB rows staged from L2 each step. The step product
// h_{t-1} @ R[:, its columns] runs
// - in f32 on the CUDA cores: warp (rg, kw) takes the 8 rows of row
//   group rg and every KW-th pair of 4-k chunks, lane (half, slot) unit
//   `slot` and one chunk of the pair by half, so the two half-warps read R
//   rows 4 apart, padded onto the other 16 banks; one shuffle joins the
//   halves, and the KW warps of a row group meet in shared memory, in kw
//   order;
// - in bf16 on the tensor cores (mma.sync m16n8k16, exact bf16 products
//   summed in f32): warp (j, half) takes units [8 j, 8 j + 8) of all
//   three gates (three n-tiles of 8) and alternate k-steps of 16 by half;
//   B fragments come from the resident R by ldmatrix.trans, A fragments
//   straight from the staged bf16 h (h is exchanged and staged in the
//   element type); the two halves' sums meet in shared memory, half 0's
//   first.
// The thread that owns (row, unit) in the product's layout applies the
// gates, keeps the f32 carry in a register and writes its rounded h_t to
// the group's exchange buffer in L2.
template <typename E, int RB>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_fwd_grid_kernel(const E* __restrict__ xg,    // [T, B, 3H]
                    const E* __restrict__ R,     // [H, 3H]
                    const E* __restrict__ h0,    // [B, H]
                    E* __restrict__ out,         // [T, B, H]
                    E* __restrict__ hT,          // [B, H]
                    float* __restrict__ reserve, // [4, T, B, H] or null
                    unsigned* __restrict__ bar,  // [groups][kGridBarWords], 0
                    E* __restrict__ hx,          // [2][B][HP] h by parity
                    int T, int B, int H, int U, int n, int groups) {
  constexpr bool kMma = sizeof(E) == 2;        // bf16: the tensor cores
  constexpr int RG = RB / 8;                   // f32: row groups of 8
  constexpr int KW = kGridWarps / RG;          // f32: warps a row group
  constexpr int MT = (RB + 15) / 16;           // bf16: m-tiles of 16 rows
  constexpr int UL = grid_units(sizeof(E));    // units a CTA at most
  constexpr int Row = fwd_grid_row<3>() * 4 / (int)sizeof(E);  // elements
  constexpr int KT = kGridStage / RB;          // k a stage
  constexpr int KS = KT + kGridStagePad;       // elements a staged row
  constexpr int VE = 16 / (int)sizeof(E);      // elements a 16-byte copy
  constexpr int NC = kMma ? 2 * MT : (8 + 2 * KW - 1) / (2 * KW);  // cells
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = grid_hp(H);
  E* Rs = reinterpret_cast<E*>(smem_raw);
  E* hs = reinterpret_cast<E*>(smem_raw + (size_t)HP * Row * sizeof(E));

  const int c = blockIdx.x % n, grp = blockIdx.x / n;
  const int j0 = c * U;
  const int nu = max(0, min(U, H - j0));      // units this CTA owns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // f32: row group rg and k-group kw of the warp, (half, slot) of the
  // lane; bf16: n-group j and k-half of the warp, (fg, ft) of the lane in
  // the mma fragments
  const int half = kMma ? warp / 4 : lane / kGridSlots;
  const int slot = lane % kGridSlots;
  const int rg = warp % RG, kw = warp / RG;
  const int j = warp % 4, fg = lane / 4, ft = lane % 4;
  const int G = 3 * H;
  const size_t plane = (size_t)T * B * H;
  const size_t par_stride = (size_t)B * HP;
  unsigned* count = bar + grp * kGridBarWords;
  unsigned arrivals = 0;

  load_grid_r<E, 3, Row>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // (the first barrier's __syncthreads publishes Rs to the whole CTA)

  for (int b0 = grp * RB; b0 < B; b0 += groups * RB) {
    // cell m of this thread: (batch row cb[m], unit cj[m]); it keeps that
    // cell's f32 carry
    int cb[NC], cj[NC];
    bool live[NC];
    float carry[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      int r, u;
      bool mine;
      if constexpr (kMma) {  // rows fg + 8 half of each m-tile
        r = (m / 2) * 16 + fg + 8 * half;
        u = 8 * j + 2 * ft + m % 2;
        mine = r < RB;
      } else {               // row 2 kw + half + 2 KW m of group rg
        const int i = 2 * kw + half + 2 * KW * m;
        r = rg * 8 + i;
        u = slot;
        mine = i < 8;
      }
      cb[m] = b0 + r;
      cj[m] = j0 + u;
      live[m] = mine && cb[m] < B && u < nu;
      // h0 is of the element type, so its rounded copy and the carry agree
      carry[m] = live[m] ? to_f32(h0[(size_t)cb[m] * H + cj[m]]) : 0.0f;
      if (live[m]) hx[(size_t)cb[m] * HP + cj[m]] = h0[(size_t)cb[m] * H + cj[m]];
    }

    for (int t = 0; t < T; ++t) {
      // this step's gates: their loads overlap the barrier
      float xv[NC][3];
#pragma unroll
      for (int m = 0; m < NC; ++m)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          xv[m][q] = live[m] ? to_f32(xg[((size_t)t * B + cb[m]) * G +
                                         q * H + cj[m]])
                             : 0.0f;
      // every CTA of the group has written h_{t-1}
      grid_sync(count, ++arrivals * (unsigned)n);

      // ---- h_{t-1} @ R for this CTA's units and rows, h_{t-1} staged
      // from L2 in k-tiles of KT
      const E* hprev = hx + (size_t)(t & 1) * par_stride;
      auto stage = [&](int tile) {
        E* dst = hs + (tile & 1) * kGridStageFloats;
        const int k0 = tile * KT;
        for (int idx = threadIdx.x; idx < RB * KT / VE; idx += kGridThreads) {
          const int r = idx / (KT / VE), k = k0 + VE * (idx % (KT / VE));
          const int b = b0 + r;
          const int bytes =
              b < B && k < H ? (int)sizeof(E) * min(VE, H - k) : 0;
          grid_stage16(dst + r * KS + (k - k0),
                       hprev + (bytes ? (size_t)b * HP + k : 0), bytes);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      // f32: acc[row][gate] over this lane's chunks; bf16: the mma
      // accumulators [m-tile][gate][4]
      float acc[kMma ? MT : 8][3][kMma ? 4 : 1];
#pragma unroll
      for (int i = 0; i < (kMma ? MT : 8); ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < (kMma ? 4 : 1); ++e) acc[i][q][e] = 0.0f;
      const int tiles = (HP + KT - 1) / KT;
      stage(0);
      for (int tile = 0; tile < tiles; ++tile) {
        if (tile + 1 < tiles) {
          stage(tile + 1);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const E* hb = hs + (tile & 1) * kGridStageFloats;
        const int k0 = tile * KT, len = min(KT, HP - k0);
        if constexpr (kMma) {
          for (int kk = 16 * half; kk < len; kk += 32) {
            // B: gates 0 and 1 (x4: k 0-7, 8-15 of each), gate 2 (x2)
            uint32_t b4[4], b2[2];
            const E* rrow = Rs + (size_t)(k0 + kk + ((lane >> 3) & 1) * 8 +
                                          (lane & 7)) * Row + 8 * j;
            ldmatrix_x4_trans(b4, rrow + (lane >> 4) * UL);
            ldmatrix_x2_trans(b2, rrow + 2 * UL);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const E* hp = hb + (mt * 16 + fg) * KS + kk + 2 * ft;
              uint32_t a[4];
              a[0] = *reinterpret_cast<const uint32_t*>(hp);
              a[2] = *reinterpret_cast<const uint32_t*>(hp + 8);
              if (mt * 16 + 8 < RB) {
                a[1] = *reinterpret_cast<const uint32_t*>(hp + 8 * KS);
                a[3] = *reinterpret_cast<const uint32_t*>(hp + 8 * KS + 8);
              } else {
                a[1] = a[3] = 0u;
              }
              mma_bf16_16816(acc[mt][0], a, b4);
              mma_bf16_16816(acc[mt][1], a, b4 + 2);
              mma_bf16_16816(acc[mt][2], a, b2);
            }
          }
        } else {
          const float* hw = hb + rg * 8 * KS;
#pragma unroll 4
          for (int kk = 4 * (2 * kw + half); kk < len; kk += 8 * KW) {
            float w[4][3];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int gg = 0; gg < 3; ++gg)
                w[q][gg] = to_f32(Rs[(size_t)(k0 + kk + q) * Row + gg * UL +
                                     slot]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 h4 =
                  *reinterpret_cast<const float4*>(hw + i * KS + kk);
              const float hk[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int gg = 0; gg < 3; ++gg)
                  acc[i][gg][0] = fmaf(hk[q], w[q][gg], acc[i][gg][0]);
            }
          }
        }
        // this stage buffer is free for tile + 2
        __syncthreads();
      }

      // ---- each cell's three sums over all of k
      float hg[NC][3];
      if constexpr (kMma) {
        // warp (j, half) hands its partner (j, 1 - half) the rows the
        // partner owns, through the now idle stage buffers
        float* xch = reinterpret_cast<float*>(hs);
        auto xslot = [&](int h_, int mt, int q) {
          return xch + ((((j * 2 + h_) * MT + mt) * 3 + q) * 32 + lane) * 2;
        };
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float* d = xslot(half, mt, q);
            d[0] = half ? acc[mt][q][0] : acc[mt][q][2];
            d[1] = half ? acc[mt][q][1] : acc[mt][q][3];
          }
        __syncthreads();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float* o = xslot(1 - half, mt, q);
#pragma unroll
            for (int s2 = 0; s2 < 2; ++s2) {
              const float mine = half ? acc[mt][q][2 + s2] : acc[mt][q][s2];
              hg[mt * 2 + s2][q] = half == 0 ? mine + o[s2] : o[s2] + mine;
            }
          }
      } else {
        // the two half-warps took alternate chunks of k
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            acc[i][q][0] += __shfl_xor_sync(0xffffffffu, acc[i][q][0],
                                            kGridSlots);
        // the KW warps of a row group took alternate chunk pairs: each
        // leaves its sums [8 rows][3 gates][16 slots] in the idle stage
        // buffers (half h rows 4 h .. 4 h + 3), and a cell's owner adds
        // them in kw order
        float* xch = reinterpret_cast<float*>(hs);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            xch[((warp * 8 + 4 * half + i) * 3 + q) * kGridSlots + slot] =
                half ? acc[4 + i][q][0] : acc[i][q][0];
        __syncthreads();
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int i = min(2 * kw + half + 2 * KW * m, 7);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float sum = 0.0f;
#pragma unroll
            for (int w2 = 0; w2 < KW; ++w2)
              sum += xch[(((w2 * RG + rg) * 8 + i) * 3 + q) * kGridSlots +
                         slot];
            hg[m][q] = sum;
          }
        }
      }

      // ---- the gates of this thread's cells; h_t to the group
      E* hnext = hx + (size_t)((t + 1) & 1) * par_stride;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        if (!live[m]) continue;
        const float rg = sigmoid_f(xv[m][0] + hg[m][0]);
        const float zg = sigmoid_f(xv[m][1] + hg[m][1]);
        const float ng = tanhf(xv[m][2] + rg * hg[m][2]);
        const float h_new = (1.0f - zg) * ng + zg * carry[m];
        const E h_st = from_f32<E>(h_new);
        carry[m] = h_new;
        const int b = cb[m], jj = cj[m];
        // the next product reads h in the element type, as the Pallas
        // kernel casts it
        hnext[(size_t)b * HP + jj] = h_st;
        const size_t at = ((size_t)t * B + b) * H + jj;
        out[at] = h_st;
        if (reserve != nullptr) {
          reserve[at] = rg;
          reserve[plane + at] = zg;
          reserve[2 * plane + at] = ng;
          reserve[3 * plane + at] = hg[m][2];
        }
        if (t == T - 1) hT[(size_t)b * H + jj] = h_st;
      }
    }
  }
}

// ------------------------------------------------------------------ choice

// What the launcher runs for a [T, B, *, H] call: the cluster design (C
// CTAs a cluster, RB rows a cluster), the grid design (U units a CTA, n
// CTAs and RB rows a row group, the groups launched together) or the
// stream design (RB rows a block, upb units a block, k-slices a unit
// tile), and the dynamic shared memory of a block.
struct Plan {
  int kind, C, rb, upb, slices;
  size_t smem;
  int U, n, groups;
};

template <typename E>
cudaError_t plan_fwd(int T, int B, int H, Plan* plan) {
  if (T > 1) {
    ClusterPlan cp;
    cudaError_t err = plan_cluster(
        B, H,
        [&](int rb, int) {
          return fwd_cluster_smem_bytes(rb, H, 3, sizeof(E));
        },
        [&](int rb, int C, size_t smem, int* n) {
          return by_rows(rb, [&](auto r) {
            return active_clusters(
                gru_fwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);
          });
        },
        &cp);
    if (err != cudaSuccess) return err;
    if (cp.C > 0) {
      *plan = {1, cp.C, cp.rb, 0, 0, cp.smem};
      return cudaSuccess;
    }
    GridPlan gp;
    err = plan_grid(
        B, H, sizeof(E), [&](int) { return fwd_grid_smem_bytes(H, 3); },
        [&](int rb, size_t smem, int* n) {
          return by_grid_rows(rb, [&](auto r) {
            return grid_resident(gru_fwd_grid_kernel<E, decltype(r)::value>,
                                 smem, n);
          });
        },
        &gp);
    if (err != cudaSuccess) return err;
    if (gp.U > 0) {
      *plan = {kGrid, 0, gp.rb, 0, 0, gp.smem, gp.U, gp.n, gp.groups};
      return cudaSuccess;
    }
  }
  int rb_max = 1;
  while (rb_max < 8 && rb_max < B) rb_max *= 2;
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

// `work` (`work_bytes` long) is the grid design's workspace
// (fwd_grid_workspace_bytes); the other designs take none.
template <typename E>
int gru_fwd(const E* xg, const E* R, const E* h0, E* out, E* hT,
            float* reserve, void* work, long long work_bytes, int T, int B,
            int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_fwd<E>(T, B, H, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.kind == kGrid) {
    if (work == nullptr ||
        work_bytes < (long long)fwd_grid_workspace_bytes(p.groups, B, H))
      return (int)cudaErrorInvalidValue;
    unsigned* bar = static_cast<unsigned*>(work);
    E* hx = reinterpret_cast<E*>(static_cast<char*>(work) +
                                 grid_bar_bytes(p.groups));
    err = cudaMemsetAsync(bar, 0, grid_bar_bytes(p.groups), s);
    if (err != cudaSuccess) return (int)err;
    return (int)by_grid_rows(p.rb, [&](auto r) {
      auto kernel = gru_fwd_grid_kernel<E, decltype(r)::value>;
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg;
      cudaError_t e = grid_config(kernel, p.groups * p.n, p.smem, s, &attr,
                                  &cfg);
      if (e != cudaSuccess) return e;
      return cudaLaunchKernelEx(&cfg, kernel, xg, R, h0, out, hT, reserve,
                                bar, hx, T, B, H, p.U, p.n, p.groups);
    });
  }
  return (int)by_rows(p.rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    if (p.kind == kStream)
      return launch<E, RB>(xg, R, h0, out, hT, reserve, T, B, H, p.upb,
                           p.slices, s);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    auto kernel = gru_fwd_cluster_kernel<E, RB>;
    cudaError_t e = cluster_config(kernel, p.C, (B + RB - 1) / RB, p.smem,
                                   p.smem, s, &attr, &cfg);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, xg, R, h0, out, hT, reserve, T,
                              B, H, cluster_units(H, p.C));
  });
}

}  // namespace

extern "C" {

// Launch the recurrence on `stream`; each returns a cudaError_t (0 =
// launched). Every pointer but `reserve` (float32, or null) and `work`
// (the grid design's workspace of `work_bytes`, or null for the other
// designs) is of the function's one element type.
int dl4j_gru_fwd(const float* xg, const float* R, const float* h0,
                 float* out, float* hT, float* reserve, void* work,
                 long long work_bytes, int T, int B, int H, void* stream) {
  return gru_fwd<float>(xg, R, h0, out, hT, reserve, work, work_bytes, T, B,
                        H, stream);
}

int dl4j_gru_fwd_bf16(const __nv_bfloat16* xg, const __nv_bfloat16* R,
                      const __nv_bfloat16* h0, __nv_bfloat16* out,
                      __nv_bfloat16* hT, float* reserve, void* work,
                      long long work_bytes, int T, int B, int H,
                      void* stream) {
  return gru_fwd<__nv_bfloat16>(xg, R, h0, out, hT, reserve, work,
                                work_bytes, T, B, H, stream);
}

// The launcher's choice for a [T, B, *, H] call of the element type (bf16
// nonzero: bfloat16, else float32) on the current device: out = {0 for the
// stream design, 1 for the cluster design, 2 for the grid design, C (0
// unless cluster), RB, dynamic shared memory bytes, U, n, groups and the
// workspace bytes a call must pass (0 unless grid)}. Returns a
// cudaError_t.
int dl4j_gru_fwd_plan(int T, int B, int H, int bf16, long long* out) {
  Plan plan;
  cudaError_t err = bf16 ? plan_fwd<__nv_bfloat16>(T, B, H, &plan)
                         : plan_fwd<float>(T, B, H, &plan);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.kind;
  out[1] = plan.C;
  out[2] = plan.rb;
  out[3] = (long long)plan.smem;
  out[4] = plan.U;
  out[5] = plan.n;
  out[6] = plan.groups;
  out[7] = plan.kind == kGrid
               ? (long long)fwd_grid_workspace_bytes(plan.groups, B, H)
               : 0;
  return 0;
}

// The CTAs of the grid kernel (RB rows) with `smem` bytes each that the
// card holds at once, into *n.
int dl4j_gru_grid_resident(int bf16, int rb, int smem, int* n) {
  return (int)by_grid_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? grid_resident(gru_fwd_grid_kernel<__nv_bfloat16, RB>,
                                (size_t)smem, n)
                : grid_resident(gru_fwd_grid_kernel<float, RB>,
                                (size_t)smem, n);
  });
}

// cudaOccupancyMaxActiveClusters of the cluster kernel (RB rows) for
// clusters of C CTAs with `smem` bytes each, into *n.
int dl4j_gru_active_clusters(int bf16, int rb, int C, int smem, int* n) {
  return (int)by_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? active_clusters(gru_fwd_cluster_kernel<__nv_bfloat16, RB>,
                                  C, smem, n)
                : active_clusters(gru_fwd_cluster_kernel<float, RB>, C, smem,
                                  n);
  });
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
