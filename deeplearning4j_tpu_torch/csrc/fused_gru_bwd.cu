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
// Types: R (and R^T), h0, out and dout are all float32 (dl4j_gru_bwd) or
// all bfloat16 (dl4j_gru_bwd_bf16); the reserve, dg and dh0 are float32. As in
// the Pallas kernel, the carry stays f32, and in bf16 [ga_r, ga_z,
// r * ga_n] enters the product rounded to bf16 (exact bf16 x bf16 products
// summed in f32).
//
// What bounds it on this card: every step reads all of R [H, 3H] to do
// 2*B*3H*H flops, so at training batch sizes it is far below the H100's
// ridge point: memory- and latency-bound, like the forward.
//
// Three designs; the launcher (gru_bwd) chooses by shape and by what the
// card can co-schedule, never because a launch failed:
//
// - Cluster (gru_bwd_cluster_kernel), for T > 1 where a cluster can hold R,
//   on the cluster layer of recurrent_cluster.cuh (the forward's): CTA c of
//   a cluster of C = 8 (or 16) owns units U_c (U <= 32) and keeps the
//   forward's slice of R, the r, z and n columns of U_c for every k < H,
//   in shared memory for all T steps. It reads R, not R^T. Each step, the
//   thread of (row, unit) in U_c forms dh, the gate gradients and the
//   product operands gp = [ga_r ga_z r*ga_n] of its unit in f32 (gp
//   rounded to R's type), stores dg and keeps z * dh in a register; after
//   one barrier, thread k of each CTA forms its CTA's part of the next
//   carry, P_c[b, k] = sum over U_c's 3 x U columns of gp[b, .] R[k, .],
//   for all RB rows, and stores it into slot [parity][c] of the CTA that
//   owns unit k, through distributed shared memory (a reduce-scatter:
//   RB x H floats leave a CTA a step, as many as the forward's h
//   broadcast). One cluster barrier; then each owner sums its C slots in
//   rank order (the same order every run) and its z * dh into the carry.
//   A row of the resident R is padded by one 4-byte word, so that the 32
//   lanes of a warp, reading one k each, hit 32 banks. The product, the
//   reduce-scatter and the rank-order sum are the header's scatter_carry
//   and gather_carry, shared with the LSTM backward.
// - Stream (gru_bwd_kernel), for T == 1 and any shape whose R fits
//   neither a cluster nor the card, the first port's design (it mirrors fused_lstm_bwd.cu):
//   a block owns RB batch rows and all H units and loops over t inside the
//   block (the carry couples every unit). The wrapper passes R transposed
//   once per call, Rt [3H, H] contiguous, so that the product reads it as
//   the forward reads R: each warp takes a (32-unit tile, slice of the 3H
//   reduction) work item, lane k accumulates column k of Rt over its slice
//   (coalesced across the warp) for all RB rows held in registers, and the
//   partial sums meet in shared memory. Phase A sums the partials and the
//   previous step's direct term into the carry, forms the gate gradients
//   in f32 registers, stores dg, and keeps this step's product operands
//   and direct term in shared memory; one barrier; phase B forms the
//   partial products; a second barrier ends the step. Step 0 runs phase B
//   too: its carry is dh0.
// - Grid (gru_bwd_grid_kernel), for T > 1 where no cluster holds R (H >
//   512) but the whole card does, on the grid layer of recurrent_grid.cuh
//   (the forward's): CTA c of a row group of n keeps the forward's slice
//   of R (the r, z and n columns of its U units for every k < H; rows
//   padded by one word) in shared memory for all T steps, and its thread
//   of (row, unit) walks that cell as the cluster kernel's does. The
//   carry crosses CTAs as a reduce-scatter through L2: each step, after
//   the gate gradients, thread k forms the CTA's part of the next carry,
//   P_c[b, k] = sum over its 3 x U columns of gp[b, .] R[k, .], for every
//   k < H and its RB rows, and stores it to the group's slot [parity][c]
//   in L2; one barrier over the group; then each owner sums its n parts
//   in rank order (ld.global.cg; the same order every run) and its z * dh
//   into the carry. A CTA writes RB x H and reads RB x U x n = RB x H
//   floats a step, and its shared memory holds only R and the operands.
//   The step product runs in f32 on the CUDA cores (thread k, all RB rows)
//   and in bf16 on the tensor cores (mma.sync m16n8k16 over the operands
//   [RB, 96], exact in bf16, and R's resident rows by ldmatrix; exact
//   products summed in f32).
//   The other way, holding R's rows for the owned units and reading the
//   whole operand [RB, 3H] back after the barrier (an all-gather), reads
//   3 RB x H operands a CTA a step, staged through what R leaves of
//   shared memory. It is built and timed beside this kernel by
//   experiments/gru_bwd_allgather/ab.py: at [64, 64, 1024] on an H100
//   (700 W) it ran 29.7 us a step against this kernel's 23.8 in f32, 9.6
//   against 8.5 in bf16.
// Later work: wgmma for the bf16 step product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent_cluster.cuh"
#include "recurrent_grid.cuh"

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // slices of the 3H reduction
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use

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

// ------------------------------------------------------------ cluster design

template <typename E, int RB>
__global__ void __launch_bounds__(kClusterThreads, 1)
gru_bwd_cluster_kernel(const float* __restrict__ reserve,  // [4, T, B, H]
                       const E* __restrict__ R,            // [H, 3H]
                       const E* __restrict__ h0,           // [B, H]
                       const E* __restrict__ out,          // [T, B, H]
                       const E* __restrict__ dout,         // [T, B, H]
                       float* __restrict__ dg,             // [T, B, 3H]
                       float* __restrict__ dh0,            // [B, H]
                       int T, int B, int H, int U) {
  constexpr int kRow = bwd_row<E, 3>();
  constexpr int kU = kClusterUnits;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = (H + 3) & ~3;
  E* Rs = reinterpret_cast<E*>(smem_raw);
  float* gp = reinterpret_cast<float*>(smem_raw +
                                       (size_t)HP * kRow * sizeof(E));
  float* slots = gp + RB * 3 * kU;

  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int j0 = rank * U;
  const int nu = max(0, min(U, H - j0));   // units this CTA owns
  const int b0 = (blockIdx.x / C) * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_r_slice<E, 3, kRow>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the product operands of units past nu and rows past B stay zero
  for (int idx = threadIdx.x; idx < RB * 3 * kU; idx += kClusterThreads)
    gp[idx] = 0.0f;

  // the thread of (row gr, unit j) walks that unit: its inputs one step
  // ahead in registers, its direct term z * dh from step to step
  const int gr = warp, j = j0 + lane;
  const bool live = gr < RB && lane < nu && b0 + gr < B;
  const int b = b0 + gr;
  const size_t plane = (size_t)T * B * H;
  const size_t BH = (size_t)B * H;
  float in[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // r z n hg_n dout h_prev
  auto load_step = [&](int t, float* v) {
    const size_t at = ((size_t)t * B + b) * H + j;
    v[0] = reserve[at];
    v[1] = reserve[plane + at];
    v[2] = reserve[2 * plane + at];
    v[3] = reserve[3 * plane + at];
    v[4] = to_f32(dout[at]);
    v[5] = t > 0 ? to_f32(out[at - BH]) : to_f32(h0[(size_t)b * H + j]);
  };
  if (live) load_step(T - 1, in);
  float zdh = 0.0f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // every CTA of the cluster is running and initialised before any CTA
  // stores into another's slots
  cluster.sync();

  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    // ---- the gate gradients of (row gr, unit j)
    float nxt[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      // the carry from step t+1: its C partial products in rank order,
      // then the direct term
      const float carry =
          t < T - 1 ? gather_carry<RB>(slots, par ^ 1, C, gr, lane) + zdh
                    : 0.0f;
      const float rg = in[0], zg = in[1], ng = in[2];
      const float dh = in[4] + carry;
      const float ga_n = dh * (1.0f - zg) * (1.0f - ng * ng);
      const float ga_z = dh * (in[5] - ng) * zg * (1.0f - zg);
      const float ga_r = ga_n * in[3] * rg * (1.0f - rg);
      float* dg_t = dg + ((size_t)t * B + b) * 3 * H + j;
      dg_t[0] = ga_r;
      dg_t[H] = ga_z;
      dg_t[2 * H] = ga_n;
      float* gp_r = gp + gr * 3 * kU + lane;
      gp_r[0] = round_to(ga_r, R);
      gp_r[kU] = round_to(ga_z, R);
      gp_r[2 * kU] = round_to(rg * ga_n, R);
      zdh = zg * dh;
      // the next step's inputs are known now: their load overlaps the
      // product
      if (t > 0) load_step(t - 1, nxt);
    }
    __syncthreads();

    // ---- this CTA's part of the next carry, for every k < H and RB rows,
    // to the CTA that owns unit k
    scatter_carry<E, 3, RB, kRow>(cluster, Rs, gp, slots, par, C, rank, H,
                                  U);
#pragma unroll
    for (int i = 0; i < 6; ++i) in[i] = nxt[i];
    // every part has reached its owner, and this step's gp is free
    cluster.sync();
  }

  // the carry after step 0 (parity 0) is dh0
  if (live)
    dh0[(size_t)b * H + j] = gather_carry<RB>(slots, 0, C, gr, lane) + zdh;
}

// --------------------------------------------------------------- grid design

template <typename E, int RB>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_bwd_grid_kernel(const float* __restrict__ reserve,  // [4, T, B, H]
                    const E* __restrict__ R,            // [H, 3H]
                    const E* __restrict__ h0,           // [B, H]
                    const E* __restrict__ out,          // [T, B, H]
                    const E* __restrict__ dout,         // [T, B, H]
                    float* __restrict__ dg,             // [T, B, 3H]
                    float* __restrict__ dh0,            // [B, H]
                    unsigned* __restrict__ bar,  // [groups][kGridBarWords], 0
                    float* __restrict__ slots,   // [2][groups][n][RB][HP]
                    int T, int B, int H, int U, int n, int groups) {
  constexpr bool kMma = sizeof(E) == 2;        // bf16: the tensor cores
  constexpr int UL = grid_units(sizeof(E));    // units a CTA at most
  constexpr int Row = bwd_grid_row(3, sizeof(E)) * 4 / (int)sizeof(E);
  constexpr int GPS = 3 * UL + kGridOperandPad;  // floats an operand row
  constexpr int NC = (RB * UL + kGridThreads - 1) / kGridThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = grid_hp(H);
  E* Rs = reinterpret_cast<E*>(smem_raw);
  float* gp = reinterpret_cast<float*>(smem_raw +
                                       (size_t)HP * Row * sizeof(E));

  const int c = blockIdx.x % n, grp = blockIdx.x / n;
  const int j0 = c * U;
  const int nu = max(0, min(U, H - j0));      // units this CTA owns
  const int U4 = (U + 3) & ~3;
  const size_t plane = (size_t)T * B * H;
  const size_t BH = (size_t)B * H;
  const size_t part = (size_t)RB * HP;        // one CTA's part
  const size_t par_stride = (size_t)groups * n * part;
  float* mine = slots + ((size_t)grp * n + c) * part;
  const float* group = slots + (size_t)grp * n * part;
  unsigned* count = bar + grp * kGridBarWords;
  unsigned arrivals = 0;

  load_grid_r<E, 3, Row>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // The carry that the group sent cell (row r, unit j) in parity par: its
  // n parts summed in rank order, the loads in batches ahead of the sums.
  auto gather = [&](int par, int r, int j) {
    const float* p = group + par * par_stride + (size_t)r * HP + j;
    float sum = 0.0f;
    for (int q0 = 0; q0 < n; q0 += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = q0 + i < n ? ld_cg_f32(p + (size_t)(q0 + i) * part) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[i];
    }
    return sum;
  };

  for (int b0 = grp * RB; b0 < B; b0 += groups * RB) {
    // cell m of this thread: (row r, unit j) from threadIdx.x + m threads;
    // its inputs one step ahead in registers, its z * dh step to step
    int cr[NC], cj[NC];
    bool live[NC];
    float in[NC][6], zdh[NC];  // r z n hg_n dout h_prev
    auto load_step = [&](int t, int m) {
      const size_t at = ((size_t)t * B + b0 + cr[m]) * H + cj[m];
      in[m][0] = reserve[at];
      in[m][1] = reserve[plane + at];
      in[m][2] = reserve[2 * plane + at];
      in[m][3] = reserve[3 * plane + at];
      in[m][4] = to_f32(dout[at]);
      in[m][5] = t > 0 ? to_f32(out[at - BH])
                       : to_f32(h0[(size_t)(b0 + cr[m]) * H + cj[m]]);
    };
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int idx = threadIdx.x + m * kGridThreads;
      cr[m] = idx / UL;
      cj[m] = j0 + idx % UL;
      live[m] = idx < RB * UL && b0 + cr[m] < B && cj[m] - j0 < nu;
      zdh[m] = 0.0f;
      if (live[m]) load_step(T - 1, m);
    }
    // the product operands of dead cells stay zero (the last pass's
    // scatter has read gp: its final barrier is behind us)
    for (int idx = threadIdx.x; idx < RB * GPS; idx += kGridThreads)
      gp[idx] = 0.0f;
    __syncthreads();

    for (int t = T - 1; t >= 0; --t) {
      const int par = t & 1;
      // every part of the carry from step t + 1 has reached L2
      if (t < T - 1) grid_sync(count, ++arrivals * (unsigned)n);
      // ---- the gate gradients of this thread's cells
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        if (!live[m]) continue;
        const float carry =
            t < T - 1 ? gather(par ^ 1, cr[m], cj[m]) + zdh[m] : 0.0f;
        const float rg = in[m][0], zg = in[m][1], ng = in[m][2];
        const float dh = in[m][4] + carry;
        const float ga_n = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float ga_z = dh * (in[m][5] - ng) * zg * (1.0f - zg);
        const float ga_r = ga_n * in[m][3] * rg * (1.0f - rg);
        const int b = b0 + cr[m], j = cj[m];
        float* dg_t = dg + ((size_t)t * B + b) * 3 * H + j;
        dg_t[0] = ga_r;
        dg_t[H] = ga_z;
        dg_t[2 * H] = ga_n;
        float* gp_r = gp + cr[m] * GPS + (j - j0);
        gp_r[0] = round_to(ga_r, R);
        gp_r[UL] = round_to(ga_z, R);
        gp_r[2 * UL] = round_to(rg * ga_n, R);
        zdh[m] = zg * dh;
        // the next step's inputs: their loads overlap the product
        if (t > 0) load_step(t - 1, m);
      }
      __syncthreads();

      // ---- this CTA's part of the next carry, for every k < H and its
      // RB rows, to its slot in L2
      float* dst = mine + par * par_stride;
      if constexpr (kMma) {
        // P [RB, HP] = gp [RB, 96] R[:, its columns]^T on the tensor
        // cores: A (the operands, exact in bf16) loaded once; warp w takes
        // the n-tiles of 8 k w, w + 8, ...; B from the resident rows of R
        // by ldmatrix (each row's 96 columns are a k-run of the product)
        constexpr int MT = (RB + 15) / 16;
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int fg = lane / 4, ft = lane % 4;
        uint32_t a[MT][6][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ks = 0; ks < 6; ++ks) {
            const float* ap = gp + (mt * 16 + fg) * GPS + 16 * ks + 2 * ft;
            float2 v = *reinterpret_cast<const float2*>(ap);
            a[mt][ks][0] = pack_bf16x2(v.x, v.y);
            v = *reinterpret_cast<const float2*>(ap + 8);
            a[mt][ks][2] = pack_bf16x2(v.x, v.y);
            if (mt * 16 + 8 < RB) {
              v = *reinterpret_cast<const float2*>(ap + 8 * GPS);
              a[mt][ks][1] = pack_bf16x2(v.x, v.y);
              v = *reinterpret_cast<const float2*>(ap + 8 * GPS + 8);
              a[mt][ks][3] = pack_bf16x2(v.x, v.y);
            } else {
              a[mt][ks][1] = a[mt][ks][3] = 0u;
            }
          }
        for (int k0 = 8 * warp; k0 < HP; k0 += 8 * kGridWarps) {
          float acc[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
          const E* rrow = Rs + (size_t)(k0 + (lane & 7)) * Row +
                          8 * (lane >> 3);
#pragma unroll
          for (int q = 0; q < 3; ++q) {  // columns [32 q, 32 q + 32)
            uint32_t b[4];
            ldmatrix_x4(b, rrow + 32 * q);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16_16816(acc[mt], a[mt][2 * q], b);
              mma_bf16_16816(acc[mt], a[mt][2 * q + 1], b + 2);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = mt * 16 + fg, k = k0 + 2 * ft;
            *reinterpret_cast<float2*>(dst + (size_t)r * HP + k) =
                make_float2(acc[mt][0], acc[mt][1]);
            if (r + 8 < RB)
              *reinterpret_cast<float2*>(dst + (size_t)(r + 8) * HP + k) =
                  make_float2(acc[mt][2], acc[mt][3]);
          }
        }
      } else {  // f32 on the CUDA cores: thread k, all RB rows
        for (int k = threadIdx.x; k < H; k += kGridThreads) {
          float acc[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
          const E* rk = Rs + (size_t)k * Row;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            for (int u = 0; u < U4; u += 4) {
              float w[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) w[i] = to_f32(rk[g * UL + u + i]);
#pragma unroll
              for (int r = 0; r < RB; ++r) {
                const float4 p4 = *reinterpret_cast<const float4*>(
                    gp + r * GPS + g * UL + u);
                acc[r] = fmaf(p4.x, w[0], acc[r]);
                acc[r] = fmaf(p4.y, w[1], acc[r]);
                acc[r] = fmaf(p4.z, w[2], acc[r]);
                acc[r] = fmaf(p4.w, w[3], acc[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) dst[(size_t)r * HP + k] = acc[r];
        }
      }
      // (the next barrier's __syncthreads frees gp)
    }

    // the carry after step 0 (parity 0) is dh0
    grid_sync(count, ++arrivals * (unsigned)n);
#pragma unroll
    for (int m = 0; m < NC; ++m)
      if (live[m])
        dh0[(size_t)(b0 + cr[m]) * H + cj[m]] =
            gather(0, cr[m], cj[m]) + zdh[m];
    // the group's slots are reused by the next pass: every CTA has read
    // this pass's last parts first
    if (b0 + groups * RB < B) grid_sync(count, ++arrivals * (unsigned)n);
  }
}

// ------------------------------------------------------------------ choice

// What the launcher runs for a [T, B, *, H] call: the cluster design (C
// CTAs a cluster, RB rows a cluster), the grid design (U units a CTA, n
// CTAs and RB rows a row group, the groups launched together) or the
// stream design (RB rows a block, slices of the 3H reduction), and the
// dynamic shared memory of a block.
struct Plan {
  int kind, C, rb, slices;
  size_t smem;
  int U, n, groups;
};

template <typename E>
cudaError_t plan_bwd(int T, int B, int H, Plan* plan) {
  if (T > 1) {
    ClusterPlan cp;
    cudaError_t err = plan_cluster(
        B, H,
        [&](int rb, int C) {
          return bwd_cluster_smem_bytes<E, 3>(rb, H, C);
        },
        [&](int rb, int C, size_t smem, int* n) {
          return by_rows(rb, [&](auto r) {
            return active_clusters(
                gru_bwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);
          });
        },
        &cp);
    if (err != cudaSuccess) return err;
    if (cp.C > 0) {
      *plan = {1, cp.C, cp.rb, 0, cp.smem};
      return cudaSuccess;
    }
    GridPlan gp;
    err = plan_grid(
        B, H, sizeof(E),
        [&](int rb) { return bwd_grid_smem_bytes(rb, H, 3, sizeof(E)); },
        [&](int rb, size_t smem, int* n) {
          return by_grid_rows(rb, [&](auto r) {
            return grid_resident(gru_bwd_grid_kernel<E, decltype(r)::value>,
                                 smem, n);
          });
        },
        &gp);
    if (err != cudaSuccess) return err;
    if (gp.U > 0) {
      *plan = {kGrid, 0, gp.rb, 0, gp.smem, gp.U, gp.n, gp.groups};
      return cudaSuccess;
    }
  }
  const int tiles = (H + kTile - 1) / kTile;
  int rb = 1;
  while (rb < 8 && rb < B) rb *= 2;
  while (rb > 1 && smem_bytes(rb, H, 1) > kSmemCap) rb /= 2;
  if (smem_bytes(rb, H, 1) > kSmemCap) return cudaErrorInvalidValue;
  // more slices of the 3H reduction while warps would idle, each >= 16 long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         3 * H >= 16 * slices * 2 &&
         smem_bytes(rb, H, slices * 2) <= kSmemCap)
    slices *= 2;
  *plan = {0, 0, rb, slices, smem_bytes(rb, H, slices)};
  return cudaSuccess;
}

// R [H, 3H] is read by the cluster and grid designs, Rt = R^T [3H, H] by
// the stream design; the other may be null. `work` (`work_bytes` long) is
// the grid design's workspace (bwd_grid_workspace_bytes); the other
// designs take none.
template <typename E>
int gru_bwd(const float* reserve, const E* R, const E* Rt, const E* h0,
            const E* out, const E* dout, float* dg, float* dh0, void* work,
            long long work_bytes, int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_bwd<E>(T, B, H, &p);
  if (err != cudaSuccess) return (int)err;
  if ((p.kind != kStream ? R : Rt) == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.kind == kGrid) {
    if (work == nullptr ||
        work_bytes < (long long)bwd_grid_workspace_bytes(p.groups, p.n, p.rb,
                                                         H))
      return (int)cudaErrorInvalidValue;
    unsigned* bar = static_cast<unsigned*>(work);
    float* slots = reinterpret_cast<float*>(static_cast<char*>(work) +
                                            grid_bar_bytes(p.groups));
    err = cudaMemsetAsync(bar, 0, grid_bar_bytes(p.groups), s);
    if (err != cudaSuccess) return (int)err;
    return (int)by_grid_rows(p.rb, [&](auto r) {
      auto kernel = gru_bwd_grid_kernel<E, decltype(r)::value>;
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg;
      cudaError_t e = grid_config(kernel, p.groups * p.n, p.smem, s, &attr,
                                  &cfg);
      if (e != cudaSuccess) return e;
      return cudaLaunchKernelEx(&cfg, kernel, reserve, R, h0, out, dout, dg,
                                dh0, bar, slots, T, B, H, p.U, p.n,
                                p.groups);
    });
  }
  return (int)by_rows(p.rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    if (p.kind == kStream)
      return launch<E, RB>(reserve, Rt, h0, out, dout, dg, dh0, T, B, H,
                           p.slices, s);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    auto kernel = gru_bwd_cluster_kernel<E, RB>;
    cudaError_t e = cluster_config(kernel, p.C, (B + RB - 1) / RB, p.smem,
                                   p.smem, s, &attr, &cfg);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, reserve, R, h0, out, dout, dg,
                              dh0, T, B, H, cluster_units(H, p.C));
  });
}

}  // namespace

extern "C" {

// Launch the reverse walk on `stream`; each returns a cudaError_t (0 =
// launched). `reserve`, `dg` and `dh0` are float32; `work` is the grid
// design's workspace of `work_bytes` (null for the other designs); every
// other pointer is of the function's one element type. The cluster and
// grid designs read R, the stream design Rt = R^T (dl4j_gru_bwd_plan says
// which); the other may be null.
int dl4j_gru_bwd(const float* reserve, const float* R, const float* Rt,
                 const float* h0, const float* out, const float* dout,
                 float* dg, float* dh0, void* work, long long work_bytes,
                 int T, int B, int H, void* stream) {
  return gru_bwd<float>(reserve, R, Rt, h0, out, dout, dg, dh0, work,
                        work_bytes, T, B, H, stream);
}

int dl4j_gru_bwd_bf16(const float* reserve, const __nv_bfloat16* R,
                      const __nv_bfloat16* Rt, const __nv_bfloat16* h0,
                      const __nv_bfloat16* out, const __nv_bfloat16* dout,
                      float* dg, float* dh0, void* work, long long work_bytes,
                      int T, int B, int H, void* stream) {
  return gru_bwd<__nv_bfloat16>(reserve, R, Rt, h0, out, dout, dg, dh0, work,
                                work_bytes, T, B, H, stream);
}

// The launcher's choice for a [T, B, *, H] call of the element type (bf16
// nonzero: bfloat16, else float32) on the current device: out = {0 for the
// stream design, 1 for the cluster design, 2 for the grid design, C (0
// unless cluster), RB, dynamic shared memory bytes, U, n, groups and the
// workspace bytes a call must pass (0 unless grid)}. Returns a
// cudaError_t.
int dl4j_gru_bwd_plan(int T, int B, int H, int bf16, long long* out) {
  Plan plan;
  cudaError_t err = bf16 ? plan_bwd<__nv_bfloat16>(T, B, H, &plan)
                         : plan_bwd<float>(T, B, H, &plan);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.kind;
  out[1] = plan.C;
  out[2] = plan.rb;
  out[3] = (long long)plan.smem;
  out[4] = plan.U;
  out[5] = plan.n;
  out[6] = plan.groups;
  out[7] = plan.kind == kGrid ? (long long)bwd_grid_workspace_bytes(
                                    plan.groups, plan.n, plan.rb, H)
                              : 0;
  return 0;
}

// The CTAs of the grid kernel (RB rows) with `smem` bytes each that the
// card holds at once, into *n.
int dl4j_gru_bwd_grid_resident(int bf16, int rb, int smem, int* n) {
  return (int)by_grid_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? grid_resident(gru_bwd_grid_kernel<__nv_bfloat16, RB>,
                                (size_t)smem, n)
                : grid_resident(gru_bwd_grid_kernel<float, RB>,
                                (size_t)smem, n);
  });
}

// cudaOccupancyMaxActiveClusters of the cluster kernel (RB rows) for
// clusters of C CTAs with `smem` bytes each, into *n.
int dl4j_gru_bwd_active_clusters(int bf16, int rb, int C, int smem, int* n) {
  return (int)by_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? active_clusters(gru_bwd_cluster_kernel<__nv_bfloat16, RB>,
                                  C, smem, n)
                : active_clusters(gru_bwd_cluster_kernel<float, RB>, C, smem,
                                  n);
  });
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
