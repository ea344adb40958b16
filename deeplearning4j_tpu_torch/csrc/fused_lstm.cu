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
// Three designs; the launcher (lstm_fwd) chooses by shape and by what the
// card can co-schedule, never because a launch failed:
//
// - Cluster (lstm_fwd_cluster_kernel), for T > 1 where a cluster can hold
//   R, on the cluster layer of recurrent_cluster.cuh (the GRU forward's,
//   with four gates): CTA c of a cluster of 8 (or 16) keeps the i, f, o and
//   z columns of R for its U <= 32 units in shared memory for all T steps
//   (128 KB in f32 at H=256, 100 KB at H=200); a cluster owns RB batch
//   rows, the fewest that let every cluster be resident at one CTA an SM.
//   Each step, each CTA: its 8 warps each take a k-slice of h_{t-1} R for
//   its units and rows (lane = unit, RB rows in registers, h_{t-1} read as
//   float4 broadcasts from its local copy); after one barrier the thread of
//   (row, unit) sums the slices and the gates xg, applies the peepholes
//   and the cell update in f32, keeps c and its unit's three peepholes in
//   registers across steps, writes out, hT, cT and the reserve, and stores
//   its rounded h_t into every CTA's h buffer through distributed shared
//   memory (double-buffered by step parity); one cluster barrier ends the
//   step. In f32 a cluster of 16 holds R up to H = 436, in bf16 to H =
//   512; wider calls take the grid design.
// - Grid (lstm_fwd_grid_kernel), for T > 1 where no cluster holds R but
//   the whole card does, on the grid layer of recurrent_grid.cuh (the GRU
//   grid forward's design with four gates): CTA c of a row group of n
//   keeps the i, f, o and z columns of R for its U units (8 in f32, 16 in
//   bf16: kLstmGridSlots = 8 slots, 32 columns of 4-byte words a CTA, 144
//   KB at H = 1024) in shared memory for all T steps; a group owns RB rows
//   (64 in f32 at B = 64: one group of 128 CTAs; 32 in bf16: two groups of
//   64). Each step, after one barrier over its group, a CTA reads h_{t-1}
//   [RB, H] back from L2 (cp.async.cg), staged through shared memory in
//   k-tiles, double-buffered. The step product runs on the CUDA cores in
//   f32 and on the tensor cores in bf16 (mma.sync m16n8k16), as the
//   kernel's own comment details. The sums meet in shared memory, and the
//   thread that owns (row, unit) applies the cell update as the cluster
//   kernel's does (c and the unit's three peepholes in registers), writes
//   out, hT, cT and the reserve, and its rounded h_t to the group's
//   exchange buffer in L2 (double-buffered by step parity), then arrives
//   at the next step's barrier. The slot count 16 of the GRU's grid would
//   need 272 KB of R a CTA at H = 1024 with four gates; 12 slots fit with
//   1 KB to spare, in 86 CTAs a group (f32), leaving 46 SMs idle at B = 64;
//   8 slots fit in 128 CTAs with room for 64-row stages. A CTA holds its
//   R up to H = 1472; in f32 a row group of 8-unit CTAs outgrows the
//   H100's 132 SMs past H = 1056. Wider calls take the stream design.
// - Stream (lstm_fwd_kernel), for T == 1 (decode) and any shape whose R
//   fits neither a cluster nor the card: a block owns RB <= 8 batch rows and a tile
//   of hidden units; rows are independent, so blocks never wait on one
//   another. When T > 1 a block owns all H units (every step needs the
//   whole h_{t-1}) and loops over T inside the block; when T == 1 there is
//   no next step, so the units are split across blocks, kDecodeUnits a
//   block, to spread the read of R over more SMs (32 blocks at H=256).
//   h_{t-1} for the block's rows sits in shared memory; R streams from
//   device memory / L2 once per step per block and is reused for all RB
//   rows held in registers. Each warp takes a (unit tile, k-slice) work
//   item: lane j accumulates the four gate columns R[:, j], R[:, H+j],
//   R[:, 2H+j], R[:, 3H+j] over its k-slice (coalesced across the warp); a
//   decode tile of kDecodeUnits units gives each unit 32 / kDecodeUnits
//   lanes, which take every 4th k of the slice and meet by warp shuffles,
//   so that a warp's chain of dependent loads is 4x shorter. The k-slices'
//   partial sums meet in shared memory. After one barrier, threads sum the
//   partials, apply the cell update in f32 registers, and publish h_t to
//   shared memory; a second barrier ends the step.
// Later work: wgmma for the bf16 step products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "recurrent_cluster.cuh"
#include "recurrent_grid.cuh"

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // k-slices per unit tile
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use
constexpr int kDecodeUnits = 8;            // units a block at T == 1

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
  // units a work item: a decode tile gives each unit 32 / tw lanes (phases)
  const int tw = T == 1 ? kDecodeUnits : kTile;
  const int phases = kTile / tw;
  const int tiles = (upb + tw - 1) / tw;
  float* h = smem;
  float* c = h + RB * H;
  float* part = c + RB * upb;

  const int G = 4 * H;
  const int b0 = blockIdx.x * RB;
  const int j0 = blockIdx.y * upb;
  const int nu = min(upb, H - j0);         // units this block owns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ul = lane % tw, ph = lane / tw;  // unit in the tile, k phase
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
      const int j = min(j0 + tile * tw + ul, H - 1);  // clamp: in bounds
      const int k_begin = ks * kchunk;
      const int k_end = min(H, k_begin + kchunk);
      float acc[4][RB];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[g][r] = 0.0f;
      const E* Rk = R + (size_t)(k_begin + ph) * G + j;
#pragma unroll 4
      for (int k = k_begin + ph; k < k_end; k += phases, Rk += phases * G) {
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
      // a unit's phases meet in its lane of phase 0
      for (int off = tw; off < kTile; off *= 2)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RB; ++r)
            acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], off);
      float* p = part + (size_t)(ks * tiles + tile) * 4 * RB * kTile;
      if (ph == 0)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < RB; ++r) p[(g * RB + r) * kTile + ul] = acc[g][r];
    }
    __syncthreads();

    // ---- phase 2: sum partials, cell update, publish h_t
    const E* xg_t = xg + (size_t)t * B * G;
    for (int idx = threadIdx.x; idx < RB * nu; idx += blockDim.x) {
      const int r = idx / nu, u = idx - r * nu, b = b0 + r;
      const int j = j0 + u;
      const int tile = u / tw, l = u % tw;
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

// ------------------------------------------------------------ cluster design

template <typename E, int RB>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_fwd_cluster_kernel(const E* __restrict__ xg,    // [T, B, 4H]
                        const E* __restrict__ R,     // [H, 4H]
                        const E* __restrict__ h0,    // [B, H]
                        const E* __restrict__ c0,    // [B, H]
                        const E* __restrict__ peep,  // [3H] or null
                        E* __restrict__ out,         // [T, B, H]
                        E* __restrict__ hT,          // [B, H]
                        E* __restrict__ cT,          // [B, H]
                        float* __restrict__ reserve, // [5, T, B, H] or null
                        int T, int B, int H, int U) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = (H + 3) & ~3;
  E* Rs = reinterpret_cast<E*>(smem_raw);
  float* hs = reinterpret_cast<float*>(
      smem_raw + (size_t)HP * 4 * kClusterUnits * sizeof(E));
  float* part = hs + 2 * RB * HP;

  const int C = (int)cluster.num_blocks();
  const int j0 = (int)cluster.block_rank() * U;
  const int nu = max(0, min(U, H - j0));   // units this CTA owns
  const int b0 = (blockIdx.x / C) * RB;
  const int G = 4 * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_r_slice<E, 4>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // h0 into the step-0 buffer; the other buffer's padding columns stay zero
  for (int idx = threadIdx.x; idx < 2 * RB * HP; idx += kClusterThreads) {
    const int r = (idx / HP) % RB, k = idx % HP, b = b0 + r;
    hs[idx] = idx < RB * HP && b < B && k < H
                  ? to_f32(h0[(size_t)b * H + k]) : 0.0f;
  }
  // the thread of (row gr, unit j) keeps that unit's f32 cell state and
  // its three peepholes in registers
  const int gr = warp, j = j0 + lane;
  const bool owner = gr < RB && lane < nu;
  const int b = b0 + gr;
  const bool live = owner && b < B;
  float c = live ? to_f32(c0[(size_t)b * H + j]) : 0.0f;
  float p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  if (owner && peep != nullptr) {
    p_i = to_f32(peep[j]);
    p_f = to_f32(peep[H + j]);
    p_o = to_f32(peep[2 * H + j]);
  }
  float xv[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
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
    float xn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live && t + 1 < T) {
      const E* x_next = xg + ((size_t)(t + 1) * B + b) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xn[g] = to_f32(x_next[g * H]);
    }

    // ---- this warp's k-slice of h_{t-1} @ R for its 32 units, RB rows
    const float* hcur = hs + (t & 1) * RB * HP;
    float acc[4][RB];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[g][r] = 0.0f;
    for (int k = k_begin; k < k_end; k += 4) {
      float4 h4[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        h4[r] = *reinterpret_cast<const float4*>(hcur + r * HP + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const E* rk = Rs + (size_t)(k + kk) * 4 * kClusterUnits + lane;
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = to_f32(rk[g * kClusterUnits]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = kk == 0 ? h4[r].x : kk == 1 ? h4[r].y
                         : kk == 2 ? h4[r].z : h4[r].w;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hk, w[g], acc[g][r]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r)
        part[((warp * 4 + g) * RB + r) * 32 + lane] = acc[g][r];
    __syncthreads();

    // ---- the cell of (row gr, unit j); h_t to every CTA of the cluster
    if (owner) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kClusterWarps; ++w)
          sum += part[((w * 4 + g) * RB + gr) * 32 + lane];
        gate[g] = xv[g] + sum;
      }
      const float c_old = c;
      if (peep != nullptr) {
        gate[0] += c_old * p_i;
        gate[1] += c_old * p_f;
      }
      const float ig = sigmoid_f(gate[0]);
      const float fg = sigmoid_f(gate[1]);
      const float zg = tanhf(gate[3]);
      const float c_new = fg * c_old + ig * zg;
      if (peep != nullptr) gate[2] += c_new * p_o;
      const float og = sigmoid_f(gate[2]);
      const E h_st = from_f32<E>(og * tanhf(c_new));
      c = c_new;
      // the next product reads h in the element type, as the Pallas
      // kernel casts it
      float* dst = hs + ((t + 1) & 1) * RB * HP + gr * HP + j;
      const float h_r = to_f32(h_st);
      for (int q = 0; q < C; ++q) *cluster.map_shared_rank(dst, q) = h_r;
      if (live) {
        const size_t at = ((size_t)t * B + b) * H + j;
        out[at] = h_st;
        if (reserve != nullptr) {
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
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[g] = xn[g];
    // h_t has reached every CTA, and this step's buffers are free
    cluster.sync();
  }
}


// --------------------------------------------------------------- grid design

// One CTA of a row group: its units' i, f, o and z columns of R resident
// (the grid layer's layout with kLstmGridSlots slots: column g UL + u of a
// row is gate g of unit u, NCOL = 4 UL columns), h_{t-1} of the group's RB
// rows staged from L2 each step. The step product h_{t-1} @ R[:, its
// columns] runs
// - in f32 on the CUDA cores: warp (rg, kw) takes the 8 rows of row group
//   rg and every KW-th pair of 4-k chunks, lane (half, slot) the columns
//   slot, slot + 16, ... (NQ of them) and one chunk of the pair by half,
//   so the two half-warps read R rows 4 apart, padded onto the other 16
//   banks; one shuffle joins the halves, and each warp leaves its sums for
//   its 8 rows in shared memory, where a cell's owner adds the KW warps'
//   in kw order;
// - in bf16 on the tensor cores (mma.sync m16n8k16, exact bf16 products
//   summed in f32): warp (j, half) takes the n-tiles of 8 columns j, j +
//   4, ... (NQ of them) and alternate k-steps of 16 by half; B fragments
//   come from the resident R by ldmatrix.trans, A fragments straight from
//   the staged bf16 h (h is exchanged and staged in the element type);
//   half 1 leaves its sums in shared memory and half 0 adds its own first.
// The columns of one unit lie in different lanes (f32) or warps (bf16), so
// the sums meet in shared memory [RB][NCOL] (the idle stage buffers), and
// thread i of the CTA owns cells i, i + 256, ... (row, unit): it applies
// the cell update, keeps the f32 c and its unit's three peepholes in
// registers, and writes its rounded h_t to the group's exchange buffer.
template <typename E, int RB>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_fwd_grid_kernel(const E* __restrict__ xg,    // [T, B, 4H]
                     const E* __restrict__ R,     // [H, 4H]
                     const E* __restrict__ h0,    // [B, H]
                     const E* __restrict__ c0,    // [B, H]
                     const E* __restrict__ peep,  // [3H] or null
                     E* __restrict__ out,         // [T, B, H]
                     E* __restrict__ hT,          // [B, H]
                     E* __restrict__ cT,          // [B, H]
                     float* __restrict__ reserve, // [5, T, B, H] or null
                     unsigned* __restrict__ bar,  // [groups][kGridBarWords], 0
                     E* __restrict__ hx,          // [2][B][HP] h by parity
                     int T, int B, int H, int U, int n, int groups) {
  constexpr bool kMma = sizeof(E) == 2;        // bf16: the tensor cores
  constexpr int S = kLstmGridSlots;
  constexpr int UL = grid_units(sizeof(E), S); // units a CTA at most
  constexpr int NCOL = 4 * UL;                 // gate columns (elements)
  constexpr int NQ = 4 * S / 16;               // columns a lane, tiles a warp
  constexpr int RG = RB / 8;                   // f32: row groups of 8
  constexpr int KW = kGridWarps / RG;          // f32: warps a row group
  constexpr int MT = (RB + 15) / 16;           // bf16: m-tiles of 16 rows
  constexpr int Row = fwd_grid_row<4, S>() * 4 / (int)sizeof(E);  // elements
  constexpr int KT = kGridStage / RB;          // k a stage
  constexpr int KS = KT + kGridStagePad;       // elements a staged row
  constexpr int SF = grid_stage_floats(64);    // elements a stage buffer
  constexpr int VE = 16 / (int)sizeof(E);      // elements a 16-byte copy
  constexpr int NC = (RB * UL + kGridThreads - 1) / kGridThreads;  // cells
  constexpr int P = kMma ? 1 : KW;             // parts of a sum left in xch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = grid_hp(H);
  E* Rs = reinterpret_cast<E*>(smem_raw);
  E* hs = reinterpret_cast<E*>(smem_raw + (size_t)HP * Row * sizeof(E));
  // the sums [P][RB][NCOL] f32, in the stage buffers once a product is done
  float* xch = reinterpret_cast<float*>(hs);

  const int c = blockIdx.x % n, grp = blockIdx.x / n;
  const int j0 = c * U;
  const int nu = max(0, min(U, H - j0));      // units this CTA owns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // f32: row group rg and k-group kw of the warp, (half, slot) of the
  // lane; bf16: n-group j and k-half of the warp, (fg, ft) of the lane in
  // the mma fragments
  const int half = kMma ? warp / 4 : lane / 16;
  const int slot = lane % 16;
  const int rg = warp % RG, kw = warp / RG;
  const int j = warp % 4, fg = lane / 4, ft = lane % 4;
  const int G = 4 * H;
  const size_t plane = (size_t)T * B * H;
  const size_t par_stride = (size_t)B * HP;
  unsigned* count = bar + grp * kGridBarWords;
  unsigned arrivals = 0;

  load_grid_r<E, 4, Row, S>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // (the first barrier's __syncthreads publishes Rs to the whole CTA)

  // cell m of this thread: (row cr[m] of the group's rows, unit cu[m]);
  // its unit's three peepholes stay in registers for every pass
  int cr[NC], cu[NC];
  float p_i[NC], p_f[NC], p_o[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int idx = threadIdx.x + m * kGridThreads;
    cr[m] = idx / UL;
    cu[m] = idx % UL;
    const bool unit = idx < RB * UL && cu[m] < nu;
    const bool pp = unit && peep != nullptr;
    p_i[m] = pp ? to_f32(peep[j0 + cu[m]]) : 0.0f;
    p_f[m] = pp ? to_f32(peep[H + j0 + cu[m]]) : 0.0f;
    p_o[m] = pp ? to_f32(peep[2 * H + j0 + cu[m]]) : 0.0f;
  }

  for (int b0 = grp * RB; b0 < B; b0 += groups * RB) {
    // each live cell keeps its f32 cell state
    bool live[NC];
    float cs[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int b = b0 + cr[m], jj = j0 + cu[m];
      live[m] = threadIdx.x + m * kGridThreads < RB * UL && b < B &&
                cu[m] < nu;
      cs[m] = live[m] ? to_f32(c0[(size_t)b * H + jj]) : 0.0f;
      if (live[m]) hx[(size_t)b * HP + jj] = h0[(size_t)b * H + jj];
    }

    for (int t = 0; t < T; ++t) {
      // this step's gates: their loads overlap the barrier
      float xv[NC][4];
#pragma unroll
      for (int m = 0; m < NC; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[m][q] = live[m] ? to_f32(xg[((size_t)t * B + b0 + cr[m]) * G +
                                         q * H + j0 + cu[m]])
                             : 0.0f;
      // every CTA of the group has written h_{t-1}, and every thread of
      // this CTA has read the last step's sums
      grid_sync(count, ++arrivals * (unsigned)n);

      // ---- h_{t-1} @ R for this CTA's columns and rows, h_{t-1} staged
      // from L2 in k-tiles of KT
      const E* hprev = hx + (size_t)(t & 1) * par_stride;
      auto stage = [&](int tile) {
        E* dst = hs + (tile & 1) * SF;
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
      // f32: acc[row][column]; bf16: the mma accumulators [m-tile][tile][4]
      float acc[kMma ? MT : 8][NQ][kMma ? 4 : 1];
#pragma unroll
      for (int i = 0; i < (kMma ? MT : 8); ++i)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
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
        const E* hb = hs + (tile & 1) * SF;
        const int k0 = tile * KT, len = min(KT, HP - k0);
        if constexpr (kMma) {
          for (int kk = 16 * half; kk < len; kk += 32) {
            // B: tiles q and q + 1 (x4: k 0-7, 8-15 of each), an odd last
            // tile by x2
            uint32_t bq[NQ][2];
            const E* rrow = Rs + (size_t)(k0 + kk + ((lane >> 3) & 1) * 8 +
                                          (lane & 7)) * Row + 8 * j;
#pragma unroll
            for (int q = 0; q + 1 < NQ; q += 2) {
              uint32_t b4[4];
              ldmatrix_x4_trans(b4, rrow + 32 * q + (lane >> 4) * 32);
              bq[q][0] = b4[0];
              bq[q][1] = b4[1];
              bq[q + 1][0] = b4[2];
              bq[q + 1][1] = b4[3];
            }
            if constexpr (NQ % 2 == 1)
              ldmatrix_x2_trans(bq[NQ - 1], rrow + 32 * (NQ - 1));
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
#pragma unroll
              for (int q = 0; q < NQ; ++q)
                mma_bf16_16816(acc[mt][q], a, bq[q]);
            }
          }
        } else {
          const float* hw = hb + rg * 8 * KS;
#pragma unroll 4
          for (int kk = 4 * (2 * kw + half); kk < len; kk += 8 * KW) {
            float w[4][NQ];
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4)
#pragma unroll
              for (int q = 0; q < NQ; ++q)
                w[q4][q] = to_f32(Rs[(size_t)(k0 + kk + q4) * Row + 16 * q +
                                     slot]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 h4 =
                  *reinterpret_cast<const float4*>(hw + i * KS + kk);
              const float hk[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
              for (int q4 = 0; q4 < 4; ++q4)
#pragma unroll
                for (int q = 0; q < NQ; ++q)
                  acc[i][q][0] = fmaf(hk[q4], w[q4][q], acc[i][q][0]);
            }
          }
        }
        // this stage buffer is free for tile + 2
        __syncthreads();
      }

      // ---- the sums [P][RB][NCOL] in shared memory
      if constexpr (kMma) {
        // c0, c1: row fg, columns 2 ft, 2 ft + 1 of the tile; c2, c3: row
        // fg + 8. Half 1 leaves its sums; half 0 adds its own first.
        auto at = [&](int mt, int q, int e) {
          return xch + (mt * 16 + fg + 8 * (e / 2)) * NCOL + 8 * (j + 4 * q) +
                 2 * ft + e % 2;
        };
        if (half) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (mt * 16 + fg + 8 * (e / 2) < RB) *at(mt, q, e) =
                    acc[mt][q][e];
        }
        __syncthreads();
        if (!half) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (mt * 16 + fg + 8 * (e / 2) < RB) {
                  float* d = at(mt, q, e);
                  *d = acc[mt][q][e] + *d;
                }
        }
      } else {
        // the two half-warps took alternate chunks of k
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            acc[i][q][0] += __shfl_xor_sync(0xffffffffu, acc[i][q][0], 16);
        // half h leaves rows 4 h .. 4 h + 3 of its row group, as part kw
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            xch[(kw * RB + rg * 8 + 4 * half + i) * NCOL + 16 * q + slot] =
                half ? acc[4 + i][q][0] : acc[i][q][0];
      }
      __syncthreads();

      // ---- the cell update of this thread's cells; h_t to the group
      E* hnext = hx + (size_t)((t + 1) & 1) * par_stride;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        if (!live[m]) continue;
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float sum = 0.0f;
#pragma unroll
          for (int w2 = 0; w2 < P; ++w2)
            sum += xch[(w2 * RB + cr[m]) * NCOL + q * UL + cu[m]];
          gate[q] = xv[m][q] + sum;
        }
        const float c_old = cs[m];
        gate[0] += c_old * p_i[m];
        gate[1] += c_old * p_f[m];
        const float ig = sigmoid_f(gate[0]);
        const float fgt = sigmoid_f(gate[1]);
        const float zg = tanhf(gate[3]);
        const float c_new = fgt * c_old + ig * zg;
        gate[2] += c_new * p_o[m];
        const float og = sigmoid_f(gate[2]);
        const E h_st = from_f32<E>(og * tanhf(c_new));
        cs[m] = c_new;
        const int b = b0 + cr[m], jj = j0 + cu[m];
        // the next product reads h in the element type, as the Pallas
        // kernel casts it
        hnext[(size_t)b * HP + jj] = h_st;
        const size_t at = ((size_t)t * B + b) * H + jj;
        out[at] = h_st;
        if (reserve != nullptr) {
          reserve[at] = c_new;
          reserve[plane + at] = ig;
          reserve[2 * plane + at] = fgt;
          reserve[3 * plane + at] = og;
          reserve[4 * plane + at] = zg;
        }
        if (t == T - 1) {
          hT[(size_t)b * H + jj] = h_st;
          cT[(size_t)b * H + jj] = from_f32<E>(c_new);
        }
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

// A forward grid CTA's shared memory: its R columns at kLstmGridSlots
// slots, and stages for the most rows a group takes.
inline size_t lstm_fwd_grid_smem_bytes(int H) {
  return fwd_grid_smem_bytes(H, 4, kLstmGridSlots, 64);
}

template <typename E>
cudaError_t plan_fwd(int T, int B, int H, Plan* plan) {
  if (T > 1) {
    ClusterPlan cp;
    cudaError_t err = plan_cluster(
        B, H,
        [&](int rb, int) {
          return fwd_cluster_smem_bytes(rb, H, 4, sizeof(E));
        },
        [&](int rb, int C, size_t smem, int* n) {
          return by_rows(rb, [&](auto r) {
            return active_clusters(
                lstm_fwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);
          });
        },
        &cp);
    if (err != cudaSuccess) return err;
    if (cp.C > 0) {
      *plan = {kCluster, cp.C, cp.rb, 0, 0, cp.smem};
      return cudaSuccess;
    }
    GridPlan gp;
    err = plan_grid(
        B, H, sizeof(E), [&](int) { return lstm_fwd_grid_smem_bytes(H); },
        [&](int rb, size_t smem, int* n) {
          return by_lstm_grid_rows(rb, [&](auto r) {
            return grid_resident(lstm_fwd_grid_kernel<E, decltype(r)::value>,
                                 smem, n);
          });
        },
        &gp, kLstmGridSlots, kLstmGridRows);
    if (err != cudaSuccess) return err;
    if (gp.U > 0) {
      *plan = {kGrid, 0, gp.rb, 0, 0, gp.smem, gp.U, gp.n, gp.groups};
      return cudaSuccess;
    }
  }
  // stream: T == 1 splits units across blocks; T > 1: a block needs all of h
  const int upb = T == 1 ? std::min(H, kDecodeUnits) : H;
  const int tiles = (upb + kTile - 1) / kTile;
  int rb = 1;
  while (rb < 8 && rb < B) rb *= 2;
  while (rb > 1 && smem_bytes(rb, H, upb, 1) > kSmemCap) rb /= 2;
  if (smem_bytes(rb, H, upb, 1) > kSmemCap) return cudaErrorInvalidValue;
  // more k-slices while warps would idle, each slice >= 16 k long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         H >= 16 * slices * 2 &&
         smem_bytes(rb, H, upb, slices * 2) <= kSmemCap)
    slices *= 2;
  *plan = {kStream, 0, rb, upb, slices, smem_bytes(rb, H, upb, slices)};
  return cudaSuccess;
}

// `work` (`work_bytes` long) is the grid design's workspace
// (fwd_grid_workspace_bytes); the other designs take none.
template <typename E>
int lstm_fwd(const E* xg, const E* R, const E* h0, const E* c0,
             const E* peep, E* out, E* hT, E* cT, float* reserve, void* work,
             long long work_bytes, int T, int B, int H, void* stream) {
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
    return (int)by_lstm_grid_rows(p.rb, [&](auto r) {
      auto kernel = lstm_fwd_grid_kernel<E, decltype(r)::value>;
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg;
      cudaError_t e = grid_config(kernel, p.groups * p.n, p.smem, s, &attr,
                                  &cfg);
      if (e != cudaSuccess) return e;
      return cudaLaunchKernelEx(&cfg, kernel, xg, R, h0, c0, peep, out, hT,
                                cT, reserve, bar, hx, T, B, H, p.U, p.n,
                                p.groups);
    });
  }
  return (int)by_rows(p.rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    if (p.kind == kStream)
      return launch<E, RB>(xg, R, h0, c0, peep, out, hT, cT, reserve, T, B,
                           H, p.upb, p.slices, s);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    auto kernel = lstm_fwd_cluster_kernel<E, RB>;
    cudaError_t e = cluster_config(kernel, p.C, (B + RB - 1) / RB, p.smem,
                                   p.smem, s, &attr, &cfg);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, xg, R, h0, c0, peep, out, hT,
                              cT, reserve, T, B, H, cluster_units(H, p.C));
  });
}

}  // namespace

extern "C" {

// Launch the recurrence on `stream`; each returns a cudaError_t (0 =
// launched). Every pointer but `reserve` (float32, or null) and `work`
// (the grid design's workspace of `work_bytes`, or null for the other
// designs) is of the function's one element type.
int dl4j_lstm_fwd(const float* xg, const float* R, const float* h0,
                  const float* c0, const float* peep, float* out, float* hT,
                  float* cT, float* reserve, void* work, long long work_bytes,
                  int T, int B, int H, void* stream) {
  return lstm_fwd<float>(xg, R, h0, c0, peep, out, hT, cT, reserve, work,
                         work_bytes, T, B, H, stream);
}

int dl4j_lstm_fwd_bf16(const __nv_bfloat16* xg, const __nv_bfloat16* R,
                       const __nv_bfloat16* h0, const __nv_bfloat16* c0,
                       const __nv_bfloat16* peep, __nv_bfloat16* out,
                       __nv_bfloat16* hT, __nv_bfloat16* cT, float* reserve,
                       void* work, long long work_bytes, int T, int B, int H,
                       void* stream) {
  return lstm_fwd<__nv_bfloat16>(xg, R, h0, c0, peep, out, hT, cT, reserve,
                                 work, work_bytes, T, B, H, stream);
}

// The launcher's choice for a [T, B, *, H] call of the element type (bf16
// nonzero: bfloat16, else float32) on the current device: out = {0 for the
// stream design, 1 for the cluster design, 2 for the grid design, C (0
// unless cluster), RB, dynamic shared memory bytes, U, n, groups and the
// workspace bytes a call must pass (0 unless grid)}. Returns a
// cudaError_t.
int dl4j_lstm_fwd_plan(int T, int B, int H, int bf16, long long* out) {
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
int dl4j_lstm_grid_resident(int bf16, int rb, int smem, int* n) {
  return (int)by_lstm_grid_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? grid_resident(lstm_fwd_grid_kernel<__nv_bfloat16, RB>,
                                (size_t)smem, n)
                : grid_resident(lstm_fwd_grid_kernel<float, RB>,
                                (size_t)smem, n);
  });
}

// cudaOccupancyMaxActiveClusters of the cluster kernel (RB rows) for
// clusters of C CTAs with `smem` bytes each, into *n.
int dl4j_lstm_active_clusters(int bf16, int rb, int C, int smem, int* n) {
  return (int)by_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? active_clusters(lstm_fwd_cluster_kernel<__nv_bfloat16, RB>,
                                  C, smem, n)
                : active_clusters(lstm_fwd_cluster_kernel<float, RB>, C,
                                  smem, n);
  });
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
