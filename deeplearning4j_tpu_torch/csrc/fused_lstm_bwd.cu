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
// What bounds it on this card: every step reads all of R [H, 4H] (640 KB in
// f32 at H=200) to do 2*B*4H*H flops, so at training batch sizes it is far
// below the H100's ridge point: memory- and latency-bound, like the forward.
//
// Three designs; the launcher (lstm_bwd) chooses by shape and by what the
// card can co-schedule, never because a launch failed:
//
// - Cluster (lstm_bwd_cluster_kernel), for T > 1 where a cluster can hold
//   R, on the cluster layer of recurrent_cluster.cuh (the GRU backward's
//   design with four gates): CTA c of a cluster of C = 8 (or 16) owns
//   units U_c (U <= 32) and keeps the forward's slice of R, the i, f, o
//   and z columns of U_c for every k < H, in shared memory for all T
//   steps, each row padded by one 4-byte word. It reads R, not R^T. The
//   thread of (row, unit) walks that unit: it keeps the dc carry and its
//   unit's three peepholes in registers, loads the next step's inputs
//   while the product runs (c_{t-1} of step t is c_t of step t-1, kept),
//   forms the gate gradients in f32, stores dg unrounded and puts dg
//   rounded to R's type into the product operands gp [RB][4][32]. After
//   one barrier, thread k forms its CTA's part of dh_rec[b, k], the sum
//   over U_c's 4 x U columns of gp[b, .] R[k, .], for every k < H and the
//   RB rows, and stores it through distributed shared memory into slot
//   [parity][c] of the CTA that owns unit k (scatter_carry); one cluster
//   barrier; the owner sums its C slots in rank order (gather_carry), so
//   the result is the same run to run. Step 0 needs no product: dh0 is a
//   GEMM outside. In f32 a cluster of 16 holds R only to H = 440; in bf16
//   to H = 512, where 32 units a CTA run out.
// - Grid (lstm_bwd_grid_kernel), for T > 1 where no cluster holds R but
//   the whole card does, on the grid layer of recurrent_grid.cuh (the GRU
//   grid backward's design with four gates, at the LSTM forward's
//   kLstmGridSlots = 8 slots): CTA c of a row group of n keeps the
//   forward's slice of R (the i, f, o and z columns of its U units, 8 in
//   f32 and 16 in bf16, for every k < H; rows padded by one word in f32,
//   four in bf16) in shared memory for all T steps, and its thread of
//   (row, unit) walks that cell as the cluster kernel's does (dc and the
//   unit's three peepholes in registers). The carry dh_rec crosses CTAs
//   as a reduce-scatter through L2: each step, after the gate gradients,
//   thread k forms the CTA's part of the next carry, P_c[b, k] = sum over
//   its 4 x U columns of dg[b, .] R[k, .], for every k < H and its RB
//   rows, and stores it to the group's slot [parity][c] in L2; one barrier
//   over the group; then each owner sums its n parts in rank order
//   (ld.global.cg; the same order every run). Step 0 needs no product. The
//   step product runs in f32 on the CUDA cores (thread k, all RB rows) and
//   in bf16 on the tensor cores (mma.sync m16n8k16 over the operands [RB,
//   64], exact in bf16, and R's resident rows by ldmatrix; exact products
//   summed in f32). A group takes up to 32 rows (kGridRows, the GRU's):
//   at [64, 64, 1024] f32 two passes of 32 rows ran 3 % faster than one of
//   64 on an H100 (experiments/lstm_grid/rows_ab.py), where the forward's
//   one pass of 64 ran 9 % faster than two of 32 (kLstmGridRows). The
//   other exchange, an all-gather of the operands,
//   ran slower in the GRU's grid backward (experiments/gru_bwd_allgather/
//   ab.py), so it is not taken here. A CTA holds its R up to H = 1744 in
//   f32 and 1584 in bf16; in f32 a row group of 8-unit CTAs outgrows the
//   H100's 132 SMs past H = 1056. Wider calls take the stream design.
// - Stream (lstm_bwd_kernel), for T == 1 and any shape whose R fits
//   neither a cluster nor the card; it mirrors the stream forward:
//   - A block owns RB batch rows and all H units and loops over t inside
//     the block (every step needs the whole dh_rec); rows are independent,
//     so blocks never wait on one another.
//   - The wrapper passes R transposed once per call, Rt [4H, H] contiguous,
//     so that the product dg @ R^T reads it exactly as the forward reads R:
//     each warp takes a (32-unit tile, slice of the 4H reduction) work
//     item, lane k accumulates column k of Rt over its slice (coalesced
//     across the warp) for all RB rows held in registers, and the partial
//     sums meet in shared memory.
//   - Phase A sums the partials into dh_rec, forms the gate gradients in
//     f32 registers, stores dg, and keeps the dc carry and this step's dg
//     in shared memory; one barrier; phase B forms the partial products; a
//     second barrier ends the step. The last step (t = 0) needs no
//     product.
// Later work: wgmma for the bf16 step product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent_cluster.cuh"
#include "recurrent_grid.cuh"

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // slices of the 4H reduction
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use

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

// ------------------------------------------------------------ cluster design

template <typename E, int RB>
__global__ void __launch_bounds__(kClusterThreads, 1)
lstm_bwd_cluster_kernel(const float* __restrict__ reserve,  // [5, T, B, H]
                        const E* __restrict__ R,            // [H, 4H]
                        const E* __restrict__ c0,           // [B, H]
                        const E* __restrict__ dout,         // [T, B, H]
                        const E* __restrict__ dcT,          // [B, H] or null
                        const E* __restrict__ peep,         // [3H] or null
                        float* __restrict__ dg,             // [T, B, 4H]
                        float* __restrict__ dc0,            // [B, H]
                        int T, int B, int H, int U) {
  constexpr int kRow = bwd_row<E, 4>();
  constexpr int kU = kClusterUnits;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = (H + 3) & ~3;
  E* Rs = reinterpret_cast<E*>(smem_raw);
  float* gp = reinterpret_cast<float*>(smem_raw +
                                       (size_t)HP * kRow * sizeof(E));
  float* slots = gp + RB * 4 * kU;

  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int j0 = rank * U;
  const int nu = max(0, min(U, H - j0));   // units this CTA owns
  const int b0 = (blockIdx.x / C) * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_r_slice<E, 4, kRow>(Rs, R, H, HP, j0, nu);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the product operands of units past nu and rows past B stay zero
  for (int idx = threadIdx.x; idx < RB * 4 * kU; idx += kClusterThreads)
    gp[idx] = 0.0f;

  // the thread of (row gr, unit j) walks that unit: its inputs one step
  // ahead in registers, the dc carry and its peepholes from step to step
  const int gr = warp, j = j0 + lane;
  const bool live = gr < RB && lane < nu && b0 + gr < B;
  const int b = b0 + gr;
  const size_t plane = (size_t)T * B * H;
  const size_t BH = (size_t)B * H;
  float dc = 0.0f, p_i = 0.0f, p_f = 0.0f, p_o = 0.0f;
  float in[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // in: i f o z c_t dout c_{t-1}; c_t of step t-1 is this step's c_{t-1}
  auto load_step = [&](int t, float* v, float c_t) {
    const size_t at = ((size_t)t * B + b) * H + j;
    v[0] = reserve[plane + at];
    v[1] = reserve[2 * plane + at];
    v[2] = reserve[3 * plane + at];
    v[3] = reserve[4 * plane + at];
    v[4] = c_t;
    v[5] = to_f32(dout[at]);
    v[6] = t > 0 ? reserve[at - BH] : to_f32(c0[(size_t)b * H + j]);
  };
  if (live) {
    load_step(T - 1, in, reserve[((size_t)(T - 1) * B + b) * H + j]);
    if (dcT != nullptr) dc = to_f32(dcT[(size_t)b * H + j]);
    if (peep != nullptr) {
      p_i = to_f32(peep[j]);
      p_f = to_f32(peep[H + j]);
      p_o = to_f32(peep[2 * H + j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // every CTA of the cluster is running and initialised before any CTA
  // stores into another's slots
  cluster.sync();

  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    // ---- the gate gradients of (row gr, unit j), as _lstm_bwd_kernel
    float nxt[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      const float i = in[0], f = in[1], o = in[2], z = in[3];
      const float dh =
          in[5] + (t < T - 1 ? gather_carry<RB>(slots, par ^ 1, C, gr, lane)
                             : 0.0f);
      const float th = tanhf(in[4]);
      const float dgo = (dh * th) * o * (1.0f - o);
      float d = dc + dh * o * (1.0f - th * th);
      if (peep != nullptr) d += dgo * p_o;
      const float dgi = (d * z) * i * (1.0f - i);
      const float dgf = (d * in[6]) * f * (1.0f - f);
      const float dgz = (d * i) * (1.0f - z * z);
      dc = d * f;
      if (peep != nullptr) dc += dgi * p_i + dgf * p_f;
      float* dg_t = dg + ((size_t)t * B + b) * 4 * H + j;
      dg_t[0] = dgi;
      dg_t[H] = dgf;
      dg_t[2 * H] = dgo;
      dg_t[3 * H] = dgz;
      float* gp_r = gp + gr * 4 * kU + lane;
      gp_r[0] = round_to(dgi, R);
      gp_r[kU] = round_to(dgf, R);
      gp_r[2 * kU] = round_to(dgo, R);
      gp_r[3 * kU] = round_to(dgz, R);
      // the next step's inputs are known now: their load overlaps the
      // product
      if (t > 0) load_step(t - 1, nxt, in[6]);
    }
    if (t == 0) break;  // dh0 is formed outside, as in _fused_bwd
    __syncthreads();

    // ---- this CTA's part of dh_rec for step t-1, for every k < H and RB
    // rows, to the CTA that owns unit k
    scatter_carry<E, 4, RB, kRow>(cluster, Rs, gp, slots, par, C, rank, H,
                                  U);
#pragma unroll
    for (int q = 0; q < 7; ++q) in[q] = nxt[q];
    // every part has reached its owner, and this step's gp is free
    cluster.sync();
  }
  // no CTA reads another's shared memory after the last cluster barrier
  if (live) dc0[(size_t)b * H + j] = dc;
}


// --------------------------------------------------------------- grid design

template <typename E, int RB>
__global__ void __launch_bounds__(kGridThreads, 1)
lstm_bwd_grid_kernel(const float* __restrict__ reserve,  // [5, T, B, H]
                     const E* __restrict__ R,            // [H, 4H]
                     const E* __restrict__ c0,           // [B, H]
                     const E* __restrict__ dout,         // [T, B, H]
                     const E* __restrict__ dcT,          // [B, H] or null
                     const E* __restrict__ peep,         // [3H] or null
                     float* __restrict__ dg,             // [T, B, 4H]
                     float* __restrict__ dc0,            // [B, H]
                     unsigned* __restrict__ bar,  // [groups][kGridBarWords], 0
                     float* __restrict__ slots,   // [2][groups][n][RB][HP]
                     int T, int B, int H, int U, int n, int groups) {
  constexpr bool kMma = sizeof(E) == 2;        // bf16: the tensor cores
  constexpr int S = kLstmGridSlots;
  constexpr int UL = grid_units(sizeof(E), S); // units a CTA at most
  constexpr int NCOL = 4 * UL;                 // operand columns
  constexpr int Row = bwd_grid_row(4, sizeof(E), S) * 4 / (int)sizeof(E);
  constexpr int GPS = NCOL + kGridOperandPad;  // floats an operand row
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

  load_grid_r<E, 4, Row, S>(Rs, R, H, HP, j0, nu);
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

  // cell m of this thread: (row cr[m], unit cj[m]) from threadIdx.x + m
  // threads; its unit's three peepholes stay in registers for every pass
  int cr[NC], cj[NC];
  float p_i[NC], p_f[NC], p_o[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int idx = threadIdx.x + m * kGridThreads;
    cr[m] = idx / UL;
    cj[m] = j0 + idx % UL;
    const bool pp = idx < RB * UL && cj[m] - j0 < nu && peep != nullptr;
    p_i[m] = pp ? to_f32(peep[cj[m]]) : 0.0f;
    p_f[m] = pp ? to_f32(peep[H + cj[m]]) : 0.0f;
    p_o[m] = pp ? to_f32(peep[2 * H + cj[m]]) : 0.0f;
  }

  for (int b0 = grp * RB; b0 < B; b0 += groups * RB) {
    // each live cell's inputs one step ahead in registers, its dc carry
    // step to step
    bool live[NC];
    float in[NC][7], dc[NC];  // i f o z c_t dout c_{t-1}
    // c_t of step t - 1 is this step's c_{t-1}: passed in, not reloaded
    auto load_step = [&](int t, int m, float c_t) {
      const int b = b0 + cr[m];
      const size_t at = ((size_t)t * B + b) * H + cj[m];
      in[m][0] = reserve[plane + at];
      in[m][1] = reserve[2 * plane + at];
      in[m][2] = reserve[3 * plane + at];
      in[m][3] = reserve[4 * plane + at];
      in[m][4] = c_t;
      in[m][5] = to_f32(dout[at]);
      in[m][6] = t > 0 ? reserve[at - BH]
                       : to_f32(c0[(size_t)b * H + cj[m]]);
    };
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int b = b0 + cr[m];
      live[m] = threadIdx.x + m * kGridThreads < RB * UL && b < B &&
                cj[m] - j0 < nu;
      dc[m] = 0.0f;
      if (live[m]) {
        load_step(T - 1, m, reserve[((size_t)(T - 1) * B + b) * H + cj[m]]);
        if (dcT != nullptr) dc[m] = to_f32(dcT[(size_t)b * H + cj[m]]);
      }
    }
    // the product operands of dead cells stay zero (the last pass's
    // products have read gp: a barrier of the last step is behind us)
    for (int idx = threadIdx.x; idx < RB * GPS; idx += kGridThreads)
      gp[idx] = 0.0f;
    __syncthreads();

    for (int t = T - 1; t >= 0; --t) {
      const int par = t & 1;
      // every part of the carry from step t + 1 has reached L2
      if (t < T - 1) grid_sync(count, ++arrivals * (unsigned)n);
      // ---- the gate gradients of this thread's cells, as
      // _lstm_bwd_kernel
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        if (!live[m]) continue;
        const float i = in[m][0], f = in[m][1], o = in[m][2], z = in[m][3];
        const float dh =
            in[m][5] + (t < T - 1 ? gather(par ^ 1, cr[m], cj[m]) : 0.0f);
        const float th = tanhf(in[m][4]);
        const float dgo = (dh * th) * o * (1.0f - o);
        float d = dc[m] + dh * o * (1.0f - th * th);
        if (peep != nullptr) d += dgo * p_o[m];
        const float dgi = (d * z) * i * (1.0f - i);
        const float dgf = (d * in[m][6]) * f * (1.0f - f);
        const float dgz = (d * i) * (1.0f - z * z);
        dc[m] = d * f;
        if (peep != nullptr) dc[m] += dgi * p_i[m] + dgf * p_f[m];
        const int b = b0 + cr[m], j = cj[m];
        float* dg_t = dg + ((size_t)t * B + b) * 4 * H + j;
        dg_t[0] = dgi;
        dg_t[H] = dgf;
        dg_t[2 * H] = dgo;
        dg_t[3 * H] = dgz;
        if (t == 0) continue;  // dh0 is formed outside, as in _fused_bwd
        float* gp_r = gp + cr[m] * GPS + (j - j0);
        gp_r[0] = round_to(dgi, R);
        gp_r[UL] = round_to(dgf, R);
        gp_r[2 * UL] = round_to(dgo, R);
        gp_r[3 * UL] = round_to(dgz, R);
        // the next step's inputs: their loads overlap the product
        load_step(t - 1, m, in[m][6]);
      }
      if (t == 0) break;
      __syncthreads();

      // ---- this CTA's part of the next carry, for every k < H and its
      // RB rows, to its slot in L2
      float* dst = mine + par * par_stride;
      if constexpr (kMma) {
        // P [RB, HP] = gp [RB, NCOL] R[:, its columns]^T on the tensor
        // cores: A (the operands, exact in bf16) loaded once; warp w takes
        // the n-tiles of 8 k w, w + 8, ...; B from the resident rows of R
        // by ldmatrix (each row's NCOL columns are a k-run of the product)
        constexpr int MT = (RB + 15) / 16;
        constexpr int KS = NCOL / 16;           // k-steps of 16
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int fg = lane / 4, ft = lane % 4;
        uint32_t a[MT][KS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
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
          for (int q = 0; q < NCOL / 32; ++q) {  // columns [32 q, 32 q + 32)
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
          for (int g = 0; g < 4; ++g) {
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

#pragma unroll
    for (int m = 0; m < NC; ++m)
      if (live[m]) dc0[(size_t)(b0 + cr[m]) * H + cj[m]] = dc[m];
    // the group's slots are reused by the next pass: every CTA has read
    // this pass's last parts first
    if (b0 + groups * RB < B) grid_sync(count, ++arrivals * (unsigned)n);
  }
}

// ------------------------------------------------------------------ choice

// What the launcher runs for a [T, B, *, H] call: the cluster design (C
// CTAs a cluster, RB rows a cluster), the grid design (U units a CTA, n
// CTAs and RB rows a row group, the groups launched together) or the
// stream design (RB rows a block, slices of the 4H reduction), and the
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
          return bwd_cluster_smem_bytes<E, 4>(rb, H, C);
        },
        [&](int rb, int C, size_t smem, int* n) {
          return by_rows(rb, [&](auto r) {
            return active_clusters(
                lstm_bwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);
          });
        },
        &cp);
    if (err != cudaSuccess) return err;
    if (cp.C > 0) {
      *plan = {kCluster, cp.C, cp.rb, 0, cp.smem};
      return cudaSuccess;
    }
    GridPlan gp;
    err = plan_grid(
        B, H, sizeof(E),
        [&](int rb) {
          return bwd_grid_smem_bytes(rb, H, 4, sizeof(E), kLstmGridSlots);
        },
        [&](int rb, size_t smem, int* n) {
          return by_grid_rows(rb, [&](auto r) {
            return grid_resident(lstm_bwd_grid_kernel<E, decltype(r)::value>,
                                 smem, n);
          });
        },
        &gp, kLstmGridSlots);
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
  // more slices of the 4H reduction while warps would idle, each >= 16 long
  int slices = 1;
  while (slices < kMaxSlices && tiles * slices < kWarps &&
         4 * H >= 16 * slices * 2 &&
         smem_bytes(rb, H, slices * 2) <= kSmemCap)
    slices *= 2;
  *plan = {kStream, 0, rb, slices, smem_bytes(rb, H, slices)};
  return cudaSuccess;
}

// R [H, 4H] is read by the cluster and grid designs, Rt = R^T [4H, H] by
// the stream design; the other may be null. `work` (`work_bytes` long) is
// the grid design's workspace (bwd_grid_workspace_bytes); the other
// designs take none.
template <typename E>
int lstm_bwd(const float* reserve, const E* R, const E* Rt, const E* c0,
             const E* dout, const E* dcT, const E* peep, float* dg,
             float* dc0, void* work, long long work_bytes, int T, int B,
             int H, void* stream) {
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
      auto kernel = lstm_bwd_grid_kernel<E, decltype(r)::value>;
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg;
      cudaError_t e = grid_config(kernel, p.groups * p.n, p.smem, s, &attr,
                                  &cfg);
      if (e != cudaSuccess) return e;
      return cudaLaunchKernelEx(&cfg, kernel, reserve, R, c0, dout, dcT, peep,
                                dg, dc0, bar, slots, T, B, H, p.U, p.n,
                                p.groups);
    });
  }
  return (int)by_rows(p.rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    if (p.kind == kStream)
      return launch<E, RB>(reserve, Rt, c0, dout, dcT, peep, dg, dc0, T, B,
                           H, p.slices, s);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    auto kernel = lstm_bwd_cluster_kernel<E, RB>;
    cudaError_t e = cluster_config(kernel, p.C, (B + RB - 1) / RB, p.smem,
                                   p.smem, s, &attr, &cfg);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, reserve, R, c0, dout, dcT, peep,
                              dg, dc0, T, B, H, cluster_units(H, p.C));
  });
}

}  // namespace

extern "C" {

// Launch the reverse walk on `stream`; each returns a cudaError_t (0 =
// launched). `reserve`, `dg` and `dc0` are float32; `work` is the grid
// design's workspace of `work_bytes` (null for the other designs); every
// other pointer is of the function's one element type; `dcT` and `peep`
// may be null. The cluster and grid designs read R, the stream design Rt =
// R^T (dl4j_lstm_bwd_plan says which); the other may be null.
int dl4j_lstm_bwd(const float* reserve, const float* R, const float* Rt,
                  const float* c0, const float* dout, const float* dcT,
                  const float* peep, float* dg, float* dc0, void* work,
                  long long work_bytes, int T, int B, int H, void* stream) {
  return lstm_bwd<float>(reserve, R, Rt, c0, dout, dcT, peep, dg, dc0, work,
                         work_bytes, T, B, H, stream);
}

int dl4j_lstm_bwd_bf16(const float* reserve, const __nv_bfloat16* R,
                       const __nv_bfloat16* Rt, const __nv_bfloat16* c0,
                       const __nv_bfloat16* dout, const __nv_bfloat16* dcT,
                       const __nv_bfloat16* peep, float* dg, float* dc0,
                       void* work, long long work_bytes, int T, int B, int H,
                       void* stream) {
  return lstm_bwd<__nv_bfloat16>(reserve, R, Rt, c0, dout, dcT, peep, dg,
                                 dc0, work, work_bytes, T, B, H, stream);
}

// The launcher's choice for a [T, B, *, H] call of the element type (bf16
// nonzero: bfloat16, else float32) on the current device: out = {0 for the
// stream design, 1 for the cluster design, 2 for the grid design, C (0
// unless cluster), RB, dynamic shared memory bytes, U, n, groups and the
// workspace bytes a call must pass (0 unless grid)}. Returns a
// cudaError_t.
int dl4j_lstm_bwd_plan(int T, int B, int H, int bf16, long long* out) {
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
int dl4j_lstm_bwd_grid_resident(int bf16, int rb, int smem, int* n) {
  return (int)by_grid_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? grid_resident(lstm_bwd_grid_kernel<__nv_bfloat16, RB>,
                                (size_t)smem, n)
                : grid_resident(lstm_bwd_grid_kernel<float, RB>,
                                (size_t)smem, n);
  });
}

// cudaOccupancyMaxActiveClusters of the cluster kernel (RB rows) for
// clusters of C CTAs with `smem` bytes each, into *n.
int dl4j_lstm_bwd_active_clusters(int bf16, int rb, int C, int smem, int* n) {
  return (int)by_rows(rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    return bf16 ? active_clusters(lstm_bwd_cluster_kernel<__nv_bfloat16, RB>,
                                  C, smem, n)
                : active_clusters(lstm_bwd_cluster_kernel<float, RB>, C,
                                  smem, n);
  });
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
