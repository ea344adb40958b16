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
// Two designs; the launcher (gru_bwd) chooses by shape and by what the
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
//   lanes of a warp, reading one k each, hit 32 banks.
// - Stream (gru_bwd_kernel), for T == 1 and any shape whose R does not fit
//   in a cluster (H=1024), PR 5's design (it mirrors fused_lstm_bwd.cu):
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
// Later work: wgmma for the bf16 step product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "recurrent_cluster.cuh"

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                  // hidden units per work item
constexpr int kMaxSlices = 16;             // slices of the 3H reduction
constexpr size_t kSmemCap = 200 * 1024;    // of the 227 KB a block may use

// a float rounded to the element type and back: what enters the product
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// ------------------------------------------------------------ cluster design

// Elements a row of the resident R: the 3 gate columns of kClusterUnits
// units and one 4-byte word of padding (an odd row length in words), so
// that lanes reading one row each hit distinct banks.
template <typename E>
__host__ __device__ constexpr int bwd_row() {
  return 3 * kClusterUnits + 4 / (int)sizeof(E);
}

// Shared memory of a backward cluster CTA (bytes), with HP = H rounded up
// to 4:
//   Rs    [HP][bwd_row] E          its gate columns of R, resident
//   gp    [RB][3][32] f32          this step's [ga_r ga_z r*ga_n] of its
//                                  units, rounded to E
//   slots [2][C][RB][32] f32       the partial carries the cluster's CTAs
//                                  send it, by step parity
template <typename E>
size_t bwd_cluster_smem_bytes(int rb, int H, int C) {
  const size_t hp = (size_t)((H + 3) & ~3);
  return hp * bwd_row<E>() * sizeof(E) +
         sizeof(float) * ((size_t)rb * 3 * 32 + 2 * (size_t)C * rb * 32);
}

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
  constexpr int kRow = bwd_row<E>();
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
  // the units of a CTA, a multiple of 4: the product's reduction length
  const int U4 = (U + 3) & ~3;
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
      float carry = 0.0f;
      if (t < T - 1) {
        const float* s = slots + (size_t)(par ^ 1) * C * RB * kU + gr * kU + lane;
        for (int q = 0; q < C; ++q) carry += s[(size_t)q * RB * kU];
        carry += zdh;
      }
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
    for (int k = threadIdx.x; k < H; k += kClusterThreads) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      const E* rk = Rs + (size_t)k * kRow;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        for (int u = 0; u < U4; u += 4) {
          const float w0 = to_f32(rk[g * kU + u]);
          const float w1 = to_f32(rk[g * kU + u + 1]);
          const float w2 = to_f32(rk[g * kU + u + 2]);
          const float w3 = to_f32(rk[g * kU + u + 3]);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float4 p = *reinterpret_cast<const float4*>(
                gp + (r * 3 + g) * kU + u);
            acc[r] = fmaf(p.x, w0, acc[r]);
            acc[r] = fmaf(p.y, w1, acc[r]);
            acc[r] = fmaf(p.z, w2, acc[r]);
            acc[r] = fmaf(p.w, w3, acc[r]);
          }
        }
      }
      const int q = k / U;
      float* dst = cluster.map_shared_rank(
          slots + ((size_t)(par * C + rank) * RB) * kU + (k - q * U), q);
#pragma unroll
      for (int r = 0; r < RB; ++r) dst[r * kU] = acc[r];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) in[i] = nxt[i];
    // every part has reached its owner, and this step's gp is free
    cluster.sync();
  }

  // the carry after step 0 is dh0
  if (live) {
    const float* s = slots + gr * kU + lane;  // step 0's parity is 0
    float carry = 0.0f;
    for (int q = 0; q < C; ++q) carry += s[(size_t)q * RB * kU];
    dh0[(size_t)b * H + j] = carry + zdh;
  }
}

// ------------------------------------------------------------------ choice

// What the launcher runs for a [T, B, *, H] call: the cluster design (C
// CTAs a cluster, RB rows a cluster) or the stream design (RB rows a
// block, slices of the 3H reduction), and the dynamic shared memory of a
// block.
struct Plan {
  int cluster, C, rb, slices;
  size_t smem;
};

template <typename E>
cudaError_t plan_bwd(int T, int B, int H, Plan* plan) {
  if (T > 1) {
    ClusterPlan cp;
    cudaError_t err = plan_cluster(
        B, H,
        [&](int rb, int C) {
          return bwd_cluster_smem_bytes<E>(rb, H, C);
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

// R [H, 3H] is read by the cluster design, Rt = R^T [3H, H] by the stream
// design; the other may be null.
template <typename E>
int gru_bwd(const float* reserve, const E* R, const E* Rt, const E* h0,
            const E* out, const E* dout, float* dg, float* dh0, int T, int B,
            int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_bwd<E>(T, B, H, &p);
  if (err != cudaSuccess) return (int)err;
  if ((p.cluster ? R : Rt) == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_rows(p.rb, [&](auto r) {
    constexpr int RB = decltype(r)::value;
    if (!p.cluster)
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
// launched). `reserve`, `dg` and `dh0` are float32; every other pointer is
// of the function's one element type. The cluster design reads R, the
// stream design Rt = R^T (dl4j_gru_bwd_plan says which); the other may be
// null.
int dl4j_gru_bwd(const float* reserve, const float* R, const float* Rt,
                 const float* h0, const float* out, const float* dout,
                 float* dg, float* dh0, int T, int B, int H, void* stream) {
  return gru_bwd<float>(reserve, R, Rt, h0, out, dout, dg, dh0, T, B, H,
                        stream);
}

int dl4j_gru_bwd_bf16(const float* reserve, const __nv_bfloat16* R,
                      const __nv_bfloat16* Rt, const __nv_bfloat16* h0,
                      const __nv_bfloat16* out, const __nv_bfloat16* dout,
                      float* dg, float* dh0, int T, int B, int H,
                      void* stream) {
  return gru_bwd<__nv_bfloat16>(reserve, R, Rt, h0, out, dout, dg, dh0, T,
                                B, H, stream);
}

// The launcher's choice for a [T, B, *, H] call of the element type (bf16
// nonzero: bfloat16, else float32) on the current device: out = {1 for the
// cluster design or 0 for the stream design, C (0 for stream), RB, dynamic
// shared memory bytes}. Returns a cudaError_t.
int dl4j_gru_bwd_plan(int T, int B, int H, int bf16, int* out) {
  Plan plan;
  cudaError_t err = bf16 ? plan_bwd<__nv_bfloat16>(T, B, H, &plan)
                         : plan_bwd<float>(T, B, H, &plan);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.cluster;
  out[1] = plan.C;
  out[2] = plan.rb;
  out[3] = (int)plan.smem;
  return 0;
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
