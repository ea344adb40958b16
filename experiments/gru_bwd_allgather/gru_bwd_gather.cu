// The GRU backward's grid design with the other exchange: an all-gather
// of the product operands, against the reduce-scatter of partial carries
// that gru_bwd_grid_kernel (deeplearning4j_tpu_torch/csrc/fused_gru_bwd.cu)
// runs. Not part of the port: ab.py, beside this file, builds it and times
// it against the port's kernel on the same inputs.
//
// The step is the port's (fused_gru_bwd.cu's header): with `carry` the
// gradient reaching h_t from step t+1,
//
//   dh   = dout[t] + carry
//   ga_n = dh * (1 - z) * (1 - n^2)
//   ga_z = dh * (h_{t-1} - n) * z * (1 - z)
//   ga_r = ga_n * hg_n * r * (1 - r)
//   carry = z * dh + [ga_r, ga_z, r * ga_n] @ R^T
//
// CTA c of a row group of n owns U hidden units [c U, c U + U), as in the
// port's grid design, but keeps the *rows* of R for them (R[j, 0:3H], the
// same bytes as the port's column slice) in shared memory for all T
// steps. Each step, the thread of (row, unit) forms the gate gradients of
// its cell and writes the product operands [ga_r, ga_z, r * ga_n] (rounded
// to R's type) to a global buffer op [2][B][3 HP] by step parity; one
// barrier over the row group; then every CTA reads the group's whole
// operand [RB, 3 HP] back from L2 (cp.async.cg, in k-tiles through shared
// memory) and forms the carry parts of its own units, sum over all 3H
// columns of op[b, .] R[j, .]: no partial sums cross CTAs. A CTA reads 3
// RB x H operands a step (in R's type) and writes RB x 3U; the port's
// kernel writes RB x H f32 partial carries and reads as many.
//
// The product splits the 3H columns over the CTA's 8 warps; each warp
// forms every cell of the CTA over its columns (f32: a lane 4 rows x 4
// units on the CUDA cores, float4 loads along k; bf16: mma.sync m16n8k16,
// R's rows by ldmatrix), and each cell's owner adds the 8 warps' parts in
// warp order (the same order every run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../deeplearning4j_tpu_torch/csrc/recurrent_cluster.cuh"
#include "../../deeplearning4j_tpu_torch/csrc/recurrent_grid.cuh"

namespace {

constexpr int kStageBytes = 16384;  // operand bytes of one stage
constexpr int kPadBytes = 16;       // after a staged row and a resident row

// Elements of a resident row of R: 3 HP and 16 bytes of padding (rows
// 4 words apart mod 32 banks: f32 float4 loads of 4 rows, bf16 ldmatrix
// of 8 rows, each on its own banks).
template <typename E>
__host__ __device__ int gather_row(int HP) {
  return 3 * HP + kPadBytes / (int)sizeof(E);
}

// Shared memory of a CTA: its U rows of R, two operand stages.
template <typename E>
size_t gather_smem_bytes(int H) {
  return (size_t)grid_units(sizeof(E)) * gather_row<E>(grid_hp(H)) *
             sizeof(E) +
         2 * (size_t)(kStageBytes + 32 * kPadBytes);
}

// The workspace: the barrier counters, then op [2][B][3 HP] of E.
template <typename E>
size_t gather_workspace_bytes(int groups, int B, int H) {
  return grid_bar_bytes(groups) +
         2 * sizeof(E) * (size_t)B * 3 * grid_hp(H);
}

template <typename E, int RB>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_bwd_gather_kernel(const float* __restrict__ reserve,  // [4, T, B, H]
                      const E* __restrict__ R,            // [H, 3H]
                      const E* __restrict__ h0,           // [B, H]
                      const E* __restrict__ out,          // [T, B, H]
                      const E* __restrict__ dout,         // [T, B, H]
                      float* __restrict__ dg,             // [T, B, 3H]
                      float* __restrict__ dh0,            // [B, H]
                      unsigned* __restrict__ bar,  // [groups][32], zeroed
                      E* __restrict__ op,          // [2][B][3 HP]
                      int T, int B, int H, int U, int n, int groups) {
  constexpr bool kMma = sizeof(E) == 2;
  constexpr int UL = grid_units(sizeof(E));       // units a CTA at most
  constexpr int KT = kStageBytes / (int)sizeof(E) / RB;  // k a stage
  constexpr int KS = KT + kPadBytes / (int)sizeof(E);    // a staged row
  constexpr int VE = 16 / (int)sizeof(E);         // elements a 16-byte copy
  constexpr int NC = (RB * UL + kGridThreads - 1) / kGridThreads;  // cells
  constexpr int RPL = RB / 8;                     // f32: rows a lane
  constexpr int MT = (RB + 15) / 16;              // bf16: m-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = grid_hp(H), K = 3 * HP;
  const int Row = gather_row<E>(HP);
  E* Rs = reinterpret_cast<E*>(smem_raw);
  E* hs = reinterpret_cast<E*>(smem_raw + (size_t)UL * Row * sizeof(E));
  constexpr int kStageElems = (kStageBytes + 32 * kPadBytes) / (int)sizeof(E);

  const int c = blockIdx.x % n, grp = blockIdx.x / n;
  const int j0 = c * U;
  const int nu = max(0, min(U, H - j0));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rq = lane / 4, uq = lane % 4;         // f32: rows rq + 8 i,
                                                  // units uq + 4 j
  const int fg = lane / 4, ft = lane % 4;         // bf16: mma fragments
  const size_t plane = (size_t)T * B * H;
  const size_t BH = (size_t)B * H;
  const size_t par_stride = (size_t)B * K;
  unsigned* count = bar + grp * kGridBarWords;
  unsigned arrivals = 0;

  // Rs[u * Row + g HP + k] = R[j0 + u][g H + k] for u < nu, k < H; else 0
  // (the padding too: the bf16 product's last k-step may reach into it)
  for (int idx = threadIdx.x; idx < UL * Row; idx += kGridThreads) {
    const int u = idx / Row, col = idx % Row;
    const int g = col / HP, k = col % HP;
    const bool in = u < nu && col < K && k < H;
    E* dst = Rs + (size_t)u * Row + col;
    if constexpr (sizeof(E) == 4) {
      cp_async4(dst, R + (in ? (size_t)(j0 + u) * 3 * H + g * H + k : 0),
                in ? 4 : 0);
    } else {
      *dst = in ? R[(size_t)(j0 + u) * 3 * H + g * H + k] : from_f32<E>(0.0f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int b0 = grp * RB; b0 < B; b0 += groups * RB) {
    int cr[NC], cu[NC];
    bool live[NC];
    float in[NC][6], zdh[NC];  // r z n hg_n dout h_prev
    auto load_step = [&](int t, int m) {
      const size_t at = ((size_t)t * B + b0 + cr[m]) * H + j0 + cu[m];
      in[m][0] = reserve[at];
      in[m][1] = reserve[plane + at];
      in[m][2] = reserve[2 * plane + at];
      in[m][3] = reserve[3 * plane + at];
      in[m][4] = to_f32(dout[at]);
      in[m][5] = t > 0 ? to_f32(out[at - BH])
                       : to_f32(h0[(size_t)(b0 + cr[m]) * H + j0 + cu[m]]);
    };
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int idx = threadIdx.x + m * kGridThreads;
      cr[m] = idx / UL;
      cu[m] = idx % UL;
      live[m] = idx < RB * UL && b0 + cr[m] < B && cu[m] < nu;
      zdh[m] = 0.0f;
      if (live[m]) load_step(T - 1, m);
    }

    // The carry parts of this CTA's cells from the group's operands `src`
    // [B][3 HP]: sum over all 3 HP columns of op[b, .] Rs[u, .].
    auto product = [&](const E* src, float (&part)[NC]) {
      auto stage = [&](int tile) {
        E* dst = hs + (tile & 1) * kStageElems;
        const int k0 = tile * KT;
        for (int idx = threadIdx.x; idx < RB * KT / VE;
             idx += kGridThreads) {
          const int r = idx / (KT / VE), k = k0 + VE * (idx % (KT / VE));
          const int b = b0 + r, col = k % HP;
          const int bytes = b < B && k < K && col < H
                                ? (int)sizeof(E) * min(VE, H - col)
                                : 0;
          grid_stage16(dst + r * KS + (k - k0),
                       src + (bytes ? (size_t)b * K + k : 0), bytes);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      float acc[kMma ? MT : RPL][4][kMma ? 4 : 4];
#pragma unroll
      for (int i = 0; i < (kMma ? MT : RPL); ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
      const int tiles = (K + KT - 1) / KT;
      stage(0);
      for (int tile = 0; tile < tiles; ++tile) {
        if (tile + 1 < tiles) {
          stage(tile + 1);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const E* hb = hs + (tile & 1) * kStageElems;
        const int k0 = tile * KT, len = min(KT, K - k0);
        if constexpr (kMma) {
          // warp w: k-steps 32 w, 32 w + 16 of each 256 columns; the four
          // n-tiles of 8 units
          for (int kk = 32 * warp; kk < len; kk += 32 * kGridWarps) {
            uint32_t bq[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              ldmatrix_x4(bq[nt], Rs + (size_t)(nt * 8 + (lane & 7)) * Row +
                                      k0 + kk + 8 * (lane >> 3));
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const E* ap = hb + (mt * 16 + fg) * KS + kk + 16 * ks + 2 * ft;
                uint32_t a[4];
                a[0] = *reinterpret_cast<const uint32_t*>(ap);
                a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
                if (mt * 16 + 8 < RB) {
                  a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * KS);
                  a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * KS + 8);
                } else {
                  a[1] = a[3] = 0u;
                }
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                  mma_bf16_16816(acc[mt][nt], a, bq[nt] + 2 * ks);
              }
          }
        } else {
          // warp w: chunks of 4 columns 4 w, 4 w + 32, ...; lane (rq, uq):
          // rows rq + 8 i, units uq + 4 j
          const float* hf = reinterpret_cast<const float*>(hb);
          const float* rf = reinterpret_cast<const float*>(Rs);
#pragma unroll 2
          for (int kk = 4 * warp; kk < len; kk += 4 * kGridWarps) {
            float4 w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              w[j] = *reinterpret_cast<const float4*>(
                  rf + (size_t)(uq + 4 * j) * Row + k0 + kk);
#pragma unroll
            for (int i = 0; i < RPL; ++i) {
              const float4 o =
                  *reinterpret_cast<const float4*>(hf + (rq + 8 * i) * KS + kk);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float s = acc[i][j][0];
                s = fmaf(o.x, w[j].x, s);
                s = fmaf(o.y, w[j].y, s);
                s = fmaf(o.z, w[j].z, s);
                s = fmaf(o.w, w[j].w, s);
                acc[i][j][0] = s;
              }
            }
          }
        }
        __syncthreads();  // this stage buffer is free for tile + 2
      }
      // each warp's parts [RB][UL] through the idle stages; each cell's
      // owner adds them in warp order
      float* xch = reinterpret_cast<float*>(hs);
      if constexpr (kMma) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int r = mt * 16 + fg, u = nt * 8 + 2 * ft;
            if (r < RB) {
              xch[(warp * RB + r) * UL + u] = acc[mt][nt][0];
              xch[(warp * RB + r) * UL + u + 1] = acc[mt][nt][1];
            }
            if (r + 8 < RB) {
              xch[(warp * RB + r + 8) * UL + u] = acc[mt][nt][2];
              xch[(warp * RB + r + 8) * UL + u + 1] = acc[mt][nt][3];
            }
          }
      } else {
#pragma unroll
        for (int i = 0; i < RPL; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xch[(warp * RB + rq + 8 * i) * UL + uq + 4 * j] = acc[i][j][0];
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        float s = 0.0f;
        if (live[m])
#pragma unroll
          for (int w2 = 0; w2 < kGridWarps; ++w2)
            s += xch[(w2 * RB + cr[m]) * UL + cu[m]];
        part[m] = s;
      }
      // (the next barrier's __syncthreads frees the stages)
    };

    for (int t = T - 1; t >= 0; --t) {
      float part[NC];
#pragma unroll
      for (int m = 0; m < NC; ++m) part[m] = 0.0f;
      if (t < T - 1) {
        // every CTA of the group has written step t + 1's operands
        grid_sync(count, ++arrivals * (unsigned)n);
        product(op + (size_t)((t + 1) & 1) * par_stride, part);
      }
      E* dst = op + (size_t)(t & 1) * par_stride;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        if (!live[m]) continue;
        const float carry = t < T - 1 ? part[m] + zdh[m] : 0.0f;
        const float rg = in[m][0], zg = in[m][1], ng = in[m][2];
        const float dh = in[m][4] + carry;
        const float ga_n = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float ga_z = dh * (in[m][5] - ng) * zg * (1.0f - zg);
        const float ga_r = ga_n * in[m][3] * rg * (1.0f - rg);
        const int b = b0 + cr[m], j = j0 + cu[m];
        float* dg_t = dg + ((size_t)t * B + b) * 3 * H + j;
        dg_t[0] = ga_r;
        dg_t[H] = ga_z;
        dg_t[2 * H] = ga_n;
        E* o = dst + (size_t)b * K + j;
        o[0] = from_f32<E>(ga_r);
        o[HP] = from_f32<E>(ga_z);
        o[2 * HP] = from_f32<E>(rg * ga_n);
        zdh[m] = zg * dh;
        if (t > 0) load_step(t - 1, m);
      }
    }
    // the carry after step 0 is dh0
    grid_sync(count, ++arrivals * (unsigned)n);
    float part[NC];
    product(op, part);
#pragma unroll
    for (int m = 0; m < NC; ++m)
      if (live[m])
        dh0[(size_t)(b0 + cr[m]) * H + j0 + cu[m]] = part[m] + zdh[m];
    // the next pass stages into the buffers this pass's sums were read
    // from
    __syncthreads();
  }
}

template <typename E>
cudaError_t plan(int B, int H, GridPlan* p) {
  return plan_grid(
      B, H, sizeof(E), [&](int) { return gather_smem_bytes<E>(H); },
      [&](int rb, size_t smem, int* n) {
        return by_grid_rows(rb, [&](auto r) {
          return grid_resident(gru_bwd_gather_kernel<E, decltype(r)::value>,
                               smem, n);
        });
      },
      p);
}

template <typename E>
int run(const float* reserve, const E* R, const E* h0, const E* out,
        const E* dout, float* dg, float* dh0, void* work,
        long long work_bytes, int T, int B, int H, void* stream) {
  if (T < 2 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  GridPlan p;
  cudaError_t err = plan<E>(B, H, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.U == 0 || work == nullptr ||
      work_bytes < (long long)gather_workspace_bytes<E>(p.groups, B, H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* bar = static_cast<unsigned*>(work);
  E* op = reinterpret_cast<E*>(static_cast<char*>(work) +
                               grid_bar_bytes(p.groups));
  err = cudaMemsetAsync(bar, 0, grid_bar_bytes(p.groups), s);
  if (err != cudaSuccess) return (int)err;
  return (int)by_grid_rows(p.rb, [&](auto r) {
    auto kernel = gru_bwd_gather_kernel<E, decltype(r)::value>;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = grid_config(kernel, p.groups * p.n, p.smem, s, &attr,
                                &cfg);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, reserve, R, h0, out, dout, dg,
                              dh0, bar, op, T, B, H, p.U, p.n, p.groups);
  });
}

}  // namespace

extern "C" {

// The reverse walk on `stream` (T > 1, where the card holds a row group):
// every pointer but reserve, dg and dh0 (f32) of bf16 if `bf16`, else
// f32. Returns a cudaError_t.
int ab_gru_bwd_gather(const float* reserve, const void* R, const void* h0,
                      const void* out, const void* dout, float* dg,
                      float* dh0, void* work, long long work_bytes, int T,
                      int B, int H, int bf16, void* stream) {
  using BF = __nv_bfloat16;
  if (bf16)
    return run<BF>(reserve, static_cast<const BF*>(R),
                   static_cast<const BF*>(h0), static_cast<const BF*>(out),
                   static_cast<const BF*>(dout), dg, dh0, work, work_bytes,
                   T, B, H, stream);
  return run<float>(reserve, static_cast<const float*>(R),
                    static_cast<const float*>(h0),
                    static_cast<const float*>(out),
                    static_cast<const float*>(dout), dg, dh0, work,
                    work_bytes, T, B, H, stream);
}

// The plan of a [*, B, *, H] call: out = {U, n, RB, groups, shared memory
// bytes, workspace bytes}; U = 0 where the card holds no row group.
int ab_gru_bwd_gather_plan(int B, int H, int bf16, long long* out) {
  GridPlan p;
  cudaError_t err = bf16 ? plan<__nv_bfloat16>(B, H, &p)
                         : plan<float>(B, H, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.U;
  out[1] = p.n;
  out[2] = p.rb;
  out[3] = p.groups;
  out[4] = (long long)p.smem;
  out[5] = p.U == 0 ? 0
           : bf16   ? (long long)gather_workspace_bytes<__nv_bfloat16>(
                        p.groups, B, H)
                    : (long long)gather_workspace_bytes<float>(p.groups, B,
                                                               H);
  return 0;
}

const char* ab_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
