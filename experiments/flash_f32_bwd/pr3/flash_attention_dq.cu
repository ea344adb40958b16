// Flash-attention backward, dq, for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/flash_attention.py::_flash_dq_kernel
// (launched by _flash_backward through pl.pallas_call). For one (batch*head,
// 64-row query tile) a block streams the key/value tiles and recomputes each
// 64 x 64 probability tile from the forward's row logsumexp instead of
// reading a saved softmax:
//
//   p  = exp(scale * q k^T - lse)      (0 where the key is masked; lse =
//                                       +inf on a row that saw no key)
//   dp = do v^T
//   ds = p * (dp - delta)              delta = rowsum(do * o), given
//   dq = scale * sum over key tiles of ds k
//
// Masking is the forward's (flash_attention_fwd.cu): keys past Tk, key
// padding kmask[b, k] <= 0 (b = bh / N), and, when causal, keys after the
// query; key tiles past a causal query tile's last row are not visited.
// lse and delta come in as inputs, so a caller may pass a global lse (ring
// attention's block merge).
//
// Types: q, k, v and do all float32 (dl4j_flash_dq) or all bfloat16
// (dl4j_flash_dq_bf16); lse, delta, kmask and dq are float32. As in the
// Pallas kernel, the products sum in f32 over the input type's values and
// ds is rounded to k's type before ds k.
//
// What bounds it on this card: at BERT-base's [32, 12, 128, 64] it reads
// q, k, v, do (25.2 MB in bf16) and writes dq in f32 (12.6 MB), about 11 us
// at 3.35 TB/s, for 2.4 GFLOP of products (2.4 us at the bf16 tensor-core
// peak, 36 us at the f32 peak off the tensor cores).
//
// Two designs, one per type:
//
// - bf16 (flash_dq_wgmma_kernel): the forward's design on the same
//   tensor-core tile layer (flash_common.cuh). One warpgroup per 64-row
//   query tile keeps q and do in shared memory and streams key/value tiles
//   through a two-stage cp.async ring. s = q k^T and dp = do v^T are two
//   wgmma chains from shared memory; p = exp(s scale - lse) (in base 2,
//   one ex2.approx, as in the forward) and ds = p (dp - delta) stay in
//   the accumulators' registers; ds, packed to bf16 in place, is the
//   register A operand of dq += ds k (k read transposed from the same tile
//   that served q k^T). dq stays in f32 registers across the key tiles and
//   is stored once, times the scale.
// - f32 (flash_dq_kernel): the tensor cores cannot take f32 at f32
//   precision (TF32 is off for every parity comparison), so the products
//   stay on the CUDA cores from shared memory, and the operations bound
//   it: one block of 256 threads per (batch*head, query tile), 4 x 4
//   scores a thread, ds through a shared tile, dq accumulated in registers
//   across the key tiles.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename E, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const E* __restrict__ q,          // [BN, Tq, D]
                const E* __restrict__ k,          // [BN, Tk, D]
                const E* __restrict__ v,          // [BN, Tk, D]
                const E* __restrict__ dout,       // [BN, Tq, D]
                const float* __restrict__ lse,    // [BN, Tq]
                const float* __restrict__ delta,  // [BN, Tq]
                const float* __restrict__ kmask,  // [B, Tk] or null
                float* __restrict__ dq,           // [BN, Tq, D]
                int N, int Tq, int Tk, int D, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NC = DMAX / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [64][LD]
  float* dos = qs + kTile * LD;   // [64][LD]
  float* ks = dos + kTile * LD;   // [64][LD]
  float* vs = ks + kTile * LD;    // [64][LD]
  float* dss = vs + kTile * LD;   // [64][kPLd], ds rounded to E

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const E* kb = k + (size_t)bh * Tk * D;
  const E* vb = v + (size_t)bh * Tk * D;
  const float* km = kmask ? kmask + (size_t)(bh / N) * Tk : nullptr;

  load_tile<E, LD>(qs, q + (size_t)bh * Tq * D, q0, Tq, D);
  load_tile<E, LD>(dos, dout + (size_t)bh * Tq * D, q0, Tq, D);

  float row_lse[kPer], row_delta[kPer], acc[kPer][NC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qpos = q0 + ty + 16 * i;
    row_lse[i] = qpos < Tq ? lse[(size_t)bh * Tq + qpos] : INFINITY;
    row_delta[i] = qpos < Tq ? delta[(size_t)bh * Tq + qpos] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<E, LD>(ks, kb, k0, Tk, D);
    load_tile<E, LD>(vs, vb, k0, Tk, D);
    __syncthreads();

    float s[kPer][kPer], dp[kPer][kPer];
    dot_tile<LD>(s, qs, ks, D, ty, tx);
    dot_tile<LD>(dp, dos, vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float ds = 0.0f;
        if (qpos < Tq && visible(qpos, kpos, Tk, km, causal)) {
          const float p = expf(s[i][j] * scale - row_lse[i]);
          ds = p * (dp[i][j] - row_delta[i]);
        }
        dss[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<E>(ds);
      }
    }
    __syncthreads();  // the ds tile is complete

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float d = dss[(ty + 16 * i) * kPLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(d, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
    float* row = dq + ((size_t)bh * Tq + qpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) row[col] = scale * acc[i][c];
    }
  }
}


template <int DMAX>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, const float* kmask, float* dq,
                       int BN, int N, int Tq, int Tk, int D, float scale,
                       int causal, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem = sizeof(float) * (4 * kTile * LD + kTile * kPLd);
  cudaError_t err = allow_smem(flash_dq_kernel<float, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tq + kTile - 1) / kTile);
  flash_dq_kernel<float, DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kmask, dq, N, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

template <int DMAX>
__global__ void __launch_bounds__(wg::kThreads)
flash_dq_wgmma_kernel(const bf16* __restrict__ q,         // [BN, Tq, D]
                      const bf16* __restrict__ k,         // [BN, Tk, D]
                      const bf16* __restrict__ v,         // [BN, Tk, D]
                      const bf16* __restrict__ dout,      // [BN, Tq, D]
                      const float* __restrict__ lse,      // [BN, Tq]
                      const float* __restrict__ delta,    // [BN, Tq]
                      const float* __restrict__ kmask,    // [B, Tk] or null
                      float* __restrict__ dq,             // [BN, Tq, D]
                      int N, int Tq, int Tk, int D, float scale, int causal,
                      int vec) {
  constexpr int kTileBytes = kTile * DMAX * 2;
  constexpr int NB = DMAX / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = wg::align_1k(smem_raw);
  uint8_t* dos = qs + kTileBytes;
  uint8_t* ks = dos + kTileBytes;     // 2 stages
  uint8_t* vs = ks + 2 * kTileBytes;  // 2 stages

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * w + (lane >> 2);  // rows row0 and row0 + 8
  const int col = 2 * (lane & 3);
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;
  const float* km = kmask ? kmask + (size_t)(bh / N) * Tk : nullptr;
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  wg::load_tile<DMAX>(qs, q + (size_t)bh * Tq * D, q0, Tq, D, vec);
  wg::load_tile<DMAX>(dos, dout + (size_t)bh * Tq * D, q0, Tq, D, vec);
  wg::load_tile<DMAX>(ks, kb, 0, Tk, D, vec);
  wg::load_tile<DMAX>(vs, vb, 0, Tk, D, vec);
  wg::cp_async_commit();

  // lse in base 2; a row past Tq gets +inf, so its p (and ds) is 0
  const float scale2 = scale * wg::kLog2e;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + row0 + 8 * h;
    row_lse[h] = qpos < Tq ? lse[(size_t)bh * Tq + qpos] * wg::kLog2e
                           : INFINITY;
    row_delta[h] = qpos < Tq ? delta[(size_t)bh * Tq + qpos] : 0.0f;
  }
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const uint8_t* kt = ks + st * kTileBytes;
    const uint8_t* vt = vs + st * kTileBytes;
    if (j + 1 < n_tiles) {
      wg::load_tile<DMAX>(ks + (st ^ 1) * kTileBytes, kb, (j + 1) * kTile, Tk,
                          D, vec);
      wg::load_tile<DMAX>(vs + (st ^ 1) * kTileBytes, vb, (j + 1) * kTile, Tk,
                          D, vec);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    wg::fence_to_async();
    __syncthreads();

    // s = q k^T and dp = do v^T, f32 sums
    float s[32], dp[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {  // padded columns are zero
      wg::mma_ss(s, wg::k_major(qs, kk), wg::k_major(kt, kk), kk > 0);
      wg::mma_ss(dp, wg::k_major(dos, kk), wg::k_major(vt, kk), kk > 0);
    }
    wg::commit();
    // while the products run: each of this thread's key columns as a bias
    // on the exponent, 0 or -inf where the key is padding or past Tk (the
    // forward's test)
    const int k0 = j * kTile;
    const bool padded = km != nullptr || k0 + kTile > Tk;
    float bias[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int kpos = k0 + 8 * (c >> 1) + col + (c & 1);
      bias[c] = !padded || (kpos < Tk && (km == nullptr || km[kpos] > 0.0f))
                    ? 0.0f
                    : -INFINITY;
    }
    const bool diagonal = causal && k0 + kTile - 1 > q0;
    wg::wait_all();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // ds = p (dp - delta), p = 2^(s scale log2(e) - lse log2(e) + bias),
    // so a masked key's p is 2^-inf = 0; in s
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (c >> 1) + 2 * h + (c & 1);
        float p = wg::fast_exp2(fmaf(s[i], scale2, -row_lse[h]) + bias[c]);
        if (diagonal && q0 + row0 + 8 * h < k0 + 8 * (c >> 1) + col + (c & 1))
          p = 0.0f;
        s[i] = p * (dp[i] - row_delta[h]);
      }
    }

    // dq += ds k: ds rounded to bf16 from registers, k read transposed
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(da[kk], s, kk);
    wg::fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs(acc[nb], da[kk], wg::mn_major(kt, kk, nb));
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wg::fence_regs(acc[nb]);
    __syncthreads();  // this stage is free for the tile after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = q0 + row0 + 8 * h;
    if (qpos >= Tq) continue;
    float* row = dq + ((size_t)bh * Tq + qpos) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // the pair at columns cc, cc + 1
        const int cc = 64 * nb + 8 * c + col;
        const float v0 = scale * acc[nb][4 * c + 2 * h];
        const float v1 = scale * acc[nb][4 * c + 2 * h + 1];
        if (cc + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<float2*>(row + cc) = make_float2(v0, v1);
        } else {
          if (cc < D) row[cc] = v0;
          if (cc + 1 < D) row[cc + 1] = v1;
        }
      }
  }
}

template <int DMAX>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse,
                        const float* delta, const float* kmask, float* dq,
                        int BN, int N, int Tq, int Tk, int D, float scale,
                        int causal, cudaStream_t stream) {
  // q, do, two key and two value stages, and 1 KB to align the first
  const size_t smem = 6 * kTile * DMAX * 2 + 1024;
  cudaError_t err = allow_smem(flash_dq_wgmma_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tq + kTile - 1) / kTile);
  const int vec = wg::vec_rows(D, {q, k, v, dout}) ? 1 : 0;
  flash_dq_wgmma_kernel<DMAX><<<grid, wg::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kmask, dq, N, Tq, Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

bool bad_shape(int BN, int N, int Tq, int Tk, int D) {
  return BN <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
         (Tq + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// Launch dq on `stream`; each returns a cudaError_t (0 = launched). q, k, v
// and dout are [BN, T, D] row-major of the function's element type; lse and
// delta [BN, Tq], kmask [BN / N, Tk] or null, dq [BN, Tq, D], all float32.
int dl4j_flash_dq(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  const float* kmask, float* dq, int BN, int N, int Tq,
                  int Tk, int D, float scale, int causal, void* stream) {
  if (bad_shape(BN, N, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_f32<64>(q, k, v, dout, lse, delta, kmask, dq,
                                        BN, N, Tq, Tk, D, scale, causal, s)
                       : launch_f32<128>(q, k, v, dout, lse, delta, kmask,
                                         dq, BN, N, Tq, Tk, D, scale, causal,
                                         s));
}

int dl4j_flash_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* dout,
                       const float* lse, const float* delta,
                       const float* kmask, float* dq, int BN, int N, int Tq,
                       int Tk, int D, float scale, int causal, void* stream) {
  if (bad_shape(BN, N, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_bf16<64>(q, k, v, dout, lse, delta, kmask,
                                         dq, BN, N, Tq, Tk, D, scale, causal,
                                         s)
                       : launch_bf16<128>(q, k, v, dout, lse, delta, kmask,
                                          dq, BN, N, Tq, Tk, D, scale,
                                          causal, s));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
