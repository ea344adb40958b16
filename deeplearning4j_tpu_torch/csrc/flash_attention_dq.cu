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
// peak). Like the forward it does the products on the CUDA cores in f32
// from shared memory, so the operations bound it. Same simple design: one
// block per (batch*head, query tile), 4 x 4 scores a thread, dq accumulated
// in registers across the key tiles.

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

template <typename E, int DMAX>
cudaError_t launch(const E* q, const E* k, const E* v, const E* dout,
                   const float* lse, const float* delta, const float* kmask,
                   float* dq, int BN, int N, int Tq, int Tk, int D,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem = sizeof(float) * (4 * kTile * LD + kTile * kPLd);
  cudaError_t err = allow_smem(flash_dq_kernel<E, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tq + kTile - 1) / kTile);
  flash_dq_kernel<E, DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kmask, dq, N, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename E>
int flash_dq(const E* q, const E* k, const E* v, const E* dout,
             const float* lse, const float* delta, const float* kmask,
             float* dq, int BN, int N, int Tq, int Tk, int D, float scale,
             int causal, void* stream) {
  if (BN <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      (Tq + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return (int)launch<E, 64>(q, k, v, dout, lse, delta, kmask, dq, BN, N,
                              Tq, Tk, D, scale, causal, s);
  return (int)launch<E, 128>(q, k, v, dout, lse, delta, kmask, dq, BN, N, Tq,
                             Tk, D, scale, causal, s);
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
  return flash_dq<float>(q, k, v, dout, lse, delta, kmask, dq, BN, N, Tq, Tk,
                         D, scale, causal, stream);
}

int dl4j_flash_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* dout,
                       const float* lse, const float* delta,
                       const float* kmask, float* dq, int BN, int N, int Tq,
                       int Tk, int D, float scale, int causal, void* stream) {
  return flash_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, kmask, dq, BN, N,
                                 Tq, Tk, D, scale, causal, stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
