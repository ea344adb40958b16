// Flash-attention backward, dk and dv, for Hopper (sm_90a), plain C
// interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/flash_attention.py::_flash_dkv_kernel
// (launched by _flash_backward through pl.pallas_call). For one (batch*head,
// 64-row key tile) a block keeps its k and v tiles in shared memory, streams
// the query tiles, and recomputes each 64 x 64 probability tile from the
// forward's row logsumexp:
//
//   p  = exp(scale * q k^T - lse)      (0 where the key is masked)
//   dp = do v^T                         ds = p * (dp - delta)
//   dv = sum over query tiles of p^T do
//   dk = scale * sum over query tiles of ds^T q
//
// Masking is the forward's (flash_attention_fwd.cu). When causal, query
// tiles that end before the key tile starts see none of its keys and are not
// visited. A key that is padding or past Tk gets dk = dv = 0.
//
// Types: q, k, v and do all float32 (dl4j_flash_dkv) or all bfloat16
// (dl4j_flash_dkv_bf16); lse, delta, kmask, dk and dv are float32. As in the
// Pallas kernel, p is rounded to do's type before p^T do and ds to q's type
// before ds^T q; the sums are f32.
//
// What bounds it on this card: at BERT-base's [32, 12, 128, 64] it reads
// q, k, v, do (25.2 MB in bf16) and writes dk, dv in f32 (25.2 MB), about
// 15 us at 3.35 TB/s, for 3.2 GFLOP of products (3.3 us at the bf16
// tensor-core peak). The products run on the CUDA cores in f32 from shared
// memory, so the operations bound it. Same simple design as the forward:
// one block per (batch*head, key tile), 4 x 4 scores a thread, dk and dv
// accumulated in registers across the query tiles.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename E, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const E* __restrict__ q,          // [BN, Tq, D]
                 const E* __restrict__ k,          // [BN, Tk, D]
                 const E* __restrict__ v,          // [BN, Tk, D]
                 const E* __restrict__ dout,       // [BN, Tq, D]
                 const float* __restrict__ lse,    // [BN, Tq]
                 const float* __restrict__ delta,  // [BN, Tq]
                 const float* __restrict__ kmask,  // [B, Tk] or null
                 float* __restrict__ dk,           // [BN, Tk, D]
                 float* __restrict__ dv,           // [BN, Tk, D]
                 int N, int Tq, int Tk, int D, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NC = DMAX / 16;
  extern __shared__ float smem[];
  float* ks = smem;                   // [64][LD]
  float* vs = ks + kTile * LD;        // [64][LD]
  float* qs = vs + kTile * LD;        // [64][LD]
  float* dos = qs + kTile * LD;       // [64][LD]
  float* pt = dos + kTile * LD;       // [64 keys][kPLd queries], p rounded to E
  float* dst = pt + kTile * kPLd;     // [64 keys][kPLd queries], ds rounded to E
  float* lse_s = dst + kTile * kPLd;  // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const E* qb = q + (size_t)bh * Tq * D;
  const E* db = dout + (size_t)bh * Tq * D;
  const float* lse_b = lse + (size_t)bh * Tq;
  const float* delta_b = delta + (size_t)bh * Tq;
  const float* km = kmask ? kmask + (size_t)(bh / N) * Tk : nullptr;

  load_tile<E, LD>(ks, k + (size_t)bh * Tk * D, k0, Tk, D);
  load_tile<E, LD>(vs, v + (size_t)bh * Tk * D, k0, Tk, D);

  float acc_k[kPer][NC], acc_v[kPer][NC];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  // causal: query tiles whose last row is before k0 see no key of this tile
  const int q_begin = causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<E, LD>(qs, qb, q0, Tq, D);
    load_tile<E, LD>(dos, db, q0, Tq, D);
    if (threadIdx.x < kTile) {
      const int qpos = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qpos < Tq ? lse_b[qpos] : INFINITY;
      delta_s[threadIdx.x] = qpos < Tq ? delta_b[qpos] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: row ty + 16 i is a key, column tx + 16 j a query
    float s[kPer][kPer], dp[kPer][kPer];
    dot_tile<LD>(s, ks, qs, D, ty, tx);
    dot_tile<LD>(dp, vs, dos, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qrow = tx + 16 * j;
        const int qpos = q0 + qrow;
        float p = 0.0f, ds = 0.0f;
        if (qpos < Tq && visible(qpos, kpos, Tk, km, causal)) {
          p = expf(s[i][j] * scale - lse_s[qrow]);
          ds = p * (dp[i][j] - delta_s[qrow]);
        }
        pt[(ty + 16 * i) * kPLd + qrow] = round_to<E>(p);
        dst[(ty + 16 * i) * kPLd + qrow] = round_to<E>(ds);
      }
    }
    __syncthreads();  // the p and ds tiles are complete

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dov[c] = dos[j * LD + tx + 16 * c];
        qv[c] = qs[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = pt[(ty + 16 * i) * kPLd + j];
        const float ds = dst[(ty + 16 * i) * kPLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[i][c] = fmaf(p, dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds, qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Tk) continue;
    float* krow = dk + ((size_t)bh * Tk + kpos) * D;
    float* vrow = dv + ((size_t)bh * Tk + kpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        krow[col] = scale * acc_k[i][c];
        vrow[col] = acc_v[i][c];
      }
    }
  }
}

template <typename E, int DMAX>
cudaError_t launch(const E* q, const E* k, const E* v, const E* dout,
                   const float* lse, const float* delta, const float* kmask,
                   float* dk, float* dv, int BN, int N, int Tq, int Tk, int D,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem =
      sizeof(float) * (4 * kTile * LD + 2 * kTile * kPLd + 2 * kTile);
  cudaError_t err = allow_smem(flash_dkv_kernel<E, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tk + kTile - 1) / kTile);
  flash_dkv_kernel<E, DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kmask, dk, dv, N, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename E>
int flash_dkv(const E* q, const E* k, const E* v, const E* dout,
              const float* lse, const float* delta, const float* kmask,
              float* dk, float* dv, int BN, int N, int Tq, int Tk, int D,
              float scale, int causal, void* stream) {
  if (BN <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      (Tk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return (int)launch<E, 64>(q, k, v, dout, lse, delta, kmask, dk, dv, BN,
                              N, Tq, Tk, D, scale, causal, s);
  return (int)launch<E, 128>(q, k, v, dout, lse, delta, kmask, dk, dv, BN, N,
                             Tq, Tk, D, scale, causal, s);
}

}  // namespace

extern "C" {

// Launch dk/dv on `stream`; each returns a cudaError_t (0 = launched). q,
// k, v and dout are [BN, T, D] row-major of the function's element type;
// lse and delta [BN, Tq], kmask [BN / N, Tk] or null, dk and dv
// [BN, Tk, D], all float32.
int dl4j_flash_dkv(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   const float* kmask, float* dk, float* dv, int BN, int N,
                   int Tq, int Tk, int D, float scale, int causal,
                   void* stream) {
  return flash_dkv<float>(q, k, v, dout, lse, delta, kmask, dk, dv, BN, N,
                          Tq, Tk, D, scale, causal, stream);
}

int dl4j_flash_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const __nv_bfloat16* dout,
                        const float* lse, const float* delta,
                        const float* kmask, float* dk, float* dv, int BN,
                        int N, int Tq, int Tk, int D, float scale, int causal,
                        void* stream) {
  return flash_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, kmask, dk, dv,
                                  BN, N, Tq, Tk, D, scale, causal, stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
