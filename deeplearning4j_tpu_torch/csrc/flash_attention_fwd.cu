// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces deeplearning4j_tpu/ops/pallas/flash_attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call). For one (batch*head,
// 64-row query tile) a block streams 64-row key/value tiles through shared
// memory and keeps the online softmax's running max m, denominator l and
// output accumulator in f32 registers, so the [Tq, Tk] score matrix never
// reaches device memory:
//
//   s   = scale * q k^T        (masked keys: -inf)
//   m'  = max(m, rowmax(s))    m_safe = m' where finite, else 0
//   p   = exp(s - m_safe)      (0 where s = -inf)
//   l   = l * exp(m - m_safe) + rowsum(p)        (the factor is 0 while m = -inf)
//   acc = acc * exp(m - m_safe) + p v
//
// and at the end o = acc / max(l, 1e-30) in the input type and
// lse = m_safe + log(l), or +inf for a row that saw no key (o = 0 there),
// so the backward's exp(s - lse) is exactly 0 on such a row. A key is
// masked past Tk, where the key-padding mask kmask[b, k] (b = bh / N) is
// not > 0, and, when causal, after the query (start-aligned qpos >= kpos).
// With causal set, key tiles that start after the query tile's last row are
// not visited: the Pallas kernel's block skipping.
//
// Types: q, k, v and o all float32 (dl4j_flash_fwd) or all bfloat16
// (dl4j_flash_fwd_bf16); kmask and lse are float32. As in the Pallas kernel,
// q k^T sums in f32 over the input type's values, the scale multiplies the
// f32 product, p is rounded to v's type before p v, and o is stored in the
// input type.
//
// What bounds it on this card: at BERT-base's [32, 12, 128, 64] it reads
// q, k, v and writes o once (25.2 MB in bf16, 7.5 us at 3.35 TB/s) for
// 1.61 GFLOP of products (1.6 us at the bf16 tensor-core peak, 24 us at the
// f32 peak off the tensor cores). This kernel does its products on the CUDA
// cores in f32, 16 fused multiply-adds for every 8 shared-memory loads, so
// it is bound by the operations and by shared-memory bandwidth, far above
// the bytes. The design is the simple one that is right: one block per
// (batch*head, query tile), 4 x 4 scores a thread. Tensor cores (wgmma over
// TMA-fed tiles) are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename E, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const E* __restrict__ q,         // [BN, Tq, D]
                 const E* __restrict__ k,         // [BN, Tk, D]
                 const E* __restrict__ v,         // [BN, Tk, D]
                 const float* __restrict__ kmask, // [B, Tk] or null
                 E* __restrict__ o,               // [BN, Tq, D]
                 float* __restrict__ lse,         // [BN, Tq]
                 int N, int Tq, int Tk, int D, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NC = DMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [64][LD]
  float* ks = qs + kTile * LD;    // [64][LD]
  float* vs = ks + kTile * LD;    // [64][LD]
  float* ps = vs + kTile * LD;    // [64][kPLd], p rounded to E

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const E* kb = k + (size_t)bh * Tk * D;
  const E* vb = v + (size_t)bh * Tk * D;
  const float* km = kmask ? kmask + (size_t)(bh / N) * Tk : nullptr;

  load_tile<E, LD>(qs, q + (size_t)bh * Tq * D, q0, Tq, D);

  float m[kPer], l[kPer], acc[kPer][NC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // causal: key tiles past the query tile's last row see nothing
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<E, LD>(ks, kb, k0, Tk, D);
    load_tile<E, LD>(vs, vb, k0, Tk, D);
    __syncthreads();

    float s[kPer][kPer];
    dot_tile<LD>(s, qs, ks, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(qpos, kpos, Tk, km, causal) ? s[i][j] * scale
                                                       : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_safe);
        rsum += p;
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<E>(p);
      }
      rsum = row_sum(rsum);
      const float corr = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + rsum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // the p tile is complete

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = ps[(ty + 16 * i) * kPLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    E* orow = o + ((size_t)bh * Tq + qpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(orow + col, acc[i][c] / denom);
    }
    if (tx == 0) {
      const float m_safe = m[i] == -INFINITY ? 0.0f : m[i];
      lse[(size_t)bh * Tq + qpos] =
          l[i] > 0.0f ? m_safe + logf(denom) : INFINITY;
    }
  }
}

template <typename E, int DMAX>
cudaError_t launch(const E* q, const E* k, const E* v, const float* kmask,
                   E* o, float* lse, int BN, int N, int Tq, int Tk, int D,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem = sizeof(float) * (3 * kTile * LD + kTile * kPLd);
  cudaError_t err = allow_smem(flash_fwd_kernel<E, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tq + kTile - 1) / kTile);
  flash_fwd_kernel<E, DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, kmask, o, lse, N, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

template <typename E>
int flash_fwd(const E* q, const E* k, const E* v, const float* kmask, E* o,
              float* lse, int BN, int N, int Tq, int Tk, int D, float scale,
              int causal, void* stream) {
  if (BN <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      (Tq + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return (int)launch<E, 64>(q, k, v, kmask, o, lse, BN, N, Tq, Tk, D,
                              scale, causal, s);
  return (int)launch<E, 128>(q, k, v, kmask, o, lse, BN, N, Tq, Tk, D, scale,
                             causal, s);
}

}  // namespace

extern "C" {

// Launch the forward on `stream`; each returns a cudaError_t (0 = launched).
// q, k, v, o are [BN, T, D] row-major of the function's element type, BN =
// batch * N heads; kmask is [BN / N, Tk] float32 or null; lse [BN, Tq]
// float32. D <= 128.
int dl4j_flash_fwd(const float* q, const float* k, const float* v,
                   const float* kmask, float* o, float* lse, int BN, int N,
                   int Tq, int Tk, int D, float scale, int causal,
                   void* stream) {
  return flash_fwd<float>(q, k, v, kmask, o, lse, BN, N, Tq, Tk, D, scale,
                          causal, stream);
}

int dl4j_flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const float* kmask,
                        __nv_bfloat16* o, float* lse, int BN, int N, int Tq,
                        int Tk, int D, float scale, int causal,
                        void* stream) {
  return flash_fwd<__nv_bfloat16>(q, k, v, kmask, o, lse, BN, N, Tq, Tk, D,
                                  scale, causal, stream);
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
