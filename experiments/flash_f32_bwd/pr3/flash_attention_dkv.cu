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
// tensor-core peak, 48 us at the f32 peak off the tensor cores).
//
// Two designs, one per type:
//
// - bf16 (flash_dkv_wgmma_kernel): the key-stationary transpose of dq's
//   design (flash_attention_dq.cu), on the same tensor-core tile layer
//   (flash_common.cuh). One warpgroup per 64-row key tile keeps k and v in
//   shared memory and streams the query tiles (q, do, and the tile's lse
//   and delta) through a two-stage cp.async ring. s^T = k q^T and
//   dp^T = v do^T are two wgmma chains from shared memory with the key
//   tile as the 64-row A operand, so rows are keys and columns queries.
//   p^T = 2^(s^T scale log2(e) - lse[query] log2(e) + bias[key]) (one
//   ex2.approx; the key mask is a per-row bias of 0 or -inf, and lse =
//   +inf on a query row that saw no key makes p = 0 with no select) and
//   ds^T = p^T (dp^T - delta[query]) stay in the accumulators' registers;
//   packed to bf16 in place they are the register A operands of
//   dv += p^T do and dk += ds^T q, with do and q read transposed from the
//   tiles that served the first products. dk and dv stay in f32 registers
//   across the query tiles and are stored once, dk times the scale.
// - f32 (flash_dkv_kernel): the tensor cores cannot take f32 at f32
//   precision (TF32 is off for every parity comparison), so the products
//   stay on the CUDA cores from shared memory, and the operations bound
//   it: one block of 256 threads per (batch*head, key tile), 4 x 4 scores
//   a thread, p and ds through shared tiles, dk and dv accumulated in
//   registers across the query tiles.

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

template <int DMAX>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, const float* kmask, float* dk,
                       float* dv, int BN, int N, int Tq, int Tk, int D,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem =
      sizeof(float) * (4 * kTile * LD + 2 * kTile * kPLd + 2 * kTile);
  cudaError_t err = allow_smem(flash_dkv_kernel<float, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tk + kTile - 1) / kTile);
  flash_dkv_kernel<float, DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kmask, dk, dv, N, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

template <int DMAX>
__global__ void __launch_bounds__(wg::kThreads)
flash_dkv_wgmma_kernel(const bf16* __restrict__ q,         // [BN, Tq, D]
                       const bf16* __restrict__ k,         // [BN, Tk, D]
                       const bf16* __restrict__ v,         // [BN, Tk, D]
                       const bf16* __restrict__ dout,      // [BN, Tq, D]
                       const float* __restrict__ lse,      // [BN, Tq]
                       const float* __restrict__ delta,    // [BN, Tq]
                       const float* __restrict__ kmask,    // [B, Tk] or null
                       float* __restrict__ dk,             // [BN, Tk, D]
                       float* __restrict__ dv,             // [BN, Tk, D]
                       int N, int Tq, int Tk, int D, float scale, int causal,
                       int vec) {
  constexpr int kTileBytes = kTile * DMAX * 2;
  constexpr int NB = DMAX / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = wg::align_1k(smem_raw);
  uint8_t* vs = ks + kTileBytes;
  uint8_t* qs = vs + kTileBytes;       // 2 stages
  uint8_t* dos = qs + 2 * kTileBytes;  // 2 stages
  // each stage's lse and delta, [2][64] each; zero past Tq
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileBytes);
  float* delta_s = lse_s + 2 * kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * w + (lane >> 2);  // key rows row0 and row0 + 8
  const int col = 2 * (lane & 3);
  const bf16* qb = q + (size_t)bh * Tq * D;
  const bf16* db = dout + (size_t)bh * Tq * D;
  const float* km = kmask ? kmask + (size_t)(bh / N) * Tk : nullptr;
  // causal: query tiles whose last row is before k0 see no key of this tile
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + kTile - 1) / kTile : 0;

  // one query tile's q, do, lse and delta into stage st (thread t < 64
  // copies lse of row t, t >= 64 delta of row t - 64)
  auto load_queries = [&](int st, int q0) {
    wg::load_tile<DMAX>(qs + st * kTileBytes, qb, q0, Tq, D, vec);
    wg::load_tile<DMAX>(dos + st * kTileBytes, db, q0, Tq, D, vec);
    const int r = threadIdx.x & (kTile - 1);
    const bool in = q0 + r < Tq;
    const float* src = (threadIdx.x < kTile ? lse : delta) + (size_t)bh * Tq +
                       (in ? q0 + r : 0);
    float* dst = (threadIdx.x < kTile ? lse_s : delta_s) + st * kTile + r;
    wg::cp_async4(wg::smem_addr(dst), src, in ? 4 : 0);
  };

  wg::load_tile<DMAX>(ks, k + (size_t)bh * Tk * D, k0, Tk, D, vec);
  wg::load_tile<DMAX>(vs, v + (size_t)bh * Tk * D, k0, Tk, D, vec);
  if (n_tiles > 0) load_queries(0, q_begin);
  wg::cp_async_commit();

  // each key row as a bias on the exponent: 0, or -inf where the key is
  // padding or past Tk, so its p (and ds) is 2^-inf = 0
  float bias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + row0 + 8 * h;
    bias[h] = kpos < Tk && (km == nullptr || km[kpos] > 0.0f) ? 0.0f
                                                               : -INFINITY;
  }
  const float scale2 = scale * wg::kLog2e;
  float acc_k[NB][32], acc_v[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[nb][i] = acc_v[nb][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const int q0 = q_begin + j * kTile;
    const uint8_t* qt = qs + st * kTileBytes;
    const uint8_t* dt = dos + st * kTileBytes;
    if (j + 1 < n_tiles) load_queries(st ^ 1, q0 + kTile);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    wg::fence_to_async();
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T: rows keys, columns queries; f32 sums
    float s[32], dp[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {  // padded columns are zero
      wg::mma_ss(s, wg::k_major(ks, kk), wg::k_major(qt, kk), kk > 0);
      wg::mma_ss(dp, wg::k_major(vs, kk), wg::k_major(dt, kk), kk > 0);
    }
    wg::commit();
    const bool diagonal = causal && q0 < k0 + kTile;
    const float* ls = lse_s + st * kTile;
    const float* dl_s = delta_s + st * kTile;
    wg::wait_all();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // p^T in s, ds^T = p^T (dp^T - delta) in dp
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // query columns 8c + col, 8c + col + 1
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * c + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * c + col);
      const float nl[2] = {-l2.x * wg::kLog2e, -l2.y * wg::kLog2e};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * h + e;
          float p = wg::fast_exp2(fmaf(s[i], scale2, nl[e]) + bias[h]);
          if (diagonal && q0 + 8 * c + col + e < k0 + row0 + 8 * h) p = 0.0f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl[e]);
        }
      }
    }

    // dv += p^T do and dk += ds^T q: p^T and ds^T rounded to bf16 from
    // registers, do and q read transposed
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::pack_a(pa[kk], s, kk);
      wg::pack_a(da[kk], dp, kk);
    }
    wg::fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::mma_rs(acc_v[nb], pa[kk], wg::mn_major(dt, kk, nb));
        wg::mma_rs(acc_k[nb], da[kk], wg::mn_major(qt, kk, nb));
      }
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      wg::fence_regs(acc_v[nb]);
      wg::fence_regs(acc_k[nb]);
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  wg::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + row0 + 8 * h;
    if (kpos >= Tk) continue;
    float* krow = dk + ((size_t)bh * Tk + kpos) * D;
    float* vrow = dv + ((size_t)bh * Tk + kpos) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // the pair at columns cc, cc + 1
        const int cc = 64 * nb + 8 * c + col;
        const float k0v = scale * acc_k[nb][4 * c + 2 * h];
        const float k1v = scale * acc_k[nb][4 * c + 2 * h + 1];
        const float v0 = acc_v[nb][4 * c + 2 * h];
        const float v1 = acc_v[nb][4 * c + 2 * h + 1];
        if (cc + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<float2*>(krow + cc) = make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(vrow + cc) = make_float2(v0, v1);
        } else {
          if (cc < D) krow[cc] = k0v, vrow[cc] = v0;
          if (cc + 1 < D) krow[cc + 1] = k1v, vrow[cc + 1] = v1;
        }
      }
  }
}

template <int DMAX>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse,
                        const float* delta, const float* kmask, float* dk,
                        float* dv, int BN, int N, int Tq, int Tk, int D,
                        float scale, int causal, cudaStream_t stream) {
  // k, v, two query and two do stages, two stages of lse and delta, and
  // 1 KB to align the first tile
  const size_t smem =
      6 * kTile * DMAX * 2 + 4 * kTile * sizeof(float) + 1024;
  cudaError_t err = allow_smem(flash_dkv_wgmma_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tk + kTile - 1) / kTile);
  const int vec = wg::vec_rows(D, {q, k, v, dout}) ? 1 : 0;
  flash_dkv_wgmma_kernel<DMAX><<<grid, wg::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kmask, dk, dv, N, Tq, Tk, D, scale, causal,
      vec);
  return cudaGetLastError();
}

bool bad_shape(int BN, int N, int Tq, int Tk, int D) {
  return BN <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
         (Tk + kTile - 1) / kTile > 65535;
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
  if (bad_shape(BN, N, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_f32<64>(q, k, v, dout, lse, delta, kmask, dk,
                                        dv, BN, N, Tq, Tk, D, scale, causal,
                                        s)
                       : launch_f32<128>(q, k, v, dout, lse, delta, kmask,
                                         dk, dv, BN, N, Tq, Tk, D, scale,
                                         causal, s));
}

int dl4j_flash_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const __nv_bfloat16* dout,
                        const float* lse, const float* delta,
                        const float* kmask, float* dk, float* dv, int BN,
                        int N, int Tq, int Tk, int D, float scale, int causal,
                        void* stream) {
  if (bad_shape(BN, N, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_bf16<64>(q, k, v, dout, lse, delta, kmask,
                                         dk, dv, BN, N, Tq, Tk, D, scale,
                                         causal, s)
                       : launch_bf16<128>(q, k, v, dout, lse, delta, kmask,
                                          dk, dv, BN, N, Tq, Tk, D, scale,
                                          causal, s));
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
