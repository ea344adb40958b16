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
// f32 peak off the tensor cores). So in bf16 the bytes bound it, and only
// the tensor cores bring the products under them.
//
// Two designs, one per type:
//
// - bf16 (flash_fwd_wgmma_kernel): one warpgroup of 128 threads per 64-row
//   query tile, on the tensor-core tile layer of flash_common.cuh. The query
//   tile and a two-stage ring of key/value tiles live in shared memory in
//   wgmma's 128-byte-swizzled layout; the next tile's cp.async copies are in
//   flight while the current one is used. s = q k^T is one wgmma chain
//   (m64n64k16, both operands from shared memory); m, l and the output
//   accumulator stay in registers; p, packed to bf16 in the accumulator's
//   own registers, is the register A operand of o += p v (v read
//   transposed), so p never touches shared memory. The softmax is the
//   CUDA cores' share, and on this card it, not the products, sets the
//   pace: it runs in base 2 (the scale times log2 e multiplies the f32
//   product, and 2^x is one ex2.approx on the special-function unit, about
//   2 ulp); key padding enters as a bias per key column (0 or -inf) in the
//   same fused multiply-add, and only a causal tile on the diagonal tests
//   each score. Head dims up to 64 use
//   64-wide tiles, up to 128 two column blocks; D is zero-padded to the
//   tile width in shared memory. The copies are cp.async, not TMA: a tensor
//   map would have to be encoded on the host for every call's pointers, and
//   rows of a D that is not a multiple of 8 values break TMA's 16-byte
//   strides; the threads gather such rows themselves.
// - f32 (flash_fwd_kernel): the tensor cores cannot take f32 at f32
//   precision (TF32 keeps 10 mantissa bits, and every parity comparison
//   runs with it off), so the products stay on the CUDA cores: one block of
//   256 threads per (batch*head, query tile), 4 x 4 scores a thread, the
//   operands as f32 in shared memory and p through a shared tile, 16 fused
//   multiply-adds for every 8 shared-memory loads. The operations and the
//   shared-memory bandwidth bound it.

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


template <int DMAX>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* kmask, float* o, float* lse, int BN,
                       int N, int Tq, int Tk, int D, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int LD = DMAX + 1;
  const size_t smem = sizeof(float) * (3 * kTile * LD + kTile * kPLd);
  cudaError_t err = allow_smem(flash_fwd_kernel<float, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tq + kTile - 1) / kTile);
  flash_fwd_kernel<float, DMAX><<<grid, kThreads, smem, stream>>>(
      q, k, v, kmask, o, lse, N, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

template <int DMAX>
__global__ void __launch_bounds__(wg::kThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q,       // [BN, Tq, D]
                       const bf16* __restrict__ k,       // [BN, Tk, D]
                       const bf16* __restrict__ v,       // [BN, Tk, D]
                       const float* __restrict__ kmask,  // [B, Tk] or null
                       bf16* __restrict__ o,             // [BN, Tq, D]
                       float* __restrict__ lse,          // [BN, Tq]
                       int N, int Tq, int Tk, int D, float scale, int causal,
                       int vec) {
  constexpr int kTileBytes = kTile * DMAX * 2;
  constexpr int NB = DMAX / 64;  // 64-column blocks of the output
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = wg::align_1k(smem_raw);
  uint8_t* ks = qs + kTileBytes;      // 2 stages
  uint8_t* vs = ks + 2 * kTileBytes;  // 2 stages

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * w + (lane >> 2);  // rows row0 and row0 + 8
  const int col = 2 * (lane & 3);         // within each 8-column chunk
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;
  const float* km = kmask ? kmask + (size_t)(bh / N) * Tk : nullptr;
  // causal: key tiles past the query tile's last row see nothing
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const float scale2 = scale * wg::kLog2e;  // softmax in base 2

  wg::load_tile<DMAX>(qs, q + (size_t)bh * Tq * D, q0, Tq, D, vec);
  wg::load_tile<DMAX>(ks, kb, 0, Tk, D, vec);
  wg::load_tile<DMAX>(vs, vb, 0, Tk, D, vec);
  wg::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const uint8_t* kt = ks + st * kTileBytes;
    const uint8_t* vt = vs + st * kTileBytes;
    if (j + 1 < n_tiles) {  // the next tile into the other stage
      wg::load_tile<DMAX>(ks + (st ^ 1) * kTileBytes, kb, (j + 1) * kTile, Tk,
                          D, vec);
      wg::load_tile<DMAX>(vs + (st ^ 1) * kTileBytes, vb, (j + 1) * kTile, Tk,
                          D, vec);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<1>();  // this tile (and q) have landed
    wg::fence_to_async();
    __syncthreads();

    // s = q k^T, f32 sums
    float s[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)  // padded columns are zero
      wg::mma_ss(s, wg::k_major(qs, kk), wg::k_major(kt, kk), kk > 0);
    wg::commit();
    // While the product runs: each of this thread's key columns as a bias
    // on its scaled score, 0 or -inf where the key is padding or past Tk.
    // Value c of a row (c < 16) is accumulator entry 4 (c / 2) + 2 h + c % 2,
    // at key column 8 (c / 2) + col + c % 2.
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
    // causal: only a tile that crosses the diagonal holds later keys
    const bool diagonal = causal && k0 + kTile - 1 > q0;
    wg::wait_all();
    wg::fence_regs(s);

    // scale (into the base-2 exponent), mask and the online softmax, p in
    // place of s; m is the running max of the scaled scores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q0 + row0 + 8 * h;
      float rmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int i = 4 * (c >> 1) + 2 * h + (c & 1);
        s[i] = fmaf(s[i], scale2, bias[c]);
        if (diagonal && qpos < k0 + 8 * (c >> 1) + col + (c & 1))
          s[i] = -INFINITY;
        rmax = fmaxf(rmax, s[i]);
      }
      // the four threads of a row are lanes 4 r .. 4 r + 3
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[h], rmax);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = wg::fast_exp2(m[h] - m_safe);  // 0 while m = -inf
      float rsum = 0.0f;  // this thread's share of the row; summed at the end
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int i = 4 * (c >> 1) + 2 * h + (c & 1);
        s[i] = wg::fast_exp2(s[i] - m_safe);  // masked: 2^-inf = 0
        rsum += s[i];
      }
      l[h] = l[h] * corr + rsum;
      m[h] = m_new;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 16; ++c)
          acc[nb][4 * (c >> 1) + 2 * h + (c & 1)] *= corr;
    }

    // o += p v: p rounded to bf16 from registers, v read transposed
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::pack_a(pa[kk], s, kk);
    wg::fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs(acc[nb], pa[kk], wg::mn_major(vt, kk, nb));
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wg::fence_regs(acc[nb]);
    __syncthreads();  // this stage is free for the tile after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float rowsum = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
    const int qpos = q0 + row0 + 8 * h;
    if (qpos >= Tq) continue;
    const float denom = fmaxf(rowsum, 1e-30f);
    const float inv = 1.0f / denom;
    bf16* orow = o + ((size_t)bh * Tq + qpos) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // the pair at columns cc, cc + 1
        const int cc = 64 * nb + 8 * c + col;
        const float v0 = acc[nb][4 * c + 2 * h] * inv;
        const float v1 = acc[nb][4 * c + 2 * h + 1] * inv;
        if (cc + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + cc) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (cc < D) orow[cc] = __float2bfloat16_rn(v0);
          if (cc + 1 < D) orow[cc + 1] = __float2bfloat16_rn(v1);
        }
      }
    if ((lane & 3) == 0) {
      lse[(size_t)bh * Tq + qpos] =
          rowsum > 0.0f ? m[h] * wg::kLn2 + logf(denom) : INFINITY;
    }
  }
}

template <int DMAX>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const float* kmask, bf16* o, float* lse, int BN,
                        int N, int Tq, int Tk, int D, float scale, int causal,
                        cudaStream_t stream) {
  // q, two key and two value stages, and 1 KB to align the first to 1 KB
  const size_t smem = 5 * kTile * DMAX * 2 + 1024;
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BN, (Tq + kTile - 1) / kTile);
  const int vec = wg::vec_rows(D, {q, k, v}) ? 1 : 0;
  flash_fwd_wgmma_kernel<DMAX><<<grid, wg::kThreads, smem, stream>>>(
      q, k, v, kmask, o, lse, N, Tq, Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

bool bad_shape(int BN, int N, int Tq, int Tk, int D) {
  return BN <= 0 || N <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
         (Tq + kTile - 1) / kTile > 65535;
}

// ------------------------------------------------ the tile layer's check

// One product of each kind the bf16 kernels use, for a test against a host
// product: ss = a b^T over K = 128 (A and B K-major from shared memory,
// eight k16 steps across both column blocks) and rs = a[:, :64] b (A from
// registers in the accumulator's layout, B MN-major: four k16 steps, both
// 64-column halves). a and b are [64, 128] row-major bf16, 16-byte
// aligned; ss is [64, 64] and rs [64, 128], f32.
__global__ void __launch_bounds__(wg::kThreads)
flash_tile_check_kernel(const bf16* __restrict__ a,
                        const bf16* __restrict__ b, float* __restrict__ ss,
                        float* __restrict__ rs) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = wg::align_1k(smem_raw);
  uint8_t* bs = as + 2 * wg::kBlockBytes;
  wg::load_tile<128>(as, a, 0, 64, 128, true);
  wg::load_tile<128>(bs, b, 0, 64, 128, true);
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  wg::fence_to_async();
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * w + (lane >> 2), col = 2 * (lane & 3);
  const unsigned short* ah = reinterpret_cast<const unsigned short*>(a);
  uint32_t fa[4][4];  // a[:, :64] as register A operands
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row0 + 8 * (r & 1), cc = 16 * kk + 8 * (r >> 1) + col;
      fa[kk][r] = (uint32_t)ah[rr * 128 + cc] |
                  ((uint32_t)ah[rr * 128 + cc + 1] << 16);
    }
  float d[32], e[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) e[0][i] = e[1][i] = 0.0f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wg::mma_ss(d, wg::k_major(as, kk), wg::k_major(bs, kk), kk > 0);
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(e[nb], fa[kk], wg::mn_major(bs, kk, nb));
  wg::commit();
  wg::wait_all();
  wg::fence_regs(d);
  wg::fence_regs(e[0]);
  wg::fence_regs(e[1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = row0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + col + (i & 1);
    ss[r * 64 + c] = d[i];
    rs[r * 128 + c] = e[0][i];
    rs[r * 128 + 64 + c] = e[1][i];
  }
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
  if (bad_shape(BN, N, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_f32<64>(q, k, v, kmask, o, lse, BN, N, Tq,
                                        Tk, D, scale, causal, s)
                       : launch_f32<128>(q, k, v, kmask, o, lse, BN, N, Tq,
                                         Tk, D, scale, causal, s));
}

int dl4j_flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const float* kmask,
                        __nv_bfloat16* o, float* lse, int BN, int N, int Tq,
                        int Tk, int D, float scale, int causal,
                        void* stream) {
  if (bad_shape(BN, N, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch_bf16<64>(q, k, v, kmask, o, lse, BN, N, Tq,
                                         Tk, D, scale, causal, s)
                       : launch_bf16<128>(q, k, v, kmask, o, lse, BN, N, Tq,
                                          Tk, D, scale, causal, s));
}

// The tile layer's check (flash_tile_check_kernel) on `stream`, one block.
int dl4j_flash_tile_check(const __nv_bfloat16* a, const __nv_bfloat16* b,
                          float* ss, float* rs, void* stream) {
  const size_t smem = 4 * wg::kBlockBytes + 1024;
  cudaError_t err = allow_smem(flash_tile_check_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  flash_tile_check_kernel<<<1, wg::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a, b, ss,
                                                                 rs);
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
