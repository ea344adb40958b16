// Device code shared by the LRN forward (lrn_fwd.cu) and backward
// (lrn_bwd.cu) for Hopper (sm_90a).
//
// Both kernels take the same layout on the [R, C] row view of a
// channels-last tensor:
// - a thread owns kSeg = 8 consecutive channels of one row, loaded and
//   stored as 16-byte vectors (two for f32, one for bf16) where every
//   pointer is 16-byte aligned and C is a multiple of the vector, else
//   element by element;
// - a block owns P whole rows, tpr = ceil(C / kSeg) threads a row (P tpr
//   <= kThreads; one row of up to kMaxThreads threads when C > 2048), so
//   a thread's row and channels come from one division when it starts;
// - a shared row of P rows is padded by kPad zeros on both sides, so a
//   thread reads its window (its 8 channels and kPad on either side) as
//   float4s, and depth 5's window is five register adds, unclipped.
//
// Python mirrors the layout in ops/cuda/lrn.py (fwd_design), and the
// tests read these constants back from this file.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lrn {

constexpr int kThreads = 256;     // threads a block (P rows of tpr threads)
constexpr int kMaxThreads = 512;  // one row of C = 4096 channels
constexpr int kSeg = 8;           // channels a thread owns
constexpr int kPad = 4;           // zero padding each side of a shared row
constexpr int kMaxChannels = 4096;

// tpr threads a row and P rows a block for C channels
struct Layout {
  int tpr, P;
};
inline Layout layout(int C) {
  const int tpr = (C + kSeg - 1) / kSeg;
  return {tpr, tpr <= kThreads ? kThreads / tpr : 1};
}

// Whether 16-byte vectors move a row: C a multiple of the vector and the
// pointers (or'ed together) 16-byte aligned
template <typename T>
inline bool vector_path(int C, uintptr_t pointers) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte vector
  return C % V == 0 && (pointers & 15) == 0;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kSeg elements at p, as f32: 16-byte vectors when Vec, else one by one
// (n of them valid, the rest zero)
template <bool Vec>
__device__ __forceinline__ void load_seg(const float* p, int n, float* v) {
  if constexpr (Vec) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < kSeg / 4; ++i) {
      const float4 a = i * 4 < n ? __ldg(q + i) : make_float4(0, 0, 0, 0);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) v[i] = i < n ? __ldg(p + i) : 0.0f;
  }
}
template <bool Vec>
__device__ __forceinline__ void load_seg(const __nv_bfloat16* p, int n,
                                         float* v) {
  if constexpr (Vec) {  // kSeg bf16 are one 16-byte vector
    uint4 a = n > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                    : make_uint4(0, 0, 0, 0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < kSeg / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      v[i] = i < n ? __bfloat162float(__ushort_as_bfloat16(__ldg(q + i)))
                   : 0.0f;
  }
}
template <bool Vec>
__device__ __forceinline__ void store_seg(float* p, int n, const float* v) {
  if constexpr (Vec) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < kSeg / 4; ++i)
      if (i * 4 < n)
        q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      if (i < n) p[i] = v[i];
  }
}
template <bool Vec>
__device__ __forceinline__ void store_seg(__nv_bfloat16* p, int n,
                                          const float* v) {
  if constexpr (Vec) {
    if (n > 0) {
      uint4 a;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
      for (int i = 0; i < kSeg / 2; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(p) = a;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      if (i < n) store(p + i, v[i]);
  }
}

// The kSeg + 2 kPad values of a shared row around a thread's channels:
// w[i] = row[c0 + i - kPad], row[] starting at its left padding
__device__ __forceinline__ void read_window(const float* row, int c0,
                                           float* w) {
  const float4* q = reinterpret_cast<const float4*>(row + c0);
#pragma unroll
  for (int i = 0; i < (kSeg + 2 * kPad) / 4; ++i) {
    const float4 a = q[i];
    w[4 * i] = a.x;
    w[4 * i + 1] = a.y;
    w[4 * i + 2] = a.z;
    w[4 * i + 3] = a.w;
  }
}

// Sum of row[c + j] over j in [-before, after], clipped to [0, C); row[]
// at channel 0
__device__ __forceinline__ float clipped(const float* row, int c, int C,
                                         int before, int after) {
  const int lo = max(0, c - before), hi = min(C - 1, c + after);
  float s = 0.0f;
  for (int j = lo; j <= hi; ++j) s += row[j];
  return s;
}

// Sums of depth 5's window [c - 2, c + 2] (its mirror is itself) for each
// of a thread's channels, from the padded neighbourhood (read_window)
__device__ __forceinline__ void window5(const float* w, float* s) {
#pragma unroll
  for (int e = 0; e < kSeg; ++e)
    s[e] = w[e + kPad - 2] + w[e + kPad - 1] + w[e + kPad] +
           w[e + kPad + 1] + w[e + kPad + 2];
}

// The window sums of a thread's channels c0 + e in a shared row (at its
// left padding): depth 5's unrolled, any other depth's clipped to [0, C)
// over [c - before, c + after]
template <int Depth>
__device__ __forceinline__ void windows(const float* row, int c0, int C,
                                        int before, int after, float* s) {
  if constexpr (Depth == 5) {
    float w[kSeg + 2 * kPad];
    read_window(row, c0, w);
    window5(w, s);
  } else {
#pragma unroll
    for (int e = 0; e < kSeg; ++e)
      s[e] = clipped(row + kPad, c0 + e, C, before, after);
  }
}

}  // namespace lrn
