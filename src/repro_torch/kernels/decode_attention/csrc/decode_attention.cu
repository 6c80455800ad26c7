// decode_attention: one query token per (row, head) against the ring KV
// cache, with an online softmax, computing the masked contraction of the
// ranker's decode step (repro/models/attention.py::attention_decode).
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// (decode_attention_bhd, body _decode_kernel), whose ring validity came in
// as an additive f32 bias (ops.ring_bias). Here the kernel builds the mask
// itself from pos (B,) and stored (B, W), as attention_decode does: slot j
// is live iff (j <= pos or pos >= W) and stored[j]. Scores are
// (q . k) * hd**-0.5 in f32; a dead slot's score is the finite -1e30, so a
// row with no live slot would get the uniform average of V (on the model
// path the new token is written before it attends, so every row has one).
// Probabilities stay f32 for the PV product.
//
// Layouts are the JAX package's: q (B, 1, nq, hd), k/v (B, W, nkv, hd),
// o like q; pos (B,) int32, stored (B, W) uint8. Query head h reads KV
// head h / g, g = nq / nkv.
//
// Bound on the H100: bytes. One query streams the whole cache: at the
// serving shape (B = 256, W = 384, nkv = 8, hd = 32) the bf16 K/V are
// 100.7 MB per launch, about 0.030 ms at 3.35 TB/s, against ~50 MFLOP.
//
// Design (simple first; splitting W over CTAs, flash-decoding, is later
// work): one CTA of 4 warps per (KV head, row), so the g query heads of a
// group share every K/V tile. The CTA stages S tiles of 32 keys at a time
// in shared memory with 16-byte loads (the wrapper checks the alignment),
// converted to f32, rows padded by one float so that lane j reading key j
// is free of bank conflicts. Each warp owns one
// (query head, tile) pair at a time: lane j scores key j, the warp
// reduces max and sum with shuffles, and for the PV product lane d holds
// output dims d, d + 32, ... . With g < 4 the warps split the keys (S > 1)
// and their partial (m, l, acc) are merged through shared memory at the
// end; with g >= 4 each warp carries up to 4 heads across all tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // attention_decode's finite mask value
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;          // keys per warp tile (one per lane)
constexpr int kMaxHeadsPerWarp = 4;
constexpr int kMaxGroup = kWarps * kMaxHeadsPerWarp;
constexpr int kStageBytes = 36 * 1024;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// the VEC = 16 / sizeof(T) elements of a 16-byte load, as f32
template <typename T> __device__ __forceinline__ void unpack(uint4 r, float* out);
template <> __device__ __forceinline__ void unpack<float>(uint4 r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 r, float* out) {
  const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
struct Shape {
  static constexpr int RS = HD + 1;               // padded f32 row stride
  static constexpr int TILE_FLOATS = kTile * RS;  // one 32-key tile of K (or V)
  // tiles of 32 keys staged at once (K and V, f32), at most kWarps
  static constexpr int SMAX_RAW = kStageBytes / (2 * TILE_FLOATS * 4);
  static constexpr int SMAX = SMAX_RAW < 1 ? 1 : (SMAX_RAW > kWarps ? kWarps : SMAX_RAW);
  static constexpr int DPL = (HD + 31) / 32;      // output dims per lane
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, const uint8_t* __restrict__ stored,
    T* __restrict__ o, int w, int nq, int nkv, float scale) {
  using L = Shape<HD>;
  __shared__ float ks[L::SMAX * L::TILE_FLOATS];
  __shared__ float vs[L::SMAX * L::TILE_FLOATS];
  __shared__ float qs[kMaxGroup * HD];
  __shared__ int live_s[L::SMAX * kTile];  // 1 live, 0 dead, -1 past W

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = nq / nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // S tiles per step: warps split the keys when the group has < 4 heads
  const int S = max(1, min(L::SMAX, kWarps / g));
  const int split = S > 1 ? warp / g : 0;

  // the heads this warp owns (index within the group, -1 = none)
  int heads[kMaxHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
    int h = -1;
    if (S > 1) {
      if (i == 0 && warp < g * S) h = warp % g;
    } else if (warp + i * kWarps < g) {
      h = warp + i * kWarps;
    }
    heads[i] = h;
  }

  const size_t qbase = ((size_t)b * nq + (size_t)kvh * g) * HD;
  for (int e = threadIdx.x; e < g * HD; e += kThreads) qs[e] = to_f32(q[qbase + e]);
  const int p = pos[b];
  const bool wrapped = p >= w;

  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp], acc[kMaxHeadsPerWarp][L::DPL];
#pragma unroll
  for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::DPL; ++c) acc[i][c] = 0.f;
  }

  constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int CPR = HD / VEC;         // 16-byte chunks in a key row
  const int step = S * kTile;
  for (int k0 = 0; k0 < w; k0 += step) {
    __syncthreads();  // the previous tiles are consumed (and qs is written)
    for (int c = threadIdx.x; c < step * CPR; c += kThreads) {
      const int j = c / CPR, d0 = (c % CPR) * VEC, key = k0 + j;
      float kx[VEC], vx[VEC];
      if (key < w) {
        const size_t off = (((size_t)b * w + key) * nkv + kvh) * HD + d0;
        unpack<T>(*reinterpret_cast<const uint4*>(k + off), kx);
        unpack<T>(*reinterpret_cast<const uint4*>(v + off), vx);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[j * L::RS + d0 + i] = kx[i];
        vs[j * L::RS + d0 + i] = vx[i];
      }
    }
    for (int j = threadIdx.x; j < step; j += kThreads) {
      const int key = k0 + j;
      live_s[j] = key >= w ? -1
                           : ((key <= p || wrapped) && stored[(size_t)b * w + key] ? 1 : 0);
    }
    __syncthreads();

    const int j = split * kTile + lane;  // this lane's key within the step
    const float* krow = ks + j * L::RS;
    const float* vt = vs + split * kTile * L::RS;
    const int lv = heads[0] >= 0 ? live_s[j] : 0;  // an idle warp's j may pass the step
#pragma unroll
    for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
      const int h = heads[i];
      if (h < 0) continue;  // warp-uniform
      const float* qh = qs + h * HD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qh[d] * krow[d];
      const float s = lv < 0 ? neg_inf() : (lv ? dot * scale : kNegInf);
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float pj = expf(s - m_new);
      l[i] = l[i] * alpha + warp_sum(pj);
#pragma unroll
      for (int c = 0; c < L::DPL; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < kTile; ++jj) {
        const float pjj = __shfl_sync(0xffffffffu, pj, jj);
#pragma unroll
        for (int c = 0; c < L::DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) acc[i][c] += pjj * vt[jj * L::RS + d];
        }
      }
      m[i] = m_new;
    }
  }

  const size_t obase = ((size_t)b * nq + (size_t)kvh * g) * HD;
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
      const int h = heads[i];
      if (h < 0) continue;
#pragma unroll
      for (int c = 0; c < L::DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) o[obase + h * HD + d] = from_f32<T>(acc[i][c] / l[i]);
      }
    }
    return;
  }

  // merge the S key splits of each head: partial states go through the
  // (now free) K staging buffer, laid out [warp][HD + 2]
  __syncthreads();
  float* part = ks;
  const int PS = HD + 2;
  if (heads[0] >= 0) {
#pragma unroll
    for (int c = 0; c < L::DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) part[warp * PS + d] = acc[0][c];
    }
    if (lane == 0) {
      part[warp * PS + HD] = m[0];
      part[warp * PS + HD + 1] = l[0];
    }
  }
  __syncthreads();
  if (heads[0] < 0 || split != 0) return;
  // warp h (split 0) merges warps h, h + g, ..., h + (S-1) g
  float mm = kNegInf;
  for (int s2 = 0; s2 < S; ++s2) mm = fmaxf(mm, part[(warp + s2 * g) * PS + HD]);
  float ll = 0.f, out[L::DPL];
#pragma unroll
  for (int c = 0; c < L::DPL; ++c) out[c] = 0.f;
  for (int s2 = 0; s2 < S; ++s2) {
    const float* ps = part + (warp + s2 * g) * PS;
    const float f = expf(ps[HD] - mm);
    ll += ps[HD + 1] * f;
#pragma unroll
    for (int c = 0; c < L::DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) out[c] += ps[d] * f;
    }
  }
#pragma unroll
  for (int c = 0; c < L::DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < HD) o[obase + heads[0] * HD + d] = from_f32<T>(out[c] / ll);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* pos,
            const void* stored, void* o, int b, int w, int nq, int nkv,
            float scale, cudaStream_t stream) {
  const dim3 grid(nkv, b);
  decode_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos,
      (const uint8_t*)stored, (T*)o, w, nq, nkv, scale);
}

template <typename T>
bool launch_hd(int hd, const void* q, const void* k, const void* v,
               const void* pos, const void* stored, void* o, int b, int w,
               int nq, int nkv, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream); return true;
    case 32: launch<T, 32>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream); return true;
    case 64: launch<T, 64>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream); return true;
    case 128: launch<T, 128>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream); return true;
  }
  return false;
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* stored, void* o, int b, int w, int nq, int nkv, int hd,
    float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nkv <= 0 || nq % nkv || nq / nkv > kMaxGroup) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool ok = is_bf16
      ? launch_hd<__nv_bfloat16>(hd, q, k, v, pos, stored, o, b, w, nq, nkv, scale, st)
      : launch_hd<float>(hd, q, k, v, pos, stored, o, b, w, nq, nkv, scale, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
