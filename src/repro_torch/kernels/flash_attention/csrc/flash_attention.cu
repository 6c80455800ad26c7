// flash_attention: masked GQA attention with an online softmax, computing
// what the ranker's attention (repro/models/attention.py::attention_full)
// computes.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_bhsd, body _flash_kernel), widened to attention_full's
// masks: key j is attendable from query i iff qpos[i] >= kpos[j], then
// qpos[i] - kpos[j] < window when the config has a window, then kvalid[j].
// Scores are (q . k) * hd**-0.5 in f32; a masked score is the finite
// -1e30, so a query row with no attendable key gets the uniform average
// of V over all Sk keys, as attention_full gives it. Every key tile is
// visited (no dead-block skip, which would change that row) and keys past
// Sk get -inf, so they carry no weight at all. Sk may exceed Sq.
//
// Layouts are the JAX package's: q (B, Sq, nq, hd), k/v (B, Sk, nkv, hd),
// o like q; qpos (B, Sq) int32, kpos/kvalid (B, Sk) int32/uint8. Query head
// h reads KV head h / (nq / nkv).
//
// Bound on the H100 at the ranker's shapes (B = S = 256, 8 heads, hd = 32):
// bytes in bf16 (~134 MB of q/k/v/o against ~9 GFLOP of live products),
// operations in fp32 (no tensor-core rate applies to exact f32 products).
//
// Design (simple first; wgmma/TMA are later work): one CTA of 128 threads
// per (q-tile, head, batch row). Each query row is owned by TPR = hd / C
// adjacent threads holding C = min(hd, 32) dims of q and of the f32
// accumulator in registers. K and V stream through shared memory in tiles
// of BK = 32 keys, converted to f32 once. A thread reads each key row as
// float4s; the float4 groups of each thread's chunk are rotated by the
// chunk index so the TPR lanes of a row hit distinct banks, and every
// other lane reads the same address (a broadcast). Partial dot products
// are summed across the TPR lanes with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // attention_full's finite mask value
constexpr int kThreads = 128;
constexpr int kBK = 32;

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

template <int HD>
struct Tile {
  static constexpr int C = HD < 32 ? HD : 32;  // dims per thread
  static constexpr int TPR = HD / C;           // threads per query row
  static constexpr int G = C / 4;              // float4 groups per thread
  static constexpr int BQ = kThreads / TPR;    // query rows per CTA
  // shared-memory float4 slot of float4 group gq of a key row
  __device__ static __forceinline__ int slot(int gq) {
    const int chunk = gq / G;
    return chunk * G + (gq % G + chunk) % G;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const uint8_t* __restrict__ kvalid, T* __restrict__ o, int sq, int sk,
    int nq, int nkv, int window, float scale) {
  using L = Tile<HD>;
  __shared__ float4 ks[kBK * HD / 4];
  __shared__ float4 vs[kBK * HD / 4];
  __shared__ int s_kpos[kBK];
  __shared__ int s_kok[kBK];  // 1 attendable-if-in-window, 0 invalid, -1 past Sk

  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (nq / nkv);
  const int r = threadIdx.x / L::TPR, t = threadIdx.x % L::TPR;
  const int qi = blockIdx.x * L::BQ + r;
  const bool row_ok = qi < sq;

  float qr[L::C], acc[L::C];
  const size_t qoff = (((size_t)b * sq + qi) * nq + h) * HD + t * L::C;
#pragma unroll
  for (int c = 0; c < L::C; ++c) {
    qr[c] = row_ok ? to_f32(q[qoff + c]) : 0.f;
    acc[c] = 0.f;
  }
  const int my_pos = row_ok ? qpos[(size_t)b * sq + qi] : 0;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int e = threadIdx.x; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < sk) {
        const size_t off = (((size_t)b * sk + key) * nkv + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      const int at = j * HD + L::slot(d / 4) * 4 + d % 4;
      kf[at] = kx;
      vf[at] = vx;
    }
    for (int j = threadIdx.x; j < kBK; j += kThreads) {
      const int key = k0 + j;
      s_kpos[j] = key < sk ? kpos[(size_t)b * sk + key] : 0;
      s_kok[j] = key < sk ? (kvalid[(size_t)b * sk + key] != 0) : -1;
    }
    __syncthreads();

    float s[kBK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < L::G; ++g) {
        const float4 kk = ks[j * HD / 4 + L::slot(t * L::G + g)];
        dot += qr[4 * g] * kk.x + qr[4 * g + 1] * kk.y + qr[4 * g + 2] * kk.z +
               qr[4 * g + 3] * kk.w;
      }
#pragma unroll
      for (int off = L::TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int ok = s_kok[j], kp = s_kpos[j];
      const bool live = ok == 1 && my_pos >= kp && (window <= 0 || my_pos - kp < window);
      s[j] = ok < 0 ? neg_inf() : (live ? dot * scale : kNegInf);
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < L::C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int g = 0; g < L::G; ++g) {
        const float4 vv = vs[j * HD / 4 + L::slot(t * L::G + g)];
        acc[4 * g] += p * vv.x;
        acc[4 * g + 1] += p * vv.y;
        acc[4 * g + 2] += p * vv.z;
        acc[4 * g + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
#pragma unroll
    for (int c = 0; c < L::C; ++c) o[qoff + c] = from_f32<T>(acc[c] / l);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* qpos,
            const void* kpos, const void* kvalid, void* o, int b, int sq,
            int sk, int nq, int nkv, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((sq + Tile<HD>::BQ - 1) / Tile<HD>::BQ, nq, b);
  flash_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos, (const int*)kpos,
      (const uint8_t*)kvalid, (T*)o, sq, sk, nq, nkv, window, scale);
}

template <typename T>
bool launch_hd(int hd, const void* q, const void* k, const void* v,
               const void* qpos, const void* kpos, const void* kvalid, void* o,
               int b, int sq, int sk, int nq, int nkv, int window, float scale,
               cudaStream_t stream) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream); return true;
    case 32: launch<T, 32>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream); return true;
    case 64: launch<T, 64>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream); return true;
    case 128: launch<T, 128>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream); return true;
  }
  return false;
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, const void* kvalid, void* o, int b, int sq, int sk,
    int nq, int nkv, int hd, int window, float scale, int is_bf16, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool ok = is_bf16
      ? launch_hd<__nv_bfloat16>(hd, q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, st)
      : launch_hd<float>(hd, q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
