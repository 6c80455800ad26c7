// decode_attention: one query token per (row, head) against the ring KV
// cache, computing the masked contraction of the ranker's decode step
// (repro/models/attention.py::attention_decode).
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// (decode_attention_bhd, body _decode_kernel), whose ring validity came in
// as an additive f32 bias (ops.ring_bias). Here the kernel builds the mask
// itself from pos (B,) and stored (B, W), as attention_decode does: slot j
// is live iff (j <= pos or pos >= W) and stored[j]. Scores are
// (q . k) * hd**-0.5 in f32; a dead slot's score is the finite -1e30.
// Probabilities stay f32 for the PV product.
//
// Layouts are the JAX package's: q (B, 1, nq, hd), k/v (B, W, nkv, hd),
// o like q; pos (B,) int32, stored (B, W) uint8. Query head h reads KV
// head h / g, g = nq / nkv.
//
// Bound on the H100: bytes, and only those of live slots. On the serving
// path (B = 256, W = 384, nkv = 8, hd = 32, bf16) a row holds ~37 live
// slots of 384: the tail of a left-padded prefill, a few injected tokens
// and the decode tokens. Their K/V rows are ~9.7 MB a launch, ~0.003 ms at
// 3.35 TB/s; the whole cache is 100.7 MB, ~0.030 ms.
//
// Design: one CTA of 8 warps per (row, block of hb KV heads), hb the most
// heads whose row of K (or V) fits kPitchMax bytes, so one live slot's K
// for the block is one contiguous run in device memory (512 B at the
// serving shape: a CTA per row, 256 CTAs).
//   liveness: the CTA reads pos[b] and stored[b, :] and writes the row's
//     live slot indices, in ring order, to a list in shared memory (4 slots
//     a thread, a shuffle scan of the counts), 1024 slots at a time;
//   staging: the K and V runs of 32 listed slots at a time come in by
//     16-byte cp.async into a ring of kStages stages, so the next 32 are in
//     flight while the current ones are scored; each 16-byte chunk is
//     placed at chunk ^ (slot & 7) within its row, so lanes reading one
//     chunk of 8 different slots hit 8 different banks;
//   QK: warp w serves query heads w, w + 8, ... of the block; lane j scores
//     slot j of the stage against q (f32, in shared memory, broadcast),
//     16 bytes of K at a time;
//   softmax and PV: an online softmax over stages (max and sum by warp
//     shuffles); the probabilities go through shared memory, and each lane
//     accumulates 32-bit words of V rows (lanes split the slots when a
//     head's row is narrower than 32 words, and the groups are summed at
//     the end).
// Dropping dead slots is exact when a row has a live one: exp(-1e30 - m)
// is 0 in f32. A row with no live slot gets the uniform average of V over
// all W slots, as the -1e30 mask gives it: a second pass lists every slot,
// stages V only, and scores each -1e30. On the model path the new token is
// written before it attends, so that pass never runs there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // attention_decode's finite mask value
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 32;                 // listed slots a stage, one per lane
constexpr int kStages = 2;                 // depth of the cp.async ring
constexpr int kPitchMax = 512;             // bytes of one slot's K run a CTA stages
constexpr int kListSlots = 4 * kThreads;   // ring slots listed in one pass
constexpr int kMaxHeadsPerWarp = 4;
constexpr int kMaxHeads = kWarps * kMaxHeadsPerWarp;  // query heads a CTA serves
constexpr int kMaxGroup = 16;              // query heads per KV head (ops.MAX_GROUP)

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

// the 16 / sizeof(T) elements of a 16-byte chunk, as f32
template <typename T> __device__ __forceinline__ void unpack16(uint4 r, float* out);
template <> __device__ __forceinline__ void unpack16<float>(uint4 r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 r, float* out) {
  const unsigned int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// the 4 / sizeof(T) elements of a 32-bit word, as f32
template <typename T> __device__ __forceinline__ void unpack4(uint32_t r, float* out);
template <> __device__ __forceinline__ void unpack4<float>(uint32_t r, float* out) {
  out[0] = __uint_as_float(r);
}
template <> __device__ __forceinline__ void unpack4<__nv_bfloat16>(uint32_t r, float* out) {
  out[0] = __uint_as_float(r << 16);
  out[1] = __uint_as_float(r & 0xffff0000u);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// KV heads a CTA serves: the largest power of two that is needed (< 2 nkv),
// whose K row fits kPitchMax bytes and whose query heads fit kMaxHeads
inline int heads_per_cta(int nkv, int g, int row_bytes) {
  int hb = 1;
  while (hb < nkv && 2 * hb * row_bytes <= kPitchMax && 2 * hb * g <= kMaxHeads) hb *= 2;
  return hb;
}

// dynamic shared memory: the K/V ring, q, the warps' probabilities, the
// live list and the scan's warp totals
inline size_t smem_bytes(int hb, int g, int hd, int es) {
  return (size_t)kStages * 2 * kSlots * hb * hd * es + (size_t)hb * g * hd * 4
      + (size_t)kWarps * kSlots * 4 + (size_t)kListSlots * 4 + kWarps * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, const uint8_t* __restrict__ stored,
    T* __restrict__ o, int w, int nq, int nkv, int hb, float scale) {
  constexpr int ES = sizeof(T);
  constexpr int VEC = 16 / ES;                        // elements a 16-byte chunk
  constexpr int CH = HD * ES / 16;                    // chunks of one head's row
  constexpr int WPH = HD * ES / 4;                    // 32-bit words of one head's row
  constexpr int KS = WPH < 32 ? 32 / WPH : 1;         // PV slot groups a warp
  constexpr int WPL = WPH > 32 ? WPH / 32 : 1;        // PV words a lane
  constexpr int EPW = 4 / ES;                         // elements a word
  constexpr int APL = WPL * EPW;                      // PV accumulators a lane

  extern __shared__ __align__(16) unsigned char smem[];
  const int g = nq / nkv;
  const int pitch = hb * HD * ES;                     // bytes of a staged K (or V) row
  const int stage_bytes = 2 * kSlots * pitch;
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  float* p_s = q_s + hb * g * HD;
  int* list = reinterpret_cast<int*>(p_s + kWarps * kSlots);
  int* warp_tot = list + kListSlots;

  const int b = blockIdx.x, kv0 = blockIdx.y * hb;
  const int nh = min(hb, nkv - kv0), nqh = nh * g;    // KV and query heads here
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int swz = min(8, pitch / 16) - 1;             // chunk swizzle mask
  const int rc = nh * CH;                             // chunks of a slot's run

  const T* qb = q + ((size_t)b * nq + (size_t)kv0 * g) * HD;
  for (int e = threadIdx.x; e < nqh * HD; e += kThreads) q_s[e] = to_f32(qb[e]);
  const int p = pos[b];
  const int live_end = p >= w ? w : min(w, p + 1);    // slots at or past it are dead
  const uint8_t* st_row = stored + (size_t)b * w;
  const size_t row0 = (size_t)b * w;

  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp], acc[kMaxHeadsPerWarp][APL];
#pragma unroll
  for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < APL; ++a) acc[i][a] = 0.f;
  }
  const int kg = lane / (WPH < 32 ? WPH : 32);        // this lane's PV slot group
  const int wi = lane % (WPH < 32 ? WPH : 32);        // and its first word

  int total_live = 0;
  // pass 0 visits the live slots; pass 1 only runs for a row with none and
  // visits every slot with the score -1e30 (the uniform mean of V)
  for (int pass = 0; pass < 2; ++pass) {
    const bool dead = pass == 1;
    if (dead && total_live > 0) break;
    const int end = dead ? w : live_end;
    for (int c0 = 0; c0 < end; c0 += kListSlots) {
      // the listed slots of [c0, c0 + kListSlots), in ring order
      int bits = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // stored is read before pos is known
        const int j = c0 + 4 * threadIdx.x + r;
        const bool s = j < w && st_row[j];
        if (j < end && (dead || s)) bits |= 1 << r;
      }
      const int cnt = __popc(bits);
      int x = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) warp_tot[warp] = x;
      __syncthreads();  // also: q_s is written
      int n = 0, at = x - cnt;
      for (int u = 0; u < kWarps; ++u) {
        const int t = warp_tot[u];
        if (u < warp) at += t;
        n += t;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (bits >> r & 1) list[at++] = c0 + 4 * threadIdx.x + r;
      __syncthreads();
      if (!dead) total_live += n;
      if (n == 0) continue;

      const int nst = (n + kSlots - 1) / kSlots;
      // stage s: the K (not in the dead pass) and V runs of listed slots
      // [s * kSlots, s * kSlots + ne) into ring stage s % kStages
      auto load_stage = [&](int s) {
        const int e0 = s * kSlots, ne = min(kSlots, n - e0);
        unsigned char* kbuf = ring + (s % kStages) * stage_bytes;
        unsigned char* vbuf = kbuf + kSlots * pitch;
        const int per = ne * rc;
        for (int c = threadIdx.x; c < (dead ? per : 2 * per); c += kThreads) {
          const bool is_v = dead || c >= per;
          const int cc = c >= per ? c - per : c;
          const int e = cc / rc, ch = cc - e * rc;
          const size_t src = ((row0 + list[e0 + e]) * nkv + kv0) * HD;
          const unsigned char* from =
              reinterpret_cast<const unsigned char*>((is_v ? v : k) + src) + ch * 16;
          cp_async16((is_v ? vbuf : kbuf) + e * pitch + ((ch ^ (e & swz)) * 16), from);
        }
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nst) load_stage(s);
        cp_async_commit();
      }
      for (int s = 0; s < nst; ++s) {
        if (s + kStages - 1 < nst) load_stage(s + kStages - 1);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();

        const int ne = min(kSlots, n - s * kSlots);
        const unsigned char* kbuf = ring + (s % kStages) * stage_bytes;
        const unsigned char* vbuf = kbuf + kSlots * pitch;
        float* pw = p_s + warp * kSlots;
#pragma unroll
        for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
          const int h = warp + i * kWarps;
          if (h >= nqh) break;  // warp-uniform
          const int kvl = h / g;
          float sc = neg_inf();
          if (lane < ne) {
            if (dead) {
              sc = kNegInf;
            } else {
              const unsigned char* krow = kbuf + lane * pitch;
              const float4* q4 = reinterpret_cast<const float4*>(q_s + h * HD);
              float d0 = 0.f, d1 = 0.f;
#pragma unroll
              for (int c = 0; c < CH; ++c) {
                const uint4 r = *reinterpret_cast<const uint4*>(
                    krow + (((kvl * CH + c) ^ (lane & swz)) * 16));
                float kx[VEC];
                unpack16<T>(r, kx);
#pragma unroll
                for (int t = 0; t < VEC; t += 4) {
                  const float4 qv = q4[(c * VEC + t) / 4];
                  d0 += qv.x * kx[t];
                  d1 += qv.y * kx[t + 1];
                  d0 += qv.z * kx[t + 2];
                  d1 += qv.w * kx[t + 3];
                }
              }
              sc = (d0 + d1) * scale;
            }
          }
          const float m_new = fmaxf(m[i], warp_max(sc));
          const float alpha = expf(m[i] - m_new);
          const float pj = expf(sc - m_new);
          l[i] = l[i] * alpha + warp_sum(pj);
          m[i] = m_new;
          pw[lane] = pj;
          __syncwarp();
#pragma unroll
          for (int a = 0; a < APL; ++a) acc[i][a] *= alpha;
          for (int jj = kg; jj < ne; jj += KS) {
            const float pr = pw[jj];
            const unsigned char* vrow = vbuf + jj * pitch;
#pragma unroll
            for (int u = 0; u < WPL; ++u) {
              const int byte = (wi + 32 * u) * 4;
              const int ch = kvl * CH + byte / 16;
              const uint32_t word = *reinterpret_cast<const uint32_t*>(
                  vrow + ((ch ^ (jj & swz)) * 16) + (byte & 15));
              float vx[EPW];
              unpack4<T>(word, vx);
#pragma unroll
              for (int f = 0; f < EPW; ++f) acc[i][u * EPW + f] += pr * vx[f];
            }
          }
          __syncwarp();  // pw is rewritten by the next head
        }
        __syncthreads();  // the stage just read is the next one written
      }
      cp_async_wait<0>();
    }
  }

  T* ob = o + ((size_t)b * nq + (size_t)kv0 * g) * HD;
#pragma unroll
  for (int i = 0; i < kMaxHeadsPerWarp; ++i) {
    const int h = warp + i * kWarps;
    if (h >= nqh) break;
#pragma unroll
    for (int a = 0; a < APL; ++a) {
      float x = acc[i][a];
#pragma unroll
      for (int off = WPH; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      acc[i][a] = x / l[i];
    }
    if (kg == 0) {
#pragma unroll
      for (int u = 0; u < WPL; ++u)
#pragma unroll
        for (int f = 0; f < EPW; ++f)
          ob[h * HD + (wi + 32 * u) * EPW + f] = from_f32<T>(acc[i][u * EPW + f]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* stored, void* o, int b, int w, int nq, int nkv,
           float scale, cudaStream_t stream) {
  const int g = nq / nkv;
  const int hb = heads_per_cta(nkv, g, HD * (int)sizeof(T));
  const size_t smem = smem_bytes(hb, g, HD, sizeof(T));
  auto kernel = decode_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, (nkv + hb - 1) / hb);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos,
      (const uint8_t*)stored, (T*)o, w, nq, nkv, hb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* pos, const void* stored, void* o, int b, int w,
              int nq, int nkv, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pos, stored, o, b, w, nq, nkv, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
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
  return is_bf16
      ? launch_hd<__nv_bfloat16>(hd, q, k, v, pos, stored, o, b, w, nq, nkv, scale, st)
      : launch_hd<float>(hd, q, k, v, pos, stored, o, b, w, nq, nkv, scale, st);
}
