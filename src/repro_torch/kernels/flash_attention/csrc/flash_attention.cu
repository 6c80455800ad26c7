// flash_attention: masked GQA attention with an online softmax, computing
// what the ranker's attention (repro/models/attention.py::attention_full)
// computes.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention_bhsd, body _flash_kernel), widened to attention_full's
// masks: key j is attendable from query i iff qpos[i] >= kpos[j], then
// qpos[i] - kpos[j] < window when the config has a window, then kvalid[j].
// Scores are (q . k) * hd**-0.5 in f32. A masked score is the finite -1e30
// in the reference, so a query row with no attendable key gets the uniform
// average of V over all Sk keys. Sk may exceed Sq.
//
// Layouts are the JAX package's: q (B, Sq, nq, hd), k/v (B, Sk, nkv, hd),
// o like q; qpos (B, Sq) int32, kpos/kvalid (B, Sk) int32/uint8. Query head
// h reads KV head h / (nq / nkv).
//
// What bounds it on the H100: bytes. On the ranker's paths a row holds ~32
// real tokens of 256, left-padded, so most query rows have no live key and
// most (query tile, key tile) pairs are dead; the live products are a few
// GFLOP against 989 TFLOP/s, while O alone is 33.5 MB at the prefill shape.
// The design therefore moves as few bytes as it can and keeps the live
// arithmetic on tensor cores:
//
// - One CTA per (b, KV head) serves every query head of that KV head and
//   every query tile, so K and V are read from device memory once. When
//   K+V fit in shared memory (Sk 256 at hd 32 is 40 KB in bf16), they are
//   staged, as they are stored, with 16-byte cp.async copies: K and V of
//   the key tiles that hold a valid key, and V whole where a query row may
//   have no live key. Otherwise each warp streams the key tiles it needs
//   through its own two-stage cp.async ring.
// - Work is cut into items of 16 query rows of one head; each warp takes
//   items in turn. Each key tile's statistics (min and max valid position,
//   mask of valid keys) are computed once per CTA, so a warp finds an
//   item's next live tile by testing 32 tiles at once. For each (item, key
//   tile of 32 keys) the tile is skipped
//   when no pair in it is live: no valid key, min(kpos of valid keys) >
//   max(qpos), or (window > 0) max(kpos of valid keys) <= min(qpos) -
//   window. Min and max, not first and last slot, since positions come
//   from the caller. For a row with a live key the skip is exact: a
//   masked key's weight is exactly 0 in the reference's f32 softmax, and
//   here a masked key gets p = 0.
// - Each row tracks whether it has seen a live key. A row that has not
//   gets mean(V over all Sk keys) of its KV head, computed once per CTA in
//   f32: the reference's uniform softmax over -1e30. An item whose key
//   tiles are all dead reads no Q and no K and writes that mean. The CTA
//   first checks whether any row can be dead (without a window: a query
//   position below every valid key's); if none can, V is read only where
//   keys are valid and no mean is computed.
// - bf16: QK^T and PV are mma.sync.m16n8k16 bf16 products into f32
//   accumulators, K and V fragments by ldmatrix (V transposed); P enters PV
//   rounded to bf16, as the reference rounds its probabilities to v's type.
//   mma.sync rather than wgmma: the live work is a few 16x32 tiles per
//   item, and wgmma's 64-row tiles would multiply the dead rows it covers.
//   Rows in shared memory are padded by 16 bytes so that the eight rows an
//   ldmatrix phase reads fall on distinct banks. A tile whose pairs are
//   all live skips the mask. O goes out through shared memory as 16-byte
//   stores of whole rows.
// - fp32: exact f32 CUDA-core arithmetic (no TF32), two lanes a row, with
//   the same items, skip and dead-row mean.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // attention_full's finite mask value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBK = 32;            // keys per tile: one per lane
constexpr int kBQ = 16;            // query rows per work item
constexpr int kWarps = 4;
constexpr int kMeanGroups = 4;     // partial sums per dim of the V mean
constexpr int kMaxSmem = 232448;   // opt-in shared memory per block, sm_90

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------
// cp.async, ldmatrix and mma.sync
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing subnormal results to 0 (p values far below bf16's reach)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ bool attends(int kp, int qp, int window) {
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// Key tile of 32 keys as an item sees it.
struct KeyTile {
  const int* kpos;  // the 32 keys' positions, in shared memory
  unsigned valid;   // bit j: key j is a valid key (and below Sk)
  bool full;        // every (row, key) pair of the item is live
};

// kmin/kmax: the min and max position of the tile's valid keys.
__device__ __forceinline__ bool tile_live(int kmin, int kmax, int qmin, int qmax,
                                          int window) {
  return kmin <= qmax && !(window > 0 && (long long)kmax <= (long long)qmin - window);
}
__device__ __forceinline__ bool tile_full(unsigned valid, int kmin, int kmax, int qmin,
                                          int qmax, int window) {
  return valid == kFull && kmax <= qmin &&
         (window <= 0 || (long long)qmax - kmin < window);
}

// ---------------------------------------------------------------------
// One work item: 16 query rows of one head against the live key tiles.
// ---------------------------------------------------------------------

// bf16 on tensor cores. Lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of the item in the mma fragment layout. Scores are kept unscaled;
// the scale and log2(e) go into one FMA before exp2.
template <int HD>
struct MmaItem {
  using T = __nv_bfloat16;
  // K/V rows in shared memory are padded by 16 bytes, so that the 8 rows
  // an ldmatrix phase reads (16 bytes each) fall on distinct banks
  static constexpr int ROW = HD + 8;
  static constexpr int STAGE = kBQ * ROW;  // O staging per warp, elements
  static constexpr int CPR = HD / 8;       // 16-byte chunks per row
  static constexpr int KS = HD / 16;       // k-steps of QK^T
  static constexpr int ND = HD / 8;        // n-tiles of O
  static constexpr int NS = kBK / 8;       // n-tiles of S
  // element offset of 16-byte chunk c of row r
  __device__ static __forceinline__ int at(int r, int c) { return r * ROW + 8 * c; }
  uint32_t qf[KS][4];
  float acc[ND][4];
  float m[2], l[2];
  bool seen[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) { m[h] = kNegInf; l[h] = 0.f; seen[h] = false; }
  }

  __device__ __forceinline__ void load_q(const T* q, size_t rs, int row0, int sq,
                                         int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      const T* p = q + (size_t)r * rs + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qf[kk][h] = r < sq ? *reinterpret_cast<const uint32_t*>(p + 16 * kk) : 0u;
        qf[kk][2 + h] = r < sq ? *reinterpret_cast<const uint32_t*>(p + 16 * kk + 8) : 0u;
      }
    }
  }

  __device__ __forceinline__ void tile(const T* ks, const T* vs, const KeyTile& key,
                                       int qp_lane, int window, float scale2, int lane) {
    const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // S = Q K^T: ldmatrix x4 gives the B fragments of two n-tiles
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, ks + at(16 * jp + (mat >> 1) * 8 + r8, 2 * kk + (mat & 1)));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    // the mask: a masked score becomes -inf, so that its p is exactly 0;
    // live[h] records whether row g + 8h has a live key in this tile
    bool live[2] = {true, true};
    if (!key.full) {
      const int qp[2] = {__shfl_sync(kFull, qp_lane, g), __shfl_sync(kFull, qp_lane, g + 8)};
      live[0] = live[1] = false;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int2 kp = *reinterpret_cast<const int2*>(key.kpos + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (key.valid >> (8 * j + 2 * t + e)) & 1u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool lv = ok && attends(e ? kp.y : kp.x, qp[h], window);
            live[h] |= lv;
            if (!lv) s[j][2 * h + e] = -INFINITY;
          }
        }
      }
    }
    // the online softmax in the log2 domain
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
      const float m_new = fmaxf(m[h], tmax * scale2);
      const float alpha = ex2(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * h + e];
          x = ex2(fmaf(x, scale2, -m_new));  // -inf gives 0
          sum += x;
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[d][2 * h] *= alpha;
        acc[d][2 * h + 1] *= alpha;
      }
      int any = live[h];
      any |= __shfl_xor_sync(kFull, any, 1);
      any |= __shfl_xor_sync(kFull, any, 2);
      seen[h] |= any != 0;
    }
    // O += P V, P in bf16 as the A operand straight from the S fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + at(16 * kk + (mat & 1) * 8 + r8, 2 * dp + (mat >> 1)));
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // O through the warp's staging rows, then 16-byte stores of whole rows.
  __device__ __forceinline__ void store(T* o, size_t rs, int row0, int sq,
                                        const float* mean, T* stage, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lsum = l[h] + __shfl_xor_sync(kFull, l[h], 1);
      lsum += __shfl_xor_sync(kFull, lsum, 2);
      const bool any = seen[h];
      T* p = stage + (g + 8 * h) * ROW;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int c = 8 * d + 2 * t;
        const float x0 = any ? acc[d][2 * h] / lsum : mean[c];
        const float x1 = any ? acc[d][2 * h + 1] / lsum : mean[c + 1];
        *reinterpret_cast<__nv_bfloat162*>(p + c) = __floats2bfloat162_rn(x0, x1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < kBQ * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      if (row0 + r < sq)
        *reinterpret_cast<uint4*>(o + (size_t)(row0 + r) * rs + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + r * ROW + 8 * c);
    }
    __syncwarp();  // the staging rows are reused by the next item
  }
};

// fp32 on CUDA cores, exact f32. Lane pair (2r, 2r + 1) holds row r; lane
// half h owns the float4 groups 2c + h of the row, so the two lanes of a
// row read distinct banks and the 16 rows read the same key (broadcast).
template <int HD>
struct FmaItem {
  using T = float;
  static constexpr int ROW = HD + 4;  // K/V row in shared memory, padded
  __device__ static __forceinline__ int at(int r, int c) { return r * ROW + 4 * c; }
  static constexpr int STAGE = 0;   // stores whole float4s directly
  static constexpr int G = HD / 8;  // float4 groups per lane
  float qr[4 * G], acc[4 * G];
  float m, l;
  bool seen;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[c] = 0.f;
    m = kNegInf;
    l = 0.f;
    seen = false;
  }

  __device__ __forceinline__ void load_q(const T* q, size_t rs, int row0, int sq,
                                         int lane) {
    const int r = row0 + (lane >> 1), h = lane & 1;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float4 x = r < sq ? *reinterpret_cast<const float4*>(q + (size_t)r * rs + 4 * (2 * c + h))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * c] = x.x; qr[4 * c + 1] = x.y; qr[4 * c + 2] = x.z; qr[4 * c + 3] = x.w;
    }
  }

  __device__ __forceinline__ void tile(const T* ks, const T* vs, const KeyTile& key,
                                       int qp_lane, int window, float scale, int lane) {
    const int h = lane & 1;
    const int qp = __shfl_sync(kFull, qp_lane, lane >> 1);
    float s[kBK];
    unsigned live = 0;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + at(j, 2 * c + h));
        dot += qr[4 * c] * kk.x + qr[4 * c + 1] * kk.y + qr[4 * c + 2] * kk.z +
               qr[4 * c + 3] * kk.w;
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      s[j] = dot * scale;
      if (key.full || (((key.valid >> j) & 1u) && attends(key.kpos[j], qp, window))) {
        live |= 1u << j;
        tmax = fmaxf(tmax, s[j]);
      }
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = (live >> j) & 1u ? expf(s[j] - m) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + at(j, 2 * c + h));
        acc[4 * c] += p * vv.x;
        acc[4 * c + 1] += p * vv.y;
        acc[4 * c + 2] += p * vv.z;
        acc[4 * c + 3] += p * vv.w;
      }
    }
    seen |= live != 0;
  }

  __device__ __forceinline__ void store(T* o, size_t rs, int row0, int sq,
                                        const float* mean, T*, int lane) {
    const int r = row0 + (lane >> 1), h = lane & 1;
    if (r >= sq) return;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int d = 4 * (2 * c + h);
      const float4 x = seen ? make_float4(acc[4 * c] / l, acc[4 * c + 1] / l,
                                          acc[4 * c + 2] / l, acc[4 * c + 3] / l)
                            : make_float4(mean[d], mean[d + 1], mean[d + 2], mean[d + 3]);
      *reinterpret_cast<float4*>(o + (size_t)r * rs + d) = x;
    }
  }
};

template <typename T, int HD> struct ItemOf;
template <int HD> struct ItemOf<__nv_bfloat16, HD> { using type = MmaItem<HD>; };
template <int HD> struct ItemOf<float, HD> { using type = FmaItem<HD>; };

// ---------------------------------------------------------------------
// Key tiles: metadata, liveness, copies
// ---------------------------------------------------------------------

// Lane j reads key kt * 32 + j: whether it is a valid key, and its position
// (0 for a key past Sk).
__device__ __forceinline__ void key_meta(const int* kpos, const uint8_t* kvalid, int sk,
                                         int kt, int lane, int& kp, bool& ok) {
  const int key = kt * kBK + lane;
  const bool in = key < sk;
  kp = in ? kpos[key] : 0;  // both loads issued together
  ok = in && kvalid[key] != 0;
}

// {min, max position of the valid keys, mask of valid keys} of the tile
// whose metadata the lanes hold.
__device__ __forceinline__ int4 tile_stats(int kp, bool ok) {
  return make_int4(__reduce_min_sync(kFull, ok ? kp : INT_MAX),
                   __reduce_max_sync(kFull, ok ? kp : INT_MIN),
                   (int)__ballot_sync(kFull, ok), 0);
}

// Resident K/V: the first live tile at or after kt (nkt if none), the
// lanes testing 32 tiles' statistics at a time.
__device__ __forceinline__ int next_live(int kt, int nkt, const int4* stats, int qmin,
                                         int qmax, int window, int lane) {
  for (; kt < nkt; kt += 32) {
    bool live = false;
    if (kt + lane < nkt) {
      const int4 st = stats[kt + lane];
      live = st.z != 0 && tile_live(st.x, st.y, qmin, qmax, window);
    }
    const unsigned hit = __ballot_sync(kFull, live);
    if (hit) return kt + __ffs(hit) - 1;
  }
  return nkt;
}

// Streamed K/V: the same from the key metadata in device memory, a tile at
// a time; leaves the lane's key position and the tile's statistics.
__device__ __forceinline__ int next_live_streamed(int kt, int nkt, const int* kpos,
                                                  const uint8_t* kvalid, int sk, int qmin,
                                                  int qmax, int window, int lane, int& kp,
                                                  int4& st) {
  for (; kt < nkt; ++kt) {
    bool ok;
    key_meta(kpos, kvalid, sk, kt, lane, kp, ok);
    st = tile_stats(kp, ok);
    if (st.z != 0 && tile_live(st.x, st.y, qmin, qmax, window)) break;
  }
  return kt;
}

// Copy the 32 rows of key tile kt (row stride `gs` elements in device
// memory) into shared memory at Item::at, 16 bytes a copy; rows past Sk
// are filled with zeros. Called by one warp.
template <typename Item, int HD, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, size_t gs, int kt, int sk,
                                          int lane) {
  constexpr int E = 16 / sizeof(T);  // elements per copy
  constexpr int CPR = HD / E;        // copies per row
#pragma unroll
  for (int i = lane; i < kBK * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, key = kt * kBK + r;
    const bool in = key < sk;
    cp_async16(dst + Item::at(r, c), in ? src + key * gs + c * E : src, in);
  }
}

// mean[d] = mean over all Sk keys of V[:, d] in f32, V[j, d] read as
// elem(j, d); `part` holds kMeanGroups * HD partial sums.
template <int HD, typename Elem>
__device__ __forceinline__ void v_mean(Elem elem, int sk, float* part, float* mean) {
  for (int i = threadIdx.x; i < kMeanGroups * HD; i += blockDim.x) {
    const int d = i % HD;
    float acc = 0.f;
    for (int j = i / HD; j < sk; j += kMeanGroups) acc += elem(j, d);
    part[i] = acc;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < kMeanGroups; ++g) acc += part[g * HD + d];
    mean[d] = acc / (float)sk;
  }
  __syncthreads();
}

// Shared memory, in bytes. A header (the V mean, its partial sums, the
// least valid key and query positions); then, with K/V resident, every K
// and V tile, each warp's O staging rows, every key position and each
// tile's statistics; with K/V streamed, per warp a two-stage ring of a K
// tile, a V tile and their key positions, and the O staging rows.
template <typename T, int HD>
struct Smem {
  using Item = typename ItemOf<T, HD>::type;
  static constexpr int TILE = kBK * Item::ROW * (int)sizeof(T);
  static constexpr int STAGE = Item::STAGE * (int)sizeof(T);
  static constexpr int HEADER = (1 + kMeanGroups) * HD * 4 + 16;
  __host__ __device__ static long long resident(long long nkt) {
    return HEADER + nkt * (2 * TILE + kBK * 4 + 16) + (long long)kWarps * STAGE;
  }
  static constexpr int PER_WARP = 4 * TILE + 2 * kBK * 4 + STAGE;
  __host__ __device__ static long long streamed(int warps) {
    return HEADER + (long long)warps * PER_WARP;
  }
};

// One CTA per (b, KV head). `resident`: K/V staged whole in shared memory;
// otherwise each warp streams its live key tiles through a 2-stage ring.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    const uint8_t* __restrict__ kvalid, T* __restrict__ o, int sq, int sk, int nq,
    int nkv, int window, float scale, int resident) {
  using Item = typename ItemOf<T, HD>::type;
  using L = Smem<T, HD>;
  constexpr int TILE = kBK * Item::ROW;  // elements of one K or V tile
  constexpr int E = 16 / sizeof(T);     // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  float* mean = reinterpret_cast<float*>(smem);
  float* part = mean + HD;
  int* kmin_all = reinterpret_cast<int*>(part + kMeanGroups * HD);
  int* qmin_all = kmin_all + 1;

  const int b = blockIdx.x / nkv, kvh = blockIdx.x % nkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nkt = (sk + kBK - 1) / kBK;
  const size_t gs = (size_t)nkv * HD;
  const T* kb = k + (size_t)b * sk * gs + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * sk * gs + (size_t)kvh * HD;
  const int* kpb = kpos + (size_t)b * sk;
  const uint8_t* kvb = kvalid + (size_t)b * sk;
  // resident layout
  T* ks_all = reinterpret_cast<T*>(smem + L::HEADER);
  T* vs_all = ks_all + (size_t)nkt * TILE;
  T* stage_res = vs_all + (size_t)nkt * TILE;
  int* kpos_all = reinterpret_cast<int*>(stage_res + kWarps * Item::STAGE);
  int4* stats = reinterpret_cast<int4*>(kpos_all + nkt * kBK);
  // streamed layout, this warp's part
  unsigned char* mine = smem + L::HEADER + (size_t)warp * L::PER_WARP;
  T* ring = reinterpret_cast<T*>(mine);  // [stage][K, V]
  int* kpos_ring = reinterpret_cast<int*>(mine + 4 * L::TILE);
  T* stage = resident ? stage_res + warp * Item::STAGE
                      : reinterpret_cast<T*>(kpos_ring + 2 * kBK);

  if (threadIdx.x == 0) *kmin_all = *qmin_all = INT_MAX;
  __syncthreads();
  if (resident) {
    // each tile's statistics and key positions; K and V of the tiles that
    // hold a valid key
    for (int kt = warp; kt < nkt; kt += nw) {
      int kp;
      bool ok;
      key_meta(kpb, kvb, sk, kt, lane, kp, ok);
      const int4 st = tile_stats(kp, ok);
      kpos_all[kt * kBK + lane] = kp;
      if (lane == 0) {
        stats[kt] = st;
        atomicMin(kmin_all, st.x);
      }
      if (st.z != 0) {
        copy_tile<Item, HD>(ks_all + kt * TILE, kb, gs, kt, sk, lane);
        copy_tile<Item, HD>(vs_all + kt * TILE, vb, gs, kt, sk, lane);
      }
    }
    cp_async_commit();
  } else {
    int kmin = INT_MAX;
    for (int j = threadIdx.x; j < sk; j += blockDim.x) {
      const int p = kpb[j];
      if (kvb[j]) kmin = min(kmin, p);
    }
    kmin = __reduce_min_sync(kFull, kmin);
    if (lane == 0) atomicMin(kmin_all, kmin);
  }
  int qmin_b = INT_MAX;  // while the copies are in flight
  for (int i = threadIdx.x; i < sq; i += blockDim.x) qmin_b = min(qmin_b, qpos[(size_t)b * sq + i]);
  qmin_b = __reduce_min_sync(kFull, qmin_b);
  if (lane == 0) atomicMin(qmin_all, qmin_b);
  __syncthreads();
  // Can a query row of this batch row have no live key? Without a window
  // a row is dead iff its position is below every valid key's; with one,
  // assume it can. Only then is the V mean needed, and V read whole.
  const bool any_dead = window > 0 || *qmin_all < *kmin_all;
  if (resident) {
    if (any_dead)
      for (int kt = warp; kt < nkt; kt += nw)
        if (stats[kt].z == 0) copy_tile<Item, HD>(vs_all + kt * TILE, vb, gs, kt, sk, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (any_dead)
      v_mean<HD>([&](int j, int d) { return to_f32(vs_all[Item::at(j, d / E) + d % E]); }, sk,
                 part, mean);
  } else if (any_dead) {
    v_mean<HD>([&](int j, int d) { return to_f32(vb[j * gs + d]); }, sk, part, mean);
  }

  const int group = nq / nkv;
  const int nqt = (sq + kBQ - 1) / kBQ;
  const float qscale = sizeof(T) == 2 ? scale * 1.4426950408889634f : scale;  // log2(e)
  for (int it = warp; it < group * nqt; it += nw) {
    const int row0 = (it % nqt) * kBQ, h = kvh * group + it / nqt;
    const int qrow = row0 + (lane & 15);
    const bool qok = lane < 16 && qrow < sq;
    const int qp_lane = qok ? qpos[(size_t)b * sq + qrow] : 0;
    const int qmin = __reduce_min_sync(kFull, qok ? qp_lane : INT_MAX);
    const int qmax = __reduce_max_sync(kFull, qok ? qp_lane : INT_MIN);
    const size_t rs = (size_t)nq * HD;
    const size_t qoff = (size_t)b * sq * rs + (size_t)h * HD;

    Item item;
    item.init();
    bool q_loaded = false;
    auto visit = [&](const T* ks, const T* vs, const int* kps, const int4& st) {
      if (!q_loaded) {  // Q is read only for an item with a live tile
        item.load_q(q + qoff, rs, row0, sq, lane);
        q_loaded = true;
      }
      const KeyTile key{kps, (unsigned)st.z,
                        tile_full((unsigned)st.z, st.x, st.y, qmin, qmax, window)};
      item.tile(ks, vs, key, qp_lane, window, qscale, lane);
    };
    if (resident) {
      for (int kt = next_live(0, nkt, stats, qmin, qmax, window, lane); kt < nkt;
           kt = next_live(kt + 1, nkt, stats, qmin, qmax, window, lane))
        visit(ks_all + (size_t)kt * TILE, vs_all + (size_t)kt * TILE, kpos_all + kt * kBK,
              stats[kt]);
    } else {
      int kp, kp_next;
      int4 st, st_next;
      int kt = next_live_streamed(0, nkt, kpb, kvb, sk, qmin, qmax, window, lane, kp, st);
      int slot = 0;
      if (kt < nkt) {
        copy_tile<Item, HD>(ring, kb, gs, kt, sk, lane);
        copy_tile<Item, HD>(ring + TILE, vb, gs, kt, sk, lane);
        cp_async_commit();
        kpos_ring[lane] = kp;
      }
      while (kt < nkt) {
        const int kn = next_live_streamed(kt + 1, nkt, kpb, kvb, sk, qmin, qmax, window,
                                          lane, kp_next, st_next);
        if (kn < nkt) {
          T* nxt = ring + (slot ^ 1) * 2 * TILE;
          copy_tile<Item, HD>(nxt, kb, gs, kn, sk, lane);
          copy_tile<Item, HD>(nxt + TILE, vb, gs, kn, sk, lane);
          cp_async_commit();
          kpos_ring[(slot ^ 1) * kBK + lane] = kp_next;
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const T* ks = ring + slot * 2 * TILE;
        visit(ks, ks + TILE, kpos_ring + slot * kBK, st);
        __syncwarp();  // the slot just read is the next one written
        slot ^= 1;
        kt = kn;
        st = st_next;
      }
    }
    item.store(o + qoff, rs, row0, sq, mean, stage, lane);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, const void* kvalid, void* o, int b, int sq, int sk,
           int nq, int nkv, int window, float scale, cudaStream_t stream) {
  using L = Smem<T, HD>;
  const long long nkt = (sk + kBK - 1) / kBK;
  const int resident = L::resident(nkt) <= kMaxSmem;
  int warps = kWarps;
  if (!resident) {
    warps = (int)((kMaxSmem - L::HEADER) / L::PER_WARP);
    warps = warps < kWarps ? warps : kWarps;
  }
  const long long smem = resident ? L::resident(nkt) : L::streamed(warps);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)b * nkv, warps * 32, (size_t)smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos, (const int*)kpos,
      (const uint8_t*)kvalid, (T*)o, sq, sk, nq, nkv, window, scale, resident);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, const void* qpos,
              const void* kpos, const void* kvalid, void* o, int b, int sq, int sk,
              int nq, int nkv, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
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
  return is_bf16
      ? launch_hd<__nv_bfloat16>(hd, q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, st)
      : launch_hd<float>(hd, q, k, v, qpos, kpos, kvalid, o, b, sq, sk, nq, nkv, window, scale, st);
}
