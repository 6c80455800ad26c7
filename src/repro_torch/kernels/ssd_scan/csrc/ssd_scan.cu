// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan of one SSM
// layer, what repro/models/ssm.py::ssd_chunked computes. Per head h, with
// a (hp, ds) f32 state:
//
//   h_t = exp(dt_t * A_h) * h_{t-1} + (dt_t * x_t) (x) B_t
//   y_t = C_t . h_t + D_h * x_t
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (ssd_scan_pallas, body _ssd_kernel), which walks the chunks on a
// sequential grid axis per (batch row, block of heads) and carries the
// state in VMEM scratch. Per chunk of Q rows, with cum the in-chunk
// cumulative sum of dt * A:
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . state_in                                 (inter)
//         + D x_i
//   state = exp(cum_last) state_in
//         + sum_j B_j (x) (x_j dt_j exp(cum_last - cum_j))
//
// exp(cum_i - cum_j) overflows above the diagonal (cum falls within a
// chunk), so it is computed only where j <= i and 0 is selected elsewhere;
// never multiplied by a 0/1 mask (0 * inf = NaN). A padded position has
// dt = 0: it adds nothing and decays nothing, so a row that is all padding
// keeps its incoming state bit for bit (exp(0) = 1 exactly).
//
// Layouts are the JAX package's: x, y (b, s, nh, hp) in T (f32 or bf16);
// dt (b, s, nh) f32; A, D (nh,) f32; B, C (b, s, ds) in T; h0 and hout
// (b, nh, hp, ds) f32; h0 may be null (a zero state, not read).
//
// What bounds it on the H100: bytes. At mamba2-780m's prefill shape (b 64,
// s = chunk = 256, nh 48, hp 64, ds 128, bf16) a launch moves ~0.31 GB (x,
// y and the f32 final state ~100 MB each): 0.094 ms at 3.35 TB/s. At the
// inject shape (s = chunk = 64, from a state) it moves ~0.26 GB, the state
// read and written: 0.076 ms. A fully live prefill (no padding) needs
// ~26 GFLOP (~39 from an initial state), 0.03-0.04 ms at the bf16
// tensor-core rate: still under the bytes.
// On the serving path a row holds ~32 live tokens of 256 (left-padded), so
// most of the work is y = D x (+ exp(cum) C h0 from a state) on dead rows.
//
// The kernel this one replaced ran a CTA per (head, row), staged one
// scalar at a time, read x and wrote y one row per lane (2-byte accesses
// 6 KB apart) and transposed the state through shared memory with 32-way
// bank conflicts: on an H100 80GB HBM3 at 700 W a pure load/store kernel
// with that access pattern alone took 1.09 ms at the prefill shape, where
// a coalesced one takes 0.11 ms.
// The design:
//
// - One CTA of 4 warps per (batch row, block of kHB heads). A row of x or
//   y for the block is kHB * hp contiguous elements; it moves as 16-byte
//   cp.async copies into shared memory (x) and as 16-byte stores out of it
//   (y). B and C are staged once for the block: C . B^T of a (16-row,
//   16-row) tile pair is computed once and every head of the block reuses
//   it with its own decay exp(cum_i - cum_j) and dt_j. A head past nh (nh
//   not a multiple of kHB) is zero-filled and never stored.
// - A chunk is walked in bands of 64 rows, one 16-row tile a warp. The
//   band's x and C arrive by cp.async; the tiles j of B and x that the
//   band's intra term needs stream through a two-stage cp.async ring, the
//   next tile in flight while the current one computes. dt, exp(cum) and
//   the decays are applied in registers, never while staging.
// - bf16 products on tensor cores (mma.sync.m16n8k16, fragments by
//   ldmatrix; f32 accumulators). One operand of each product is exact in
//   bf16; the f32 one is split into hi = bf16(v) and lo = bf16(v - hi)
//   and multiplied twice (~16 mantissa bits): C B^T (both exact), G' X
//   with G' = (C B^T) o exp(segsum) o dt split, C h^T with the state
//   split, and X'^T B with X' = x dt exp(cum_last - cum) split.
// - The state is carried across chunks in hout itself (the CTA's own
//   heads, made visible by __syncthreads): one head at a time it is
//   staged in shared memory, split, for the inter term, and it seeds the
//   state update's accumulators. h0 and hout move as 16-byte accesses in
//   their (hp, ds) order through a row-padded f32 tile (rows 8 floats
//   apart in banks: the fragment writes of a half-warp fall on 32
//   distinct banks). At (hp 64, ds 128) that tile is 34.8 KB, one head.
// - Row tiles that are all padding (dt = 0 for every head of the block)
//   add exact zeros and are skipped, as is the inter term while the state
//   is zero; a band with no live row and a zero state stages no C and
//   only writes y = D x.
// - fp32: exact f32 arithmetic on CUDA cores (each lane computes the same
//   accumulator elements an mma fragment would hold), with the same CTA
//   shape, staging, skips and output path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>


namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 16;                 // rows of a tile: the mma's m
constexpr int kBand = kWarps * kR;     // rows of a band: one tile a warp
constexpr int kMaxChunk = 256;
// Heads a CTA and tiles of the ring, both chosen by measurement on the
// H100: 1 and 4 heads, and 3 and 4 tiles, were no faster.
constexpr int kHB = 2;
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;       // opt-in shared memory of a CTA

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
__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s) : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

// (v0, v1) -> hi = bf16(v), lo = bf16(v - hi), each packed as a pair
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(v1 - __bfloat162float(h1)));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------
// Shared memory
// ---------------------------------------------------------------------

template <typename T, int HP, int DS>
struct Cfg {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kPer = 16 / (int)sizeof(T);  // elements a 16-byte copy
  static constexpr int XW = kHB * HP;               // x/y elements of a row
  // rows padded by 16 bytes: a row is an odd number of 16-byte chunks, so
  // the 8 rows an ldmatrix phase reads fall on distinct banks
  static constexpr int XROW = XW + kPer;
  static constexpr int CROW = DS + kPer;
  static constexpr int XCH = XW / kPer;             // 16-byte chunks a row
  static constexpr int CCH = DS / kPer;
  // the state tile: f32 [HP][SROW], or hi and lo bf16 [HP][SROW] each
  static constexpr int SROW = DS + 8;
  // the state update: output columns a pass (<= 64 f32 accumulators a
  // thread), 8-column tiles a warp, 16-row tiles along hp
  static constexpr int NPASS = HP * DS > 8192 ? HP * DS / 8192 : 1;
  static constexpr int DSP = DS / NPASS;
  static constexpr int NTW = DSP / 8 / kWarps;
  static constexpr int MT = HP / 16;
  static constexpr int OROW = DSP + 8;              // f32 staging row
  static constexpr int OCH = DSP / 4;               // float4s a staged row
  static_assert(HP % 32 == 0 && DS % 32 == 0 && NTW >= 1, "hp, ds in {32, 64, 128}");
  static_assert(HP * OROW <= HP * SROW, "the staging tile fits the state tile");
  static_assert((XCH & (XCH - 1)) == 0 && (CCH & (CCH - 1)) == 0, "powers of two");

  // byte offsets
  static constexpr int kCum = 0;                                  // cum[kHB][256]
  static constexpr int kDt = kCum + kHB * kMaxChunk * 4;          // dt
  static constexpr int kW = kDt + kHB * kMaxChunk * 4;            // dt exp(cl - cum)
  static constexpr int kX = kW + kHB * kMaxChunk * 4;             // x band / y
  static constexpr int kC = kX + kBand * XROW * (int)sizeof(T);   // C band
  static constexpr int kBj = kC + kBand * CROW * (int)sizeof(T);  // ring: B_j
  static constexpr int kXj = kBj + kStages * kR * CROW * (int)sizeof(T);  // ring: x_j
  static constexpr int kSt = kXj + kStages * kR * XROW * (int)sizeof(T);  // state tile
  static constexpr int kBytes = kSt + HP * SROW * 4;
  static_assert(kBytes <= kMaxSmem, "shared memory of one CTA");
};

// ---------------------------------------------------------------------
// A warp's 16 rows of y for every head of the block. Lane (g, t) holds
// rows g and g + 8, columns 8n + 2t and 8n + 2t + 1 of each 8-column tile
// n: the mma accumulator layout, in both types.
// ---------------------------------------------------------------------

template <typename T, int HP, int DS> struct RowTile;

// bf16 on tensor cores
template <int HP, int DS>
struct RowTile<__nv_bfloat16, HP, DS> {
  using T = __nv_bfloat16;
  using K = Cfg<T, HP, DS>;
  static constexpr int NP = HP / 8;
  float acc[kHB][NP][4];
  uint32_t cf[DS / 16][4];  // C_i as A fragments

  __device__ __forceinline__ void load_c(const T* cb, int lane) {
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      ldsm_x4(cf[kk], cb + ((mat & 1) * 8 + r8) * K::CROW + 16 * kk + (mat >> 1) * 8);
  }

  // a = exp(cum_i) (C_i . state^T), the state split into hi and lo
  __device__ __forceinline__ void inter(float (&a)[NP][4], const T* hi, const T* lo,
                                        float e0, float e1, int lane) {
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NP / 2; ++np) {
        const int off = (16 * np + (mat >> 1) * 8 + r8) * K::SROW + 16 * kk + (mat & 1) * 8;
        uint32_t b[4];
        ldsm_x4(b, hi + off);
        mma_bf16(a[2 * np], cf[kk], b[0], b[1]);
        mma_bf16(a[2 * np + 1], cf[kk], b[2], b[3]);
        ldsm_x4(b, lo + off);
        mma_bf16(a[2 * np], cf[kk], b[0], b[1]);
        mma_bf16(a[2 * np + 1], cf[kk], b[2], b[3]);
      }
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      a[n][0] *= e0; a[n][1] *= e0; a[n][2] *= e1; a[n][3] *= e1;
    }
  }

  // S = C_i B_j^T (16 x 16), once for the block; even and odd k-steps
  // accumulate apart, halving the chain of dependent mma
  __device__ __forceinline__ void scores(float (&s)[2][4], const T* bj, int lane) {
    const int mat = lane >> 3, r8 = lane & 7;
    float u[2][2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[p][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, bj + ((mat >> 1) * 8 + r8) * K::CROW + 16 * kk + (mat & 1) * 8);
      mma_bf16(u[kk & 1][0], cf[kk], b[0], b[1]);
      mma_bf16(u[kk & 1][1], cf[kk], b[2], b[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = u[0][n][e] + u[1][n][e];
  }

  // a += G' X_j for one head, G' = S o exp(segsum) o dt_j in registers
  __device__ __forceinline__ void gx(float (&a)[NP][4], const float (&gv)[2][4],
                                     const T* xj, int lane) {
    const int mat = lane >> 3, r8 = lane & 7;
    uint32_t hi[4], lo[4];
    split2(gv[0][0], gv[0][1], hi[0], lo[0]);
    split2(gv[0][2], gv[0][3], hi[1], lo[1]);
    split2(gv[1][0], gv[1][1], hi[2], lo[2]);
    split2(gv[1][2], gv[1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < NP / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, xj + ((mat & 1) * 8 + r8) * K::XROW + 16 * dp + (mat >> 1) * 8);
      mma_bf16(a[2 * dp], hi, b[0], b[1]);
      mma_bf16(a[2 * dp], lo, b[0], b[1]);
      mma_bf16(a[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(a[2 * dp + 1], lo, b[2], b[3]);
    }
  }
};

// fp32: exact f32 on CUDA cores, the same elements a lane
template <int HP, int DS>
struct RowTile<float, HP, DS> {
  using T = float;
  using K = Cfg<T, HP, DS>;
  static constexpr int NP = HP / 8;
  float acc[kHB][NP][4];
  const float* cb;  // the warp's 16 rows of C in the band

  __device__ __forceinline__ void load_c(const T* c, int) { cb = c; }

  __device__ __forceinline__ static float dot(const float* u, const float* v) {
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < DS; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(u + k);
      const float4 b = *reinterpret_cast<const float4*>(v + k);
      s = fmaf(a.x, b.x, s); s = fmaf(a.y, b.y, s); s = fmaf(a.z, b.z, s); s = fmaf(a.w, b.w, s);
    }
    return s;
  }

  __device__ __forceinline__ void inter(float (&a)[NP][4], const float* st, const float*,
                                        float e0, float e1, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float u[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[n][e] = 0.f;
    // the two rows of C are read once a k-step for every column
#pragma unroll 2
    for (int k = 0; k < DS; k += 4) {
      const float4 c0 = *reinterpret_cast<const float4*>(cb + g * K::CROW + k);
      const float4 c1 = *reinterpret_cast<const float4*>(cb + (g + 8) * K::CROW + k);
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 v =
              *reinterpret_cast<const float4*>(st + (8 * n + 2 * t + e) * K::SROW + k);
          u[n][e] = fmaf(c0.x, v.x, fmaf(c0.y, v.y, fmaf(c0.z, v.z, fmaf(c0.w, v.w, u[n][e]))));
          u[n][2 + e] =
              fmaf(c1.x, v.x, fmaf(c1.y, v.y, fmaf(c1.z, v.z, fmaf(c1.w, v.w, u[n][2 + e]))));
        }
    }
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      a[n][0] = e0 * u[n][0]; a[n][1] = e0 * u[n][1];
      a[n][2] = e1 * u[n][2]; a[n][3] = e1 * u[n][3];
    }
  }

  __device__ __forceinline__ void scores(float (&s)[2][4], const T* bj, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* bp = bj + (8 * n + 2 * t + e) * K::CROW;
        s[n][e] = dot(cb + g * K::CROW, bp);
        s[n][2 + e] = dot(cb + (g + 8) * K::CROW, bp);
      }
  }

  // row g of G' is spread over lanes 4g..4g+3: gathered by shuffles
  __device__ __forceinline__ void gx(float (&a)[NP][4], const float (&gv)[2][4],
                                     const T* xj, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int src = 4 * g + ((k & 7) >> 1);
      const float ga = __shfl_sync(kFull, gv[k >> 3][k & 1], src);
      const float gb = __shfl_sync(kFull, gv[k >> 3][2 + (k & 1)], src);
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const float2 xv = *reinterpret_cast<const float2*>(xj + k * K::XROW + 8 * n + 2 * t);
        a[n][0] = fmaf(ga, xv.x, a[n][0]);
        a[n][1] = fmaf(ga, xv.y, a[n][1]);
        a[n][2] = fmaf(gb, xv.x, a[n][2]);
        a[n][3] = fmaf(gb, xv.y, a[n][3]);
      }
    }
  }
};

// ---------------------------------------------------------------------
// The state update of one head, one pass of DSP columns: the warp owns
// every 16-row tile along hp and NTW 8-column tiles; lane (g, t) holds
// rows 16 mt + g (+ 8) and columns 8 nt + 2t (+ 1) of its tiles.
// ---------------------------------------------------------------------

template <typename T, int HP, int DS>
struct StateTile {
  using K = Cfg<T, HP, DS>;
  float acc[K::MT][K::NTW][4];

  __device__ __forceinline__ int col(int warp, int nt, int lane) const {
    return (warp * K::NTW + nt) * 8 + 2 * (lane & 3);
  }

  // acc = decay * the staged state, or 0
  __device__ __forceinline__ void init(const float* so, float decay, bool zero, int warp,
                                       int lane) {
    const int g = lane >> 2;
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NTW; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = zero ? make_float2(0.f, 0.f)
                                : *reinterpret_cast<const float2*>(
                                      so + (16 * mt + g + 8 * hf) * K::OROW + col(warp, nt, lane));
          acc[mt][nt][2 * hf] = zero ? 0.f : decay * v.x;
          acc[mt][nt][2 * hf + 1] = zero ? 0.f : decay * v.y;
        }
  }

  __device__ __forceinline__ void store(float* so, int warp, int lane) const {
    const int g = lane >> 2;
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NTW; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store2(so + (16 * mt + g + 8 * hf) * K::OROW + col(warp, nt, lane),
                 acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
  }

  // acc += (x_j w_j)^T B_j over the tile's 16 rows j; xj points at the
  // head's columns, bj at the pass's columns, w at the tile's 16 weights
  __device__ __forceinline__ void update(const T* xj, const T* bj, const float* w, int warp,
                                         int lane) {
    const int g = lane >> 2, t = lane & 3;
    if constexpr (K::kMma) {
      const int mat = lane >> 3, r8 = lane & 7;
      uint32_t bf[K::NTW][2];
      const T* bw = bj + ((mat & 1) * 8 + r8) * K::CROW + warp * K::NTW * 8;
      if constexpr (K::NTW % 2 == 0) {
#pragma unroll
        for (int q = 0; q < K::NTW / 2; ++q) {
          uint32_t b[4];
          ldsm_x4_trans(b, bw + 16 * q + (mat >> 1) * 8);
          bf[2 * q][0] = b[0]; bf[2 * q][1] = b[1];
          bf[2 * q + 1][0] = b[2]; bf[2 * q + 1][1] = b[3];
        }
      } else {
        ldsm_x2_trans(bf[0], bw);
      }
      const float2 wa = *reinterpret_cast<const float2*>(w + 2 * t);
      const float2 wb = *reinterpret_cast<const float2*>(w + 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) {
        uint32_t a[4], hi[4], lo[4];
        ldsm_x4_trans(a, xj + (r8 + (mat >> 1) * 8) * K::XROW + 16 * mt + (mat & 1) * 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = unpack_bf16(a[q]);
          const float2 wq = q < 2 ? wa : wb;
          split2(f.x * wq.x, f.y * wq.y, hi[q], lo[q]);
        }
#pragma unroll
        for (int nt = 0; nt < K::NTW; ++nt) {
          mma_bf16(acc[mt][nt], hi, bf[nt][0], bf[nt][1]);
          mma_bf16(acc[mt][nt], lo, bf[nt][0], bf[nt][1]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < kR; ++k) {
        const float wk = w[k];
        float2 bv[K::NTW];
#pragma unroll
        for (int nt = 0; nt < K::NTW; ++nt)
          bv[nt] = load2(bj + k * K::CROW + col(warp, nt, lane));
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float xv = to_float(xj[k * K::XROW + 16 * mt + g + 8 * hf]) * wk;
#pragma unroll
            for (int nt = 0; nt < K::NTW; ++nt) {
              acc[mt][nt][2 * hf] = fmaf(xv, bv[nt].x, acc[mt][nt][2 * hf]);
              acc[mt][nt][2 * hf + 1] = fmaf(xv, bv[nt].y, acc[mt][nt][2 * hf + 1]);
            }
          }
      }
    }
  }
};

// 16-byte copies of columns [0, NCOL) of HP rows of f32 state (rows SRC
// floats apart) into shared memory rows ROW floats apart
template <int HP, int ROW, int NCOL, int SRC>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int tid) {
  constexpr int CH = NCOL / 4;
  for (int e = tid; e < HP * CH; e += kThreads) {
    const int p = e / CH, c = e % CH;
    cp_async16(dst + p * ROW + 4 * c, src + (size_t)p * SRC + 4 * c, true);
  }
}

template <typename T, int HP, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                const float* h0, T* __restrict__ y, float* hout, int s, int nh,
                int chunk) {
  using K = Cfg<T, HP, DS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = reinterpret_cast<float*>(smem + K::kCum);
  float* dtv = reinterpret_cast<float*>(smem + K::kDt);
  float* wv = reinterpret_cast<float*>(smem + K::kW);
  T* xb = reinterpret_cast<T*>(smem + K::kX);
  T* cb = reinterpret_cast<T*>(smem + K::kC);
  T* bring = reinterpret_cast<T*>(smem + K::kBj);
  T* xring = reinterpret_cast<T*>(smem + K::kXj);
  float* st = reinterpret_cast<float*>(smem + K::kSt);
  T* st_hi = reinterpret_cast<T*>(st);  // bf16: the split state; fp32: st
  T* st_lo = st_hi + HP * K::SROW;
  __shared__ unsigned live_mask;        // bit i: row tile i has dt != 0

  const int hb = blockIdx.x * kHB, bi = blockIdx.y;
  const int hv = min(kHB, nh - hb);     // heads of the block below nh
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t xrs = (size_t)nh * HP;   // x/y row stride
  float* hblk = hout + ((size_t)bi * nh + hb) * HP * DS;
  const float* h0blk = h0 ? h0 + ((size_t)bi * nh + hb) * HP * DS : nullptr;
  float dcoef[kHB];
#pragma unroll
  for (int h = 0; h < kHB; ++h) dcoef[h] = h < hv ? Dv[hb + h] : 0.f;
  bool st_zero = h0 == nullptr;  // the same in every thread

  // 16-byte copies of rows [r0, r0 + n) of the chunk; rows past the chunk
  // and heads past nh are zero-filled
  auto stage_x = [&](T* dst, const T* xc, int r0, int n) {
    for (int e = tid; e < n * K::XCH; e += kThreads) {
      const int r = e / K::XCH, c = e % K::XCH, q = r0 + r;
      const bool ok = q < chunk && c * K::kPer < hv * HP;
      cp_async16(dst + r * K::XROW + c * K::kPer, ok ? xc + q * xrs + c * K::kPer : xc, ok);
    }
  };
  auto stage_bc = [&](T* dst, const T* src, int r0, int n) {
    for (int e = tid; e < n * K::CCH; e += kThreads) {
      const int r = e / K::CCH, c = e % K::CCH, q = r0 + r;
      const bool ok = q < chunk;
      cp_async16(dst + r * K::CROW + c * K::kPer, ok ? src + (size_t)q * DS + c * K::kPer : src,
                 ok);
    }
  };
  // one head's state for the inter term: split into hi and lo (bf16), or
  // as it is (fp32)
  auto load_state = [&](const float* src) {
    if constexpr (K::kMma) {
      constexpr int CH = DS / 4;
#pragma unroll 4
      for (int e = tid; e < HP * CH; e += kThreads) {
        const int p = e / CH, c = e % CH;
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)p * DS + 4 * c));
        uint32_t h01, l01, h23, l23;
        split2(v.x, v.y, h01, l01);
        split2(v.z, v.w, h23, l23);
        *reinterpret_cast<uint2*>(st_hi + p * K::SROW + 4 * c) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(st_lo + p * K::SROW + 4 * c) = make_uint2(l01, l23);
      }
    } else {
      stage_f32<HP, K::SROW, DS, DS>(st, src, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
  };

  // the ring: the tiles j of a mask in increasing order, kStages - 1 of them in
  // flight ahead of the one being computed, each its own cp.async group
  const T* bc = nullptr;  // B and x rows of the current chunk
  const T* xc = nullptr;
  unsigned ring_todo = 0u;  // tiles not issued yet
  int ring_n = 0;           // tiles issued
  auto ring_issue = [&]() {
    if (ring_todo) {
      const int jt = __ffs(ring_todo) - 1, k = ring_n % kStages;
      ring_todo &= ring_todo - 1u;
      stage_bc(bring + k * kR * K::CROW, bc, jt * kR, kR);
      stage_x(xring + k * kR * K::XROW, xc, jt * kR, kR);
      ++ring_n;
    }
    cp_async_commit();  // an empty group past the last tile
  };
  auto ring_start = [&](unsigned mask) {
    ring_todo = mask;
    ring_n = 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) ring_issue();
  };

  for (int c0 = 0; c0 < s; c0 += chunk) {
    const size_t row0 = (size_t)bi * s + c0;     // first row of the chunk
    xc = x + (row0 * nh + hb) * HP;
    T* yc = y + (row0 * nh + hb) * HP;
    bc = Bm + row0 * DS;
    const T* cc = Cm + row0 * DS;
    const float* s_in = c0 == 0 ? h0blk : hblk;   // the state entering it
    const int rows16 = (chunk + kR - 1) / kR * kR;

    __syncthreads();  // the previous chunk is done with every buffer
    if (tid == 0) live_mask = 0u;
    stage_x(xb, xc, 0, min(kBand, rows16));      // in flight during the scan
    cp_async_commit();
    __syncthreads();

    // ---- dt, cum = the in-chunk sum of dt * A (a shuffle scan per 32
    // rows), w = dt exp(cum_last - cum), and the live row tiles ----------
    for (int h = warp; h < kHB; h += kWarps) {
      const float a = h < hv ? A[hb + h] : 0.f;
      float d[kMaxChunk / 32], v[kMaxChunk / 32];
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i) {
        const int q = 32 * i + lane;
        d[i] = h < hv && q < chunk ? dt[(row0 + q) * nh + hb + h] : 0.f;
      }
      float carry = 0.f;
      unsigned live = 0u;
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i) {
        float u = d[i] * a;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float n = __shfl_up_sync(kFull, u, off);
          if (lane >= off) u += n;
        }
        v[i] = u + carry;
        carry = __shfl_sync(kFull, v[i], 31);
        const unsigned nz = __ballot_sync(kFull, d[i] != 0.f);
        live |= ((nz & 0xffffu) ? 1u : 0u) << (2 * i);
        live |= ((nz >> 16) ? 1u : 0u) << (2 * i + 1);
      }
      // rows past the chunk have dt = 0: carry is cum[chunk - 1]
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i) {
        const int q = h * kMaxChunk + 32 * i + lane;
        cum[q] = v[i];
        dtv[q] = d[i];
        wv[q] = d[i] * expf(carry - v[i]);
      }
      if (lane == 0 && live) atomicOr(&live_mask, live);
    }
    __syncthreads();
    const unsigned lm = live_mask;

    // ---- y, one band of 64 rows at a time ------------------------------
    RowTile<T, HP, DS> rt;
    for (int b0 = 0; b0 < chunk; b0 += kBand) {
      const int nb = min(kBand, rows16 - b0);    // rows staged: whole tiles
      const int i0 = b0 + warp * kR;             // this warp's first row
      const bool mine = warp * kR < nb;
      unsigned todo = lm & ((1u << ((b0 + nb) / kR)) - 1u);  // live j <= last i
      const bool need_c = todo != 0u || !st_zero;
      if (b0 > 0) {
        __syncthreads();  // the previous band's y has left xb
        stage_x(xb, xc, b0, nb);
      }
      if (need_c) stage_bc(cb, cc, b0, nb);
      cp_async_commit();
      ring_start(todo);
      cp_async_wait<kStages - 1>();  // x and C of the band
      __syncthreads();

#pragma unroll
      for (int h = 0; h < kHB; ++h)
#pragma unroll
        for (int n = 0; n < HP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) rt.acc[h][n][e] = 0.f;
      if (need_c && mine) rt.load_c(cb + warp * kR * K::CROW, lane);

      // inter-chunk term, one head at a time through the state tile
      if (!st_zero) {
#pragma unroll
        for (int h = 0; h < kHB; ++h) {
          if (h >= hv) break;
          __syncthreads();  // the state tile is free
          load_state(s_in + (size_t)h * HP * DS);
          __syncthreads();
          if (mine) {
            const float* ch = cum + h * kMaxChunk;
            rt.inter(rt.acc[h], st_hi, st_lo, expf(ch[i0 + g]), expf(ch[i0 + g + 8]), lane);
          }
        }
      }

      // intra-chunk term over the live tiles j, through the ring
      for (int k = 0; todo; ++k) {
        const int jt = __ffs(todo) - 1, stage = k % kStages;
        todo &= todo - 1u;
        ring_issue();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const int j0 = jt * kR;
        if (mine && j0 <= i0) {
          const T* bj = bring + stage * kR * K::CROW;
          const T* xj = xring + stage * kR * K::XROW;
          float sc[2][4];
          rt.scores(sc, bj, lane);  // C_i B_j^T, once for the block
          const int ia = i0 + g, ib = ia + 8;
#pragma unroll
          for (int h = 0; h < kHB; ++h) {
            if (h >= hv) break;
            const float* ch = cum + h * kMaxChunk;
            const float* dh = dtv + h * kMaxChunk;
            const float ca = ch[ia], cbv = ch[ib];
            float gv[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + 8 * n + 2 * t + e;
                const float cj = ch[j], dj = dh[j];
                // exp only where j <= i: selected, never multiplied by a mask
                gv[n][e] = j <= ia ? sc[n][e] * expf(ca - cj) * dj : 0.f;
                gv[n][2 + e] = j <= ib ? sc[n][2 + e] * expf(cbv - cj) * dj : 0.f;
              }
            rt.gx(rt.acc[h], gv, xj + h * HP, lane);
          }
        }
        __syncthreads();  // the stage is free for the ring's next tile
      }

      // y = acc + D x over the staged x, then 16-byte stores of whole rows
      if (mine) {
        T* xw = xb + warp * kR * K::XROW;
#pragma unroll
        for (int h = 0; h < kHB; ++h) {
          if (h >= hv) break;
#pragma unroll
          for (int n = 0; n < HP / 8; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              T* p = xw + (g + 8 * hf) * K::XROW + h * HP + 8 * n + 2 * t;
              const float2 xv = load2(p);
              store2(p, rt.acc[h][n][2 * hf] + dcoef[h] * xv.x,
                     rt.acc[h][n][2 * hf + 1] + dcoef[h] * xv.y);
            }
        }
        __syncwarp();
        const int rows = min(kR, chunk - i0);
        for (int e = lane; e < rows * K::XCH; e += 32) {
          const int r = e / K::XCH, c = e % K::XCH;
          if (c * K::kPer < hv * HP)
            *reinterpret_cast<uint4*>(yc + (size_t)(i0 + r) * xrs + c * K::kPer) =
                *reinterpret_cast<const uint4*>(xw + r * K::XROW + c * K::kPer);
        }
      }
    }

    // ---- the state update, one head and DSP columns at a time ----------
    if (lm != 0u || !st_zero) {
      StateTile<T, HP, DS> su;
#pragma unroll 1
      for (int h = 0; h < hv; ++h) {
        const float decay = expf(cum[h * kMaxChunk + chunk - 1]);
        const float* wh = wv + h * kMaxChunk;
#pragma unroll 1
        for (int pp = 0; pp < K::NPASS; ++pp) {
          const int col0 = pp * K::DSP;
          __syncthreads();  // the state tile and the ring are free
          if (!st_zero)
            stage_f32<HP, K::OROW, K::DSP, DS>(st, s_in + (size_t)h * HP * DS + col0, tid);
          cp_async_commit();
          unsigned todo = lm;
          ring_start(todo);
          cp_async_wait<kStages - 1>();  // the staged state
          __syncthreads();
          su.init(st, decay, st_zero, warp, lane);
          for (int k = 0; todo; ++k) {
            const int jt = __ffs(todo) - 1, stage = k % kStages;
            todo &= todo - 1u;
            ring_issue();
            cp_async_wait<kStages - 1>();
            __syncthreads();
            su.update(xring + stage * kR * K::XROW + h * HP,
                      bring + stage * kR * K::CROW + col0, wh + jt * kR, warp, lane);
            __syncthreads();
          }
          __syncthreads();  // every warp has read its initial state
          su.store(st, warp, lane);
          __syncthreads();
          float* dst = hblk + (size_t)h * HP * DS + col0;
          for (int e = tid; e < HP * K::OCH; e += kThreads) {
            const int p = e / K::OCH, c = e % K::OCH;
            *reinterpret_cast<float4*>(dst + (size_t)p * DS + 4 * c) =
                *reinterpret_cast<const float4*>(st + p * K::OROW + 4 * c);
          }
        }
      }
      st_zero = false;
    }
  }

  if (st_zero) {  // no initial state and no live row: the final state is 0
    for (int e = tid; e < hv * HP * DS / 4; e += kThreads)
      reinterpret_cast<float4*>(hblk)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int HP, int DS>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y, void* hout,
           int b, int s, int nh, int chunk, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, HP, DS>;
  constexpr int bytes = Cfg<T, HP, DS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((nh + kHB - 1) / kHB, b), kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)D, (const float*)h0, (T*)y, (float*)hout,
      s, nh, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int HP>
int launch_ds(int ds, const void* x, const void* dt, const void* A,
              const void* B, const void* C, const void* D, const void* h0,
              void* y, void* hout, int b, int s, int nh, int chunk,
              cudaStream_t st) {
  switch (ds) {
    case 32: return launch<T, HP, 32>(x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
    case 64: return launch<T, HP, 64>(x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
    case 128: return launch<T, HP, 128>(x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_hp(int hp, int ds, const void* x, const void* dt, const void* A,
              const void* B, const void* C, const void* D, const void* h0,
              void* y, void* hout, int b, int s, int nh, int chunk,
              cudaStream_t st) {
  switch (hp) {
    case 32: return launch_ds<T, 32>(ds, x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
    case 64: return launch_ds<T, 64>(ds, x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
    case 128: return launch_ds<T, 128>(ds, x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* h0, void* y, void* hout, int b,
                               int s, int nh, int hp, int ds, int chunk,
                               int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || nh <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      s % chunk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
      ? launch_hp<__nv_bfloat16>(hp, ds, x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st)
      : launch_hp<float>(hp, ds, x, dt, A, B, C, D, h0, y, hout, b, s, nh, chunk, st);
}
