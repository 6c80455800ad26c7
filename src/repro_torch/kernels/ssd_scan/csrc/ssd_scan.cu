// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan of one SSM
// layer, what repro/models/ssm.py::ssd_chunked computes. Per head h, with
// a (hp, ds) f32 state:
//
//   h_t = exp(dt_t * A_h) * h_{t-1} + (dt_t * x_t) (x) B_t
//   y_t = C_t . h_t + D_h * x_t
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (ssd_scan_pallas, body _ssd_kernel), which walks the chunks on a
// sequential grid axis and carries the state in VMEM scratch. Per chunk of
// Q rows, with cum the in-chunk cumulative sum of dt * A:
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
// keeps its incoming state bit for bit.
//
// Layouts are the JAX package's: x, y (b, s, nh, hp) in T (f32 or bf16);
// dt (b, s, nh) f32; A, D (nh,) f32; B, C (b, s, ds) in T; h0 and hout
// (b, nh, hp, ds) f32; h0 may be null (a zero state, not read).
//
// Bound on the H100: at the prefill shape of mamba2-780m (b = 64,
// s = chunk = 256, nh = 48, hp = 64, ds = 128, bf16) one launch needs
// ~39 GFLOP (intra, inter and state update ~12.9 G each, C.B^T on the
// causal half ~0.5 G) and moves ~0.31 GB (x, y, h_final, B, C, dt): the
// bytes bound it at the bf16 tensor-core rate (~0.09 ms), but this kernel
// computes in f32 on the CUDA cores (67 TFLOP/s, ~0.6 ms for 39 GFLOP).
//
// Design (simple first; tensor cores, wgmma and TMA are later work): one
// CTA of 8 warps per (head, batch row) walks the chunks in order, its
// state held in shared memory as st[ds][hp] across chunks. A chunk (any Q
// up to 256) is cut into tiles of 32 rows. For each row tile i the CTA
// stages C_i, then for each row tile j <= i it stages B_j and x_j dt_j and
// forms G = (C_i B_j^T) o exp(segsum) (lane = row i, 4 columns j a
// thread), then y += G X_j (lane = row i, each warp hp/8 columns p). The
// inter term is a product of C_i with st. For the state update each
// thread keeps an ES x EP block of the state in registers while the row
// tiles of B and of the decayed x dt stream through shared memory. C.B^T
// is recomputed per head (the heads share B and C); sharing it across a
// block of heads is later work. Tiles of B and C are stored in rows padded
// to ds + 4 floats, so the per-lane rows of C_i fall in distinct banks.
// Row tiles that are all padding (dt = 0) add exact zeros and are skipped,
// as is the inter term while the state is still zero: a left-padded
// prefill row of 32 real tokens in 256 runs one tile of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // rows of a chunk staged at a time (one a lane)
constexpr int kMaxChunk = 256; // cum and dt of a chunk, one a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int HP, int DS>
struct Layout {
  static constexpr int kRow = DS + 4;             // padded row of a B/C tile
  static constexpr int kSt = DS * HP;             // st[k][p]
  static constexpr int kCi = kTile * kRow;
  static constexpr int kBj = kTile * kRow;
  static constexpr int kXj = kTile * HP;          // x dt rows, [j][p]
  static constexpr int kG = kTile * (kTile + 1);  // G[i][j], padded
  static constexpr int kFloats = kSt + kCi + kBj + kXj + kG + 2 * kMaxChunk;
  static constexpr int kBytes = kFloats * 4;
  // the y tile: lane = row i, warp w owns columns [w * EY, (w + 1) * EY)
  static constexpr int EY = HP / kWarps;
  // the state update: each thread owns an ES x EP block of st
  static constexpr int PER = HP * DS / kThreads;
  static constexpr int EP = PER < 8 ? PER : 8;
  static constexpr int ES = PER / EP;
  static constexpr int NPB = HP / EP;             // blocks along p
  static_assert(EY % 4 == 0, "hp must be a multiple of 32");
  static_assert(EP % 4 == 0 && PER % EP == 0, "hp * ds must be >= 1024");
  static_assert(NPB * (DS / ES) == kThreads, "state blocks must cover st");
};

// Stage rows [r0, r0 + kTile) of a (rows, n) slice into dst[r][0:n] with
// row stride `stride`, scaled by scale(r); rows at or past `rows` are 0.
template <typename T, typename F>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      size_t src_stride, int n, int r0,
                                      int rows, F scale) {
  for (int e = threadIdx.x; e < kTile * n; e += kThreads) {
    const int r = e / n, c = e % n;
    const int t = r0 + r;
    dst[r * stride + c] =
        t < rows ? to_f32(src[(size_t)t * src_stride + c]) * scale(t) : 0.f;
  }
}

template <typename T, int HP, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hout, int s, int nh, int chunk) {
  using L = Layout<HP, DS>;
  extern __shared__ __align__(16) float smem[];
  float* st = smem;
  float* Ci = st + L::kSt;
  float* Bj = Ci + L::kCi;
  float* Xj = Bj + L::kBj;
  float* G = Xj + L::kXj;
  float* cum = G + L::kG;
  float* dtv = cum + kMaxChunk;
  __shared__ float wsum[kWarps];
  __shared__ int tile_live[kMaxChunk / kTile];  // a row with dt != 0

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = A[h], dcoef = Dv[h];
  const size_t hbase = ((size_t)bi * nh + h) * HP * DS;
  // row t of the sequence: x/y at ((bi * s + t) * nh + h) * HP, B/C at
  // (bi * s + t) * DS, dt at (bi * s + t) * nh + h
  const size_t xrow = (size_t)nh * HP;

  for (int e = tid; e < HP * DS; e += kThreads)  // h0[p][k] -> st[k][p]
    st[(e % DS) * HP + e / DS] = h0 ? h0[hbase + e] : 0.f;
  bool st_zero = h0 == nullptr;  // the same in every thread

  for (int c0 = 0; c0 < s; c0 += chunk) {
    const size_t r0 = (size_t)bi * s + c0;       // first row of the chunk
    const T* xc = x + r0 * xrow + (size_t)h * HP;
    const T* Bc = Bm + r0 * DS;
    const T* Cc = Cm + r0 * DS;

    // ---- dt and the in-chunk cumulative sum of dt * A ------------------
    __syncthreads();  // the previous chunk is done with cum, dtv, wsum
    float v = 0.f;
    if (tid < chunk) {
      const float d = dt[(r0 + tid) * nh + h];
      dtv[tid] = d;
      v = d * a;
    }
    // warp w holds rows [32 w, 32 w + 32): row tile w
    const unsigned nz = __ballot_sync(0xffffffffu, v != 0.f);
    if (lane == 0) tile_live[warp] = nz != 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < chunk) cum[tid] = v;
    __syncthreads();
    const float cl = cum[chunk - 1];

    // ---- outputs, one tile of 32 rows at a time -------------------------
    // A row tile whose dt are all 0 (padding) adds exact zeros to y and to
    // the state, and a zero state adds nothing to y: both are skipped, the
    // same way in every thread.
    const int p0 = warp * L::EY;
    bool live_so_far = false;  // a live row in the tiles j0 <= i0
    for (int i0 = 0; i0 < chunk; i0 += kTile) {
      live_so_far = live_so_far || tile_live[i0 / kTile];
      __syncthreads();  // the previous tile is done with Ci, Bj, Xj, G
      if (!st_zero || live_so_far)
        stage(Ci, L::kRow, Cc, DS, DS, i0, chunk, [](int) { return 1.f; });
      __syncthreads();
      const int gi = i0 + lane;                  // this lane's row
      const bool live = gi < chunk;
      const float cum_i = live ? cum[gi] : 0.f;
      const float* ci = Ci + lane * L::kRow;

      // inter-chunk term: exp(cum_i) * (C_i . st[:, p])
      float acc[L::EY];
#pragma unroll
      for (int q = 0; q < L::EY; ++q) acc[q] = 0.f;
      for (int k = 0; k < (st_zero ? 0 : DS); k += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(ci + k);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* sr = st + (k + kk) * HP + p0;
#pragma unroll
          for (int q = 0; q < L::EY; q += 4) {
            const float4 s4 = *reinterpret_cast<const float4*>(sr + q);
            acc[q] += cv[kk] * s4.x;
            acc[q + 1] += cv[kk] * s4.y;
            acc[q + 2] += cv[kk] * s4.z;
            acc[q + 3] += cv[kk] * s4.w;
          }
        }
      }
      const float ecum = live ? expf(cum_i) : 0.f;
#pragma unroll
      for (int q = 0; q < L::EY; ++q) acc[q] *= ecum;

      // intra-chunk term over the row tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        if (!tile_live[j0 / kTile]) continue;
        __syncthreads();  // the previous j tile is done with Bj, Xj, G
        stage(Bj, L::kRow, Bc, DS, DS, j0, chunk, [](int) { return 1.f; });
        stage(Xj, HP, xc, xrow, HP, j0, chunk,
              [dtv](int t) { return dtv[t]; });
        __syncthreads();
        // G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < DS; k += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(ci + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 b4 = *reinterpret_cast<const float4*>(
                Bj + (warp * 4 + q) * L::kRow + k);
            dot[q] += c4.x * b4.x + c4.y * b4.y + c4.z * b4.z + c4.w * b4.w;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = warp * 4 + q, gj = j0 + jj;
          G[lane * (kTile + 1) + jj] =
              (live && gj <= gi) ? dot[q] * expf(cum_i - cum[gj]) : 0.f;
        }
        __syncthreads();
        // y_i += sum_j G[i][j] (x_j dt_j)
        const int jn = min(kTile, chunk - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float g = G[lane * (kTile + 1) + jj];
          const float* xr = Xj + jj * HP + p0;
#pragma unroll
          for (int q = 0; q < L::EY; q += 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(xr + q);
            acc[q] += g * x4.x;
            acc[q + 1] += g * x4.y;
            acc[q + 2] += g * x4.z;
            acc[q + 3] += g * x4.w;
          }
        }
      }
      if (live) {
        const T* xi = xc + (size_t)gi * xrow + p0;
        T* yi = y + (r0 + gi) * xrow + (size_t)h * HP + p0;
#pragma unroll
        for (int q = 0; q < L::EY; ++q)
          yi[q] = from_f32<T>(acc[q] + dcoef * to_f32(xi[q]));
      }
    }

    // ---- state update ---------------------------------------------------
    const int pp0 = (tid % L::NPB) * L::EP, kk0 = (tid / L::NPB) * L::ES;
    const float decay = expf(cl);
    float hs[L::ES][L::EP];
#pragma unroll
    for (int es = 0; es < L::ES; ++es)
#pragma unroll
      for (int ep = 0; ep < L::EP; ++ep)
        hs[es][ep] = decay * st[(kk0 + es) * HP + pp0 + ep];
    for (int j0 = 0; j0 < chunk; j0 += kTile) {
      if (!tile_live[j0 / kTile]) continue;
      __syncthreads();  // Bj and Xj are free
      stage(Bj, L::kRow, Bc, DS, DS, j0, chunk, [](int) { return 1.f; });
      stage(Xj, HP, xc, xrow, HP, j0, chunk, [dtv, cum, cl](int t) {
        return dtv[t] * expf(cl - cum[t]);
      });
      __syncthreads();
      const int jn = min(kTile, chunk - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float xv[L::EP];
#pragma unroll
        for (int ep = 0; ep < L::EP; ep += 4) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(Xj + jj * HP + pp0 + ep);
          xv[ep] = x4.x;
          xv[ep + 1] = x4.y;
          xv[ep + 2] = x4.z;
          xv[ep + 3] = x4.w;
        }
#pragma unroll
        for (int es = 0; es < L::ES; ++es) {
          const float bv = Bj[jj * L::kRow + kk0 + es];
#pragma unroll
          for (int ep = 0; ep < L::EP; ++ep) hs[es][ep] += xv[ep] * bv;
        }
      }
    }
    __syncthreads();  // every thread has read its old st (and the y tiles)
#pragma unroll
    for (int es = 0; es < L::ES; ++es)
#pragma unroll
      for (int ep = 0; ep < L::EP; ++ep)
        st[(kk0 + es) * HP + pp0 + ep] = hs[es][ep];
    st_zero = st_zero && !live_so_far;
  }

  __syncthreads();
  for (int e = tid; e < HP * DS; e += kThreads)  // st[k][p] -> hout[p][k]
    hout[hbase + e] = st[(e % DS) * HP + e / DS];
}

template <typename T, int HP, int DS>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y, void* hout,
           int b, int s, int nh, int chunk, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, HP, DS>;
  const int bytes = Layout<HP, DS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nh, b), kThreads, bytes, stream>>>(
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
