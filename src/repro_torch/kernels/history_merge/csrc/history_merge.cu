// history_merge: inference-time watch-history injection (paper §III-B).
//
// Replaces the TPU kernel repro/kernels/history_merge/history_merge.py
// (history_merge_pallas, body _merge_kernel). Per row it merges the batch
// history (Lb events) and the realtime buffer (Lr events) into the K
// freshest events, one copy per item (the freshest), right-aligned in
// ascending time, zeros before them. Freshness is the order
// (ts, is_rt, index), which is (ts, concatenated index) because realtime
// events follow batch events.
//
// Bound on the H100: bytes. A row's inputs and outputs are ~7 KB of device
// memory (N = Lb + Lr = 320, K = 256 at the design point B = 256, Lb = 256,
// Lr = 64); the TPU kernel's pairwise formulation (written for a chip with
// no sort) spends 2 N^2 compares a row instead.
//
// Design: one CTA per row, P / 2 threads (P the power of two >= N, at
// least 64, at most 2048 threads' worth of pairs). Each event's freshness
// is one 64-bit key, (ts with its sign bit flipped) << 32 | index, so that
// an unsigned compare is the freshness order and keys are distinct.
//   dedup, O(N): a hash table in shared memory keyed by item (linear
//     probing; a slot is claimed by atomicCAS of item + 1, 0 = empty) keeps
//     the freshest key of each item by 64-bit atomicMax. An event is alive
//     iff it is valid and its key is its item's table value. A max does not
//     depend on the order of the atomics, so the result is deterministic.
//   rank: the alive keys (0 for the rest) are sorted in descending order by
//     a bitonic network in shared memory; steps whose partners lie within
//     a warp's 64 elements end in __syncwarp, the others in __syncthreads.
//   output: slot K - 1 - r takes the r-th freshest key for r < min(K, A),
//     A the number of alive events, and zeros before that: every output
//     slot is written once, in a coalesced store. (An alive key can be 0,
//     ts = INT_MIN at index 0; it then sorts last among the alive, and a
//     padding 0 beside it decodes to the same event.)
// The table (16 B a slot, at least 2N slots), the keys (8 B a slot of P)
// and the items (4 B an event) exceed 48 KB above N ~ 1000, so the launch
// raises the kernel's dynamic shared memory limit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPerThread = 4;  // events (and sort slots) a thread stages

__host__ __device__ __forceinline__ int pow2_at_least(int n, int lo) {
  int p = lo;
  while (p < n) p <<= 1;
  return p;
}

struct Layout {
  int p;        // sort width, a power of two >= N
  int table;    // hash table slots, a power of two >= 2N
  int threads;
  size_t smem;
};

__host__ __device__ __forceinline__ Layout layout(int n) {
  Layout L;
  L.p = pow2_at_least(n, 64);
  L.table = pow2_at_least(2 * n, 64);
  L.threads = L.p / 2 < kMaxThreads ? L.p / 2 : kMaxThreads;
  L.smem = (size_t)L.table * 16 + (size_t)L.p * 8 + (size_t)n * 4 + 16;
  return L;
}

__device__ __forceinline__ unsigned int hash_item(int item, int mask) {
  unsigned int h = (unsigned int)item * 2654435761u;
  return (h ^ (h >> 16)) & mask;
}

__global__ void history_merge_kernel(
    const int* __restrict__ bi, const int* __restrict__ bt,
    const int* __restrict__ bv, const int* __restrict__ ri,
    const int* __restrict__ rt, const int* __restrict__ rv,
    int* __restrict__ oi, int* __restrict__ ot, int* __restrict__ ov,
    int lb, int lr, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = lb + lr;
  const Layout L = layout(n);
  unsigned long long* t_item = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* t_key = t_item + L.table;
  unsigned long long* keys = t_key + L.table;
  int* s_item = reinterpret_cast<int*>(keys + L.p);
  int* s_alive = s_item + n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x;
  const int mask = L.table - 1;

  if (tid == 0) *s_alive = 0;
  for (int s = tid; s < L.table; s += nt) t_item[s] = t_key[s] = 0ull;
  // this thread's events: i = tid + u * nt
  int item[kMaxPerThread], slot[kMaxPerThread];
  unsigned long long key[kMaxPerThread];
  bool valid[kMaxPerThread];
#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) {
    const int i = tid + u * nt;
    valid[u] = false;
    if (i < n) {
      const bool is_rt = i >= lb;
      const long long off = is_rt ? row * lr + (i - lb) : row * lb + i;
      item[u] = is_rt ? ri[off] : bi[off];
      const int ts = is_rt ? rt[off] : bt[off];
      valid[u] = (is_rt ? rv[off] : bv[off]) > 0;
      key[u] = (unsigned long long)((unsigned int)ts ^ 0x80000000u) << 32 | (unsigned int)i;
      s_item[i] = item[u];
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) {
    if (!valid[u]) continue;
    const unsigned long long tag = (unsigned long long)(unsigned int)item[u] + 1ull;
    unsigned int s = hash_item(item[u], mask);
    for (;;) {
      const unsigned long long prev = atomicCAS(&t_item[s], 0ull, tag);
      if (prev == 0ull || prev == tag) break;
      s = (s + 1) & mask;
    }
    slot[u] = (int)s;
    atomicMax(&t_key[s], key[u]);
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kMaxPerThread; ++u) {
    const int i = tid + u * nt;
    if (i >= L.p) continue;
    const bool alive = i < n && valid[u] && t_key[slot[u]] == key[u];
    keys[i] = alive ? key[u] : 0ull;
    if (alive) atomicAdd(s_alive, 1);
  }
  __syncthreads();

  // bitonic sort, descending
  const int pairs = L.p / 2;
  for (int kk = 2; kk <= L.p; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < pairs; q += nt) {
        const int a = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int c = a | j;
        const unsigned long long x = keys[a], y = keys[c];
        if (((a & kk) == 0) == (x < y)) {
          keys[a] = y;
          keys[c] = x;
        }
      }
      // a step whose partners lie within each warp's 64 elements, after
      // one of the same kind, needs only the warp's own writes
      const int nj = j > 1 ? j >> 1 : kk;
      if (j >= 64 || nj >= 64) __syncthreads(); else __syncwarp();
    }
  }
  __syncthreads();

  const int kept = min(k, *s_alive);
  for (int s = tid; s < k; s += nt) {
    const int r = k - 1 - s;
    int it = 0, ts = 0, v = 0;
    if (r < kept) {
      const unsigned long long x = keys[r];
      it = s_item[(unsigned int)x];
      ts = (int)((unsigned int)(x >> 32) ^ 0x80000000u);
      v = 1;
    }
    oi[row * k + s] = it;
    ot[row * k + s] = ts;
    ov[row * k + s] = v;
  }
}

}  // namespace

extern "C" int history_merge_launch(
    const void* bi, const void* bt, const void* bv, const void* ri,
    const void* rt, const void* rv, void* oi, void* ot, void* ov,
    int b, int lb, int lr, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Layout L = layout(lb + lr);
  if (lb + lr > kMaxPerThread * L.threads) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(history_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.smem);
  if (err != cudaSuccess) return (int)err;
  history_merge_kernel<<<b, L.threads, L.smem, (cudaStream_t)stream>>>(
      (const int*)bi, (const int*)bt, (const int*)bv, (const int*)ri,
      (const int*)rt, (const int*)rv, (int*)oi, (int*)ot, (int*)ov, lb, lr, k);
  return (int)cudaGetLastError();
}
