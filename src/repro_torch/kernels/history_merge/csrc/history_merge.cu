// history_merge: inference-time watch-history injection (paper §III-B).
//
// Replaces the TPU kernel repro/kernels/history_merge/history_merge.py
// (history_merge_pallas, body _merge_kernel). Per row it merges the batch
// history (Lb events) and the realtime buffer (Lr events) into the K
// freshest events, one copy per item (the freshest), right-aligned in
// ascending time. Freshness is the order (ts, is_rt, index).
//
// Bound on the H100: bytes. The pairwise rank does 2 * N^2 integer
// compares per row, all out of shared memory (N = Lb + Lr = 320 at the
// design point B = 256, Lb = 256, Lr = 64, K = 256), while the row's
// inputs and outputs are ~7 KB of device memory.
//
// Design: one CTA per row. The row's N items, timestamps and valid flags
// are staged in shared memory (16 B per event, 5 KB at N = 320), each
// thread owns events i = tid, tid + blockDim, ...:
//   pass 1: dup(i) = !valid(i) || some valid j with the same item is fresher;
//   pass 2: rank(i) = #alive j fresher than i; an alive event with rank < K
//           is written straight to slot K - 1 - rank.
// Freshness is a strict total order, so alive events have distinct ranks
// and the scatter never collides. The output is zero-filled before the
// first barrier and scattered after the second, so the two never race.
// A zero-length side needs no widening: N is simply Lb or Lr.

#include <cuda_runtime.h>

namespace {

// Realtime events follow the batch events in the concatenated index, so on
// a timestamp tie the (is_rt, index) order is the index order.
__device__ __forceinline__ bool fresher(int ts_j, int j, int ts_i, int i) {
  return ts_j > ts_i || (ts_j == ts_i && j > i);
}

__global__ void history_merge_kernel(
    const int* __restrict__ bi, const int* __restrict__ bt,
    const int* __restrict__ bv, const int* __restrict__ ri,
    const int* __restrict__ rt, const int* __restrict__ rv,
    int* __restrict__ oi, int* __restrict__ ot, int* __restrict__ ov,
    int lb, int lr, int k) {
  extern __shared__ int smem[];
  const int n = lb + lr;
  int* s_item = smem;
  int* s_ts = smem + n;
  int* s_valid = smem + 2 * n;
  int* s_alive = smem + 3 * n;
  const long long row = blockIdx.x;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool is_rt = i >= lb;
    const long long off = is_rt ? row * lr + (i - lb) : row * lb + i;
    s_item[i] = is_rt ? ri[off] : bi[off];
    s_ts[i] = is_rt ? rt[off] : bt[off];
    s_valid[i] = (is_rt ? rv[off] : bv[off]) > 0;
  }
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    oi[row * k + s] = 0;
    ot[row * k + s] = 0;
    ov[row * k + s] = 0;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool alive = s_valid[i];
    const int item = s_item[i], ts = s_ts[i];
    for (int j = 0; alive && j < n; ++j)
      if (s_valid[j] && s_item[j] == item && fresher(s_ts[j], j, ts, i))
        alive = false;
    s_alive[i] = alive;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!s_alive[i]) continue;
    const int ts = s_ts[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += s_alive[j] && fresher(s_ts[j], j, ts, i);
    if (rank < k) {
      const long long slot = row * k + (k - 1 - rank);
      oi[slot] = s_item[i];
      ot[slot] = ts;
      ov[slot] = 1;
    }
  }
}

}  // namespace

extern "C" int history_merge_launch(
    const void* bi, const void* bt, const void* bv, const void* ri,
    const void* rt, const void* rv, void* oi, void* ot, void* ov,
    int b, int lb, int lr, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n = lb + lr;
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = 4 * (size_t)n * sizeof(int);
  history_merge_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const int*)bi, (const int*)bt, (const int*)bv, (const int*)ri,
      (const int*)rt, (const int*)rv, (int*)oi, (int*)ot, (int*)ov, lb, lr, k);
  return (int)cudaGetLastError();
}
