// Merge-path merge of two sorted packed-row arrays with counts, for Hopper.
//
// Replaces the Pallas TPU kernel soapdenovo_trans_tpu/kernels/merge_path.py
// (_merge_device / _merge_kernel, pallas_call at :284): the LSM merge of
// sorted k-mer runs on the counting path (dictionary.merge_runs).
//
// A row is two lanes, each an int64 holding a uint32 (hi, lo); it compares
// as the 64-bit key hi << 32 | lo.  Rows [0, n) of A and [0, m) of B are
// live; n and m are device scalars read through pointers, so the caller
// never waits on the host.  The output has exactly na + nb rows: the n + m
// live rows in ascending order (ties take A first, so a count is never
// duplicated), then all-ones sentinel rows with count 0.
//
// Design: a partition kernel binary-searches the merge-path diagonal of
// every TILE-row output block; then one CTA per output block loads its A
// and B windows (together at most TILE rows) into shared memory, each
// thread finds its own diagonal there and merges ITEMS outputs, and the
// block writes its results back through shared memory so global stores
// are coalesced.  Each row is read once and written once: the merge is
// bound by device-memory bandwidth, not by compares.  The TPU kernel's
// int32 bias, reversed B and roll-based realignment were workarounds for
// Mosaic and have no counterpart here.  No cp.async/TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // output rows per block
constexpr unsigned long long SENTINEL = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ unsigned long long row_key(const longlong2* rows,
                                                      long long i) {
  const longlong2 r = rows[i];
  return ((unsigned long long)r.x << 32) | (unsigned long long)r.y;
}

__device__ __forceinline__ long long live_count(const long long* p,
                                                long long cap) {
  const long long v = *p;
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// split[i] = rows taken from A among the first min(i*TILE, n+m) outputs.
__global__ void partition_kernel(const longlong2* __restrict__ a,
                                 const longlong2* __restrict__ b,
                                 long long na, long long nb,
                                 const long long* __restrict__ n_ptr,
                                 const long long* __restrict__ m_ptr,
                                 long long n_blocks,
                                 long long* __restrict__ split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n_blocks) return;
  const long long n = live_count(n_ptr, na);
  const long long m = live_count(m_ptr, nb);
  const long long d = min(i * TILE, n + m);
  long long lo = max(0LL, d - m), hi = min(d, n);
  while (lo < hi) {  // largest a with A[a-1] <= B[d-a]
    const long long mid = (lo + hi + 1) >> 1;
    if (row_key(a, mid - 1) <= row_key(b, d - mid)) lo = mid;
    else hi = mid - 1;
  }
  split[i] = lo;
}

__global__ void __launch_bounds__(THREADS)
merge_kernel(const longlong2* __restrict__ a, const int* __restrict__ a_cnt,
             const longlong2* __restrict__ b, const int* __restrict__ b_cnt,
             long long na, long long nb,
             const long long* __restrict__ n_ptr,
             const long long* __restrict__ m_ptr,
             const long long* __restrict__ split,
             longlong2* __restrict__ out, int* __restrict__ out_cnt) {
  __shared__ unsigned long long s_key[TILE];
  __shared__ int s_cnt[TILE];

  const long long n = live_count(n_ptr, na);
  const long long m = live_count(m_ptr, nb);
  const long long blk = blockIdx.x;
  const long long d0 = blk * TILE;
  const int n_out = (int)min((long long)TILE, na + nb - d0);
  const int n_live = (int)max(0LL, min((long long)TILE, n + m - d0));

  if (n_live > 0) {  // uniform across the block
    const long long a0 = split[blk], a1 = split[blk + 1];
    const long long b0 = d0 - a0;
    const int la = (int)(a1 - a0);
    const int lb = n_live - la;
    for (int t = threadIdx.x; t < la; t += THREADS) {
      s_key[t] = row_key(a, a0 + t);
      s_cnt[t] = a_cnt[a0 + t];
    }
    for (int t = threadIdx.x; t < lb; t += THREADS) {
      s_key[la + t] = row_key(b, b0 + t);
      s_cnt[la + t] = b_cnt[b0 + t];
    }
    __syncthreads();

    const int dd = min((int)threadIdx.x * ITEMS, n_live);
    int lo = max(0, dd - lb), hi = min(dd, la);
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_key[mid - 1] <= s_key[la + dd - mid]) lo = mid;
      else hi = mid - 1;
    }
    int ia = lo, ib = dd - lo;
    unsigned long long r_key[ITEMS];
    int r_cnt[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (dd + j >= n_live) {
        r_key[j] = SENTINEL;
        r_cnt[j] = 0;
        continue;
      }
      const bool take_a =
          ib >= lb || (ia < la && s_key[ia] <= s_key[la + ib]);
      const int src = take_a ? ia++ : la + ib++;
      r_key[j] = s_key[src];
      r_cnt[j] = s_cnt[src];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int t = threadIdx.x * ITEMS + j;
      s_key[t] = r_key[j];
      s_cnt[t] = r_cnt[j];
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < n_out; t += THREADS) {
    const unsigned long long key = t < n_live ? s_key[t] : SENTINEL;
    out[d0 + t] = make_longlong2((long long)(key >> 32),
                                 (long long)(key & 0xFFFFFFFFull));
    out_cnt[d0 + t] = t < n_live ? s_cnt[t] : 0;
  }
}

}  // namespace

extern "C" long long merge_path_blocks(long long rows) {
  return (rows + TILE - 1) / TILE;
}

// Enqueues the merge on `stream`; returns cudaGetLastError() after the
// launches (0 on success).  `split` is scratch of merge_path_blocks(na+nb)+1
// int64 values.
extern "C" int merge_path_launch(const void* a, const void* a_cnt,
                                 const void* b, const void* b_cnt,
                                 long long na, long long nb,
                                 const void* n_ptr, const void* m_ptr,
                                 void* split, void* out, void* out_cnt,
                                 void* stream) {
  const long long n_blocks = merge_path_blocks(na + nb);
  if (n_blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_split = n_blocks + 1;
  partition_kernel<<<(unsigned)((n_split + 255) / 256), 256, 0, s>>>(
      static_cast<const longlong2*>(a), static_cast<const longlong2*>(b),
      na, nb, static_cast<const long long*>(n_ptr),
      static_cast<const long long*>(m_ptr), n_blocks,
      static_cast<long long*>(split));
  merge_kernel<<<(unsigned)n_blocks, THREADS, 0, s>>>(
      static_cast<const longlong2*>(a), static_cast<const int*>(a_cnt),
      static_cast<const longlong2*>(b), static_cast<const int*>(b_cnt),
      na, nb, static_cast<const long long*>(n_ptr),
      static_cast<const long long*>(m_ptr),
      static_cast<const long long*>(split),
      static_cast<longlong2*>(out), static_cast<int*>(out_cnt));
  return (int)cudaGetLastError();
}
