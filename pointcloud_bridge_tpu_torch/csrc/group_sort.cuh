// The counting sort of slots by point, and the ranking of a bucket into
// ascending order: what two owner-computes folds share. Its users:
//   K3b, group_bwd.cu (the group backward and index_points' backward),
//   K7b, edge_reduce_bwd.cu (the backward of DGCNN's edge reduction).
// Each includes this header into its own translation unit, a copy each in
// an anonymous namespace, after naming its copy's namespace
// PCB_SORT_NAMESPACE (k3b_sort, k7b_sort), which the kernels' names carry
// in a profile.
//
// For idx [B, T] (T slots a batch element, each the index of a point,
// clamped into [0, N - 1] as index_points clamps) the sort writes, per
// batch element:
//   ends [B, N]     bucket j ends at ends[b, j] (starts at ends[b, j - 1])
//   bucket [B, T]   each slot id p in its point's bucket, in no set order
// count, `split` blocks a batch element, each over its own slice of the T
// slots, counts the slots a point has in shared memory with integer
// atomics (exact) and writes the block's histogram [N] to `hist`; scan, a
// block a batch element, turns the histograms into each block's offsets in
// every bucket (block g's part of bucket j at the bucket's start plus the
// counts of blocks 0..g-1 at j) and writes the bucket ends; place, the
// blocks of count over the same slices, puts each slot id into its
// point's bucket at a position taken by an integer atomic on the block's
// offsets in shared memory. Where one slice holds a batch element's slots
// (split = 1), one block a batch element does all three in one launch
// (group_bwd_sort). No memset and no atomic on device memory; a bucket
// holds the right set, and rank_bucket orders it.
#pragma once

#include <climits>

#include "common.cuh"

#ifndef PCB_SORT_NAMESPACE
#error "name this copy of the sort: #define PCB_SORT_NAMESPACE before the #include"
#endif

namespace {
namespace PCB_SORT_NAMESPACE {

constexpr int kSortThreads = 256;  // count and place
constexpr int kScanThreads = 1024;  // scan, and the sort in one block
constexpr int kUnroll = 4;  // slots a thread loads before their atomics

// cnt[j] += the slots in [lo, hi) of ib on point j (shared atomics)
template <int kThreads>
__device__ __forceinline__ void count_slots(const int* __restrict__ ib, int* cnt, int lo, int hi,
                                            int n) {
  for (int p0 = lo; p0 < hi; p0 += kThreads * kUnroll) {
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads + (int)threadIdx.x;
      j[u] = p < hi ? clamp_index(__ldg(ib + p), n) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j[u] >= 0) atomicAdd(&cnt[j[u]], 1);
  }
}

// each slot id p in [lo, hi) into bucket position cur[j]++ of its point j
template <int kThreads>
__device__ __forceinline__ void place_slots(const int* __restrict__ ib, int* cur,
                                            int* __restrict__ bk, int lo, int hi, int n) {
  for (int p0 = lo; p0 < hi; p0 += kThreads * kUnroll) {
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kThreads + (int)threadIdx.x;
      j[u] = p < hi ? clamp_index(__ldg(ib + p), n) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j[u] >= 0) bk[atomicAdd(&cur[j[u]], 1)] = p0 + u * kThreads + (int)threadIdx.x;
  }
}

// a[0..n) in shared memory -> its exclusive prefix sums, in place, by a
// block of kScanThreads; a thread owns `per` consecutive entries. Ends
// with the block synchronised.
__device__ __forceinline__ void exclusive_scan(int* a, int n) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, n);
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += a[j];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int c = a[j];
    a[j] = run;
    run += c;
  }
  __syncthreads();
}

// block g of batch element b takes slots [g * per, (g + 1) * per)
__device__ __forceinline__ int slice_lo(int t, int per) { return min((int)blockIdx.x * per, t); }

__global__ void __launch_bounds__(kSortThreads)
    group_bwd_count(const int* __restrict__ idx, int* __restrict__ hist, int n, int t, int per) {
  extern __shared__ int cnt[];
  for (int j = threadIdx.x; j < n; j += kSortThreads) cnt[j] = 0;
  __syncthreads();
  const int lo = slice_lo(t, per);
  count_slots<kSortThreads>(idx + (size_t)blockIdx.y * t, cnt, lo, min(lo + per, t), n);
  __syncthreads();
  int* h = hist + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += kSortThreads) h[j] = cnt[j];
}

__global__ void __launch_bounds__(kScanThreads)
    group_bwd_scan(int* __restrict__ hist, int* __restrict__ ends, int n, int split) {
  extern __shared__ int tot[];  // bucket sizes, then their starts
  int* hb = hist + (size_t)blockIdx.x * split * n;
  for (int j = threadIdx.x; j < n; j += kScanThreads) {
    int c = 0;
    for (int g = 0; g < split; ++g) c += hb[(size_t)g * n + j];
    tot[j] = c;
  }
  __syncthreads();
  exclusive_scan(tot, n);
  // each block's offsets into bucket j, in block order; then its end
  for (int j = threadIdx.x; j < n; j += kScanThreads) {
    int at = tot[j];
    for (int g = 0; g < split; ++g) {
      const int c = hb[(size_t)g * n + j];
      hb[(size_t)g * n + j] = at;
      at += c;
    }
    ends[(size_t)blockIdx.x * n + j] = at;
  }
}

__global__ void __launch_bounds__(kSortThreads)
    group_bwd_place(const int* __restrict__ idx, const int* __restrict__ hist,
                    int* __restrict__ bucket, int n, int t, int per) {
  extern __shared__ int cur[];
  const int* h = hist + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += kSortThreads) cur[j] = h[j];
  __syncthreads();
  const int lo = slice_lo(t, per);
  place_slots<kSortThreads>(idx + (size_t)blockIdx.y * t, cur, bucket + (size_t)blockIdx.y * t,
                            lo, min(lo + per, t), n);
}

// count, scan and place in one block a batch element, where one slice
// holds them all (split = 1): one launch in place of three
__global__ void __launch_bounds__(kScanThreads)
    group_bwd_sort(const int* __restrict__ idx, int* __restrict__ ends, int* __restrict__ bucket,
                   int n, int t) {
  extern __shared__ int cnt[];  // counts, then the cursors
  const int* ib = idx + (size_t)blockIdx.x * t;
  for (int j = threadIdx.x; j < n; j += kScanThreads) cnt[j] = 0;
  __syncthreads();
  count_slots<kScanThreads>(ib, cnt, 0, t, n);
  __syncthreads();
  exclusive_scan(cnt, n);
  place_slots<kScanThreads>(ib, cnt, bucket + (size_t)blockIdx.x * t, 0, t, n);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kScanThreads) ends[(size_t)blockIdx.x * n + j] = cnt[j];
}

// A bucket's `len` ids bk[0..len) (distinct) into ascending order by the
// calling warp: an id's rank is the number of ids below it, found with a
// shuffle a comparison, 32 ids at a time; so[rank] = div(id) (div with
// mul = 0 keeps the id). (len / 32)^2 * 32 shuffles: quadratic in a
// bucket's length, little at the buckets of k-NN graphs and balls.
__device__ __forceinline__ void rank_bucket(const int* __restrict__ bk, int len, int* so,
                                            int lane, FastDiv div) {
  for (int base = 0; base < len; base += 32) {
    const int e = base + lane < len ? bk[base + lane] : INT_MAX;
    int rank = 0;
    for (int ob = 0; ob < len; ob += 32) {
      const int o = ob + lane < len ? bk[ob + lane] : INT_MAX;
#pragma unroll
      for (int r = 0; r < 32; ++r) rank += __shfl_sync(0xffffffffu, o, r) < e;
    }
    if (base + lane < len) so[rank] = div.div(e);
  }
}

}  // namespace PCB_SORT_NAMESPACE
using namespace PCB_SORT_NAMESPACE;
}  // namespace

// Raise a kernel's dynamic shared memory limit to `bytes` where it is past
// the 48 KB that needs no opt-in.
template <typename F>
static cudaError_t allow_smem(F kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
             : cudaSuccess;
}

// The counting sort of idx [B, T] into `ends` [B, N] and `bucket` [B, T]
// (above), `hist` [B, split, N] the count blocks' histograms (unused at
// split = 1): one launch or three on stream st.
static cudaError_t sort_slots(const int* idx, int* ends, int* hist, int* bucket, int b, int n,
                              int t, int split, cudaStream_t st) {
  cudaError_t err;
  const size_t smem = (size_t)n * sizeof(int);
  if (split == 1) {
    if ((err = allow_smem(group_bwd_sort, smem)) != cudaSuccess) return err;
    group_bwd_sort<<<b, kScanThreads, smem, st>>>(idx, ends, bucket, n, t);
  } else {
    if ((err = allow_smem(group_bwd_count, smem)) != cudaSuccess ||
        (err = allow_smem(group_bwd_scan, smem)) != cudaSuccess ||
        (err = allow_smem(group_bwd_place, smem)) != cudaSuccess)
      return err;
    const int per = (t + split - 1) / split;
    const dim3 sort_grid((unsigned)split, (unsigned)b);
    group_bwd_count<<<sort_grid, kSortThreads, smem, st>>>(idx, hist, n, t, per);
    group_bwd_scan<<<b, kScanThreads, smem, st>>>(hist, ends, n, split);
    group_bwd_place<<<sort_grid, kSortThreads, smem, st>>>(idx, hist, bucket, n, t, per);
  }
  return cudaGetLastError();
}
