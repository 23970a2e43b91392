// K3b: backward of the fused group (group.cu): the grouped gradient summed
// onto the points, each point's row by the warp that owns it.
//
// Replaces: the backward of pointcloud_bridge_tpu/ops/pallas_kernels/
// gather3.py's grouped gather, which the JAX package runs as the XLA
// scatter-add _gather3_bwd (ops/core.py:44-52) for the xyz channels and as
// XLA's gather transpose (ops/core.py:105) for the feature channels. For a
// channel range [c0, c1) of g [B, S, K, width]:
//   out[b, j, ch - c0] = sum of g[b, s, k, ch] over the slots with
//                        clamp(idx[b,s,k], 0, N-1) == j
// c0 = 3 gives dfeatures [B, N, C]; c0 = 0 adds dxyz in front, c1 = 3 is
// dxyz alone. The clamp is index_points' (ops/core.py:93): an empty-ball
// slot holds N, reads point N-1, and so sends its gradient to N-1. A sparse
// ball repeats its first hit in its trailing slots, and every repeat adds its
// gradient, as XLA's scatter-add does. (dnew_xyz = -sum_K g[..., :3] is a
// plain reduction beside it.) The same launch is the backward of
// ops/core.py::index_points on the card (c0 = 0, c1 = width = C, idx viewed
// as [B, S, K]).
//
// The order of the adds is fixed: each output row is a left fold from 0.0
// over its slots in ascending s * K + k, every add rounded on its own
// (__fadd_rn), and a row that no slot points at is written as zeros. So a
// call gives the same bits every time, and tests/test_torch_group_backward_
// order.py emulates it exactly. There are no float atomics and no memset.
//
// Design (four launches, two where a batch element's slots are few):
// 1. count, `split` blocks a batch element, each over its own slice of the
//    S * K slots: the slots a point has, counted in shared memory with
//    integer atomics (exact), written out as the block's histogram [N].
// 2. scan, a block a batch element: bucket j starts at the sum of the
//    counts of the points before it, and block g's part of bucket j at that
//    start plus the counts of blocks 0..g-1 at j; the histograms become
//    those offsets in place, and the bucket ends go to `ends` [B, N].
// 3. place, the blocks of step 1 over the same slices: each slot id
//    s * K + k goes into its point's bucket at a position taken by an
//    integer atomic on the block's offsets in shared memory (so a bucket
//    holds the right set, in no set order). The buckets go to `bucket`.
// 4. fold, a warp a point and a chunk of 32 * V channels (V = 4 where
//    c1 - c0 is a multiple of 4, else 1): it ranks its bucket's ids against
//    each other (a shuffle a comparison, 32 ids at a time), writes them in
//    ascending order to its chunk's copy in `sorted`, and folds the slot
//    rows of g in that order, the loads of kAhead slots issued before their
//    adds. The fold of a row is one chain of adds a channel, as long as the
//    row's bucket: ball queries over a wide radius send most slots to the
//    few lowest indices (buckets of 100 and more ids), so a row's chunks go
//    to separate warps and each keeps kAhead loads in flight.
// Steps 1-3 are a counting sort split over blocks, which fill the card
// where one block a batch element would leave most SMs idle; no memset
// and no atomic on device memory. Where the slots of a batch element make
// one slice (split = 1, S * K <= GROUP_BWD_SLICE), one block a batch
// element runs all three in one launch (group_bwd_sort). (__match_any_sync,
// one atomic for the lanes on one point, was slower.)
// The ranking costs a warp (L / 32)^2 * 32 shuffles for a bucket of L ids:
// little at the models' shapes, but quadratic in a bucket that collects
// thousands (every slot of empty balls).
// What bounds it on the H100: bytes, g read once (17 MB at the SSG train
// step's sa2 at B=4); the sort moves idx twice, the histograms three times
// and the id arrays once.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kSortThreads = 256;  // count and place
constexpr int kScanThreads = 1024;  // scan, and the sort in one block
constexpr int kUnroll = 4;  // slots a thread loads before their atomics
constexpr int kFoldThreads = 128;  // 4 warps a block, a point a warp
constexpr int kFoldWarps = kFoldThreads / 32;

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

// The V channels of one slot row that a lane adds (V = 1 or 4).
template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(T& a, T b) { a = __fadd_rn(a, b); }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  // g's rows are width floats, so a lane's four channels are seldom 16-byte
  // aligned: four 4-byte loads, which L1 serves from the same sectors
  static __device__ __forceinline__ T load(const float* p) {
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
  // an output row is c1 - c0 floats, a multiple of 4: 16-byte aligned
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

// slots a fold lane loads before their adds: 16 rows of 4 channels or 32 of 1
template <int V>
struct Ahead {
  static constexpr int value = V == 4 ? 16 : 32;
};

template <int V>
__global__ void __launch_bounds__(kFoldThreads)
    group_bwd_fold(const float* __restrict__ g, const int* __restrict__ ends,
                   const int* __restrict__ bucket, int* __restrict__ sorted,
                   float* __restrict__ out, int n, int t, int width, int c0, int wout) {
  using W = Vec<V>;
  constexpr int kAhead = Ahead<V>::value;
  const int j = blockIdx.x * kFoldWarps + threadIdx.x / 32;
  if (j >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const size_t rb = (size_t)b * n;
  const int start = j == 0 ? 0 : __ldg(ends + rb + j - 1);
  const int len = __ldg(ends + rb + j) - start;
  const int* bk = bucket + (size_t)b * t + start;
  // this chunk's own copy of the sorted bucket
  int* so = sorted + ((size_t)b * gridDim.y + blockIdx.y) * t + start;

  // the bucket's ids in ascending order: an id's rank is the number of ids
  // below it (the ids are distinct)
  for (int base = 0; base < len; base += 32) {
    const int e = base + lane < len ? bk[base + lane] : INT_MAX;
    int rank = 0;
    for (int ob = 0; ob < len; ob += 32) {
      const int o = ob + lane < len ? bk[ob + lane] : INT_MAX;
#pragma unroll
      for (int r = 0; r < 32; ++r) rank += __shfl_sync(0xffffffffu, o, r) < e;
    }
    if (base + lane < len) so[rank] = e;
  }
  __syncwarp();

  const float* gb = g + (size_t)b * t * width + c0;
  const int ch = blockIdx.y * 32 * V + lane * V;
  const bool active = ch < wout;
  typename W::T acc = W::zero();
  for (int q0 = 0; q0 < len; q0 += 32) {
    const int pl = q0 + lane < len ? so[q0 + lane] : 0;
    const int m = min(32, len - q0);
    for (int q = 0; q < m; q += kAhead) {
      typename W::T v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int p = __shfl_sync(0xffffffffu, pl, (q + u) & 31);
        v[u] = active && q + u < m ? W::load(gb + (size_t)p * width + ch) : W::zero();
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (q + u < m) W::add(acc, v[u]);
    }
  }
  if (active) W::store(out + (rb + j) * wout + ch, acc);
}

}  // namespace

// Raise a kernel's dynamic shared memory limit to `bytes` where it is past
// the 48 KB that needs no opt-in.
template <typename F>
static cudaError_t allow_smem(F kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
             : cudaSuccess;
}

// g [B, S, K, width], idx [B, S, K] -> out [B, N, c1 - c0]. `work` is
// B * (N + split * N + (1 + chunks) * S * K) ints of scratch (bucket ends,
// the blocks' histograms, buckets, a sorted copy of the buckets a chunk),
// chunks = ceil((c1 - c0) / (32 * vec)). `plan` holds the integers of a
// launch, laid out once a shape by the wrapper
// (ops/grouping.py::_group_backward_plan, fields GROUP_BWD_PLAN), which
// checks 0 <= c0 < c1 <= width, 1 <= B <= 65535, 1 <= N <=
// GROUP_BWD_MAX_N and B * S * K < 2^31, and picks `vec` (4 where c1 - c0
// is a multiple of 4, else 1) and `split`, the blocks a batch element of
// the count and the place.
PCB_API int pcb_group_backward(const float* g, const int* idx, float* out, int* work,
                               const int* plan, int device, void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int width = plan[4];
  const int c0 = plan[5];
  const int c1 = plan[6];
  const int vec = plan[7];
  const int split = plan[8];
  cudaStream_t st = (cudaStream_t)stream;
  const int wout = c1 - c0;
  const int t = s * k;
  const int per = (t + split - 1) / split;
  const int chunks = (wout + 32 * vec - 1) / (32 * vec);
  int* ends = work;
  int* hist = ends + (size_t)b * n;
  int* bucket = hist + (size_t)b * split * n;
  int* sorted = bucket + (size_t)b * t;
  const size_t smem = (size_t)n * sizeof(int);
  if (split == 1) {
    if ((err = allow_smem(group_bwd_sort, smem)) != cudaSuccess) return (int)err;
    group_bwd_sort<<<b, kScanThreads, smem, st>>>(idx, ends, bucket, n, t);
  } else {
    if ((err = allow_smem(group_bwd_count, smem)) != cudaSuccess ||
        (err = allow_smem(group_bwd_scan, smem)) != cudaSuccess ||
        (err = allow_smem(group_bwd_place, smem)) != cudaSuccess)
      return (int)err;
    const dim3 sort_grid((unsigned)split, (unsigned)b);
    group_bwd_count<<<sort_grid, kSortThreads, smem, st>>>(idx, hist, n, t, per);
    group_bwd_scan<<<b, kScanThreads, smem, st>>>(hist, ends, n, split);
    group_bwd_place<<<sort_grid, kSortThreads, smem, st>>>(idx, hist, bucket, n, t, per);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kFoldWarps - 1) / kFoldWarps), (unsigned)chunks, (unsigned)b);
  if (vec == 4)
    group_bwd_fold<4><<<grid, kFoldThreads, 0, st>>>(g, ends, bucket, sorted, out, n, t,
                                                     width, c0, wout);
  else if (vec == 1)
    group_bwd_fold<1><<<grid, kFoldThreads, 0, st>>>(g, ends, bucket, sorted, out, n, t,
                                                     width, c0, wout);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
