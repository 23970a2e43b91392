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
// Steps 1-3 are the counting sort of group_sort.cuh (K7b, edge_reduce_bwd.cu,
// sorts its slots with it too), and step 4 ranks with its rank_bucket.
// The sort is split over blocks, which fill the card
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
#define PCB_SORT_NAMESPACE k3b_sort
#include "group_sort.cuh"

namespace {

constexpr int kFoldThreads = 128;  // 4 warps a block, a point a warp
constexpr int kFoldWarps = kFoldThreads / 32;

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

  // the bucket's ids in ascending order
  rank_bucket(bk, len, so, lane, FastDiv{0u, 0u});
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
  const int chunks = (wout + 32 * vec - 1) / (32 * vec);
  int* ends = work;
  int* hist = ends + (size_t)b * n;
  int* bucket = hist + (size_t)b * split * n;
  int* sorted = bucket + (size_t)b * t;
  err = sort_slots(idx, ends, hist, bucket, b, n, t, split, st);
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
