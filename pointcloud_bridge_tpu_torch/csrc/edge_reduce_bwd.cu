// K7b: the backward of K7 (edge_reduce.cu): the gradient on y, each
// point's row folded by the thread that owns it, with no per-edge tensor.
//
// Replaces: no Pallas kernel: the VJP that XLA derives for the reductions
// of pointcloud_bridge_tpu/models/dgcnn.py:127-137 on the TPU. For row i
// and its slot j (point p = clamp(idx[b, i, j])), channel c, v = y[b, p, c],
// the slot's term is
//   e[b, i, j, c] = ((v == mx_i ? g_mx_i / n_mx_i : 0)
//                    + (v == mn_i ? g_mn_i / n_mn_i : 0))
//                   + g_s1_i * inv_k + v * ((g_s2_i * inv_k) * 2)
// where n_mx_i counts the slots of row i whose value equals mx_i (K7's
// ties): a tie splits the cotangent evenly, as JAX's reduce_max VJP and
// torch's amax backward do. The last two terms only with moments. Each
// operation is rounded on its own in that order (-fmad=false), as
// ops/edge.py::edge_grads_plain computes it, and
//   dy[b, p, c] = the terms of p's slots added from 0.0 in ascending
//                 slot id i * k + j, one __fadd_rn at a time,
// the order of K3b's fold (group_bwd.cu), so a call gives the same bits
// every time: those of edge_grads_plain folded by
// ops/grouping.py::group_backward_order.
//
// Design (three launches, five where a batch element's slots are many):
// 1. the counting sort of the slots by point (group_sort.cuh, K3b's:
//    count, scan and place over `split` blocks a batch element, or one
//    block a batch element) -> the buckets, in no set order;
// 2. rank, a warp a point: its bucket into ascending slot order
//    (rank_bucket), written as the slots' rows i = id / k (`rows`);
// 3. fold, a block a batch element and a channel pair, a thread a point:
//    the block first builds a 48-byte record a row in shared memory (192 KB
//    at S = 4096) of what a term needs of its row, a = (mx, mn,
//    g_s1 * inv_k, (g_s2 * inv_k) * 2) a channel and the cotangents over
//    their ties, g = (g_mx / n_mx, g_mn / n_mn), 2 blocks a cluster sharing
//    the reads through distributed shared memory; then each thread keeps
//    its y values in registers, walks its rows in order and adds each
//    slot's term (g read only where the slot hits the max or the min).
//    Where S records do not fit a block (S > 4,842) the fold computes
//    those values from device memory at each slot (`staged` = 0).
// The first design wrote every slot's term e as a [B, S, k, F] float32 scratch (336 MB
// at B = 16, k = 20, F = 64) for K3b to fold; here the scratch is the
// sort's, B * (N + split * N + 2 * S * k) ints.
// What bounds it on the H100: bytes: y, idx, the six (four) per-row arrays
// and the ties read once, the gradient written once. Its work: the sort
// moves idx twice and the id arrays once; the fold's random reads of the
// records (16 bytes a slot and channel) are what its time goes to.
#include "common.cuh"
#define PCB_SORT_NAMESPACE k7b_sort
#include "group_sort.cuh"

#include <cooperative_groups.h>

#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int kRankThreads = 128;  // a point (and a row) a warp
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kFoldThreads = 1024;  // a point a thread
constexpr int kAhead = 4;  // rows a thread loads before their terms
constexpr int kCluster = 2;  // blocks a cluster of the staged fold, a pair each
// a row's record of a channel pair: a of channel c0, a of c0 + 1, then the
// two g, 48 bytes (an odd number of 16-byte words, so that random rows
// spread over the banks of shared memory)
constexpr int kRec = 3;

// What a slot's term needs of its row i and channel c (at = (b * S + i) *
// F + c): a = (mx, mn, g_s1 * inv_k, (g_s2 * inv_k) * 2) (the last two 0
// without moments) and g = (g_mx / n_mx, g_mn / n_mn).
struct Rows {
  const float* mx;
  const float* mn;
  const int* ties;
  const float* gmx;
  const float* gmn;
  const float* gs1;
  const float* gs2;
  float inv_k;

  template <bool kMoments>
  __device__ __forceinline__ float4 a(size_t at) const {
    float4 r = make_float4(__ldg(mx + at), __ldg(mn + at), 0.0f, 0.0f);
    if (kMoments) {
      r.z = __fmul_rn(__ldg(gs1 + at), inv_k);
      r.w = __fmul_rn(__fmul_rn(__ldg(gs2 + at), inv_k), 2.0f);
    }
    return r;
  }
  __device__ __forceinline__ float2 g(size_t at) const {
    const unsigned tie = (unsigned)__ldg(ties + at);
    return make_float2(__fdiv_rn(__ldg(gmx + at), (float)(tie & 0xffffu)),
                       __fdiv_rn(__ldg(gmn + at), (float)(tie >> 16)));
  }
};

__global__ void __launch_bounds__(kRankThreads)
    edge_bwd_rank(const int* __restrict__ ends, const int* __restrict__ bucket,
                  int* __restrict__ rows, int n, int t, FastDiv kdiv) {
  const int j = blockIdx.x * kRankWarps + threadIdx.x / 32;
  if (j >= n) return;  // uniform across the warp
  const size_t pb = (size_t)blockIdx.y * n + j;
  const int start = j == 0 ? 0 : __ldg(ends + pb - 1);
  const size_t at = (size_t)blockIdx.y * t + start;
  rank_bucket(bucket + at, __ldg(ends + pb) - start, rows + at, threadIdx.x & 31, kdiv);
}

// A slot's values of its row i and channel c0 + c from a row's record in
// shared memory (kRec float4 a row: a of c0, a of c0 + 1, the two g).
struct SharedRows {
  const float4* rec;
  template <bool kMoments>
  __device__ __forceinline__ float4 a(int i, int c) const { return rec[i * kRec + c]; }
  __device__ __forceinline__ float2 g(int i, int c) const {
    return reinterpret_cast<const float2*>(rec + i * kRec + 2)[c];
  }
};

// The same values computed from device memory at each slot.
struct GlobalRows {
  Rows r;
  size_t row0;  // (b * S) * F + c0
  int f;
  int width;  // channels c0.. that exist (1 or 2)
  template <bool kMoments>
  __device__ __forceinline__ float4 a(int i, int c) const {
    return c < width ? r.a<kMoments>(row0 + (size_t)i * f + c)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __device__ __forceinline__ float2 g(int i, int c) const {
    return r.g(row0 + (size_t)i * f + c);
  }
};

// Point p's gradient in channels c0 and c0 + 1 (the first `width` stored):
// its slots' rows rw[start, end) in ascending slot order, each slot's term
// added from 0.0, one __fadd_rn at a time. The rows of the next kAhead
// slots are loaded while this batch's terms are computed.
template <bool kMoments, typename Src>
__device__ __forceinline__ void fold_point(const Src& src, const int* __restrict__ rw, int start,
                                           int end, const float* __restrict__ yp,
                                           float* __restrict__ op, int width) {
  float v[2], acc[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    v[c] = c < width ? __ldg(yp + c) : 0.0f;
    acc[c] = 0.0f;
  }
  int next[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) next[u] = start + u < end ? __ldg(rw + start + u) : 0;
  for (int q = start; q < end; q += kAhead) {
    int ii[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ii[u] = next[u];
      next[u] = q + kAhead + u < end ? __ldg(rw + q + kAhead + u) : 0;
    }
    float4 a[kAhead][2];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int c = 0; c < 2; ++c) a[u][c] = src.template a<kMoments>(ii[u], c);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool slot = q + u < end;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool hx = slot && v[c] == a[u][c].x;
        const bool hn = slot && v[c] == a[u][c].y;
        float term = 0.0f;  // __fadd_rn(0.0f, 0.0f) where neither hits
        if (hx || hn) {
          const float2 g = src.g(ii[u], c);
          term = __fadd_rn(hx ? g.x : 0.0f, hn ? g.y : 0.0f);
        }
        if (kMoments) term = __fadd_rn(__fadd_rn(term, a[u][c].z), __fmul_rn(v[c], a[u][c].w));
        const float sum = __fadd_rn(acc[c], term);
        acc[c] = slot ? sum : acc[c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (c < width) op[c] = acc[c];
}

// The staged fold: a block a batch element and a channel pair, 2 blocks a
// cluster along the pairs (4 channels). Block q of a cluster reads rows
// [q S / 2, (q + 1) S / 2) of the cluster's 4 channels, 16 bytes of each
// row of each array (half a 32-byte sector; a block alone would read a
// quarter of each sector it moves), and writes each channel's part of the
// row's record into the shared memory of the block that folds that pair.
// After the cluster's barrier every block holds the records of all S rows
// for its pair (192 KB at S = 4096), and a thread a point folds from them.
// (Clusters of 4, whole sectors, placed fewer blocks on the card at once
// and were slower; a block alone was 4-13% slower at DGCNN's train shapes,
// B = 4 and 16; probes/k7_probe.py K7B_VARIANTS.)
template <bool kMoments>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kFoldThreads)
    edge_bwd_fold_staged(const float* __restrict__ y, Rows r, const int* __restrict__ ends,
                         const int* __restrict__ rows, float* __restrict__ out, int n, int s,
                         int t, int f) {
  extern __shared__ float4 rec[];  // [S][kRec]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int c8 = ((int)blockIdx.y - q) * 2;  // the cluster's first channel
  const int lo = (int)((long long)s * q / kCluster);
  const int hi = (int)((long long)s * (q + 1) / kCluster);
#pragma unroll 4
  for (int e = threadIdx.x; e < (hi - lo) * 2 * kCluster; e += kFoldThreads) {
    const int i = lo + e / (2 * kCluster);
    const int cc = e % (2 * kCluster);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 g = make_float2(0.0f, 0.0f);
    if (c8 + cc < f) {
      const size_t at = ((size_t)b * s + i) * f + c8 + cc;
      a = r.a<kMoments>(at);
      g = r.g(at);
    }
    float4* d = cluster.map_shared_rank(rec, cc / 2) + (size_t)i * kRec;
    d[cc % 2] = a;
    reinterpret_cast<float2*>(d + 2)[cc % 2] = g;
  }
  cluster.sync();
  const int c0 = blockIdx.y * 2;
  const int width = min(2, f - c0);
  if (width <= 0) return;  // a cluster's block past F stages and leaves
  const SharedRows src{rec};
  const int* rw = rows + (size_t)b * t;
  for (int p = threadIdx.x; p < n; p += kFoldThreads) {
    const size_t pb = (size_t)b * n + p;
    fold_point<kMoments>(src, rw, p == 0 ? 0 : __ldg(ends + pb - 1), __ldg(ends + pb),
                         y + pb * f + c0, out + pb * f + c0, width);
  }
}

// The fold where S rows of records do not fit a block: a thread a point
// and a channel pair, each slot's values read from device memory.
template <bool kMoments>
__global__ void __launch_bounds__(kFoldThreads)
    edge_bwd_fold_global(const float* __restrict__ y, Rows r, const int* __restrict__ ends,
                         const int* __restrict__ rows, float* __restrict__ out, int n, int s,
                         int t, int f) {
  const int p = blockIdx.x * kFoldThreads + threadIdx.x;
  if (p >= n) return;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * 2;
  const int width = min(2, f - c0);
  const GlobalRows src{r, (size_t)b * s * f + c0, f, width};
  const size_t pb = (size_t)b * n + p;
  fold_point<kMoments>(src, rows + (size_t)b * t, p == 0 ? 0 : __ldg(ends + pb - 1),
                       __ldg(ends + pb), y + pb * f + c0, out + pb * f + c0, width);
}

template <bool kMoments>
cudaError_t launch_fold(const float* y, const Rows& r, const int* ends, const int* rows,
                        float* out, int b, int n, int s, int t, int f, bool staged,
                        cudaStream_t st) {
  const int pairs = (f + 1) / 2;
  if (staged) {
    const size_t smem = (size_t)s * kRec * sizeof(float4);
    const cudaError_t err = allow_smem(edge_bwd_fold_staged<kMoments>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(1, (unsigned)((pairs + kCluster - 1) / kCluster * kCluster), (unsigned)b);
    edge_bwd_fold_staged<kMoments><<<grid, kFoldThreads, smem, st>>>(y, r, ends, rows, out, n,
                                                                     s, t, f);
  } else {
    const dim3 grid((unsigned)((n + kFoldThreads - 1) / kFoldThreads), (unsigned)pairs,
                    (unsigned)b);
    edge_bwd_fold_global<kMoments><<<grid, kFoldThreads, 0, st>>>(y, r, ends, rows, out, n, s,
                                                                  t, f);
  }
  return cudaGetLastError();
}

}  // namespace

// y [B, N, F], idx [B, S, k], K7's mx and mn [B, S, F] and its ties (int32
// [B, S, F], n_mx | n_mn << 16), their cotangents g_mx, g_mn and, with
// moments, those of s1 and s2 (else null), each [B, S, F] -> out [B, N, F].
// `work` is B * (N + split * N + 2 * S * k) ints of scratch (bucket ends,
// the count blocks' histograms, the buckets, their rows in order).
// `plan` holds the integers of a launch, laid out once a shape by the
// wrapper (ops/edge.py::_edge_bwd_plan, fields EDGE_BWD_PLAN): b, n, s, k,
// f, moments, split (the sort's blocks a batch element), staged (the
// fold's route), k_mul and k_shift (k's FastDiv) and inv_k's float32 bits.
// The wrapper checks 1 <= B <= 65535, 1 <= N <= GROUP_BWD_MAX_N, B * S * k
// < 2^31 and S * 48 bytes within a block's shared memory where staged.
PCB_API int pcb_edge_reduce_backward(const float* y, const int* idx, const float* mx,
                                     const float* mn, const int* ties, const float* g_mx,
                                     const float* g_mn, const float* g_s1, const float* g_s2,
                                     float* out, int* work, const int* plan, int device,
                                     void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int f = plan[4];
  const int moments = plan[5];
  const int split = plan[6];
  const int staged = plan[7];
  const int k_mul = plan[8];
  const int k_shift = plan[9];
  float inv_k;
  std::memcpy(&inv_k, plan + 10, sizeof(float));
  cudaStream_t st = (cudaStream_t)stream;
  const int t = s * k;
  int* ends = work;
  int* hist = ends + (size_t)b * n;
  int* bucket = hist + (size_t)b * split * n;
  int* rows = bucket + (size_t)b * t;
  if ((err = sort_slots(idx, ends, hist, bucket, b, n, t, split, st)) != cudaSuccess)
    return (int)err;
  const dim3 rank_grid((unsigned)((n + kRankWarps - 1) / kRankWarps), (unsigned)b);
  edge_bwd_rank<<<rank_grid, kRankThreads, 0, st>>>(ends, bucket, rows, n, t,
                                                   FastDiv{(unsigned)k_mul, (unsigned)k_shift});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const Rows r{mx, mn, ties, g_mx, g_mn, g_s1, g_s2, inv_k};
  return (int)(moments ? launch_fold<true>(y, r, ends, rows, out, b, n, s, t, f, staged, st)
                       : launch_fold<false>(y, r, ends, rows, out, b, n, s, t, f, staged, st));
}
